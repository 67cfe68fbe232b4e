"""Pretrained-weight resolution (the port's copy of the JAX package's
`train/weights.py`): `ensure_weights` returns a local CLIP checkpoint path,
fetching one of the released OpenAI files by name when it is missing.

The training loop never calls it: it imports `model.clip_pretrained` when
the file exists and trains from the seeded init with a warning when it does
not, so nothing is fetched in training.  Fetch a file explicitly with

    python3 -c "from denseclip_vit_multimodal_tpu_torch.train.weights import \
ensure_weights; ensure_weights('pretrained/ViT-B-16.pt')"

One process: the JAX package's wait for process 0 has no counterpart.
"""

from __future__ import annotations

import os
import shutil
import urllib.request
from typing import Optional

CLIP_URLS = {
    "RN50.pt": "https://openaipublic.azureedge.net/clip/models/afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762/RN50.pt",
    "RN101.pt": "https://openaipublic.azureedge.net/clip/models/8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599/RN101.pt",
    "ViT-B-16.pt": "https://openaipublic.azureedge.net/clip/models/5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f/ViT-B-16.pt",
    "ViT-L-14.pt": "https://openaipublic.azureedge.net/clip/models/b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836/ViT-L-14.pt",
}


def _fetch(url: str, dst: str, timeout: float = 60.0) -> None:
    """Copy `url` to the file `dst` (a socket timeout, so a stalled server
    cannot hang the caller)."""
    with urllib.request.urlopen(url, timeout=timeout) as src, open(dst, "wb") as out:
        shutil.copyfileobj(src, out)


def ensure_weights(path: str, logger=None) -> Optional[str]:
    """`path` if it exists; else the released file of that name fetched to
    `path`; None (logged) when the name is unknown or the fetch fails, and
    the caller trains from its init, as the reference does."""
    log = logger.info if logger is not None else (lambda msg: None)
    if os.path.exists(path):
        return path
    name = os.path.basename(path)
    url = CLIP_URLS.get(name)
    if url is None:
        log(f"no known URL for {name}; cannot fetch {path}")
        return None
    tmp = path + ".part"
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        log(f"downloading {url} -> {path}")
        _fetch(url, tmp)
        os.replace(tmp, path)
    except OSError as e:  # urllib's errors are OSErrors
        log(f"download failed ({e}); continuing without pretrained weights")
        if os.path.exists(tmp):
            os.remove(tmp)
        return None
    return path
