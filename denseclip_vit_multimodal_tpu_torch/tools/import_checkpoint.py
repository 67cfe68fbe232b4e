"""Migrate a reference-trained DenseCLIP checkpoint into the port's format
(the JAX package's `tools/import_checkpoint.py`, writing the port's
checkpoints instead of Orbax ones).

    python3 -m denseclip_vit_multimodal_tpu_torch.tools.import_checkpoint \
        CONFIG REF.pth --out WORK_DIR
    python3 -m denseclip_vit_multimodal_tpu_torch.tools.test CONFIG WORK_DIR --eval mIoU depth
    python3 -m denseclip_vit_multimodal_tpu_torch.tools.train CONFIG --load WORK_DIR ...

REF.pth is the reference trainer's dict (`{'epoch', 'state_dict',
'best_metric', ...}`) or a raw `state_dict`; a `module.` prefix (DDP) is
stripped.  The weights go through `train/clip_import.py::
import_reference_denseclip`; the optimizer state is a fresh one (torch Adam
moments of the reference's parameter groups are not carried over, as the
reference's own `--load` drops them).  WORK_DIR gets `checkpoints/epoch_N.pt`
with `latest` (and `best` when the file carries a best metric), which
`tools/test.py`, `tools/serve.py` and `tools/train.py --load` restore.  Runs
on `cuda` unless `--device cpu`.
"""

from __future__ import annotations

import argparse
from typing import Dict


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="reference .pth -> checkpoint of the PyTorch port")
    p.add_argument("config", help="config the checkpoint was trained with")
    p.add_argument("torch_ckpt", help=".pth file (trainer dict or state_dict)")
    p.add_argument("--out", required=True, help="work dir to write checkpoints/epoch_N + latest into")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--set", dest="overrides", nargs="*", default=[],
                   metavar="KEY.PATH=VALUE", help="dotted config overrides")
    return p.parse_args(argv)


def load_reference_state_dict(path: str):
    """(state_dict as {key: fp32 CPU tensor}, epoch, best_metric or None)."""
    import torch

    blob = torch.load(path, map_location="cpu", weights_only=False)
    epoch, best = 0, None
    if isinstance(blob, dict) and "state_dict" in blob:
        epoch = int(blob.get("epoch", 0))
        if blob.get("best_metric") is not None:
            best = float(blob["best_metric"])
        blob = blob["state_dict"]
    if hasattr(blob, "state_dict"):  # a whole nn.Module
        blob = blob.state_dict()
    state: Dict[str, "torch.Tensor"] = {}
    for k, v in blob.items():
        if isinstance(v, torch.Tensor):
            state[k[len("module."):] if k.startswith("module.") else k] = v.detach().float()
    return state, epoch, best


def main(argv=None) -> str:
    args = parse_args(argv)

    import torch

    from denseclip_vit_multimodal_tpu_torch.core.config import load_config, resolve_config_path
    from denseclip_vit_multimodal_tpu_torch.models.denseclip import build_denseclip
    from denseclip_vit_multimodal_tpu_torch.train.checkpoint import save_checkpoint
    from denseclip_vit_multimodal_tpu_torch.train.clip_import import import_reference_denseclip
    from denseclip_vit_multimodal_tpu_torch.train.loop import class_names_for
    from denseclip_vit_multimodal_tpu_torch.train.state import create_train_state

    cfg = load_config(resolve_config_path(args.config), overrides=args.overrides)
    tpu_cfg = cfg.get("tpu", {}) or {}
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        str(tpu_cfg.get("compute_dtype", "bfloat16"))]
    model, _ = build_denseclip(cfg.model, class_names_for(cfg.get("data", {}) or {}), dtype=dtype, device=args.device)

    state_dict, epoch, best = load_reference_state_dict(args.torch_ckpt)
    print(f"read {len(state_dict)} tensors from {args.torch_ckpt} (epoch {epoch})")
    written = import_reference_denseclip(state_dict, model)
    train_state = create_train_state(model, cfg.get("training", {}) or {}, steps_per_epoch=1)
    path = save_checkpoint(args.out, train_state, epoch=epoch, best_metric=best,
                           is_best=best is not None)
    print(f"wrote {path} ({written} tensors imported; aliases: latest"
          + (", best)" if best is not None else ")"))
    return path


if __name__ == "__main__":
    main()
