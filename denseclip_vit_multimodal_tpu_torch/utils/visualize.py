"""Colour panels of predictions, with numpy alone.

The port's own copy of the two colourisers of the JAX package's
`utils/visualize.py` that the HTTP server uses (the matplotlib figure grids
there are not ported).  `colorize_depth` reads a committed 256-entry copy of
matplotlib's magma table and indexes it as matplotlib does, so serving needs
no matplotlib; `tests/test_torch_serve.py` holds both functions equal to the
JAX package's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# Standard Cityscapes train-id palette (19 classes).
CITYSCAPES_PALETTE = np.array(
    [
        [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
        [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
        [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
        [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
        [0, 0, 230], [119, 11, 32],
    ],
    dtype=np.uint8,
)

# matplotlib's "magma" colormap, its 256 entries times 255 truncated to uint8
# (what `(cmap(x)[..., :3] * 255).astype(np.uint8)` yields), RGB row by row.
MAGMA = np.frombuffer(bytes.fromhex(
    "00000300000400000601000701010901010b02020d02020f030311040313040415050417"
    "06051907051b08061d09071f0a07220b08240c09260d0a280e0a2a0f0b2c100c2f110c31"
    "120d33140d35150e38160e3a170f3c180f3f1a10411b10441c10461e10491f114b20114d"
    "2211502311522511552611572811592a115c2b115e2d10602f1062301065321067341068"
    "350f6a370f6c390f6e3b0f6f3c0f713e0f72400f73420f74430f75450f76470f77481078"
    "4a10794b10794d117a4f117b50127b52127c53137c55137d57147d58157e5a157e5b167e"
    "5d177e5e177f60187f61187f63197f651a80661a80681b80691c806b1c806c1d806e1e81"
    "6f1e81711f81731f817420817621817721817922817a22817c23817e24817f2481812581"
    "8225818426818526818727818928818a28818c29808d29808f2a80912a80922b80942b80"
    "952c80972c7f992d7f9a2d7f9c2e7f9e2e7e9f2f7ea12f7ea3307ea4307da6317da7317d"
    "a9327cab337cac337bae347bb0347bb1357ab3357ab53679b63679b83778b93778bb3877"
    "bd3977be3976c03a75c23a75c33b74c53c74c63c73c83d72ca3e72cb3e71cd3f70ce4070"
    "d0416fd1426ed3426dd4436dd6446cd7456bd9466ada4769dc4869dd4968de4a67e04b66"
    "e14c66e24d65e44e64e55063e65162e75262e85461ea5560eb5660ec585fed595fee5b5e"
    "ee5d5def5e5df0605df1615cf2635cf3655cf3675bf4685bf56a5bf56c5bf66e5bf6705b"
    "f7715bf7735cf8755cf8775cf9795cf97b5df97d5dfa7f5efa805efa825ffb8460fb8660"
    "fb8861fb8a62fc8c63fc8e63fc9064fc9265fc9366fd9567fd9768fd9969fd9b6afd9d6b"
    "fd9f6cfda16efda26ffda470fea671fea873feaa74feac75feae76feaf78feb179feb37b"
    "feb57cfeb77dfeb97ffebb80febc82febe83fec085fec286fec488fec689fec78bfec98d"
    "fecb8efdcd90fdcf92fdd193fdd295fdd497fdd698fdd89afdda9cfddc9dfddd9ffddfa1"
    "fde1a3fce3a5fce5a6fce6a8fce8aafceaacfcecaefceeb0fcf0b1fcf1b3fcf3b5fcf5b7"
    "fbf7b9fbf9bbfbfabdfbfcbf"
), dtype=np.uint8).reshape(256, 3)


def colorize_seg(
    seg: np.ndarray,
    palette: Optional[np.ndarray] = None,
    ignore_index: int = 255,
) -> np.ndarray:
    """[H, W] int labels -> [H, W, 3] uint8 (ignore and out-of-range -> black)."""
    palette = CITYSCAPES_PALETTE if palette is None else palette
    out = np.zeros(seg.shape + (3,), np.uint8)
    valid = (seg != ignore_index) & (seg < len(palette)) & (seg >= 0)
    out[valid] = palette[seg[valid]]
    return out


def colorize_depth(depth: np.ndarray, max_depth: float = 80.0) -> np.ndarray:
    """[H, W] metric depth -> [H, W, 3] uint8 through the magma table.

    Entry min(floor(clip(depth / max_depth, 0, 1) * 256), 255), computed in
    the input's dtype as matplotlib does; black where depth <= 0 or NaN.
    """
    norm = np.clip(depth / max_depth, 0.0, 1.0)
    x = norm * MAGMA.shape[0]
    bad = np.isnan(x)
    idx = np.minimum(np.where(bad, 0, x), MAGMA.shape[0] - 1).astype(np.int64)
    rgb = MAGMA[idx]
    rgb[(depth <= 0) | bad] = 0
    return rgb
