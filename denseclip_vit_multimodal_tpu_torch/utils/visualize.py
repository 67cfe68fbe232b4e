"""Colour panels of predictions, with numpy alone.

The port's own copy of the JAX package's `utils/visualize.py`, which draws
with matplotlib; the card has none, so here:

* `colorize_seg`, `colorize_depth` and `colorize_scaled` read committed
  256-entry uint8 copies of matplotlib's tables (`MAGMA`, `JET`) and index
  them as matplotlib does, so their arrays are the JAX package's bit for bit;
* `save_comparison_panel` and `save_multi_task_panel` lay the JAX panels,
  in JAX's order and grid, out as tiles in one PNG (`utils/png.py`), each
  tile the colouriser's array at full size.  No text is drawn (there is no
  font renderer): the titles go into tEXt chunks.  `read_panels` cuts the
  tiles back out.

Panel layout.  Tile i of n sits in row i // cols, column i % cols of a grid
of cells of the largest tile's height x width (cell_h x cell_w), at its
cell's top-left corner: y = GUTTER + row * (cell_h + GUTTER), x = GUTTER +
col * (cell_w + GUTTER).  The image is GUTTER + rows * (cell_h + GUTTER)
high and GUTTER + cols * (cell_w + GUTTER) wide, white (255) outside the
tiles.  Its tEXt chunks, in this order: "Title" (the figure's suptitle,
only where it has one), "Layout" ("gutter G grid ROWSxCOLS cell HxW"), then
per tile "Panel i" (its title, as the JAX figure names it) and
"Panel i size" ("HxW").
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from denseclip_vit_multimodal_tpu_torch.utils.png import decode_png, encode_png, read_text

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


# matplotlib's "jet" colormap, made and truncated as MAGMA is, RGB row by row.
JET = np.frombuffer(bytes.fromhex(
    "00007f00008400008800008d00009100009600009a00009f0000a30000a80000ac0000b1"
    "0000b60000ba0000bf0000c30000c80000cc0000d10000d50000da0000de0000e30000e8"
    "0000ec0000f10000f50000fa0000fe0000ff0000ff0000ff0000ff0004ff0008ff000cff"
    "0010ff0014ff0018ff001cff0020ff0024ff0028ff002cff0030ff0034ff0038ff003cff"
    "0040ff0044ff0048ff004cff0050ff0054ff0058ff005cff0060ff0064ff0068ff006cff"
    "0070ff0074ff0078ff007cff0080ff0084ff0088ff008cff0090ff0094ff0098ff009cff"
    "00a0ff00a4ff00a8ff00acff00b0ff00b4ff00b8ff00bcff00c0ff00c4ff00c8ff00ccff"
    "00d0ff00d4ff00d8ff00dcfe00e0fa00e4f702e8f405ecf108f0ed0cf4ea0ff8e712fce4"
    "15ffe118ffdd1cffda1fffd722ffd425ffd029ffcd2cffca2fffc732ffc336ffc039ffbd"
    "3cffba3fffb742ffb346ffb049ffad4cffaa4fffa653ffa356ffa059ff9d5cff9a5fff96"
    "63ff9366ff9069ff8d6cff8970ff8673ff8376ff8079ff7d7cff7980ff7683ff7386ff70"
    "89ff6c8dff6990ff6693ff6396ff5f9aff5c9dff59a0ff56a3ff53a6ff4faaff4cadff49"
    "b0ff46b3ff42b7ff3fbaff3cbdff39c0ff36c3ff32c7ff2fcaff2ccdff29d0ff25d4ff22"
    "d7ff1fdaff1cddff18e0ff15e4ff12e7ff0feaff0cedff08f1fc05f4f802f7f400faf000"
    "feed00ffe900ffe500ffe200ffde00ffda00ffd700ffd300ffcf00ffcb00ffc800ffc400"
    "ffc000ffbd00ffb900ffb500ffb100ffae00ffaa00ffa600ffa300ff9f00ff9b00ff9800"
    "ff9400ff9000ff8c00ff8900ff8500ff8100ff7e00ff7a00ff7600ff7300ff6f00ff6b00"
    "ff6700ff6400ff6000ff5c00ff5900ff5500ff5100ff4d00ff4a00ff4600ff4200ff3f00"
    "ff3b00ff3700ff3400ff3000ff2c00ff2800ff2500ff2100ff1d00ff1a00ff1600fe1200"
    "fa0f00f50b00f10700ec0300e80000e30000de0000da0000d50000d10000cc0000c80000"
    "c30000bf0000ba0000b60000b10000ac0000a80000a300009f00009a0000960000910000"
    "8d00008800008400007f0000"
), dtype=np.uint8).reshape(256, 3)

CMAPS = {"jet": JET, "magma": MAGMA}
GUTTER = 8  # pixels around and between the tiles of a panel
MEAN = (0.48145466, 0.4578275, 0.40821073)  # CLIP's
STD = (0.26862954, 0.26130258, 0.27577711)


def denormalize_image(image: np.ndarray, mean: Sequence[float] = MEAN,
                      std: Sequence[float] = STD) -> np.ndarray:
    """[H, W, 3] normalized float -> uint8 RGB."""
    img = image * np.asarray(std) + np.asarray(mean)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


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


def colorize_scaled(arr: np.ndarray, cmap: str = "jet") -> np.ndarray:
    """Max-scale a 2-D array to [0, 1] (in float64, by max + 1e-6) and look
    it up in `cmap`'s table as matplotlib does: entry floor(x * 256), x = 1
    taken as entry 255; NaN (0 / 0 where the max is -1e-6) is black."""
    if cmap not in CMAPS:
        raise ValueError(f"unknown colormap {cmap!r} (have {sorted(CMAPS)})")
    table = CMAPS[cmap]
    arr = np.asarray(arr, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        x = np.clip(arr / (arr.max() + 1e-6), 0.0, 1.0) * table.shape[0]
    x[x == table.shape[0]] = table.shape[0] - 1
    bad = np.isnan(x)
    rgb = table[np.where(bad, 0, x).astype(np.int64)]
    rgb[bad] = 0
    return rgb


def _save_tiles(path: str, tiles: List[Tuple[str, np.ndarray]], cols: int,
                title: str = "") -> str:
    """Lay `tiles` (name, uint8 [h, w, 3]) out as the module note says and write the PNG."""
    rows = math.ceil(len(tiles) / cols)
    cell_h = max(t.shape[0] for _, t in tiles)
    cell_w = max(t.shape[1] for _, t in tiles)
    canvas = np.full((GUTTER + rows * (cell_h + GUTTER), GUTTER + cols * (cell_w + GUTTER), 3),
                     255, np.uint8)
    text = [("Title", title)] if title else []
    text.append(("Layout", f"gutter {GUTTER} grid {rows}x{cols} cell {cell_h}x{cell_w}"))
    for i, (name, tile) in enumerate(tiles):
        y = GUTTER + (i // cols) * (cell_h + GUTTER)
        x = GUTTER + (i % cols) * (cell_w + GUTTER)
        canvas[y:y + tile.shape[0], x:x + tile.shape[1]] = tile
        text += [(f"Panel {i}", name), (f"Panel {i} size", f"{tile.shape[0]}x{tile.shape[1]}")]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(canvas, text=text))
    return path


def read_panels(data: bytes) -> Tuple[str, List[Tuple[str, np.ndarray]]]:
    """(title, [(name, tile)]) of a panel PNG written by this module."""
    text = read_text(data)
    fields = text["Layout"].split()  # gutter G grid RxC cell HxW
    gutter, cols = int(fields[1]), int(fields[3].split("x")[1])
    cell_h, cell_w = (int(v) for v in fields[5].split("x"))
    canvas = decode_png(data)
    tiles = []
    for i in range(sum(k.startswith("Panel ") and not k.endswith(" size") for k in text)):
        h, w = (int(v) for v in text[f"Panel {i} size"].split("x"))
        y = gutter + (i // cols) * (cell_h + gutter)
        x = gutter + (i % cols) * (cell_w + gutter)
        tiles.append((text[f"Panel {i}"], canvas[y:y + h, x:x + w]))
    return text.get("Title", ""), tiles


def save_comparison_panel(
    path: str,
    image: np.ndarray,  # normalized [H, W, 3] or uint8
    pred: np.ndarray,  # [H, W] raw values (labels or depth)
    target: np.ndarray,  # [H, W] raw values
    epoch: Optional[int] = None,
    cmap: str = "jet",
    mean: Sequence[float] = MEAN,
    std: Sequence[float] = STD,
) -> str:
    """Input / prediction / ground truth side by side (1 x 3), pred and
    target max-scaled through `cmap`; titled "Validation Epoch N - Best
    Accuracy Image" where `epoch` is given.  Returns the path."""
    if image.dtype != np.uint8:
        image = denormalize_image(image, mean, std)
    tiles = [("Input Image", image), ("Prediction", colorize_scaled(pred, cmap)),
             ("Ground Truth", colorize_scaled(target, cmap))]
    title = f"Validation Epoch {epoch} - Best Accuracy Image" if epoch is not None else ""
    return _save_tiles(path, tiles, 3, title)


def save_multi_task_panel(
    path: str,
    image: np.ndarray,  # normalized [H, W, 3] or uint8
    seg_pred: np.ndarray,
    seg_gt: Optional[np.ndarray] = None,
    depth_pred: Optional[np.ndarray] = None,
    depth_gt: Optional[np.ndarray] = None,
    palette: Optional[np.ndarray] = None,
    max_depth: float = 80.0,
    title: str = "",
) -> str:
    """input, seg pred, then seg gt, depth pred, depth gt where given, on a
    grid of min(3, n) columns; returns the path."""
    if image.dtype != np.uint8:
        image = denormalize_image(image)
    tiles = [("input", image), ("seg pred", colorize_seg(seg_pred, palette))]
    if seg_gt is not None:
        tiles.append(("seg gt", colorize_seg(seg_gt, palette)))
    if depth_pred is not None:
        tiles.append(("depth pred", colorize_depth(depth_pred, max_depth)))
    if depth_gt is not None:
        tiles.append(("depth gt", colorize_depth(depth_gt, max_depth)))
    return _save_tiles(path, tiles, min(3, len(tiles)), title)
