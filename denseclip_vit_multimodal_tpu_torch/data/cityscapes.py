"""Cityscapes datasets: seg-only and joint seg + depth (the port's copy of the
JAX package's `data/cityscapes.py`).

The host scans the tree, decodes the PNGs, remaps labelIds to trainIds and
turns disparity into depth; every augmentation runs on the device
(`data/augment.py`).  Decoding goes through `utils/png.py`, not Pillow, so
the readers run where Pillow is not installed: the image as RGB
(`decode_png`, Pillow's `convert("RGB")`), the labels and the 16-bit
disparity as the file stores them (`decode_png_array`, `np.asarray` of
`Image.open`).

Semantics, as in the JAX package and the reference:
  * layout and triplet scan: `leftImg8bit/{split}/{city}/*_leftImg8bit.png`
    with `gtFine/.../*_gtFine_labelIds.png` and `disparity/.../*_disparity.png`;
    an image without its label (or, for seg + depth, its disparity) is skipped;
  * the 34 -> 19 trainId table, ids past it -> ignore 255;
  * disparity d (uint16) -> depth: scaled = (d - 1) / 256 where d > 0; depth =
    500 / (scaled + 1e-6) where scaled > 1e-3; kept where d > 0 and depth <=
    depth_max, else 0;
  * a sample that fails to decode is None (the loader resamples).
The remap and the disparity conversion take the native host ops
(`data/_native.py`) where the library builds, numpy otherwise; both give the
same bits.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import List, Tuple

import numpy as np

from denseclip_vit_multimodal_tpu_torch.data import _native
from denseclip_vit_multimodal_tpu_torch.utils.png import decode_png, decode_png_array

CLASSES: Tuple[str, ...] = (
    "road", "sidewalk", "building", "wall", "fence", "pole",
    "traffic light", "traffic sign", "vegetation", "terrain", "sky",
    "person", "rider", "car", "truck", "bus", "train",
    "motorcycle", "bicycle",
)
NUM_CLASSES = len(CLASSES)
IGNORE_INDEX = 255

# labelId (0..33) -> trainId (0..18) or 255.
ID_TO_TRAIN_ID = np.full(34, IGNORE_INDEX, dtype=np.uint8)
for _label_id, _train_id in {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8, 22: 9,
    23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16, 32: 17, 33: 18,
}.items():
    ID_TO_TRAIN_ID[_label_id] = _train_id

# trainId -> labelId, for predictions in the Cityscapes submission format;
# ignore / unknown trainIds -> labelId 0 ("unlabeled").
TRAIN_ID_TO_LABEL_ID = np.zeros(256, dtype=np.uint8)
for _label_id in range(len(ID_TO_TRAIN_ID)):
    if ID_TO_TRAIN_ID[_label_id] != IGNORE_INDEX:
        TRAIN_ID_TO_LABEL_ID[ID_TO_TRAIN_ID[_label_id]] = _label_id

BASELINE_FOCAL_LENGTH = 500.0
DEPTH_IGNORE_VALUE = 0.0
DISPARITY_SCALE = 256.0
DISPARITY_OFFSET = 1.0
MIN_DISPARITY_SCALED = 1e-3


def labelids_from_trainids(train_ids: np.ndarray) -> np.ndarray:
    """trainId -> labelId (submission format); uint8 out."""
    return TRAIN_ID_TO_LABEL_ID[np.asarray(train_ids, dtype=np.uint8)]


def remap_labels(label_ids: np.ndarray) -> np.ndarray:
    """labelId -> trainId; ids past the table -> ignore."""
    if label_ids.dtype == np.uint8:
        native = _native.remap_labels(label_ids, ID_TO_TRAIN_ID, IGNORE_INDEX)
        if native is not None:
            return native
    return remap_labels_numpy(label_ids)


def remap_labels_numpy(label_ids: np.ndarray) -> np.ndarray:
    """`remap_labels` without the native library."""
    out = np.full(label_ids.shape, IGNORE_INDEX, dtype=np.uint8)
    in_range = label_ids < len(ID_TO_TRAIN_ID)
    out[in_range] = ID_TO_TRAIN_ID[label_ids[in_range]]
    return out


def disparity_to_depth(disparity: np.ndarray, depth_max: float = 80.0,
                       bf: float = BASELINE_FOCAL_LENGTH) -> Tuple[np.ndarray, np.ndarray]:
    """uint16 disparity -> (float32 depth, uint8 validity = depth > 0)."""
    if disparity.dtype == np.uint16:
        native = _native.disparity_to_depth(
            disparity, depth_max, bf, scale=DISPARITY_SCALE, offset=DISPARITY_OFFSET,
            min_scaled=MIN_DISPARITY_SCALED, ignore_value=DEPTH_IGNORE_VALUE)
        if native is not None:
            depth, _ = native
            return depth, (depth > 0).astype(np.uint8)
    return disparity_to_depth_numpy(disparity, depth_max, bf)


def disparity_to_depth_numpy(disparity: np.ndarray, depth_max: float = 80.0,
                             bf: float = BASELINE_FOCAL_LENGTH) -> Tuple[np.ndarray, np.ndarray]:
    """`disparity_to_depth` without the native library."""
    disp = disparity.astype(np.float32)
    raw_valid = disp > 0
    scaled = np.where(raw_valid, (disp - DISPARITY_OFFSET) / DISPARITY_SCALE, 0.0)
    usable = scaled > MIN_DISPARITY_SCALED
    depth = np.where(usable, bf / (scaled + 1e-6), DEPTH_IGNORE_VALUE).astype(np.float32)
    in_range = raw_valid & usable & (depth <= depth_max)
    depth = np.where(in_range, depth, DEPTH_IGNORE_VALUE).astype(np.float32)
    # validity == positive depth (the reference recomputes its mask as depth > 0)
    return depth, (depth > 0.0).astype(np.uint8)


def _scan_pairs(root: str, split: str, with_disparity: bool) -> List[Tuple[str, ...]]:
    images_base = osp.join(root, "leftImg8bit", split)
    labels_base = osp.join(root, "gtFine", split)
    disparity_base = osp.join(root, "disparity", split)
    if not osp.isdir(images_base):
        raise RuntimeError(f"Image directory not found: {images_base}")
    if not osp.isdir(labels_base):
        raise RuntimeError(f"Label directory not found: {labels_base}")
    if with_disparity and not osp.isdir(disparity_base):
        raise RuntimeError(f"Disparity directory not found: {disparity_base}")

    samples: List[Tuple[str, ...]] = []
    for city in sorted(os.listdir(images_base)):
        img_dir = osp.join(images_base, city)
        label_dir = osp.join(labels_base, city)
        disp_dir = osp.join(disparity_base, city)
        if not osp.isdir(img_dir) or not osp.isdir(label_dir):
            continue
        if with_disparity and not osp.isdir(disp_dir):
            continue
        for filename in sorted(os.listdir(img_dir)):
            if not filename.endswith("_leftImg8bit.png"):
                continue
            base = filename[: -len("_leftImg8bit.png")]
            label_path = osp.join(label_dir, f"{base}_gtFine_labelIds.png")
            if not osp.exists(label_path):
                continue
            triplet = (osp.join(img_dir, filename), label_path)
            if with_disparity:
                disp_path = osp.join(disp_dir, f"{base}_disparity.png")
                if not osp.exists(disp_path):
                    continue
                triplet += (disp_path,)
            samples.append(triplet)
    if not samples:
        raise RuntimeError(f"No samples found under {root} split={split}")
    return samples


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def read_image(path: str) -> np.ndarray:
    """uint8 RGB [H, W, 3]."""
    return decode_png(_read(path))


def read_label_ids(path: str) -> np.ndarray:
    """uint8 labelIds [H, W], as stored."""
    return np.asarray(decode_png_array(_read(path)), dtype=np.uint8)


def read_disparity(path: str) -> np.ndarray:
    """uint16 disparity [H, W], as stored."""
    return decode_png_array(_read(path))


class CityscapesDataset:
    """Seg-only Cityscapes: uint8 image [H, W, 3] + uint8 trainIds [H, W] at
    full resolution; None for a sample that fails to decode."""

    CLASSES = CLASSES
    IGNORE_INDEX = IGNORE_INDEX

    def __init__(self, root: str, split: str = "train", remap: bool = True):
        self.root = root
        self.split = split
        self.remap = remap
        self.samples = _scan_pairs(root, split, with_disparity=False)

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int):
        img_path, label_path = self.samples[idx]
        try:
            img = read_image(img_path)
            label = read_label_ids(label_path)
        except (OSError, ValueError):
            return None
        return {"image": img, "seg": remap_labels(label) if self.remap else label}


class CityscapesDepthSegDataset:
    """Joint seg + depth Cityscapes: image, trainIds and float32 depth [H, W]
    (0 where invalid; the mask is depth > 0, taken on the device)."""

    CLASSES = CLASSES
    IGNORE_INDEX = IGNORE_INDEX

    def __init__(self, root: str, split: str = "train", remap: bool = True,
                 depth_max: float = 80.0):
        self.root = root
        self.split = split
        self.remap = remap
        self.depth_max = depth_max
        self.samples = _scan_pairs(root, split, with_disparity=True)

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int):
        img_path, label_path, disp_path = self.samples[idx]
        try:
            img = read_image(img_path)
            label = read_label_ids(label_path)
            disparity = read_disparity(disp_path)
        except (OSError, ValueError):
            return None
        if self.remap:
            label = remap_labels(label)
        depth, _ = disparity_to_depth(disparity, self.depth_max)
        return {"image": img, "seg": label, "depth": depth}
