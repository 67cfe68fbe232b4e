"""ADE20K semantic segmentation dataset (the port's copy of the JAX package's
`data/ade20k.py`), without Pillow.

The same contract as the JAX module:

  * layout ``{root}/ADEChallengeData2016/images/{training,validation}`` with
    the label PNGs under ``annotations/`` (split aliases ``train`` / ``val``);
    sorted ``.jpg`` files, and an image without a label is skipped;
  * labels 0 (background) -> ignore 255, 1..150 -> 0..149; 150 classes;
  * every sample is resized to a fixed canvas (default 512x683) so batches
    stack: the image with Pillow's BILINEAR, the label with NEAREST.

The pixels are Pillow's, bit for bit, computed by the port's own C++
(`utils/imageio.py`: a baseline JPEG decoder with libjpeg-turbo's numerics
and Pillow's two resize filters) and the label through `utils/png.py`.  A file
that fails to decode gives None, as in the JAX package (the loader resamples
it), with one warning a file naming the decoder's reason: a progressive JPEG
is then visible, not silently lost.  The library is built in `__init__`, so a
missing compiler is a set-up error.
"""

from __future__ import annotations

import logging
import os
import os.path as osp
import threading
from typing import List, Tuple

import numpy as np

from denseclip_vit_multimodal_tpu_torch.utils import imageio
from denseclip_vit_multimodal_tpu_torch.utils.png import decode_png_array

NUM_CLASSES = 150
IGNORE_INDEX = 255

ADE20K_CLASSES: Tuple[str, ...] = (
    "wall", "building", "sky", "floor", "tree", "ceiling", "road", "bed",
    "windowpane", "grass", "cabinet", "sidewalk", "person", "earth", "door",
    "table", "mountain", "plant", "curtain", "chair", "car", "water",
    "painting", "sofa", "shelf", "house", "sea", "mirror", "rug", "field",
    "armchair", "seat", "fence", "desk", "rock", "wardrobe", "lamp",
    "bathtub", "railing", "cushion", "base", "box", "column", "signboard",
    "chest of drawers", "counter", "sand", "sink", "skyscraper", "fireplace",
    "refrigerator", "grandstand", "path", "stairs", "runway", "case",
    "pool table", "pillow", "screen door", "stairway", "river", "bridge",
    "bookcase", "blind", "coffee table", "toilet", "flower", "book", "hill",
    "bench", "countertop", "stove", "palm", "kitchen island", "computer",
    "swivel chair", "boat", "bar", "arcade machine", "hovel", "bus", "towel",
    "light", "truck", "tower", "chandelier", "awning", "streetlight",
    "booth", "television receiver", "airplane", "dirt track", "apparel",
    "pole", "land", "bannister", "escalator", "ottoman", "bottle", "buffet",
    "poster", "stage", "van", "ship", "fountain", "conveyer belt", "canopy",
    "washer", "plaything", "swimming pool", "stool", "barrel", "basket",
    "waterfall", "tent", "bag", "minibike", "cradle", "oven", "ball", "food",
    "step", "tank", "trade name", "microwave", "pot", "animal", "bicycle",
    "lake", "dishwasher", "screen", "blanket", "sculpture", "hood", "sconce",
    "vase", "traffic light", "tray", "ashcan", "fan", "pier", "crt screen",
    "plate", "monitor", "bulletin board", "shower", "radiator", "glass",
    "clock", "flag",
)

assert len(ADE20K_CLASSES) == NUM_CLASSES

logger = logging.getLogger(__name__)


def remap_labels(labels: np.ndarray, ignore_index: int = IGNORE_INDEX) -> np.ndarray:
    """0 -> ignore; 1..150 -> 0..149."""
    out = labels.astype(np.int16) - 1
    out[labels == 0] = ignore_index
    return out.astype(np.uint8) if ignore_index < 256 else out


class ADE20KSegmentation:
    """ADE20K dataset returning fixed-canvas uint8 image + remapped mask."""

    CLASSES = ADE20K_CLASSES
    IGNORE_INDEX = IGNORE_INDEX

    def __init__(self, root: str, split: str = "training",
                 canvas_size: Tuple[int, int] = (512, 683), ignore_index: int = IGNORE_INDEX):
        if split in ("train", "training"):
            split = "training"
        elif split in ("val", "validation"):
            split = "validation"
        else:
            raise ValueError(f"Unknown ADE20K split: {split}")
        base = osp.join(root, "ADEChallengeData2016")
        self.image_dir = osp.join(base, "images", split)
        self.label_dir = osp.join(base, "annotations", split)
        if not osp.isdir(self.image_dir):
            raise RuntimeError(f"Image directory not found: {self.image_dir}")
        if not osp.isdir(self.label_dir):
            raise RuntimeError(f"Label directory not found: {self.label_dir}")
        self.canvas_size = tuple(canvas_size)
        self.ignore_index = ignore_index

        self.samples: List[Tuple[str, str]] = []
        for filename in sorted(os.listdir(self.image_dir)):
            if not filename.endswith(".jpg"):
                continue
            label_path = osp.join(self.label_dir, filename.replace(".jpg", ".png"))
            if osp.exists(label_path):
                self.samples.append((osp.join(self.image_dir, filename), label_path))
        if not self.samples:
            raise RuntimeError(f"No samples found under {self.image_dir}")
        imageio.library()  # build now: a missing compiler is a set-up error
        self._warned = set()
        self._warn_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int):
        img_path, label_path = self.samples[idx]
        ch, cw = self.canvas_size
        try:
            with open(img_path, "rb") as f:
                img = imageio.resize_bilinear_u8(imageio.decode_jpeg(f.read()), (cw, ch))
            with open(label_path, "rb") as f:
                label = imageio.resize_nearest(decode_png_array(f.read()), (cw, ch))
        except (OSError, ValueError) as e:
            with self._warn_lock:
                first = img_path not in self._warned
                self._warned.add(img_path)
            if first:
                logger.warning("skipping ADE20K sample %s: %s", img_path, e)
            return None
        return {"image": img, "seg": remap_labels(label, self.ignore_index)}
