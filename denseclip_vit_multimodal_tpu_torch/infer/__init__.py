"""Inference engines of the port: whole-image and batched slide-window."""

from denseclip_vit_multimodal_tpu_torch.infer.engine import Inferencer, package_outputs
from denseclip_vit_multimodal_tpu_torch.infer.slide import (
    count_map,
    slide_grid,
    slide_inference,
    window_origins,
)
