"""PyTorch model zoo of the port: ViT backbone, text tower, neck, heads, composite."""

from denseclip_vit_multimodal_tpu_torch.models.denseclip import (
    CITYSCAPES_CLASSES,
    DenseCLIP,
    build_denseclip,
)
from denseclip_vit_multimodal_tpu_torch.models.heads import FCNHead
from denseclip_vit_multimodal_tpu_torch.models.necks import ViTFeatureFusionNeck
from denseclip_vit_multimodal_tpu_torch.models.text import CLIPTextContextEncoder
from denseclip_vit_multimodal_tpu_torch.models.vit import CLIPVisionTransformer
