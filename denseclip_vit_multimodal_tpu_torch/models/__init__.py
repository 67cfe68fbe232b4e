"""PyTorch model zoo of the port: ViT and ResNet backbones, text towers, context
decoder, necks, heads, composite."""

from denseclip_vit_multimodal_tpu_torch.models.context_decoder import ContextDecoder
from denseclip_vit_multimodal_tpu_torch.models.denseclip import (
    CITYSCAPES_CLASSES,
    DenseCLIP,
    build_denseclip,
)
from denseclip_vit_multimodal_tpu_torch.models.heads import FCNHead, IdentityHead
from denseclip_vit_multimodal_tpu_torch.models.necks import FPN, ViTFeatureFusionNeck
from denseclip_vit_multimodal_tpu_torch.models.resnet import CLIPResNet, CLIPResNetWithAttention
from denseclip_vit_multimodal_tpu_torch.models.text import CLIPTextContextEncoder, CLIPTextEncoder
from denseclip_vit_multimodal_tpu_torch.models.vit import CLIPVisionTransformer
