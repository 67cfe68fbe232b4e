"""Ops of the port: the Hopper attention kernels (qkv K1 / K2, flash K4) and the score map."""

from denseclip_vit_multimodal_tpu_torch.ops.attention import (
    flash_attention,
    flash_attention_reference,
    flash_supported,
)
from denseclip_vit_multimodal_tpu_torch.ops.mha_kernel import (
    LAUNCHES,
    mha_qkv_attention,
    mha_qkv_attention_reference,
)
from denseclip_vit_multimodal_tpu_torch.ops.score_map import l2_normalize, score_map
