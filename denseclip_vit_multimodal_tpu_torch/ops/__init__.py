"""Ops of the port: the Hopper qkv attention kernel and the score map."""

from denseclip_vit_multimodal_tpu_torch.ops.mha_kernel import (
    LAUNCHES,
    mha_qkv_attention,
    mha_qkv_attention_reference,
)
from denseclip_vit_multimodal_tpu_torch.ops.score_map import l2_normalize, score_map
