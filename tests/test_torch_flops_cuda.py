"""The FLOP make-up of every forward kernel the port launches (marker `cuda`;
skips without a card).  No JAX here: on a machine with a card run

    python -m pytest --noconftest -q -m cuda tests/test_torch_flops_cuda.py
"""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from denseclip_vit_multimodal_tpu_torch.ops import attention, lnqkv_kernel, mha_kernel
from denseclip_vit_multimodal_tpu_torch.tools import exp_outproj_epilogue
from denseclip_vit_multimodal_tpu_torch.utils import flops

pytestmark = pytest.mark.cuda
B, N, HEADS, D, VALID = 2, 1100, 2, 64, 1050
HD = HEADS * D


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _operands(kernel, device):
    """(kernel call, plain-version call) on the same bf16 inputs."""
    gen = torch.Generator(device=device).manual_seed(0)
    bf = lambda *shape: torch.randn(*shape, generator=gen, device=device).to(torch.bfloat16)
    if kernel in ("K1", "K5", "K7"):
        qkv = bf(B, N, 3 * HD)
        if kernel == "K7":
            w = bf(HD, HD) * 0.05
            return ((lambda: exp_outproj_epilogue.qkv_out_attention(qkv, w, HEADS,
                                                                    valid_len=VALID)),
                    lambda: exp_outproj_epilogue.qkv_out_attention_reference(
                        qkv, w, HEADS, valid_len=VALID))
        fn, ref = ((mha_kernel.mha_qkv_attention, mha_kernel.mha_qkv_attention_reference)
                   if kernel == "K1" else (mha_kernel.mha_qkv_attention_int8,
                                           mha_kernel.mha_qkv_attention_int8_reference))
        return (lambda: fn(qkv, HEADS, valid_len=VALID)), (lambda: ref(qkv, HEADS,
                                                                       valid_len=VALID))
    if kernel in ("K3", "K4"):
        q, k, v = (bf(B, N, HEADS, D) for _ in range(3))
        if kernel == "K3":
            return ((lambda: mha_kernel.mha_attention(q, k, v, valid_len=VALID)),
                    lambda: mha_kernel.mha_attention_reference(q, k, v, valid_len=VALID))
        return ((lambda: attention.flash_attention(q, k, v, causal=True, valid_len=VALID)),
                lambda: attention.flash_attention_reference(q, k, v, causal=True,
                                                            valid_len=VALID))
    args = (bf(B, N, HD), bf(HD), bf(HD), bf(HD, 3 * HD) * 0.05, bf(3 * HD), HEADS)
    if kernel == "K6":
        return ((lambda: lnqkv_kernel.ln_qkv_attention(*args, valid_len=VALID)),
                lambda: lnqkv_kernel.ln_qkv_attention_reference(*args, valid_len=VALID))
    return ((lambda: lnqkv_kernel.ln_qkv_projection(*args)),
            lambda: lnqkv_kernel.ln_qkv_projection_reference(*args))


@pytest.mark.parametrize("kernel", ["K1", "K3", "K4", "K5", "K6", "K6 projection", "K7"])
def test_launched_kernel_make_up_equals_its_plain_version_count(cuda, kernel):
    """Each wrapper launches its kernel, which FlopCounterMode counts as 0;
    the tally adds what FlopCounterMode counts of the plain version on the
    same inputs."""
    call, plain = _operands(kernel, cuda)
    with FlopCounterMode(display=False) as counter:
        plain()
    got = flops.program_flops(call)
    assert got.aten == 0 and got.kernels == counter.get_total_flops() > 0
