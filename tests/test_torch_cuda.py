"""Tests of the port that need an NVIDIA GPU (marker `cuda`; they skip without one).

Run them on a machine with a card, where JAX is not installed, without the
JAX-only conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from denseclip_vit_multimodal_tpu_torch.models.layers import MultiHeadAttention
from denseclip_vit_multimodal_tpu_torch.ops import mha_kernel

pytestmark = pytest.mark.cuda

# bf16 kernel vs bf16 plain version on unit-normal inputs: the output is
# rounded to bf16 (ulp 2^-8 near 1) and P is rounded at another running max.
KERNEL_TOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, n, heads, d, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(b, n, 3 * heads * d, generator=gen, device="cuda").to(torch.bfloat16)


@pytest.mark.parametrize("b,n,heads,d,valid_len", [
    (2, 300, 12, 64, 290),
    (1, 1536, 12, 64, 1522),
    (3, 65, 2, 64, None),
    (1, 1100, 8, 128, 1025),
    (2, 7, 1, 128, None),
])
def test_kernel_matches_plain_version(cuda, b, n, heads, d, valid_len):
    qkv = _qkv(b, n, heads, d)
    before = mha_kernel.LAUNCHES["qkv_attention"]
    out = mha_kernel.mha_qkv_attention(qkv, heads, valid_len=valid_len)
    ref = mha_kernel.mha_qkv_attention_reference(qkv, heads, valid_len=valid_len)
    torch.cuda.synchronize()
    assert mha_kernel.LAUNCHES["qkv_attention"] == before + 1
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    assert float((out.float() - ref.float()).abs().max()) <= KERNEL_TOL


def test_kernel_honours_sm_scale(cuda):
    qkv = _qkv(1, 200, 2, 64, seed=1)
    out = mha_kernel.mha_qkv_attention(qkv, 2, sm_scale=0.3)
    ref = mha_kernel.mha_qkv_attention_reference(qkv, 2, sm_scale=0.3)
    assert float((out.float() - ref.float()).abs().max()) <= KERNEL_TOL


def test_wrapper_raises_instead_of_falling_back(cuda):
    qkv = _qkv(1, 64, 2, 64)
    with pytest.raises(TypeError):
        mha_kernel.mha_qkv_attention(qkv.float(), 2)
    with pytest.raises(ValueError):
        mha_kernel.mha_qkv_attention(qkv[:, ::2], 2)  # not contiguous
    with pytest.raises(ValueError):
        mha_kernel.mha_qkv_attention(_qkv(1, 64, 4, 32), 4)  # head dim 32


@pytest.mark.parametrize("n,dtype,causal,impl,launches", [
    (1100, torch.bfloat16, False, "auto", 1),
    (500, torch.bfloat16, False, "auto", 0),  # short: plain attention
    (1100, torch.float32, False, "auto", 0),  # the kernel takes bf16 only
    (1100, torch.bfloat16, True, "auto", 0),  # causal: plain attention
    (1100, torch.bfloat16, False, "xla", 0),  # forced plain
])
def test_attention_dispatch_rule(cuda, n, dtype, causal, impl, launches):
    mha = MultiHeadAttention(768, 12, causal=causal, attn_impl=impl, dtype=dtype).to(cuda)
    x = torch.from_numpy(np.random.RandomState(0).randn(1, n, 768).astype(np.float32)).to(cuda)
    before = mha_kernel.LAUNCHES["qkv_attention"]
    with torch.inference_mode():
        out = mha(x.to(dtype), valid_len=n - 3)
    assert torch.isfinite(out.float()).all()
    assert mha_kernel.LAUNCHES["qkv_attention"] - before == launches


@pytest.mark.parametrize("b,n,heads,d,valid_len", [(2, 1100, 12, 64, 1025), (1, 300, 4, 128, None)])
def test_backward_kernel_matches_plain_version(cuda, b, n, heads, d, valid_len):
    """K2 through the autograd binding against the plain backward on K1's output."""
    qkv = _qkv(b, n, heads, d, seed=2).requires_grad_(True)
    gen = torch.Generator(device="cuda").manual_seed(3)
    dout = torch.randn(b, n, heads * d, generator=gen, device="cuda").to(torch.bfloat16)
    before = dict(mha_kernel.LAUNCHES)
    out = mha_kernel.mha_qkv_attention(qkv, heads, valid_len=valid_len)
    out.backward(dout)
    torch.cuda.synchronize()
    assert mha_kernel.LAUNCHES["qkv_attention"] == before["qkv_attention"] + 1
    assert mha_kernel.LAUNCHES["qkv_attention_bwd"] == before["qkv_attention_bwd"] + 1
    ref = mha_kernel.mha_qkv_attention_bwd_reference(qkv.detach(), out.detach(), dout, heads,
                                                      valid_len=valid_len)
    got = qkv.grad
    assert got.dtype == torch.bfloat16 and got.shape == qkv.shape
    rel = float((got.float() - ref.float()).norm() / ref.float().norm())
    assert rel <= 2e-3  # chip_smoke.py's limit (measured 1.0e-4 to 2.2e-4)
    kv = n if valid_len is None else valid_len
    assert not got[:, kv:, heads * d:].any()  # dk, dv of masked keys: exactly 0


def test_two_step_bf16_training_on_the_card(cuda, tmp_path):
    """The heritage preset cut to 2 layers of width 128 at crop 512 (1025
    tokens: the pad-once branch and the kernels), 2 steps through `train()`."""
    from denseclip_vit_multimodal_tpu_torch.core.config import load_config
    from denseclip_vit_multimodal_tpu_torch.train.loop import train

    cfg = load_config("configs/denseclip_vitb16_640x640_80k.yaml", overrides=[
        "model.backbone.width=128", "model.backbone.layers=2", "model.backbone.heads=2",
        "model.backbone.out_indices=[0,1]", "model.text_encoder.transformer_layers=1",
        "model.neck.inter_channels=16", "model.neck.out_channels=32",
        "model.decode_head.in_channels=32", "model.decode_head.channels=32",
        "model.depth_head.in_channels=32", "model.depth_head.channels=16",
        "data.synthetic=true", "data.synthetic_options.image_size=[512,1024]",
        "data.synthetic_options.length=4", "data.crop_size=[512,512]",
        "training.batch_size=2", "training.workers=2"])
    before = dict(mha_kernel.LAUNCHES)
    out = train(cfg, str(tmp_path), max_steps=2, no_validate=True, device="cuda")
    assert out["step"] == 2 and np.isfinite(out["loss_total"]) and out["skipped"] == 0.0
    assert mha_kernel.LAUNCHES["qkv_attention"] - before["qkv_attention"] == 2 * 2
    assert mha_kernel.LAUNCHES["qkv_attention_bwd"] - before["qkv_attention_bwd"] == 2 * 2
    assert os.path.islink(os.path.join(tmp_path, "checkpoints", "latest"))
