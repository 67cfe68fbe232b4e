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
from denseclip_vit_multimodal_tpu_torch.ops import attention, lnqkv_kernel, mha_kernel
from denseclip_vit_multimodal_tpu_torch.tools import exp_outproj_epilogue

pytestmark = pytest.mark.cuda

# bf16 kernel vs bf16 plain version on unit-normal inputs: the output is
# rounded to bf16 (ulp 2^-8 near 1) and P is rounded at another running max.
KERNEL_TOL = 2e-2
# The backward kernels against their plain versions, per gradient: relative
# L2, and max abs error as a share of the largest reference magnitude
# (chip_smoke.py's KERNEL_BWD_REL_TOL / KERNEL_BWD_MAX_TOL).
BWD_REL_TOL, BWD_MAX_TOL = 2e-3, 1e-2


def _assert_grads_close(got, want, rows, keys):
    """dq on rows < `rows`, dk / dv on keys < `keys`, within the backward limits."""
    for name, g, w, lim in zip(("dq", "dk", "dv"), got, want, (rows, keys, keys)):
        g, w = g[:, :lim].float(), w[:, :lim].float()
        assert float((g - w).norm() / w.norm()) <= BWD_REL_TOL, name
        assert float((g - w).abs().max()) <= BWD_MAX_TOL * float(w.abs().max()), name


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
    (1100, torch.bfloat16, True, "auto", 0),  # causal: not K1 (K4: see below)
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


@pytest.mark.parametrize("b,n,heads,d,valid_len,causal,strided", [
    (2, 1100, 2, 128, 1050, False, True),  # ragged, views of a fused qkv
    (1, 2048, 4, 64, None, True, False),  # causal
    (2, 1100, 3, 64, 1050, True, True),  # causal and ragged
])
def test_flash_kernel_matches_plain_version(cuda, b, n, heads, d, valid_len, causal, strided):
    """K4 (through its launching wrapper: the dispatcher would send the short
    non-causal case to the K3 branch) against its plain version on the rows
    below `valid_len`; pad rows finite."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    if strided:
        qkv = torch.randn(b, n, 3 * heads * d, generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = (t.view(b, n, heads, d) for t in qkv.split(heads * d, dim=-1))
    else:
        q, k, v = (torch.randn(b, n, heads, d, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
    rows = n if valid_len is None else valid_len
    before = attention.LAUNCHES["flash_attention"]
    out = attention._launch(q, k, v, causal, d**-0.5, rows)
    ref = attention.flash_attention_reference(q, k, v, causal=causal, valid_len=valid_len)
    torch.cuda.synchronize()
    assert attention.LAUNCHES["flash_attention"] == before + 1
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()
    err = out[:, :rows].float() - ref[:, :rows].float()
    assert float(err.abs().max()) <= KERNEL_TOL
    assert float(err.norm() / ref[:, :rows].float().norm()) <= 5e-3  # chip_smoke.py's limit


def test_flash_wrapper_raises_instead_of_falling_back(cuda):
    q = torch.zeros(1, 9000, 2, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        attention.flash_attention(q.float(), q.float(), q.float())
    with pytest.raises(ValueError):
        h32 = torch.zeros(1, 9000, 4, 32, device="cuda", dtype=torch.bfloat16)
        attention.flash_attention(h32, h32, h32)  # head dim 32


@pytest.mark.parametrize("n,causal,qkv_launches,flash_launches", [
    (8448, False, 1, 0),  # the qkv kernel's window
    (8449, False, 0, 1),  # longer: the flash kernel
    (1100, True, 0, 1),  # causal: the flash kernel
])
def test_long_and_causal_attention_dispatch(cuda, n, causal, qkv_launches, flash_launches):
    mha = MultiHeadAttention(128, 2, causal=causal, dtype=torch.bfloat16).to(cuda)
    x = torch.from_numpy(np.random.RandomState(0).randn(1, n, 128).astype(np.float32)).to(cuda)
    before = (mha_kernel.LAUNCHES["qkv_attention"], attention.LAUNCHES["flash_attention"])
    with torch.inference_mode():
        out = mha(x.to(torch.bfloat16), valid_len=n - 3)
    assert torch.isfinite(out.float()).all()
    assert mha_kernel.LAUNCHES["qkv_attention"] - before[0] == qkv_launches
    assert attention.LAUNCHES["flash_attention"] - before[1] == flash_launches


@pytest.mark.parametrize("b,n,heads,d,valid_len,dtype", [
    (2, 300, 12, 64, 290, torch.bfloat16),
    (10, 1536, 12, 64, 1522, torch.bfloat16),  # the serving shape
    (3, 65, 2, 64, None, torch.float32),  # fp32 qkv: fp32 output
    (1, 1100, 8, 128, 1025, torch.bfloat16),
    (2, 7, 1, 128, None, torch.float32),
    (1, 1, 2, 64, None, torch.bfloat16),
])
def test_int8_kernel_matches_plain_version(cuda, b, n, heads, d, valid_len, dtype):
    """K5 through `mha_qkv_attention_int8` against the int8 plain version:
    the same quantized operands and arithmetic, so the output rounding (and a
    rare exp2 ulp moving a p8 by one step) is all that separates them."""
    qkv = _qkv(b, n, heads, d, seed=5).to(dtype)
    before = mha_kernel.LAUNCHES["qkv_attention_int8"]
    out = mha_kernel.mha_qkv_attention_int8(qkv, heads, valid_len=valid_len)
    ref = mha_kernel.mha_qkv_attention_int8_reference(qkv, heads, valid_len=valid_len)
    torch.cuda.synchronize()
    assert mha_kernel.LAUNCHES["qkv_attention_int8"] == before + 1
    assert out.shape == ref.shape and out.dtype == dtype
    assert torch.isfinite(out.float()).all()
    rows = n if valid_len is None else valid_len
    err = out[:, :rows].float() - ref[:, :rows].float()
    assert float(err.abs().max()) <= KERNEL_TOL
    assert float(err.norm() / ref[:, :rows].float().norm()) <= 5e-3  # chip_smoke.py's limit


def test_int8_wrapper_raises_instead_of_falling_back(cuda):
    qkv = _qkv(1, 64, 2, 64)
    with pytest.raises(TypeError):
        mha_kernel.mha_qkv_attention_int8(qkv.half(), 2)
    with pytest.raises(ValueError):
        mha_kernel.mha_qkv_attention_int8(_qkv(1, 64, 4, 32), 4)  # head dim 32
    with pytest.raises(TypeError):  # under autograd too
        mha_kernel.mha_qkv_attention_int8(qkv.half().requires_grad_(True), 2)


@pytest.mark.parametrize("n,causal,dtype,int8_launches,flash_launches", [
    (300, False, torch.bfloat16, 1, 0),  # no 1024-token floor
    (8448, False, torch.float32, 1, 0),  # fp32 too, up to the one-shot limit
    (8449, False, torch.bfloat16, 0, 1),  # longer: the flash kernel
    (1100, True, torch.bfloat16, 0, 1),  # causal: never quantized
])
def test_int8_attention_dispatch(cuda, n, causal, dtype, int8_launches, flash_launches):
    mha = MultiHeadAttention(128, 2, causal=causal, attn_impl="int8", dtype=dtype).to(cuda)
    x = torch.from_numpy(np.random.RandomState(0).randn(1, n, 128).astype(np.float32)).to(cuda)
    before = (mha_kernel.LAUNCHES["qkv_attention_int8"], mha_kernel.LAUNCHES["qkv_attention"],
              attention.LAUNCHES["flash_attention"])
    with torch.inference_mode():
        out = mha(x.to(dtype), valid_len=n - 3)
    assert torch.isfinite(out.float()).all()
    assert mha_kernel.LAUNCHES["qkv_attention_int8"] - before[0] == int8_launches
    assert mha_kernel.LAUNCHES["qkv_attention"] == before[1]  # never K1 under int8
    assert attention.LAUNCHES["flash_attention"] - before[2] == flash_launches


def _strided_bnhd(b, n, heads, d, seed, strided):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if strided:  # views of a fused qkv projection (row stride 3*H*D)
        qkv = torch.randn(b, n, 3 * heads * d, generator=gen, device="cuda").to(torch.bfloat16)
        return [t.view(b, n, heads, d) for t in qkv.split(heads * d, dim=-1)]
    return [torch.randn(b, n, heads, d, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(3)]


@pytest.mark.parametrize("b,n,heads,d,valid_len,strided", [
    (10, 1536, 12, 64, 1522, True),  # chip_smoke.py's shapes
    (2, 1601, 12, 64, None, False),
    (2, 1100, 8, 128, 1050, True),
    (2, 2048, 3, 256, None, False),
    (1, 77, 2, 256, 70, True),  # ragged, head dim 256
])
def test_oneshot_kernel_matches_plain_version(cuda, b, n, heads, d, valid_len, strided):
    """K3 through `mha_attention` against its plain version (rows below
    `valid_len`; pad rows finite)."""
    q, k, v = _strided_bnhd(b, n, heads, d, 6, strided)
    before = mha_kernel.LAUNCHES["mha_attention"]
    out = mha_kernel.mha_attention(q, k, v, valid_len=valid_len)
    ref = mha_kernel.mha_attention_reference(q, k, v, valid_len=valid_len)
    torch.cuda.synchronize()
    assert mha_kernel.LAUNCHES["mha_attention"] == before + 1
    assert out.shape == ref.shape and out.dtype == torch.bfloat16 and out.is_contiguous()
    assert torch.isfinite(out.float()).all()
    rows = n if valid_len is None else valid_len
    err = out[:, :rows].float() - ref[:, :rows].float()
    assert float(err.abs().max()) <= KERNEL_TOL
    assert float(err.norm() / ref[:, :rows].float().norm()) <= 5e-3  # chip_smoke.py's limit
    assert float(err.abs().mean()) <= 5e-4


def _lnqkv_inputs(b, n, dim, seed):
    """x and ln_1 / qkv parameters at the scale of a seeded init."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(b, n, dim, generator=gen, device="cuda").to(torch.bfloat16)
    gamma = 1.0 + 0.1 * torch.randn(dim, generator=gen, device="cuda")
    beta = 0.1 * torch.randn(dim, generator=gen, device="cuda")
    limit = (6.0 / (4 * dim)) ** 0.5  # xavier-uniform of a [D, 3D] kernel
    w = ((torch.rand(3 * dim, dim, generator=gen, device="cuda") * 2 - 1) * limit)
    bias = 0.02 * torch.randn(3 * dim, generator=gen, device="cuda")
    return x, gamma, beta, w.to(torch.bfloat16).t(), bias  # W [D, 3D] as a transposed view


@pytest.mark.parametrize("b,n,dim,heads,valid_len", [
    (10, 1536, 768, 12, 1522),  # chip_smoke.py's shapes
    (2, 1100, 768, 6, 1050),
    (1, 3968, 768, 12, None),
    (3, 130, 256, 4, 129),  # ragged rows of x
])
def test_lnqkv_kernel_matches_plain_version(cuda, b, n, dim, heads, valid_len):
    x, gamma, beta, w, bias = _lnqkv_inputs(b, n, dim, 7)
    before = lnqkv_kernel.LAUNCHES["ln_qkv_attention"]
    out = lnqkv_kernel.ln_qkv_attention(x, gamma, beta, w, bias, heads, valid_len=valid_len)
    ref = lnqkv_kernel.ln_qkv_attention_reference(x, gamma, beta, w, bias, heads,
                                                   valid_len=valid_len)
    torch.cuda.synchronize()
    assert lnqkv_kernel.LAUNCHES["ln_qkv_attention"] == before + 1
    assert out.shape == ref.shape == (b, n, dim) and out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()
    rows = n if valid_len is None else valid_len
    err = out[:, :rows].float() - ref[:, :rows].float()
    assert float(err.abs().max()) <= KERNEL_TOL
    assert float(err.norm() / ref[:, :rows].float().norm()) <= 5e-3  # chip_smoke.py's limit
    assert float(err.abs().mean()) <= 5e-4


def test_oneshot_and_lnqkv_wrappers_raise_instead_of_falling_back(cuda):
    q, k, v = _strided_bnhd(1, 64, 2, 64, 8, False)
    with pytest.raises(TypeError):
        mha_kernel.mha_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):
        h32 = torch.zeros(1, 64, 4, 32, device="cuda", dtype=torch.bfloat16)
        mha_kernel.mha_attention(h32, h32, h32)  # head dim 32
    with pytest.raises(ValueError):  # K3's backward takes head dim 64 / 128: refused up front
        h256 = torch.zeros(1, 64, 1, 256, device="cuda", dtype=torch.bfloat16)
        mha_kernel.mha_attention(h256.requires_grad_(True), h256, h256)
    x, gamma, beta, w, bias = _lnqkv_inputs(1, 64, 256, 9)
    with pytest.raises(TypeError):
        lnqkv_kernel.ln_qkv_attention(x.float(), gamma, beta, w, bias, 4)
    with pytest.raises(ValueError):
        lnqkv_kernel.ln_qkv_attention(x, gamma, beta, w, bias, 8)  # head dim 32


@pytest.mark.parametrize("n,impl,fused,lnqkv_launches,qkv_launches,int8_launches", [
    (1536, "auto", "1", 1, 0, 0),  # the fused kernel replaces K1
    (1536, "auto", "0", 0, 1, 0),  # opt-in: off by default
    (8320, "auto", "1", 0, 1, 0),  # beyond lnqkv_supported: the unfused K1 route
    (300, "int8", "1", 1, 0, 0),  # under int8 the fused branch comes first
])
def test_fused_block_launch_counts(cuda, monkeypatch, n, impl, fused, lnqkv_launches,
                                   qkv_launches, int8_launches):
    from denseclip_vit_multimodal_tpu_torch.models.layers import ResidualAttentionBlock

    monkeypatch.setenv("DENSECLIP_FUSED_LNQKV", fused)
    blk = ResidualAttentionBlock(768, 12, attn_impl=impl, dtype=torch.bfloat16).to(cuda)
    x = torch.from_numpy(np.random.RandomState(0).randn(1, n, 768).astype(np.float32))
    before = (lnqkv_kernel.LAUNCHES["ln_qkv_attention"], mha_kernel.LAUNCHES["qkv_attention"],
              mha_kernel.LAUNCHES["qkv_attention_int8"])
    with torch.inference_mode():
        out = blk(x.to(cuda, torch.bfloat16), valid_len=n - 3)
    assert torch.isfinite(out.float()).all()
    assert lnqkv_kernel.LAUNCHES["ln_qkv_attention"] - before[0] == lnqkv_launches
    assert mha_kernel.LAUNCHES["qkv_attention"] - before[1] == qkv_launches
    assert mha_kernel.LAUNCHES["qkv_attention_int8"] - before[2] == int8_launches


@pytest.mark.parametrize("b,n,heads,d,valid_len,strided", [
    (2, 1664, 12, 64, 1601, True),  # the heritage training shape, views of a fused qkv
    (2, 1100, 8, 128, 1050, True),
    (1, 300, 4, 64, None, False),
])
def test_oneshot_backward_kernel_matches_plain_version(cuda, b, n, heads, d, valid_len, strided):
    """K3's backward through `mha_attention` under autograd against the plain
    backward on K3's output; dk / dv of masked keys exactly 0."""
    q, k, v = (t.detach().requires_grad_(True) for t in _strided_bnhd(b, n, heads, d, 11, strided))
    gen = torch.Generator(device="cuda").manual_seed(12)
    dout = torch.randn(b, n, heads, d, generator=gen, device="cuda").to(torch.bfloat16)
    before = dict(mha_kernel.LAUNCHES)
    out = mha_kernel.mha_attention(q, k, v, valid_len=valid_len)
    got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert mha_kernel.LAUNCHES["mha_attention"] == before["mha_attention"] + 1
    assert mha_kernel.LAUNCHES["mha_attention_bwd"] == before["mha_attention_bwd"] + 1
    want = mha_kernel.mha_attention_bwd_reference(q.detach(), k.detach(), v.detach(),
                                                  out.detach(), dout, valid_len=valid_len)
    kv = n if valid_len is None else valid_len
    _assert_grads_close(got, want, n, kv)
    assert not got[1][:, kv:].any() and not got[2][:, kv:].any()


@pytest.mark.parametrize("b,n,heads,d,valid_len,causal", [
    (1, 9344, 2, 64, 9217, False),  # the long training crop's sequence, 2 of its heads
    (2, 2048, 4, 64, None, True),
    (2, 1100, 3, 128, 1050, False),
    (1, 1100, 2, 64, 1050, True),
])
def test_flash_backward_kernel_matches_plain_version(cuda, b, n, heads, d, valid_len, causal):
    """K4b through `flash_attention` under autograd (views of a fused qkv)
    against its plain version on K4's output: rows / keys below `valid_len`;
    pad rows get dq = 0 and pad keys dk = dv = 0."""
    q, k, v = (t.detach().requires_grad_(True) for t in _strided_bnhd(b, n, heads, d, 13, True))
    gen = torch.Generator(device="cuda").manual_seed(14)
    dout = torch.randn(b, n, heads, d, generator=gen, device="cuda").to(torch.bfloat16)
    before = dict(attention.LAUNCHES)
    out = attention.FlashAttentionFunction.apply(q, k, v, causal, d**-0.5,
                                                 n if valid_len is None else valid_len)
    got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert attention.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert attention.LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    want = attention.flash_attention_bwd_reference(q.detach(), k.detach(), v.detach(),
                                                   out.detach(), dout, causal=causal,
                                                   valid_len=valid_len)
    kv = n if valid_len is None else valid_len
    _assert_grads_close(got, want, kv, kv)
    assert not got[0][:, kv:].any() and not got[1][:, kv:].any() and not got[2][:, kv:].any()


def test_long_sequence_attention_trains_through_k4b(cuda):
    """A block's attention past the one-shot limit under autograd: K4 and K4b,
    no plain attention, no K1 / K2."""
    mha = MultiHeadAttention(128, 2, dtype=torch.bfloat16).to(cuda)
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 8449, 128).astype(np.float32))
    x = x.to(cuda, torch.bfloat16).requires_grad_(True)
    before = {**mha_kernel.LAUNCHES, **attention.LAUNCHES}
    mha(x, valid_len=8446).float().sum().backward()
    torch.cuda.synchronize()
    after = {**mha_kernel.LAUNCHES, **attention.LAUNCHES}
    assert {k: after[k] - before[k] for k in after} == {
        "qkv_attention": 0, "qkv_attention_bwd": 0, "qkv_attention_int8": 0, "mha_attention": 0,
        "mha_attention_bwd": 0, "flash_attention": 1, "flash_attention_bwd": 1}
    assert torch.isfinite(x.grad.float()).all()


def test_int8_straight_through_backward_on_the_card(cuda):
    """The int8 path's gradient is the bf16 one of the unquantized qkv: K1's
    forward for the statistics, then K2."""
    qkv = _qkv(2, 300, 4, 64, seed=15).requires_grad_(True)
    gen = torch.Generator(device="cuda").manual_seed(16)
    dout = torch.randn(2, 300, 256, generator=gen, device="cuda").to(torch.bfloat16)
    before = dict(mha_kernel.LAUNCHES)
    out = mha_kernel.mha_qkv_attention_int8(qkv, 4, valid_len=290)
    (got,) = torch.autograd.grad(out, qkv, dout)
    torch.cuda.synchronize()
    after = mha_kernel.LAUNCHES
    assert [after[k] - before[k] for k in ("qkv_attention_int8", "qkv_attention",
                                           "qkv_attention_bwd")] == [1, 1, 1]
    x = qkv.detach()
    want = mha_kernel.mha_qkv_attention_bwd_reference(
        x, mha_kernel.mha_qkv_attention_reference(x, 4, valid_len=290), dout, 4, valid_len=290)
    assert float((got.float() - want.float()).norm() / want.float().norm()) <= BWD_REL_TOL


@pytest.mark.parametrize("b,n,heads,d,valid_len", [
    (10, 1601, 12, 64, None),  # the experiment's shape
    (2, 1100, 4, 128, 1050),
    (1, 77, 2, 64, 70),
])
def test_outproj_kernel_matches_plain_version(cuda, b, n, heads, d, valid_len):
    """K7 against its plain version (fp32 output, rows below `valid_len`)."""
    hd = heads * d
    qkv = _qkv(b, n, heads, d, seed=17)
    gen = torch.Generator(device="cuda").manual_seed(18)
    w = (torch.randn(hd, hd, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    before = exp_outproj_epilogue.LAUNCHES["qkv_out_attention"]
    out = exp_outproj_epilogue.qkv_out_attention(qkv, w, heads, valid_len=valid_len)
    ref = exp_outproj_epilogue.qkv_out_attention_reference(qkv, w, heads, valid_len=valid_len)
    torch.cuda.synchronize()
    assert exp_outproj_epilogue.LAUNCHES["qkv_out_attention"] == before + 1
    assert out.shape == ref.shape == (b, n, hd) and out.dtype == torch.float32
    rows = n if valid_len is None else valid_len
    err = out[:, :rows] - ref[:, :rows]
    # each head's output is rounded to bf16 in both: a one-ulp difference
    # there moves the fp32 sum by ~ulp * |w| * sqrt(H * D)
    assert float(err.norm() / ref[:, :rows].norm()) <= 5e-3
    assert float(err.abs().max()) <= KERNEL_TOL * float(ref[:, :rows].abs().max())


@pytest.mark.parametrize("n,valid_len,counters,kernel", [
    (1100, 1090, mha_kernel.LAUNCHES, "qkv_attention"),  # K1 + K2
    (8704, 8600, attention.LAUNCHES, "flash_attention"),  # past the one-shot limit: K4 + K4b
])
def test_remat_training_step_matches_on_the_card(cuda, n, valid_len, counters, kernel):
    """`tpu.remat` on the card: the same loss and gradients as without it
    (the kernels are deterministic), with drop path on; the attention
    forward runs again in the backward."""
    from denseclip_vit_multimodal_tpu_torch.models.layers import Transformer

    grads = []
    for remat in (False, True):
        torch.manual_seed(0)
        net = Transformer(128, 2, 2, dtype=torch.bfloat16, drop_path_rate=0.3,
                          gen=torch.Generator().manual_seed(1), remat=remat).to(cuda)
        x = torch.from_numpy(np.random.RandomState(2).randn(2, n, 128).astype(np.float32))
        x = x.to(cuda, torch.bfloat16).requires_grad_(True)
        before = counters[kernel]
        final, _ = net(x, valid_len=valid_len, gen=torch.Generator(device="cuda").manual_seed(3))
        final.float().square().mean().backward()
        grads.append([x.grad] + [p.grad for p in net.parameters()])
        assert counters[kernel] - before == (4 if remat else 2)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
