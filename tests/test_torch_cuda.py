"""Tests of the port that need an NVIDIA GPU (marker `cuda`; they skip without one).

Run them on a machine with a card, where JAX is not installed, without the
JAX-only conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import os
import threading

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
# The fp32 kernels against their plain versions (chip_smoke.py's FP32_*):
# outputs max abs and relative L2; gradients relative L2 and max abs as a
# share of the largest, per gradient.
FP32_MAX_TOL, FP32_REL_TOL = 1e-4, 1e-5
FP32_BWD_REL_TOL, FP32_BWD_MAX_TOL = 1e-4, 1e-4


def _assert_grads_close(got, want, rows, keys, rel_tol=BWD_REL_TOL, max_tol=BWD_MAX_TOL):
    """dq on rows < `rows`, dk / dv on keys < `keys`, within the backward limits."""
    for name, g, w, lim in zip(("dq", "dk", "dv"), got, want, (rows, keys, keys)):
        g, w = g[:, :lim].float(), w[:, :lim].float()
        assert float((g - w).norm() / w.norm()) <= rel_tol, name
        assert float((g - w).abs().max()) <= max_tol * float(w.abs().max()), name


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
    before = mha_kernel.LAUNCHES["qkv_attention_fp32"]
    out = mha_kernel.mha_qkv_attention(qkv.float(), 2)  # fp32: K1's fp32 kernel
    assert out.dtype == torch.float32
    assert mha_kernel.LAUNCHES["qkv_attention_fp32"] == before + 1
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        mha_kernel.mha_qkv_attention(qkv.half(), 2)
    with pytest.raises(ValueError):
        mha_kernel.mha_qkv_attention(qkv[:, ::2], 2)  # not contiguous
    with pytest.raises(ValueError):
        mha_kernel.mha_qkv_attention(_qkv(1, 64, 4, 32), 4)  # head dim 32


@pytest.mark.parametrize("n,dtype,causal,impl,launches", [
    (1100, torch.bfloat16, False, "auto", 1),
    (500, torch.bfloat16, False, "auto", 0),  # short: plain attention
    (1100, torch.float32, False, "auto", 1),  # K1's fp32 kernel
    (1100, torch.bfloat16, True, "auto", 0),  # causal: not K1 (K4: see below)
    (1100, torch.bfloat16, False, "xla", 0),  # forced plain
])
def test_attention_dispatch_rule(cuda, n, dtype, causal, impl, launches):
    mha = MultiHeadAttention(768, 12, causal=causal, attn_impl=impl, dtype=dtype).to(cuda)
    x = torch.from_numpy(np.random.RandomState(0).randn(1, n, 768).astype(np.float32)).to(cuda)
    counter = mha_kernel.kernel_name("qkv_attention", dtype)
    before = dict(mha_kernel.LAUNCHES)
    with torch.inference_mode():
        out = mha(x.to(dtype), valid_len=n - 3)
    assert torch.isfinite(out.float()).all()
    assert mha_kernel.LAUNCHES[counter] - before[counter] == launches
    assert sum(mha_kernel.LAUNCHES.values()) - sum(before.values()) == launches


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
    (1, 8704, 2, 256, 8600, False, True),  # head dim 256 past the one-shot limit
    (1, 1100, 2, 256, 1050, True, True),  # head dim 256, causal and ragged
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
    before = attention.LAUNCHES["flash_attention_fp32"]  # fp32: K4's fp32 kernel
    assert attention.flash_attention(q.float(), q.float(), q.float()).dtype == torch.float32
    assert attention.LAUNCHES["flash_attention_fp32"] == before + 1
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        attention.flash_attention(q.half(), q.half(), q.half())
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
    before = dict(mha_kernel.LAUNCHES)
    out = mha_kernel.mha_qkv_attention_int8(qkv, heads, valid_len=valid_len)
    ref = mha_kernel.mha_qkv_attention_int8_reference(qkv, heads, valid_len=valid_len)
    torch.cuda.synchronize()
    assert mha_kernel.LAUNCHES["qkv_attention_int8"] == before["qkv_attention_int8"] + 1
    assert mha_kernel.LAUNCHES["quantize_qkv_int8"] == before["quantize_qkv_int8"] + 1
    assert out.shape == ref.shape and out.dtype == dtype
    assert torch.isfinite(out.float()).all()
    rows = n if valid_len is None else valid_len
    err = out[:, :rows].float() - ref[:, :rows].float()
    assert float(err.abs().max()) <= KERNEL_TOL
    assert float(err.norm() / ref[:, :rows].float().norm()) <= 5e-3  # chip_smoke.py's limit


@pytest.mark.parametrize("b,n,heads,d,valid_len,dtype", [
    (10, 1536, 12, 64, 1522, torch.bfloat16),  # the serving shape
    (1, 8320, 12, 64, 8193, torch.bfloat16),  # a mode=whole request
    (2, 1100, 8, 128, 1025, torch.float32),
    (3, 65, 2, 64, None, torch.float32),
    (1, 1, 2, 64, None, torch.bfloat16),
])
def test_int8_prologue_kernel_is_bitwise_the_plain_prologue(cuda, b, n, heads, d, valid_len,
                                                            dtype):
    """The prologue kernel's q8 (its q and k thirds: the v third is not
    written), V's key-major copy and scales equal `quantize_qkv_int8` +
    `value_key_major` bit for bit, with inf / NaN in the pad rows (never
    read) and one launch counted."""
    qkv = _qkv(b, n, heads, d, seed=9).to(dtype)
    kv = n if valid_len is None else valid_len
    qkv[:, kv:, ::2] = float("inf")
    qkv[:, kv:, 1::2] = float("nan")
    before = mha_kernel.LAUNCHES["quantize_qkv_int8"]
    q8, vt, scales = mha_kernel._launch_quantize_int8(qkv, heads, kv)
    want_q8, want_scales = mha_kernel.quantize_qkv_int8(qkv, heads, kv)
    torch.cuda.synchronize()
    assert mha_kernel.LAUNCHES["quantize_qkv_int8"] == before + 1
    qk = 2 * heads * d
    assert torch.equal(q8[..., :qk], want_q8[..., :qk]) and torch.equal(scales, want_scales)
    assert torch.equal(vt, mha_kernel.value_key_major(want_q8, heads))


def test_int8_prologue_refuses_what_it_does_not_take(cuda):
    qkv = _qkv(1, 64, 2, 64)
    with pytest.raises(TypeError):
        mha_kernel._launch_quantize_int8(qkv.half(), 2, 64)
    with pytest.raises(ValueError):
        mha_kernel._launch_quantize_int8(_qkv(1, 64, 4, 32), 4, 64)  # head dim 32
    with pytest.raises(ValueError):  # not contiguous
        mha_kernel._launch_quantize_int8(_qkv(1, 128, 2, 64)[:, ::2], 2, 64)


def test_tma_kernels_launch_from_a_fresh_thread(cuda):
    """K1, the int8 path (prologue + K5) and K6 build TMA tensor maps, which
    need a current context: from a thread where no CUDA call has made one
    current (an autograd or server worker on device 0) they launch and give
    what they give from the main thread."""
    qkv = _qkv(2, 300, 4, 64, seed=3)
    lnqkv_args = _lnqkv_inputs(2, 300, 256, 5)
    got = {}

    def run():
        got["k1"] = mha_kernel.mha_qkv_attention(qkv, 4, valid_len=290)
        got["int8"] = mha_kernel.mha_qkv_attention_int8(qkv, 4, valid_len=290)
        got["k6"] = lnqkv_kernel.ln_qkv_attention(*lnqkv_args, 4, valid_len=290)
        torch.cuda.synchronize()

    worker = threading.Thread(target=run)
    worker.start()
    worker.join(timeout=300)
    assert not worker.is_alive() and set(got) == {"k1", "int8", "k6"}
    assert torch.equal(got["k1"], mha_kernel.mha_qkv_attention(qkv, 4, valid_len=290))
    assert torch.equal(got["int8"], mha_kernel.mha_qkv_attention_int8(qkv, 4, valid_len=290))
    assert torch.equal(got["k6"], lnqkv_kernel.ln_qkv_attention(*lnqkv_args, 4, valid_len=290))


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


@pytest.mark.parametrize("kernel,b,n,heads,d,valid_len,layout", [
    ("qkv", 2, 1664, 12, 64, 1601, "fused"),  # K1: three warpgroups at head dim 64
    ("qkv", 1, 700, 6, 128, 650, "fused"),
    ("mha", 2, 1100, 8, 128, 1050, "bhnd"),  # K3 on [B, H, N, D] storage
    ("mha", 1, 300, 2, 256, 290, "bhnd"),
    ("flash", 2, 1100, 4, 64, 1050, "bhnd"),  # K4 (causal) on [B, H, N, D] storage
    ("flash", 1, 2100, 2, 256, 2000, "fused"),
])
def test_forward_kernels_skip_nan_pad_keys_and_write_plain_stats(cuda, kernel, b, n, heads, d,
                                                                valid_len, layout):
    """K1 / K3 / K4 (causal) with NaN in every K / V row past valid_len (their
    tensor maps end there: TMA never reads them) give finite outputs within
    the limits, and row statistics within chip_smoke.py's STATS_M_TOL /
    STATS_L_TOL of the plain row max and sum.  The [B, H, N, D] views have
    their head stride above their token stride (the maps order dimensions by
    stride)."""
    from denseclip_vit_multimodal_tpu_torch.tools.time_fwd_trees import (
        STATS_L_TOL,
        STATS_M_TOL,
        plain_stats,
        stats_errors,
    )

    gen = torch.Generator(device="cuda").manual_seed(12)
    if layout == "fused":
        qkv = torch.randn(b, n, 3 * heads * d, generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = (t.view(b, n, heads, d) for t in qkv.split(heads * d, dim=-1))
    else:
        q, k, v = (torch.randn(b, heads, n, d, generator=gen, device="cuda").to(torch.bfloat16)
                   .transpose(1, 2) for _ in range(3))
    k[:, valid_len:] = float("nan")
    v[:, valid_len:] = float("nan")
    scale = d**-0.5
    causal = kernel == "flash"
    if kernel == "qkv":
        out, stats = mha_kernel._launch(qkv, heads, scale, valid_len, with_stats=True)
        out = out.view(b, n, heads, d)
    else:
        stats = torch.empty(b, heads, n, 2, device="cuda")
        if causal:
            out = attention._launch(q, k, v, True, scale, valid_len, stats)
        else:
            out = mha_kernel._launch_mha(q, k, v, scale, valid_len, stats)
    if causal:
        ref = attention.flash_attention_reference(q, k, v, causal=True, valid_len=valid_len)
    else:
        ref = mha_kernel.mha_attention_reference(q, k, v, valid_len=valid_len)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    err = out.float() - ref.float()
    assert float(err.abs().max()) <= KERNEL_TOL
    assert float(err.norm() / ref.float().norm()) <= 5e-3
    errs = stats_errors(stats, plain_stats(q, k, valid_len, scale, prescaled=not causal,
                                           causal=causal))
    assert errs["stats_m_max_abs_err"] <= STATS_M_TOL
    assert errs["stats_l_max_rel_err"] <= STATS_L_TOL


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


@pytest.mark.parametrize("b,n,dim,heads", [
    (10, 1536, 768, 12),  # the slide window batch
    (2, 1100, 768, 6),  # head dim 128
    (3, 130, 256, 4),  # ragged rows of x
    (2, 70, 128, 1),  # 3*H*d = 384: a ragged 256-column tile
])
def test_lnqkv_first_stage_matches_plain_projection(cuda, b, n, dim, heads):
    """K6's first stage writes the workspace of `ln_qkv_projection_reference`
    within `lnqkv_kernel.workspace_errors`' limits (one bf16 step, plus the
    fp32 sums' error bound where they cancel); its statistics pass is
    bitwise the plain one."""
    x, gamma, beta, w, bias = _lnqkv_inputs(b, n, dim, 11)
    before = dict(lnqkv_kernel.LAUNCHES)
    got = lnqkv_kernel.ln_qkv_projection(x, gamma, beta, w, bias, heads)
    torch.cuda.synchronize()
    assert lnqkv_kernel.LAUNCHES == dict(before, ln_qkv_projection=before["ln_qkv_projection"] + 1)
    errs = lnqkv_kernel.workspace_errors(got, x, gamma, beta, w, bias, heads)
    assert errs["max_share_of_limit"] <= 1.0, errs
    stats = torch.empty(b * n, 2, device="cuda")
    assert lnqkv_kernel.kernel_fns()["stats"](x.data_ptr(), stats.data_ptr(), b * n, dim, 1e-5,
                                               torch.cuda.current_stream().cuda_stream) == 0
    assert torch.equal(stats, lnqkv_kernel.ln_qkv_stats_reference(x).reshape(-1, 2))


def test_oneshot_and_lnqkv_wrappers_raise_instead_of_falling_back(cuda):
    q, k, v = _strided_bnhd(1, 64, 2, 64, 8, False)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        mha_kernel.mha_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        h32 = torch.zeros(1, 64, 4, 32, device="cuda", dtype=torch.bfloat16)
        mha_kernel.mha_attention(h32, h32, h32)  # head dim 32
    with pytest.raises(TypeError):  # under autograd too: K3 and its backward take bf16 / fp32
        mha_kernel.mha_attention(q.half().requires_grad_(True), k.half(), v.half())
    before = dict(mha_kernel.LAUNCHES)  # fp32: K3's fp32 kernel, no refusal
    assert mha_kernel.mha_attention(q.float(), k.float(), v.float()).dtype == torch.float32
    assert mha_kernel.LAUNCHES["mha_attention_fp32"] == before["mha_attention_fp32"] + 1
    x, gamma, beta, w, bias = _lnqkv_inputs(1, 64, 256, 9)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        lnqkv_kernel.ln_qkv_attention(x.half(), gamma, beta, w, bias, 4)
    before = lnqkv_kernel.LAUNCHES["ln_qkv_attention_fp32"]  # fp32: K6's fp32 kernel
    assert lnqkv_kernel.ln_qkv_attention(x.float(), gamma, beta, w, bias, 4).dtype == torch.float32
    assert lnqkv_kernel.LAUNCHES["ln_qkv_attention_fp32"] == before + 1
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
    (2, 1030, 2, 256, 1025, True),  # head dim 256: the dk/dv kernel's two passes
    (1, 77, 1, 256, None, False),
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
    (1, 8704, 2, 256, 8600, False),  # head dim 256: two dk/dv passes
    (1, 1100, 2, 256, 1050, True),
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
    assert {k: after[k] - before[k] for k in after} == {  # every other counter (knobs too) 0
        **{k: 0 for k in after}, "flash_attention": 1, "flash_attention_bwd": 1}
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
    (2, 1100, 16, 64, 1050),  # H*D = 1024 (ViT-L/14's width), the widest the kernel takes
    (2, 1601, 8, 128, None),
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


def test_outproj_wrapper_refuses_widths_past_the_kernel(cuda):
    """H*D past 1024 (or head dim 32) raises ValueError before any launch."""
    before = exp_outproj_epilogue.LAUNCHES["qkv_out_attention"]
    for heads, d in ((17, 64), (9, 128), (4, 32)):
        qkv = torch.zeros(1, 64, 3 * heads * d, dtype=torch.bfloat16, device="cuda")
        w = torch.zeros(heads * d, heads * d, dtype=torch.bfloat16, device="cuda")
        with pytest.raises(ValueError):
            exp_outproj_epilogue.qkv_out_attention(qkv, w, heads)
    assert exp_outproj_epilogue.LAUNCHES["qkv_out_attention"] == before


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


def _backward_launches(kernel, b, n, heads, d, valid_len, causal):
    """A closure launching one backward kernel (K2, K3's backward or K4b) on
    fixed inputs from its forward's output and statistics."""
    kv = n if valid_len is None else valid_len
    gen = torch.Generator(device="cuda").manual_seed(21)
    if kernel == "qkv_attention_bwd":
        qkv = _qkv(b, n, heads, d, seed=20)
        dout = torch.randn(b, n, heads * d, generator=gen, device="cuda").to(torch.bfloat16)
        out, stats = mha_kernel._launch(qkv, heads, d**-0.5, kv, with_stats=True)
        return lambda: (mha_kernel._launch_bwd(qkv, out, dout, stats, heads, d**-0.5, kv),)
    q, k, v = _strided_bnhd(b, n, heads, d, 20, True)
    dout = torch.randn(b, n, heads, d, generator=gen, device="cuda").to(torch.bfloat16)
    stats = torch.empty(b, heads, n, 2, dtype=torch.float32, device="cuda")
    if kernel == "mha_attention_bwd":
        out = mha_kernel._launch_mha(q, k, v, d**-0.5, kv, stats)
        return lambda: mha_kernel._launch_mha_bwd(q, k, v, out, dout, stats, d**-0.5, kv)
    out = attention._launch(q, k, v, causal, d**-0.5, kv, stats)
    return lambda: attention._launch_bwd(q, k, v, out, dout, stats, causal, d**-0.5, kv)


@pytest.mark.parametrize("kernel,b,n,heads,d,valid_len,causal", [
    ("qkv_attention_bwd", 2, 1664, 12, 64, 1601, False),
    ("qkv_attention_bwd", 1, 700, 4, 128, None, False),
    ("mha_attention_bwd", 2, 1664, 12, 64, 1601, False),
    ("mha_attention_bwd", 1, 1030, 2, 256, 1025, False),
    ("flash_attention_bwd", 1, 9344, 2, 64, 9217, False),
    ("flash_attention_bwd", 1, 2048, 4, 64, None, True),
    ("flash_attention_bwd", 1, 1100, 2, 128, 1050, False),
    ("flash_attention_bwd", 1, 1100, 2, 256, 1050, True),
])
def test_backward_kernels_are_bitwise_deterministic(cuda, kernel, b, n, heads, d, valid_len,
                                                    causal):
    """Two launches of a backward kernel on the same inputs give the same
    gradients bit for bit: the kernels have no atomics."""
    bwd = _backward_launches(kernel, b, n, heads, d, valid_len, causal)
    first, second = bwd(), bwd()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.parametrize("n,causal", [(8704, False), (1100, True)])
def test_flash_branch_takes_head_dim_256_through_k4_and_k4b(cuda, n, causal):
    """`flash_attention` at head dim 256, causal or past the one-shot limit,
    launches K4 (and K4b under autograd), never K3 or plain attention, and
    its gradients are K4b's plain version's on K4's output."""
    q, k, v = (t.detach().requires_grad_(True) for t in _strided_bnhd(1, n, 2, 256, 23, True))
    gen = torch.Generator(device="cuda").manual_seed(24)
    dout = torch.randn(1, n, 2, 256, generator=gen, device="cuda").to(torch.bfloat16)
    before = {**mha_kernel.LAUNCHES, **attention.LAUNCHES}
    out = attention.flash_attention(q, k, v, causal=causal, valid_len=n - 3)
    got = torch.autograd.grad(out, (q, k, v), dout)
    with torch.no_grad():
        attention.flash_attention(q, k, v, causal=causal, valid_len=n - 3)
    torch.cuda.synchronize()
    after = {**mha_kernel.LAUNCHES, **attention.LAUNCHES}
    assert {key: after[key] - before[key] for key in after} == {  # every other counter 0
        **{key: 0 for key in after}, "flash_attention": 2, "flash_attention_bwd": 1}
    want = attention.flash_attention_bwd_reference(q.detach(), k.detach(), v.detach(),
                                                   out.detach(), dout, causal=causal,
                                                   valid_len=n - 3)
    _assert_grads_close(got, want, n - 3, n - 3)


def test_oneshot_branch_trains_head_dim_256_and_refuses_fp32(cuda):
    """Under autograd on CUDA, `flash_attention`'s K3 branch takes head dim
    256 through K3 and its backward, in bf16 and, through their fp32
    kernels, in fp32 (gradients as the plain backward's on the kernel's
    output); another dtype it refuses with `TypeError` before any launch."""
    q, k, v = (t.detach().requires_grad_(True) for t in _strided_bnhd(1, 1030, 2, 256, 22, True))
    before = dict(mha_kernel.LAUNCHES)
    out = attention.flash_attention(q, k, v, valid_len=1025)
    grads = torch.autograd.grad(out.float().sum(), (q, k, v))
    torch.cuda.synchronize()
    assert mha_kernel.LAUNCHES["mha_attention"] == before["mha_attention"] + 1
    assert mha_kernel.LAUNCHES["mha_attention_bwd"] == before["mha_attention_bwd"] + 1
    assert all(torch.isfinite(g.float()).all() for g in grads)
    q32, k32, v32 = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    before = dict(mha_kernel.LAUNCHES)
    out = attention.flash_attention(q32, k32, v32, valid_len=1025)
    dout = torch.ones_like(out)
    got = torch.autograd.grad(out, (q32, k32, v32), dout)
    torch.cuda.synchronize()
    assert mha_kernel.LAUNCHES["mha_attention_fp32"] == before["mha_attention_fp32"] + 1
    assert mha_kernel.LAUNCHES["mha_attention_bwd_fp32"] == before["mha_attention_bwd_fp32"] + 1
    want = mha_kernel.mha_attention_bwd_reference(q32.detach(), k32.detach(), v32.detach(),
                                                  out.detach(), dout, valid_len=1025)
    _assert_grads_close(got, want, 1030, 1025, FP32_BWD_REL_TOL, FP32_BWD_MAX_TOL)
    before = {**mha_kernel.LAUNCHES, **attention.LAUNCHES}
    with pytest.raises(TypeError):
        attention.flash_attention(*(t.detach().half().requires_grad_(True) for t in (q, k, v)),
                                  valid_len=1025)
    assert {**mha_kernel.LAUNCHES, **attention.LAUNCHES} == before


def test_kernel_ops_pass_opcheck_on_cuda(cuda):
    """The six forward kernels as `denseclip_torch` ops (`ops/_library.py`):
    the CUDA implementation against the fake one (shapes, dtypes, strides)
    and through aot_autograd.  The prologue leaves q8's v third unwritten
    (K5 reads V from its key-major copy), so two of its runs differ there:
    it is held to its schema and fake implementation only."""
    qkv = _qkv(2, 300, 2, 64)
    q, k, v = (t.view(2, 300, 2, 64) for t in qkv.split(128, dim=-1))
    scale = 64**-0.5
    q8, vt, scales = mha_kernel.QUANTIZE_QKV_INT8_OP(qkv, 2, 290)
    x, gamma, beta, w, bias = _lnqkv_inputs(1, 300, 256, 4)
    cases = [
        (mha_kernel.QKV_ATTENTION_OP, (qkv, 2, scale, 290), None),
        (mha_kernel.MHA_ATTENTION_OP, (q, k, v, scale, 290), None),
        (attention.FLASH_ATTENTION_OP, (q, k, v, True, scale, 290), None),
        (mha_kernel.QUANTIZE_QKV_INT8_OP, (qkv, 2, 290), ("test_schema", "test_faketensor")),
        (mha_kernel.QKV_ATTENTION_INT8_OP, (q8, vt, scales, 2, scale, 290, torch.bfloat16), None),
        (lnqkv_kernel.LN_QKV_ATTENTION_OP, (x, gamma, beta, w, bias, 4, scale, 1e-5, 290), None),
    ]
    for op, args, utils in cases:
        kw = {} if utils is None else {"test_utils": utils}
        assert set(torch.library.opcheck(op, args, **kw).values()) == {"SUCCESS"}, op


def _fp32_case(kernel, b, n, heads, d, kv, causal, seed):
    """An fp32 forward kernel (`kernel`: its bf16 counter's name) through its
    launching wrapper with row statistics, on views of one fused fp32 qkv
    with NaN in the K / V rows at or past kv; returns (qkv, q, k, v, out,
    stats, plain out)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, n, 3 * heads * d, generator=gen, device="cuda")
    q, k, v = (t.view(b, n, heads, d) for t in qkv.split(heads * d, dim=-1))
    k[:, kv:] = float("nan")
    v[:, kv:] = float("nan")
    scale = d**-0.5
    stats = torch.empty(b, heads, n, 2, device="cuda")
    if kernel == "qkv_attention":
        out, stats = mha_kernel._launch(qkv, heads, scale, kv, with_stats=True)
        out = out.view(b, n, heads, d)
        ref = mha_kernel.mha_qkv_attention_reference(qkv, heads, valid_len=kv).view(b, n, heads, d)
    elif kernel == "mha_attention":
        out = mha_kernel._launch_mha(q, k, v, scale, kv, stats)
        ref = mha_kernel.mha_attention_reference(q, k, v, valid_len=kv)
    else:
        out = attention._launch(q, k, v, causal, scale, kv, stats)
        ref = attention.flash_attention_reference(q, k, v, causal=causal, valid_len=kv)
    return qkv, q, k, v, out, stats, ref


@pytest.mark.parametrize("kernel,b,n,heads,d,valid_len,causal", [
    ("qkv_attention", 2, 1100, 12, 64, 1025, False),
    ("qkv_attention", 1, 300, 4, 128, 300, False),
    ("mha_attention", 2, 1664, 12, 64, 1601, False),
    ("mha_attention", 1, 1030, 2, 256, 1025, False),
    ("flash_attention", 1, 9344, 2, 64, 9217, False),
    ("flash_attention", 1, 1100, 2, 128, 1050, True),
    ("flash_attention", 1, 1100, 2, 256, 1050, True),
])
def test_fp32_forward_kernels_match_plain_versions(cuda, kernel, b, n, heads, d, valid_len,
                                                   causal):
    """K1, K3 and K4 in fp32 against their plain versions: outputs on the
    rows below valid_len, NaN in the pad keys kept out, row statistics."""
    from denseclip_vit_multimodal_tpu_torch.tools.time_fwd_trees import (
        STATS_L_TOL,
        STATS_M_TOL,
        plain_stats,
        stats_errors,
    )

    counter = f"{kernel}_fp32"
    before = {**mha_kernel.LAUNCHES, **attention.LAUNCHES}[counter]
    _, q, k, v, out, stats, ref = _fp32_case(kernel, b, n, heads, d, valid_len, causal, 31)
    torch.cuda.synchronize()
    assert {**mha_kernel.LAUNCHES, **attention.LAUNCHES}[counter] == before + 1
    assert out.dtype == torch.float32 and torch.isfinite(out[:, :valid_len]).all()
    err = out[:, :valid_len] - ref[:, :valid_len]
    assert float(err.abs().max()) <= FP32_MAX_TOL
    assert float(err.norm() / ref[:, :valid_len].norm()) <= FP32_REL_TOL
    errs = stats_errors(stats[:, :, :valid_len],
                        plain_stats(q[:, :valid_len], k, valid_len, d**-0.5,
                                    prescaled=kernel != "flash_attention", causal=causal))
    assert errs["stats_m_max_abs_err"] <= STATS_M_TOL
    assert errs["stats_l_max_rel_err"] <= STATS_L_TOL


@pytest.mark.parametrize("kernel,b,n,heads,d,valid_len,causal", [
    ("qkv_attention", 4, 1664, 12, 64, 1601, False),
    ("qkv_attention", 1, 300, 4, 128, 290, False),
    ("mha_attention", 1, 1030, 2, 256, 1025, False),
    ("flash_attention", 1, 9344, 2, 64, 9217, False),
    ("flash_attention", 1, 2048, 4, 64, 2000, True),
    ("flash_attention", 1, 1100, 2, 256, 1050, True),
])
def test_fp32_backward_kernels_match_plain_versions(cuda, kernel, b, n, heads, d, valid_len,
                                                    causal):
    """K2, K3's backward and K4b in fp32 against their plain versions on the
    fp32 forward's output and statistics, per gradient; keys past valid_len
    get exactly 0 (their rows hold NaN), and a rerun is bitwise the same."""
    qkv, q, k, v, out, stats, _ = _fp32_case(kernel, b, n, heads, d, valid_len, causal, 32)
    gen = torch.Generator(device="cuda").manual_seed(33)
    dout = torch.randn(b, n, heads, d, generator=gen, device="cuda")
    scale, hd = d**-0.5, heads * d
    if kernel == "qkv_attention":
        do2 = dout.reshape(b, n, hd)
        bwd = lambda: mha_kernel._launch_bwd(qkv, out.reshape(b, n, hd), do2, stats, heads,
                                             scale, valid_len).split(hd, dim=-1)
        want = mha_kernel.mha_qkv_attention_bwd_reference(
            qkv, out.reshape(b, n, hd), do2, heads, valid_len=valid_len).split(hd, dim=-1)
        rows = n
    elif kernel == "mha_attention":
        bwd = lambda: mha_kernel._launch_mha_bwd(q, k, v, out, dout, stats, scale, valid_len)
        want = mha_kernel.mha_attention_bwd_reference(q, k, v, out, dout, valid_len=valid_len)
        rows = n
    else:
        bwd = lambda: attention._launch_bwd(q, k, v, out, dout, stats, causal, scale, valid_len)
        want = attention.flash_attention_bwd_reference(q, k, v, out, dout, causal=causal,
                                                       valid_len=valid_len)
        rows = valid_len
    counter = f"{kernel}_bwd_fp32"
    before = {**mha_kernel.LAUNCHES, **attention.LAUNCHES}[counter]
    got, again = tuple(bwd()), tuple(bwd())
    torch.cuda.synchronize()
    assert {**mha_kernel.LAUNCHES, **attention.LAUNCHES}[counter] == before + 2
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
    assert all(torch.isfinite(g[:, :valid_len]).all() for g in got)
    _assert_grads_close(got, want, rows, valid_len, FP32_BWD_REL_TOL, FP32_BWD_MAX_TOL)
    assert not got[1][:, valid_len:].any() and not got[2][:, valid_len:].any()


# ---- the softmax knobs and the fp32 K6 / K7 ----

KNOB_CASES = [  # (kernel, dtype, knob, valid_len): None at a ragged N is JAX's zero-pad branch
    ("qkv", torch.float32, "DENSECLIP_FAST_EXP2", 1201), ("qkv", torch.float32,
                                                          "DENSECLIP_FAST_EXP2", None),
    ("qkv", torch.bfloat16, "DENSECLIP_FAST_EXP2", 1201), ("qkv", torch.bfloat16,
                                                           "DENSECLIP_FAST_EXP2", None),
    ("qkv", torch.bfloat16, "DENSECLIP_EXP_BF16", 1201),
    ("mha", torch.float32, "DENSECLIP_FAST_EXP2", 1201),
    ("mha", torch.bfloat16, "DENSECLIP_FAST_EXP2", None),
    ("mha", torch.bfloat16, "DENSECLIP_EXP_BF16", 1201),
]


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.parametrize("kernel,dtype,knob,valid_len", KNOB_CASES)
def test_knob_kernels_match_plain_versions(cuda, monkeypatch, kernel, dtype, knob, valid_len):
    """K1 / K3 (forward) and K2 / K3's backward under a knob, through the
    wrappers and autograd, against their plain versions in the same mode: the
    variant's counter moves, the limits hold, and (fp32, and EXP_BF16's bf16
    outputs) the kernel is at most a fifth as far from the plain version in
    the mode as from the knob-off one, on the rows the caller keeps (bf16
    outputs hide FAST_EXP2's polynomial under their rounding: chip_smoke.py
    holds its row sums)."""
    n, heads, d = 1236, 4, 64
    monkeypatch.setenv(knob, "1")
    qkv = _qkv(1, n, heads, d, seed=41).to(dtype)
    fwd_mode, bwd_mode = mha_kernel.softmax_modes(kernel, dtype, n, valid_len)
    rows = valid_len or n
    x = qkv.clone().requires_grad_(True)
    before = dict(mha_kernel.LAUNCHES)
    if kernel == "qkv":
        out = mha_kernel.mha_qkv_attention(x, heads, valid_len=valid_len)
        plain = lambda m: mha_kernel.mha_qkv_attention_reference(qkv, heads, valid_len=valid_len,
                                                                 exp_mode=m)
    else:
        view = lambda t: t.view(1, n, heads, d)
        out = view(mha_kernel.mha_attention(*(view(t) for t in x.split(heads * d, dim=-1)),
                                            valid_len=valid_len)).reshape(1, n, -1)
        plain = lambda m: mha_kernel.mha_attention_reference(
            *(view(t) for t in qkv.split(heads * d, dim=-1)), valid_len=valid_len,
            exp_mode=m).reshape(1, n, -1)
    dout = torch.randn(out.shape, device="cuda").to(dtype)
    out.backward(dout)
    torch.cuda.synchronize()
    counter = mha_kernel.kernel_name(f"{kernel}_attention", dtype, fwd_mode)
    assert mha_kernel.LAUNCHES[counter] >= before[counter] + 1
    bwd_counter = mha_kernel.kernel_name(f"{kernel}_attention_bwd", dtype, bwd_mode)
    assert mha_kernel.LAUNCHES[bwd_counter] == before[bwd_counter] + 1
    want, want_off = plain(fwd_mode)[:, :rows], plain(mha_kernel.EXP_EXACT)[:, :rows]
    got = out.detach()[:, :rows]
    rel_lim, max_lim = (FP32_REL_TOL, FP32_MAX_TOL) if dtype == torch.float32 else (5e-3, KERNEL_TOL)
    assert _rel(got, want) <= rel_lim and float((got - want).float().abs().max()) <= max_lim
    if dtype == torch.float32 or knob == "DENSECLIP_EXP_BF16":
        assert 5 * _rel(got, want) <= _rel(got, want_off)
    ref = qkv.clone().requires_grad_(True)  # the plain backward in the backward's mode
    if kernel == "qkv":
        out_b = mha_kernel.mha_qkv_attention_reference(ref.detach(), heads, valid_len=valid_len,
                                                       exp_mode=bwd_mode)
        want_g = mha_kernel.mha_qkv_attention_bwd_reference(
            ref.detach(), out_b, dout, heads, valid_len=valid_len, exp_mode=bwd_mode)
    else:
        qs = [view(t) for t in qkv.split(heads * d, dim=-1)]
        out_b = mha_kernel.mha_attention_reference(*qs, valid_len=valid_len, exp_mode=bwd_mode)
        want_g = torch.cat([g.reshape(1, n, -1) for g in mha_kernel.mha_attention_bwd_reference(
            *qs, out_b, view(dout), valid_len=valid_len, exp_mode=bwd_mode)], dim=-1)
    tol = (FP32_BWD_REL_TOL, FP32_BWD_MAX_TOL) if dtype == torch.float32 else (BWD_REL_TOL,
                                                                                BWD_MAX_TOL)
    _assert_grads_close(x.grad.split(heads * d, dim=-1), want_g.split(heads * d, dim=-1), n,
                        rows, *tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fast", [False, True])
def test_lnqkv_kernels_in_fp32_and_under_fast_exp2(cuda, monkeypatch, dtype, fast):
    """K6 in fp32 (and bf16) with and without DENSECLIP_FAST_EXP2 against its
    plain version in the same mode; its variant's counter moves."""
    monkeypatch.setenv("DENSECLIP_FAST_EXP2", str(int(fast)))
    x, gamma, beta, w, bias = _lnqkv_inputs(2, 333, 256, 43)
    x = x.to(dtype)
    mode = mha_kernel.EXP_POLY if fast else mha_kernel.EXP_EXACT
    counter = mha_kernel.kernel_name("ln_qkv_attention", dtype, mode)
    before = lnqkv_kernel.LAUNCHES[counter]
    got = lnqkv_kernel.ln_qkv_attention(x, gamma, beta, w, bias, 4, valid_len=320)[:, :320]
    want = lnqkv_kernel.ln_qkv_attention_reference(x, gamma, beta, w, bias, 4, valid_len=320,
                                                   exp_mode=mode)[:, :320]
    assert lnqkv_kernel.LAUNCHES[counter] == before + 1
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= FP32_MAX_TOL and _rel(got, want) <= FP32_REL_TOL
    else:
        assert float((got - want).float().abs().max()) <= KERNEL_TOL and _rel(got, want) <= 5e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fast,valid_len", [(False, 300), (True, 300), (True, None)])
def test_outproj_kernels_in_fp32_and_under_fast_exp2(cuda, monkeypatch, dtype, fast, valid_len):
    """K7 in fp32 (and bf16) with and without DENSECLIP_FAST_EXP2 (None at N
    333: the script's zero pads) against its plain version in the same mode."""
    monkeypatch.setenv("DENSECLIP_FAST_EXP2", str(int(fast)))
    qkv = _qkv(2, 333, 4, 64, seed=44).to(dtype)
    gen = torch.Generator(device="cuda").manual_seed(45)
    w = (torch.randn(256, 256, generator=gen, device="cuda") * 0.05).to(dtype)
    mode = mha_kernel.softmax_modes("qkv_out", dtype, 333, valid_len)[0]
    counter = mha_kernel.kernel_name("qkv_out_attention", dtype, mode)
    before = exp_outproj_epilogue.LAUNCHES[counter]
    got = exp_outproj_epilogue.qkv_out_attention(qkv, w, 4, valid_len=valid_len)
    want = exp_outproj_epilogue.qkv_out_attention_reference(qkv, w, 4, valid_len=valid_len,
                                                            exp_mode=mode)
    assert exp_outproj_epilogue.LAUNCHES[counter] == before + 1
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= FP32_MAX_TOL and _rel(got, want) <= FP32_REL_TOL
    else:
        assert _rel(got, want) <= 5e-3
