"""The port's FLOP accounting (`utils/flops.py`) against the JAX package's
analytic terms and against FlopCounterMode's count of each kernel's plain
version.  The make-up counts of launched kernels are checked on the card by
`tests/test_torch_flops_cuda.py`."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from denseclip_vit_multimodal_tpu.utils import flops as j_flops
from denseclip_vit_multimodal_tpu_torch.ops import attention, lnqkv_kernel, mha_kernel
from denseclip_vit_multimodal_tpu_torch.models.layers import set_attn_impl
from denseclip_vit_multimodal_tpu_torch.models.vit import CLIPVisionTransformer
from denseclip_vit_multimodal_tpu_torch.tools import exp_outproj_epilogue
from denseclip_vit_multimodal_tpu_torch.utils import flops


@pytest.mark.parametrize("layers,width,batch,tokens", [
    (12, 768, 10, 1522), (12, 768, 10, 1601), (4, 96, 2, 33), (24, 1024, 4, 2026),
    (1, 128, 1, 1), (12, 768, 1, 8193)])
def test_analytic_terms_equal_jax(layers, width, batch, tokens):
    assert flops.vit_layer_dense_flops(batch * tokens, width) == \
        j_flops.vit_layer_dense_flops(batch * tokens, width)
    assert flops.vit_layer_attn_flops(batch, tokens, width) == \
        j_flops.vit_layer_attn_flops(batch, tokens, width)
    for counted in (False, True):
        assert flops.vit_backbone_flop_correction(layers, width, batch, tokens, counted) == \
            j_flops.vit_backbone_flop_correction(layers, width, batch, tokens,
                                                 attn_counted=counted)
    # the port's attention term over full scores is JAX's
    assert flops.attention_flops(batch, tokens, tokens, width) == \
        j_flops.vit_layer_attn_flops(batch, tokens, width)


def _counted(fn, *args, **kwargs) -> int:
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return int(counter.get_total_flops())


def _randn(rs, *shape):
    return torch.from_numpy(rs.randn(*shape).astype(np.float32))


# (batch, n, heads, head_dim, valid_len): one shape with valid_len < N each
SHAPES = [(2, 96, 2, 64, None), (1, 200, 3, 64, 150)]


def _plain_and_formula(kernel, b, n, heads, d, valid_len):
    rs = np.random.RandomState(n)
    hd = heads * d
    kv = n if valid_len is None else valid_len
    attn = flops.attention_flops(b, n, kv, hd)
    if kernel == "K1":
        return (lambda: mha_kernel.mha_qkv_attention_reference(
            _randn(rs, b, n, 3 * hd), heads, valid_len=valid_len)), attn
    if kernel in ("K3", "K4"):
        q, k, v = (_randn(rs, b, n, heads, d) for _ in range(3))
        ref = (mha_kernel.mha_attention_reference if kernel == "K3"
               else attention.flash_attention_reference)
        return (lambda: ref(q, k, v, valid_len=valid_len)), attn
    if kernel == "K5":
        return (lambda: mha_kernel.mha_qkv_attention_int8_reference(
            _randn(rs, b, n, 3 * hd), heads, valid_len=valid_len)), attn
    if kernel in ("K6", "K6 projection"):
        dim = hd
        args = (_randn(rs, b, n, dim), _randn(rs, dim), _randn(rs, dim),
                _randn(rs, dim, 3 * hd) * 0.05, _randn(rs, 3 * hd), heads)
        proj = flops.projection_flops(b, n, dim, 3 * hd)
        if kernel == "K6":
            return (lambda: lnqkv_kernel.ln_qkv_attention_reference(
                *args, valid_len=valid_len)), proj + attn
        return (lambda: lnqkv_kernel.ln_qkv_projection_reference(*args)), proj
    assert kernel == "K7"
    qkv, w = _randn(rs, b, n, 3 * hd), _randn(rs, hd, hd)
    return (lambda: exp_outproj_epilogue.qkv_out_attention_reference(
        qkv, w, heads, valid_len=valid_len)), attn + flops.projection_flops(b, n, hd, hd)


@pytest.mark.parametrize("shape", SHAPES, ids=["full", "valid_len<N"])
@pytest.mark.parametrize("kernel", ["K1", "K3", "K4", "K5", "K6", "K6 projection", "K7"])
def test_kernel_formula_equals_flop_counter_of_plain_version(kernel, shape):
    """Each kernel's make-up is what FlopCounterMode counts of its plain
    version at the same shapes: K6 with its qkv projection, K7 with its
    out-projection, K5 as if bf16."""
    plain, formula = _plain_and_formula(kernel, *shape)
    assert _counted(plain) == formula


@pytest.mark.parametrize("hw", [(64, 128), (512, 528)], ids=["33 tokens", "1057 -> 1152 tokens"])
def test_backbone_count_is_layers_times_dense_and_attention_plus_patches(hw):
    """The tiny ViT's FlopCounterMode count: every layer's dense and
    attention terms at the padded token count (plain attention scores all N
    × N), plus the patch embedding (a [p·p·3, W] projection per patch)."""
    layers, width, heads, patch = 4, 96, 3, 16
    vit = CLIPVisionTransformer(patch_size=patch, width=width, layers=layers, heads=heads,
                                out_indices=(layers - 1,)).eval()
    b, (h, w) = 2, hw
    grid = (h // patch) * (w // patch)
    n = grid + 1
    n_pad = -(-n // 128) * 128 if n >= 1024 else n
    x = torch.from_numpy(np.random.RandomState(0).randn(b, h, w, 3).astype(np.float32))
    with torch.inference_mode():
        got = flops.program_flops(vit, x)
    want = (layers * (flops.vit_layer_dense_flops(b * n_pad, width)
                      + flops.vit_layer_attn_flops(b, n_pad, width))
            + flops.projection_flops(b, grid, patch * patch * 3, width))
    assert got == (want, 0, {})


def _bf16_vit(attn_impl="auto"):
    """Width 128 / 2 heads: head dim 64, the kernels' regime in bf16."""
    vit = CLIPVisionTransformer(patch_size=16, width=128, layers=2, heads=2,
                                out_indices=(1,), dtype=torch.bfloat16).eval()
    set_attn_impl(vit, attn_impl)
    return vit


ROUTES = [("auto", False), ("int8", False), ("auto", True)]
ROUTE_IDS = ["K1", "K5", "K6"]
# the plain version each route's kernel branch runs on the CPU
ROUTE_PLAIN = {"K1": (mha_kernel, "mha_qkv_attention_reference"),
               "K5": (mha_kernel, "int8_attention_plain"),
               "K6": (lnqkv_kernel, "ln_qkv_attention_reference")}


def _image(seed, h, w):
    return torch.from_numpy(np.random.RandomState(seed).randn(1, h, w, 3).astype(np.float32))


@pytest.mark.parametrize("attn_impl,fused", ROUTES, ids=ROUTE_IDS)
def test_program_flops_same_with_kernel_branches_taken(monkeypatch, attn_impl, fused):
    """On the CPU the kernel branches (`_on_cuda` patched) run the plain
    versions, which FlopCounterMode counts, and launch nothing, so the tally
    adds nothing: at 1024 tokens (no padding) the count is the plain
    attention route's, exactly."""
    monkeypatch.setenv("DENSECLIP_FUSED_LNQKV", "1" if fused else "0")
    vit = _bf16_vit(attn_impl)
    x = _image(1, 496, 528).bfloat16()  # 31 x 33 + 1 = 1024 tokens
    with torch.inference_mode():
        plain = flops.program_flops(vit, x)
        monkeypatch.setattr(attention, "_on_cuda", lambda t: True)
        branches = flops.program_flops(vit, x)
    assert branches == plain and plain.kernels == 0 and not plain.by_kernel


@pytest.mark.parametrize("attn_impl,fused", ROUTES, ids=ROUTE_IDS)
def test_kernel_branches_count_valid_keys_where_plain_attention_counts_all(
        monkeypatch, attn_impl, fused):
    """At 1057 tokens (padded to 1152) the kernel routes score N × kv_len,
    plain attention, which masks the pad keys, N × N: the gap is exactly
    that, layer by layer.  Each layer took the route's kernel branch."""
    monkeypatch.setenv("DENSECLIP_FUSED_LNQKV", "1" if fused else "0")
    vit = _bf16_vit(attn_impl)
    x = _image(2, 512, 528).bfloat16()
    module, name = ROUTE_PLAIN[ROUTE_IDS[ROUTES.index((attn_impl, fused))]]
    calls, plain_version = [], getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or plain_version(*a, **k))
    with torch.inference_mode():
        plain = flops.program_flops(vit, x)
        monkeypatch.setattr(attention, "_on_cuda", lambda t: True)
        branches = flops.program_flops(vit, x)
    assert len(calls) == 2  # both layers, in the second count only
    gap = 2 * flops.attention_flops(1, 1152, 1152 - 1057, 128)
    assert plain.total - branches.total == gap


def test_tally_records_launches_only_while_open():
    flops.record_kernel_flops("k", 7)  # no tally open: dropped
    with flops.kernel_tally() as outer:
        flops.record_kernel_flops("k", 5)
        with flops.kernel_tally() as inner:
            flops.record_kernel_flops("j", 3)
    assert outer == [("k", 5), ("j", 3)] and inner == [("j", 3)]
    assert not flops._OPEN_TALLIES

    def launches(x):
        flops.record_kernel_flops("k", 11)
        flops.record_kernel_flops("k", 2)
        flops.record_kernel_flops("prologue", 0)
        return x @ x

    got = flops.program_flops(launches, torch.ones(4, 4))
    assert got == (128, 13, {"k": 13, "prologue": 0}) and got.total == 141


def test_peak_lookup_by_card_name(monkeypatch):
    assert flops.peak_bf16_tflops("NVIDIA H100 80GB HBM3") == 989.4
    with pytest.raises(KeyError, match="no bf16 peak"):
        flops.peak_bf16_tflops("NVIDIA GeForce GTX 1080")
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert flops.device_peak_bf16_tflops() == 989.4
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "Some Card")
    with pytest.raises(KeyError):
        flops.device_peak_bf16_tflops(0)
