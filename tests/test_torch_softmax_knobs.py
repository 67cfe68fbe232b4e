"""The JAX package's softmax knobs in the port: `DENSECLIP_FAST_EXP2` (the
polynomial exp2) and `DENSECLIP_EXP_BF16` (the bf16 exp pass).

Each knob-reading plain version of the port (K1, K2 through autograd, K3,
K3's backward, K6, K7), under each knob JAX makes it read, against the JAX
function under the same knob: the JAX module's import-time constants
(`_FAST_EXP2`, `_EXP_BF16`) are patched and the compile caches cleared, the
port's environment variables set; the Pallas kernels run in interpret mode.
The check must see the knob: the port's distance to JAX under the knob is
held to a fifth of its distance to JAX without it, besides the limits.
Also: `exp2_poly` bitwise against JAX's `_exp2_poly`, the bf16 exp against
XLA's, the zero-pad branch where EXP_BF16 changes nothing, K4 and K5
unchanged, and an exported program keeping the mode it was traced with.
The kernels themselves are held to these plain versions on the card
(`chip_smoke.py` phase `knobs_path`, `tests/test_torch_cuda.py`) and under
the CPU emulation (`tests/test_torch_cuda_emulated_knobs.py`).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseclip_vit_multimodal_tpu.ops import lnqkv_kernel as j_lnqkv
from denseclip_vit_multimodal_tpu.ops import mha_kernel as j_mha
from denseclip_vit_multimodal_tpu_torch.ops import attention as t_attention
from denseclip_vit_multimodal_tpu_torch.ops import lnqkv_kernel as t_lnqkv
from denseclip_vit_multimodal_tpu_torch.ops import mha_kernel as t_mha
from denseclip_vit_multimodal_tpu_torch.tools import exp_outproj_epilogue as t_exp

ROOT = Path(__file__).resolve().parents[1]
FAST, EBF16 = "DENSECLIP_FAST_EXP2", "DENSECLIP_EXP_BF16"
# ROADMAP's fp32 limits: outputs max abs and relative L2; gradients relative L2
OUT_MAX, OUT_REL, GRAD_REL = 1e-4, 1e-5, 1e-4
# bf16 outputs (PERF.md §2)
BF16_MAX, BF16_REL = 2e-2, 5e-3
SEES = 5.0  # the distance to JAX without the knob over the distance with it, at least
# scale * log2 e = 1/8 exactly: JAX rounds the constant to bf16 (weak typing),
# the port keeps it in fp32; a power of two makes the two q operands equal
EXACT_SCALE = 0.125 / 1.4426950408889634


@pytest.fixture
def knobs(monkeypatch):
    """set(fast, bf16): both knobs on both sides, JAX's caches cleared."""

    def set_knobs(fast: bool = False, bf16: bool = False) -> None:
        monkeypatch.setattr(j_mha, "_FAST_EXP2", fast)
        monkeypatch.setattr(j_mha, "_EXP_BF16", bf16)
        monkeypatch.setenv(FAST, str(int(fast)))
        monkeypatch.setenv(EBF16, str(int(bf16)))
        jax.clear_caches()

    yield set_knobs
    jax.clear_caches()  # the patches are undone after the test: drop what they compiled


@pytest.fixture(scope="module")
def jax_exp():
    spec = importlib.util.spec_from_file_location("jax_exp_outproj_epilogue",
                                                  ROOT / "tools" / "exp_outproj_epilogue.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _dist(got, want) -> tuple:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want)), float(np.abs(got - want).max())


def _assert_sees_knob(port, jax_on, jax_off, rel_lim, max_lim):
    """port within the limits of JAX under the knob, and at most a fifth as
    far from it as from JAX without the knob."""
    on, off = _dist(port, jax_on), _dist(port, jax_off)
    assert on[0] <= rel_lim and on[1] <= max_lim, (on, off)
    assert on[0] * SEES <= off[0], (on, off)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


# ---- the exp functions ----


def test_exp2_poly_is_bitwise_jax():
    """`exp2_poly` equals JAX's `_exp2_poly` bit for bit, evaluated op by op
    (its definition): a dense grid over [-140, 0], x <= -126 (the clamp), the
    integers (xf = 0), -0.0 and the floats next to them (fractions next to
    1).  Under jit, XLA's CPU backend fuses the cubic into FMAs and differs
    by an ulp on some arguments; the port's kernels round each operation, as
    the definition does."""
    ints = np.arange(-130, 1, dtype=np.float32)
    grid = np.concatenate([
        np.linspace(-140, 0, 40001, dtype=np.float32), ints,
        np.nextafter(ints, np.float32(-np.inf)), np.nextafter(ints, np.float32(np.inf)),
        np.array([-0.0, -126.0, -126.5, -1e30, -3.4e38, -1e-7, -1e-30], np.float32)])
    want = np.asarray(j_mha._exp2_poly(jnp.asarray(grid))).view(np.int32)
    got = t_mha.exp2_poly(torch.from_numpy(grid)).numpy().view(np.int32)
    assert np.array_equal(got, want)


def test_bf16_exp_against_xla():
    """EXP_BF16's exp: bf16(exp2(bf16(x))).  XLA's CPU backend lowers a bf16
    exp2 as exp(x * ln 2) in bf16: ln 2 rounded to bf16 (2.5e-3 relative)
    and the product rounded to bf16 (2^-8), so the exponent is off by up to
    |x| 4.5e-3 and the two agree bit for bit on a share of the arguments
    only (11% over [-40, 0]).  Per element they differ by at most
    expm1(|x| 4.5e-3) + 2^-7, relative (both results rounded to bf16)."""
    x = -np.linspace(0, 40, 20001, dtype=np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jnp.exp2(xb).astype(jnp.float32))
    got = t_mha.softmax_exp(torch.from_numpy(x), t_mha.EXP_BF16).numpy()
    xr = np.asarray(xb.astype(jnp.float32))
    bound = (np.expm1(np.abs(xr) * 4.5e-3) + 2.0**-7) * np.maximum(got, want)
    assert np.all(np.abs(got - want) <= bound)
    assert np.mean(got == want) > 0.1  # bitwise where XLA's rounding allows


def test_softmax_modes_follow_jax(monkeypatch):
    """Which mode each kernel takes, as JAX reads the knobs."""
    f32, b16 = torch.float32, torch.bfloat16
    modes = t_mha.softmax_modes
    for fast, bf16 in ((0, 0), (1, 0), (0, 1), (1, 1)):
        monkeypatch.setenv(FAST, str(fast))
        monkeypatch.setenv(EBF16, str(bf16))
        poly = t_mha.EXP_POLY if fast else t_mha.EXP_EXACT
        zeroed = t_mha.EXP_POLY_ZEROED if fast else t_mha.EXP_EXACT
        ebf = t_mha.EXP_BF16 if bf16 else poly
        assert modes("qkv", b16, 300, 290) == (ebf, poly)  # K1's mask branch
        assert modes("qkv", b16, 256, None) == (ebf, poly)  # N a multiple of 128
        assert modes("qkv", b16, 300, None) == (zeroed, zeroed)  # zeroed pads
        assert modes("qkv", f32, 300, 290) == (poly, poly)  # EXP_BF16: bf16 only
        assert modes("mha", b16, 300, None) == (ebf, zeroed)  # K3 masks; its backward not
        assert modes("ln_qkv", b16, 300, None)[0] == poly  # K6: FAST_EXP2 only
        assert modes("qkv_out", f32, 300, None)[0] == zeroed  # K7 pads with zeros
        assert modes("qkv_out", b16, 300, 290)[0] == poly


# ---- K1, K2 ----


@pytest.mark.parametrize("valid_len", [290, None])  # JAX's mask branch; its zero-pad branch
def test_k1_fp32_fast_exp2(knobs, valid_len):
    qkv = np.random.RandomState(1).randn(2, 300, 3 * 128).astype(np.float32) * 2
    rows = valid_len or 300
    run_j = lambda: np.asarray(j_mha.mha_qkv_attention(jnp.asarray(qkv), 2, interpret=True,
                                                       valid_len=valid_len))[:, :rows]
    off = run_j()
    knobs(fast=True)
    on = run_j()
    port = _np(t_mha.mha_qkv_attention(torch.from_numpy(qkv), 2, valid_len=valid_len))[:, :rows]
    _assert_sees_knob(port, on, off, OUT_REL, OUT_MAX)


def test_k1_bf16_fast_exp2(knobs):
    """bf16 outputs see the polynomial once both sides form the same q
    (`EXACT_SCALE`)."""
    qkv = np.random.RandomState(2).randn(2, 300, 3 * 128).astype(np.float32) * 3
    x = jnp.asarray(qkv, jnp.bfloat16)
    run_j = lambda: np.asarray(j_mha.mha_qkv_attention(
        x, 2, sm_scale=EXACT_SCALE, interpret=True, valid_len=290).astype(jnp.float32))[:, :290]
    off = run_j()
    knobs(fast=True)
    on = run_j()
    port = _np(t_mha.mha_qkv_attention(torch.from_numpy(qkv).to(torch.bfloat16), 2,
                                       sm_scale=EXACT_SCALE, valid_len=290))[:, :290]
    _assert_sees_knob(port, on, off, BF16_REL, BF16_MAX)


def _xla_bf16_exp(x: torch.Tensor, exp_mode: int) -> torch.Tensor:
    """`softmax_exp` with EXP_BF16 as XLA's CPU backend computes JAX's
    interpreted kernel: exp(bf16(bf16(x) * bf16(ln 2))), left in fp32 (XLA
    keeps the excess precision until P is cast for P V)."""
    if exp_mode != t_mha.EXP_BF16:
        return _SOFTMAX_EXP(x, exp_mode)
    ln2 = torch.tensor(np.log(2.0), dtype=torch.bfloat16)
    return torch.exp((x.to(torch.bfloat16) * ln2).float())


_SOFTMAX_EXP = t_mha.softmax_exp


@pytest.mark.parametrize("kernel", ["k1", "k3"])
def test_exp_bf16_structure_matches_jax(knobs, monkeypatch, kernel):
    """K1's mask branch and K3 under EXP_BF16 (bf16): bf16 (s - m), the bf16
    exp's p summed in fp32 for the denominator, P V on those p.  With XLA's
    CPU lowering of the bf16 exp2 substituted for the port's exp (see
    `test_bf16_exp_against_xla`), the port lands on JAX's kernel; without
    the knob on either side it does not."""
    qkv = np.random.RandomState(3).randn(2, 300, 3 * 128).astype(np.float32) * 3
    x = jnp.asarray(qkv, jnp.bfloat16)
    t = torch.from_numpy(qkv).to(torch.bfloat16)
    if kernel == "k1":
        run_j = lambda: j_mha.mha_qkv_attention(x, 2, sm_scale=EXACT_SCALE, interpret=True,
                                                valid_len=290)
        run_t = lambda: t_mha.mha_qkv_attention(t, 2, sm_scale=EXACT_SCALE, valid_len=290)
    else:
        heads = lambda a: a.reshape(2, 300, 2, 64)
        jq, jk, jv = (heads(a) for a in jnp.split(x, 3, axis=-1))
        tq, tk, tv = (heads(a) for a in t.split(128, dim=-1))
        run_j = lambda: j_mha.mha_attention(jq, jk, jv, sm_scale=EXACT_SCALE, interpret=True,
                                            valid_len=290)
        run_t = lambda: t_mha.mha_attention(tq, tk, tv, sm_scale=EXACT_SCALE, valid_len=290)
    off = np.asarray(run_j().astype(jnp.float32)).reshape(2, 300, -1)[:, :290]
    knobs(bf16=True)
    on = np.asarray(run_j().astype(jnp.float32)).reshape(2, 300, -1)[:, :290]
    monkeypatch.setattr(t_mha, "softmax_exp", _xla_bf16_exp)
    port = _np(run_t()).reshape(2, 300, -1)[:, :290]
    _assert_sees_knob(port, on, off, BF16_REL, BF16_MAX)


def test_exp_bf16_leaves_the_zero_pad_branch(knobs):
    """JAX's K1 reads EXP_BF16 in its mask branch only: without valid_len at
    a ragged N (the zero-pad branch) the output is bitwise the knob-off
    one, on both sides."""
    qkv = np.random.RandomState(4).randn(1, 200, 3 * 128).astype(np.float32)
    x, t = jnp.asarray(qkv, jnp.bfloat16), torch.from_numpy(qkv).to(torch.bfloat16)
    run_j = lambda: np.asarray(j_mha.mha_qkv_attention(x, 2, interpret=True).astype(jnp.float32))
    j_off, t_off = run_j(), t_mha.mha_qkv_attention(t, 2)
    knobs(bf16=True)
    assert np.array_equal(run_j(), j_off)
    assert torch.equal(t_mha.mha_qkv_attention(t, 2), t_off)
    assert t_mha.softmax_modes("qkv", torch.bfloat16, 200, None)[0] == t_mha.EXP_EXACT


def _grads_k1(qkv: np.ndarray, valid_len, dout: np.ndarray):
    jg = jax.grad(lambda a: jnp.sum(j_mha.mha_qkv_attention(a, 2, interpret=True,
                                                            valid_len=valid_len) * dout))
    want = np.asarray(jg(jnp.asarray(qkv)))
    x = torch.from_numpy(qkv).requires_grad_(True)
    t_mha.mha_qkv_attention(x, 2, valid_len=valid_len).backward(torch.from_numpy(dout))
    return _np(x.grad), want


@pytest.mark.parametrize("valid_len", [290, None])
def test_k2_fp32_fast_exp2_through_autograd(knobs, valid_len):
    """K2's plain version (through `QKVAttentionFunction`) against `jax.grad`
    of JAX's K1 (its VJP is the interpreted `_bwd_kernel`), fp32, under
    FAST_EXP2: the polynomial p from the row max (floored at 0 in the
    zero-pad branch, as JAX's backward over its zero keys)."""
    rs = np.random.RandomState(5)
    qkv = rs.randn(2, 300, 3 * 128).astype(np.float32) * 2
    dout = rs.randn(2, 300, 128).astype(np.float32)
    if valid_len:
        dout[:, valid_len:] = 0  # rows past valid_len are left to the caller
    _, off = _grads_k1(qkv, valid_len, dout)
    knobs(fast=True)
    port, on = _grads_k1(qkv, valid_len, dout)
    _assert_sees_knob(port, on, off, GRAD_REL, np.inf)


def test_k2_exp_bf16_backward_takes_the_exact_softmax(knobs):
    """Under EXP_BF16 JAX's backward recomputes its fp32-exp softmax: the
    port's backward reruns K1 in that mode for the output and statistics,
    so its gradients equal the knob-off ones bit for bit, while the forward
    moved."""
    rs = np.random.RandomState(6)
    qkv = torch.from_numpy(rs.randn(1, 256, 3 * 128).astype(np.float32)).to(torch.bfloat16)
    dout = torch.from_numpy(rs.randn(1, 256, 128).astype(np.float32)).to(torch.bfloat16)

    def run():
        x = qkv.clone().requires_grad_(True)
        out = t_mha.mha_qkv_attention(x, 2, valid_len=250)
        out.backward(dout)
        return out.detach(), x.grad

    out_off, grad_off = run()
    knobs(bf16=True)
    out_on, grad_on = run()
    assert not torch.equal(out_on, out_off)
    assert torch.equal(grad_on, grad_off)


# ---- K3 and its backward ----


def _bnhd(qkv: np.ndarray, n: int):
    return [a.reshape(1, n, 2, 64) for a in np.split(qkv, 3, axis=-1)]


@pytest.mark.parametrize("valid_len", [190, None])  # None at N 200: JAX's backward pads with zeros
def test_k3_and_its_backward_fp32_fast_exp2(knobs, valid_len):
    rs = np.random.RandomState(7)
    q, k, v = _bnhd(rs.randn(1, 200, 3 * 128).astype(np.float32) * 2, 200)
    dout = rs.randn(1, 200, 2, 64).astype(np.float32)
    rows = valid_len or 200

    def run_j():
        f = lambda a, b, c: j_mha.mha_attention(a, b, c, interpret=True, valid_len=valid_len)
        out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(dout))]

    out_off, grads_off = run_j()
    knobs(fast=True)
    out_on, grads_on = run_j()
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = t_mha.mha_attention(tq, tk, tv, valid_len=valid_len)
    out.backward(torch.from_numpy(dout))
    _assert_sees_knob(_np(out)[:, :rows], out_on[:, :rows], out_off[:, :rows], OUT_REL, OUT_MAX)
    for g, on, off in zip((tq.grad, tk.grad, tv.grad), grads_on, grads_off):
        assert _dist(_np(g), on)[0] <= GRAD_REL
        assert _dist(_np(g), on)[0] * SEES <= _dist(_np(g), off)[0]


def test_flash_attention_k3_branch_reads_the_knob_and_k4_does_not(knobs):
    """The port's `flash_attention`: its K3 branch (non-causal, N <= 8448)
    under FAST_EXP2 equals K3's plain version in that mode; its K4 branch
    (causal) reads neither knob, bit for bit."""
    rs = np.random.RandomState(8)
    q, k, v = (torch.from_numpy(a) for a in _bnhd(rs.randn(1, 200, 3 * 128).astype(np.float32),
                                                   200))
    k4_off = t_attention.flash_attention(q, k, v, causal=True)
    knobs(fast=True, bf16=True)
    want = t_mha.mha_attention_reference(q, k, v, exp_mode=t_mha.EXP_POLY)
    assert torch.equal(t_attention.flash_attention(q, k, v), want)
    assert torch.equal(t_attention.flash_attention(q, k, v, causal=True), k4_off)


# ---- K5 ----


def test_k5_forward_unchanged_and_its_backward_follows_k2(knobs):
    """K5 (int8) reads neither knob: bitwise the knob-off output.  Its
    straight-through backward is K1 + K2 of the unquantized qkv, which read
    FAST_EXP2: its gradient is K2's under the knob."""
    rs = np.random.RandomState(9)
    qkv = torch.from_numpy(rs.randn(1, 200, 3 * 128).astype(np.float32))
    dout = torch.from_numpy(rs.randn(1, 200, 128).astype(np.float32))
    off = t_mha.mha_qkv_attention_int8(qkv, 2, valid_len=190)
    knobs(fast=True, bf16=True)
    assert torch.equal(t_mha.mha_qkv_attention_int8(qkv, 2, valid_len=190), off)
    x = qkv.clone().requires_grad_(True)
    t_mha.mha_qkv_attention_int8(x, 2, valid_len=190).backward(dout)
    out = t_mha.mha_qkv_attention_reference(qkv, 2, valid_len=190, exp_mode=t_mha.EXP_POLY)
    want = t_mha.mha_qkv_attention_bwd_reference(qkv, out, dout, 2, valid_len=190,
                                                 exp_mode=t_mha.EXP_POLY)
    assert torch.equal(x.grad, want)


# ---- K6 (the repair) and K7 ----


def _k6_inputs():
    """The case the repair was found on: fp32, B 2, N 200, D 128, 2 heads."""
    rng = np.random.RandomState(0)
    return (rng.randn(2, 200, 128).astype(np.float32), rng.rand(128).astype(np.float32) + 0.5,
            rng.randn(128).astype(np.float32) * 0.1,
            rng.randn(128, 384).astype(np.float32) * 0.05,
            rng.randn(384).astype(np.float32) * 0.01)


def test_k6_fp32_reads_fast_exp2(knobs):
    """JAX's K6 reads FAST_EXP2 (`_softmax_unnormalized` -> `_exp2`): the
    port's K6, through its wrapper, under the knob lands on JAX's under the
    knob within the fp32 limits, and sees the knob.  (Before the port read
    it, its K6 ignored the knob: 1.9e-5 rel. L2 from JAX's.)"""
    args = _k6_inputs()
    run_j = lambda: np.asarray(j_lnqkv.ln_qkv_attention(*(jnp.asarray(a) for a in args), 2,
                                                        interpret=True, valid_len=190))[:, :190]
    off = run_j()
    knobs(fast=True)
    on = run_j()
    port = _np(t_lnqkv.ln_qkv_attention(*(torch.from_numpy(a) for a in args), 2,
                                        valid_len=190))[:, :190]
    _assert_sees_knob(port, on, off, OUT_REL, OUT_MAX)
    plain = t_lnqkv.ln_qkv_attention_reference(*(torch.from_numpy(a) for a in args), 2,
                                               valid_len=190, exp_mode=t_mha.EXP_POLY)
    assert np.array_equal(port, _np(plain)[:, :190])


@pytest.mark.parametrize("valid_len", [None, 190])  # the script's zero pads; its iota mask
def test_k7_fp32_fast_exp2(knobs, jax_exp, valid_len):
    rs = np.random.RandomState(10)
    qkv = rs.randn(2, 200, 3 * 128).astype(np.float32) * 2
    w = (rs.randn(128, 128) * 0.05).astype(np.float32)
    rows = valid_len or 200
    run_j = lambda: np.asarray(jax_exp.qkv_out_attention(
        jnp.asarray(qkv), jnp.asarray(w), 2, interpret=True, valid_len=valid_len))[:, :rows]
    off = run_j()
    knobs(fast=True)
    on = run_j()
    port = _np(t_exp.qkv_out_attention(torch.from_numpy(qkv), torch.from_numpy(w), 2,
                                       valid_len=valid_len))[:, :rows]
    _assert_sees_knob(port, on, off, OUT_REL, OUT_MAX)


# ---- an exported program keeps its mode ----


def test_exported_program_keeps_its_traced_mode(knobs):
    """`torch.export` bakes the exp mode the wrapper resolved while tracing
    (the op's trailing int), as JAX bakes its import-time constants: the
    program traced under FAST_EXP2 keeps the polynomial after the knob is
    unset, and the knob-off one keeps exp2 after it is set."""

    class K1(torch.nn.Module):
        def forward(self, qkv):
            return t_mha.mha_qkv_attention(qkv, 2, valid_len=190)

    qkv = torch.from_numpy(np.random.RandomState(11).randn(1, 200, 384).astype(np.float32))
    poly = t_mha.mha_qkv_attention_reference(qkv, 2, valid_len=190, exp_mode=t_mha.EXP_POLY)
    exact = t_mha.mha_qkv_attention_reference(qkv, 2, valid_len=190)
    knobs(fast=True)
    traced_on = torch.export.export(K1(), (qkv,))
    knobs()
    traced_off = torch.export.export(K1(), (qkv,))
    assert torch.equal(traced_on.module()(qkv), poly)
    knobs(fast=True)
    assert torch.equal(traced_off.module()(qkv), exact)
    assert not torch.equal(poly, exact)
