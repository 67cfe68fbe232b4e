"""K6 in fp32 on the CPU emulation, in its default (exact) mode.

`csrc/ln_qkv_attention_fp32.cu` (the statistics pass; the 3xTF32 product
`csrc/gemm_fp32.cuh` with the LayerNorm applied to each A chunk before its
split; K1's fp32 body on `csrc/attention_fp32.cuh`) compiled by the host
compiler against `tests/cuda_emu/` (`tests/torch_cuda_emu.py::_build`), each
entry against its plain version: the whole kernel against
`ln_qkv_attention_reference`, its first stage alone (`ln_qkv_projection_fp32`)
with the statistics bitwise `ln_qkv_stats_reference`'s and the workspace
against `ln_qkv_projection_reference`, and the stages one at a time, each
bitwise the whole kernel's.  Row counts that are not a multiple of the
product's 128-row tile, q/k/v widths that are not a multiple of its
128-column tile, widths of 2, 3 and 5 k-tiles (the ring of two stages
wraps), head dim 64 and 128, NaN in x's pad rows, and rows past the last
left untouched.  The plain versions are held against the JAX kernel in
`tests/test_torch_lnqkv_kernel.py`.
"""

import shutil

import numpy as np
import pytest
import torch

from denseclip_vit_multimodal_tpu_torch.ops import lnqkv_kernel
from torch_cuda_emu import LOG2E, _build

FP32_MAX, FP32_REL = 1e-4, 1e-5  # outputs against the plain versions (the card's limits)
EPS = 1e-5


@pytest.fixture(scope="module")
def k6(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs a C++20 host compiler (g++)")
    lib = _build("ln_qkv_attention_fp32", tmp_path_factory.mktemp("cuda_emu_fp32_fused"))
    return lnqkv_kernel.bind_fp32_entry_points(lib)


def _inputs(b, n, dim, hd, kv, seed):
    """x (NaN in the rows at or past kv), gamma, beta, W^T [3*hd, dim] at the
    scale of the model's init, bias."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, n, dim).astype(np.float32))
    x[:, kv:] = float("nan")
    gamma = torch.from_numpy(1.0 + 0.1 * rng.randn(dim).astype(np.float32))
    beta = torch.from_numpy(0.1 * rng.randn(dim).astype(np.float32))
    limit = (6.0 / (4 * dim)) ** 0.5
    wt = torch.from_numpy(((rng.rand(3 * hd, dim) * 2 - 1) * limit).astype(np.float32))
    bias = torch.from_numpy(0.02 * rng.randn(3 * hd).astype(np.float32))
    return x, gamma, beta, wt, bias


def _assert_close(got, want):
    got, want = got.double(), want.double()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= FP32_MAX
    assert float((got - want).norm() / want.norm()) <= FP32_REL


def _nan(*shape, spare=0):
    """A NaN buffer of `shape` with `spare` NaN rows of its last dim after it."""
    flat = torch.full((int(np.prod(shape)) + spare * shape[-1],), float("nan"))
    return flat, flat[: int(np.prod(shape))].view(*shape)


@pytest.mark.parametrize("b,n,dim,heads,d,kv", [
    (2, 75, 96, 1, 64, 70),     # 150 rows, 192 columns, 3 k-tiles
    (1, 140, 64, 1, 128, 133),  # head dim 128, 384 columns, 2 k-tiles
    (1, 130, 160, 2, 64, 130),  # 2 heads, 5 k-tiles, every key valid
])
def test_k6_fp32_and_its_stages(k6, b, n, dim, heads, d, kv):
    x, gamma, beta, wt, bias = _inputs(b, n, dim, heads * d, kv, seed=n + dim)
    hd, rows, q_scale = heads * d, b * n, d**-0.5 * LOG2E
    params = [t.data_ptr() for t in (x, gamma, beta, wt, bias)]
    ws_flat, ws = _nan(b, n, 3 * hd, spare=64)
    out_flat, out = _nan(b, n, hd, spare=64)

    def whole():
        return k6["attention"](*params, ws.data_ptr(), out.data_ptr(), b, n, dim, heads, d, kv,
                               q_scale, EPS, 0, None)

    assert whole() == 0
    want = lnqkv_kernel.ln_qkv_attention_reference(x, gamma, beta, wt.t(), bias, heads,
                                                   valid_len=kv)
    _assert_close(out[:, :kv], want[:, :kv])
    assert torch.isnan(ws_flat[rows * 3 * hd:]).all() and torch.isnan(out_flat[rows * hd:]).all()
    first = [out.clone(), ws.clone()]
    out.fill_(float("nan"))
    assert whole() == 0
    assert torch.equal(out[:, :kv], first[0][:, :kv])
    assert torch.equal(ws[:, :kv], first[1][:, :kv])

    # the first stage alone: statistics bitwise, the workspace within the limits
    _, stats = _nan(rows, 2)
    _, ws2 = _nan(b, n, 3 * hd)
    assert k6["projection"](*params, stats.data_ptr(), ws2.data_ptr(), rows, dim, hd, q_scale,
                            EPS, None) == 0
    want_stats = lnqkv_kernel.ln_qkv_stats_reference(x)
    assert torch.equal(stats.view(b, n, 2)[:, :kv], want_stats[:, :kv])
    plain_ws = lnqkv_kernel.ln_qkv_projection_reference(x, gamma, beta, wt.t(), bias, heads)
    _assert_close(ws2[:, :kv], plain_ws[:, :kv])
    assert torch.equal(ws2[:, :kv], ws[:, :kv])

    # the stages one at a time, each bitwise the whole kernel's
    _, stats3 = _nan(rows, 2)
    _, ws3 = _nan(b, n, 3 * hd)
    _, out3 = _nan(b, n, hd)
    assert k6["stats"](x.data_ptr(), stats3.data_ptr(), rows, dim, EPS, None) == 0
    assert torch.equal(stats3.view(b, n, 2)[:, :kv], stats.view(b, n, 2)[:, :kv])
    assert k6["gemm"](*params, stats3.data_ptr(), ws3.data_ptr(), rows, dim, hd, q_scale,
                      None) == 0
    assert torch.equal(ws3[:, :kv], ws[:, :kv])
    assert k6["stage2"](ws3.data_ptr(), out3.data_ptr(), b, n, heads, d, kv, None) == 0
    assert torch.equal(out3[:, :kv], out[:, :kv])


def test_k6_fp32_entries_refuse_what_they_do_not_take(k6):
    """A width that is not a multiple of the 32-deep k-tile, head dim 32,
    q/k/v widths that are not a multiple of 64, kv_len outside [1, N]:
    cudaErrorInvalidValue (1), nothing launched."""
    x, gamma, beta, wt, bias = (torch.zeros(s) for s in ((1, 8, 96), (96,), (96,), (192, 96),
                                                          (192,)))
    ptrs = [t.data_ptr() for t in (x, gamma, beta, wt, bias)]
    ws, out, stats = torch.zeros(1, 8, 192), torch.zeros(1, 8, 64), torch.zeros(8, 2)
    run = lambda dim, heads, d, kv: k6["attention"](*ptrs, ws.data_ptr(), out.data_ptr(), 1, 8,
                                                    dim, heads, d, kv, 1.0, EPS, 0, None)
    assert run(80, 1, 64, 8) == 1
    assert run(96, 2, 32, 8) == 1
    assert run(96, 1, 64, 9) == 1 and run(96, 1, 64, 0) == 1
    assert k6["projection"](*ptrs, stats.data_ptr(), ws.data_ptr(), 8, 96, 32, 1.0, EPS,
                            None) == 1
    assert k6["stats"](x.data_ptr(), stats.data_ptr(), 8, 80, EPS, None) == 1
    assert k6["gemm"](*ptrs, stats.data_ptr(), ws.data_ptr(), 8, 96, 96, 1.0, None) == 1
    assert k6["stage2"](ws.data_ptr(), out.data_ptr(), 1, 8, 2, 32, 8, None) == 1
