"""The one-shot and fused-qkv backward sources, run on the CPU:
`csrc/qkv_attention_bwd.cu` (K3's backward, K2) on its core
`csrc/attention_bwd.cuh`, compiled against the CPU emulation in
`tests/cuda_emu/` (see `tests/test_torch_cuda_emulated.py`), at small shapes
that reach every branch, each gradient held to the chip's limits against the
port's plain version and masked keys to exactly 0.  Split from
`tests/test_torch_cuda_emulated.py` by source: the cases are unchanged.
"""

import pytest
import torch

from torch_cuda_emu import (  # noqa: F401  (libs: a fixture)
    LOG2E,
    _assert_grads_close,
    _inputs,
    _row_stats,
    _run_mha,
    libs,
    mha_kernel,
)


@pytest.mark.parametrize("b,n,heads,d,kv", [
    (1, 150, 2, 64, 140),  # ragged tiles, pad keys; pad rows reach dk / dv
    (1, 140, 1, 128, 133),
    (1, 100, 1, 256, 90),  # head dim 256: 4 warps, 32-row tiles, dk then dv
    (2, 140, 1, 64, 140),  # batch 2, no pad keys: every chunk but the last unmasked
])
def test_oneshot_backward_source_matches_plain_version(libs, b, n, heads, d, kv):
    got, want = _run_mha(libs["mha"], b, n, heads, d, kv)
    _assert_grads_close(got, want, n, kv)


def _run_qkv(fn, b, n, heads, d, kv, seed):
    qkv, q, k, v, dout = _inputs(b, n, heads, d, seed=seed)
    scale, hd = d**-0.5, heads * d
    out = mha_kernel.mha_qkv_attention_reference(qkv, heads, valid_len=kv)
    stats = _row_stats(q, k, kv, scale, True)
    dqkv = torch.full_like(qkv, float("nan"))
    dcoef, scratch = torch.empty(b, heads, n), torch.empty(2, b, heads, n, d, dtype=torch.bfloat16)
    dout = dout.reshape(b, n, hd)
    err = fn(qkv.data_ptr(), out.data_ptr(), dout.data_ptr(), stats.data_ptr(),
             dcoef.data_ptr(), scratch.data_ptr(), dqkv.data_ptr(), b, n, heads, d, kv,
             scale * LOG2E, scale, None)
    assert err == 0
    want = mha_kernel.mha_qkv_attention_bwd_reference(qkv, out, dout, heads, valid_len=kv)
    split = lambda x: [t.view(b, n, heads, d) for t in x.split(hd, dim=-1)]
    return split(dqkv), split(want)


def test_fused_qkv_backward_source_matches_plain_version(libs):
    got, want = _run_qkv(libs["qkv"], 1, 130, 2, 64, 100, seed=5)
    _assert_grads_close(got, want, 130, 100)


@pytest.mark.parametrize("b,n,heads,d,kv", [
    (1, 140, 1, 128, 133),  # head dim 128: qkv's column blocks of 3 * 128
    (2, 70, 1, 64, 70),  # batch 2, one ragged tile, no pad keys
])
def test_fused_qkv_backward_source_at_more_shapes(libs, b, n, heads, d, kv):
    got, want = _run_qkv(libs["qkv"], b, n, heads, d, kv, seed=n + d)
    _assert_grads_close(got, want, n, kv)

