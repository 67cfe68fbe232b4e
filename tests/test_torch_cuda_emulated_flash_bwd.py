"""The flash backward source (`csrc/flash_attention_bwd.cu`, K4b) and every
backward source's bitwise rerun and entry-point refusals, run on the CPU
against the emulation in `tests/cuda_emu/` (see
`tests/test_torch_cuda_emulated.py`).  Split from
`tests/test_torch_cuda_emulated.py` by source: the cases are unchanged.
"""

import pytest
import torch

from torch_cuda_emu import (  # noqa: F401  (libs: a fixture)
    _assert_grads_close,
    _run_flash,
    _run_mha,
    libs,
)


@pytest.mark.parametrize("b,n,heads,d,kv,causal", [
    (1, 150, 2, 64, 140, False),  # pad rows: dq = 0, no share in dk / dv
    (1, 200, 1, 64, 200, True),
    (1, 140, 1, 128, 120, True),
    (2, 130, 1, 64, 130, False),  # batch 2, no pad rows
    (1, 300, 1, 64, 290, True),  # causal over three 128-row blocks, with pad keys
    (1, 100, 1, 256, 90, True),  # head dim 256: two dk/dv passes, the bundled policy
    (1, 130, 1, 256, 120, False),
])
def test_flash_backward_source_matches_plain_version(libs, b, n, heads, d, kv, causal):
    got, want = _run_flash(libs["flash"], b, n, heads, d, kv, causal)
    _assert_grads_close(got, want, kv, kv)
    assert not got[0][:, kv:].any()  # pad rows' dq


@pytest.mark.parametrize("kernel,d,causal", [
    ("mha", 64, False),
    ("mha", 256, False),  # the dk/dv kernel's two passes
    ("flash", 64, True),
])
def test_backward_sources_are_bitwise_deterministic(libs, kernel, d, causal):
    """A second call on the same inputs gives the same gradients bit for bit:
    the kernels have no atomics, so every sum runs in one order."""
    run = ((lambda: _run_mha(libs["mha"], 1, 150, 1, d, 140)) if kernel == "mha"
           else (lambda: _run_flash(libs["flash"], 1, 150, 1, d, 140, causal)))
    (first, want), (second, _) = run(), run()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    _assert_grads_close(first, want, 150 if kernel == "mha" else 140, 140)


def test_entry_points_refuse_what_the_kernels_do_not_take(libs):
    """Head dim 256 in K2 (K1 takes 64 / 128), head dim 32 in K2 and K4b,
    and kv_len outside [1, N] return cudaErrorInvalidValue (1) before any
    launch."""
    args = lambda d, kv: [None] * 7 + [1, 64, 1, d, kv, 1.0, 1.0, None]
    assert libs["qkv"](*args(256, 64)) == 1
    assert libs["qkv"](*args(32, 64)) == 1
    assert libs["qkv"](*args(64, 65)) == 1
    flash = lambda d, kv: libs["flash"](*([None] * 9 + [0] * 9 + [1, 64, 1, d, kv, 0, 1.0, None]))
    assert flash(32, 64) == 1 and flash(64, 0) == 1 and flash(64, 65) == 1
