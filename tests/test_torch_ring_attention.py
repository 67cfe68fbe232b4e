"""Sequence-parallel ring attention (`parallel/ring_attention.py`) on the CPU.

Two spawned Gloo ranks (`torch_ddp.py`, one spawn for the file) run
`ring_attention` on the same q, k, v and are held in fp32 to the JAX
package's `ring_attention` over conftest's 8 virtual devices at a shape with
a key shard that is all pad (N 40, valid 17: the second rank's keys 20-39),
and to JAX's single-device attention at N 32 (JAX's ring tests hold its ring
to it): the output and dq / dk / dv of sum(out ** 2), at `torch_parity`'s
module limits.  The block arithmetic (K3's plain version with its statistics, the
merge, the backward under the merged statistics) runs in process over JAX's
eight shards, against the same results.  The tiny seg+depth
ViT built with `ring`, with a different row on each rank (the data axis),
gives each rank the one-process port's outputs and backbone gradients on its
row; the one-process port is held to JAX's ring by
`test_torch_ring_fallback.py`.  A stack given [B, N] that differ between
the ranks raises ValueError on every rank instead of hanging.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from denseclip_vit_multimodal_tpu.models.layers import _xla_attention
from denseclip_vit_multimodal_tpu.parallel.ring_attention import ring_attention as j_ring
from denseclip_vit_multimodal_tpu_torch.parallel import mesh as port_mesh
from denseclip_vit_multimodal_tpu_torch.parallel import ring_attention as t_ring

import torch_ddp
from test_torch_ddp_step import VIT
from torch_parity import assert_parity, randn

# B, N, H, D, valid_len, JAX's devices: its ring over 8 (the pad-only shard), or one
CASES = [(2, 32, 2, 8, None, 0), (2, 40, 2, 8, 17, 8)]
ROWS = [[0], [1]]  # the rank's rows of the model's batch
# per-rank [B, N] given to a stack built with `ring`: N differs, B differs, equal
MISMATCHED = [[(2, 10), (2, 12)], [(2, 10), (1, 10)], [(2, 10), (2, 10)]]


def _qkv(case, seed):
    b, n, h, d = case[:4]
    return {x: randn(b, n, h, d, seed=seed + i) for i, x in enumerate("qkv")}


def _jax_ring(arrays, valid_len, devices):
    """JAX's ring over `devices` devices (none: JAX's single-device
    `_xla_attention`, which its own ring tests hold the ring to): the output
    and the gradients of sum(out ** 2)."""
    mesh = Mesh(np.asarray(jax.devices()[:devices or 1]), ("sp",))

    def loss(q, k, v):
        if devices:
            out = j_ring(q, k, v, mesh, axis_name="sp", valid_len=valid_len)
        else:
            out = _xla_attention(q, k, v, causal=False, valid_len=valid_len)
        return jnp.sum(out ** 2), out

    args = [jnp.asarray(arrays[x]) for x in "qkv"]
    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def runs():
    cases = [dict(_qkv(c, seed=10 * i), valid_len=c[4]) for i, c in enumerate(CASES)]
    model, _ = torch_ddp._model(VIT, seed=4)
    images = np.random.RandomState(7).rand(2, 64, 96, 3).astype(np.float32) * 255.0
    model_payload = {"task": "ring_model_rows", "cfg": VIT, "state_dict": model.state_dict(),
                     "images": images, "rows": ROWS}
    mismatch = {"task": "ring_rows_mismatch", "shapes": MISMATCHED}
    ranks = torch_ddp.start({"cases": {"task": "ring_cases", "cases": cases},
                             "model": model_payload, "mismatch": mismatch}, world=2)
    want = [_jax_ring(c, c["valid_len"], case[5]) for c, case in zip(cases, CASES)]
    one = [torch_ddp.ring_model_rows(0, 1, {**model_payload, "as_rank": r}) for r in range(2)]
    return cases, want, ranks.join(), one


@pytest.mark.parametrize("index", range(len(CASES)))
def test_ring_over_two_ranks_matches_jax_ring_over_eight_devices(runs, index):
    """Index 0 against JAX's single-device attention, 1 against its ring."""
    _, want, ranks, _ = runs
    want_out, want_grads = want[index]
    for r in ranks:
        got = r["cases"][index]
        assert_parity(want_out, got["out"], what="out")
        for name, w, g in zip("qkv", want_grads, got["grads"]):
            assert_parity(w, g, what=f"d{name}")


def test_ring_model_rows_match_one_process(runs):
    """Each rank's row through the ViT built with `ring` over 2 ranks (25
    tokens padded to 26, valid 25): outputs and backbone gradients are the
    one-process port's on that row."""
    _, _, ranks, one = runs
    for r, got in enumerate(ranks):
        want = one[r]
        for key in ("seg", "depth"):
            assert_parity(want[key].numpy(), got["model"][key], what=key)
        assert set(got["model"]["grads"]) == set(want["grads"])
        for name, g in want["grads"].items():
            assert_parity(g.numpy(), got["model"]["grads"][name], what=name)


def test_ring_refuses_rows_that_differ_between_ranks(runs):
    """[B, N] that differ between the ranks raise ValueError on every rank
    before any attention call (one exchange of the shapes a forward of the
    stack), and equal ones run."""
    _, _, ranks, _ = runs
    for r in ranks:
        *refused, ran = r["mismatch"]
        assert ran is None
        for text in refused:
            assert text is not None and "same rows and sequence length on every rank" in text


@pytest.mark.parametrize("index", range(len(CASES)))
def test_block_arithmetic_over_simulated_shards_matches_jax(runs, index):
    """Eight shards in one process: each query shard's blocks (K3's
    plain version with statistics; a shard past `valid_len` skipped) merged,
    then each block's backward under the merged statistics, summed."""
    cases, want, _, _ = runs
    want_out, want_grads = want[index]
    valid_len = cases[index]["valid_len"]
    q, k, v = (torch.from_numpy(cases[index][x]) for x in "qkv")
    shards = 8
    n = q.shape[1] // shards
    part = lambda x, i: x[:, i * n:(i + 1) * n]
    scale = q.shape[-1] ** -0.5
    outs, stats = [], []
    for i in range(shards):
        merged = t_ring.empty_merge(part(q, i))
        for j in range(shards):
            kv_len = t_ring.shard_kv_len(valid_len, j, n)
            if kv_len:
                merged = t_ring.merge_block(merged, *t_ring.block_forward(
                    part(q, i), part(k, j), part(v, j), scale, kv_len))
        o, st = t_ring.merged_output(merged, q.dtype)
        outs.append(o)
        stats.append(st)
    assert_parity(want_out, torch.cat(outs, dim=1), what="out")
    grads = [torch.zeros_like(x) for x in (q, k, v)]
    for i in range(shards):
        for j in range(shards):
            kv_len = t_ring.shard_kv_len(valid_len, j, n)
            if kv_len:
                gq, gk, gv = t_ring.block_backward(part(q, i), part(k, j), part(v, j), outs[i],
                                                   2 * outs[i], stats[i], scale, kv_len)
                part(grads[0], i).add_(gq)
                part(grads[1], j).add_(gk)
                part(grads[2], j).add_(gv)
    for name, w, g in zip("qkv", want_grads, grads):
        assert_parity(w, g, what=f"d{name}")


def test_indivisible_sequence_rejected(monkeypatch):
    """JAX's assertion: pad and pass valid_len."""
    q = torch.zeros(1, 25, 2, 8)
    monkeypatch.setattr(port_mesh, "group_size", lambda group: 8)
    with pytest.raises(AssertionError, match=r"sequence 25 not divisible by ring axis \(8\); "
                                             r"pad and pass valid_len"):
        t_ring.ring_attention(q, q, q)


def test_current_ring_mesh_in_one_process():
    """No group: `current_ring_mesh` is None (the dispatch takes `auto`),
    and a pinned group is the ring's while pinned."""
    assert t_ring.current_ring_mesh() is None
    marker = object()
    with t_ring.ring_mesh(marker):
        assert t_ring.current_ring_mesh() is marker
    assert t_ring.current_ring_mesh() is None
