"""GPipe over a `pipe` axis (`parallel/pipeline.py`) on the CPU.

Two spawned Gloo ranks (`torch_ddp.py`, one spawn for the file) run
`pipeline_blocks` on `tests/test_pipeline.py`'s toy (8 layers, 4 rows) over
`{pipe: 2}` at 2 and 4 microbatches, against the JAX package's
`pipeline_blocks` on `{pipe: 2, data: 4}`: the taps on every rank, the
gradients of each stage's layers and of the input.  The same ranks take one
SGD step of the seg+depth ViT (`torch_shard_cases.py`'s, 2 layers: one a
stage) under `tpu.mesh: {pipe: 2}` with `tpu.pipeline: {microbatches: 2}`,
held to JAX's step as `test_torch_tp_step.py` holds tensor parallelism (the
loss, every parameter's update, the BatchNorm statistics; JAX's
`test_pp_train_step_matches_dp` asserts the loss and `contexts`); under
`tpu.remat` too; four ranks take the same step under `{data: 2, pipe: 2}`
(a second spawn, started beside the first).  In process: the context and config functions against
JAX's, the replicated fallback's warning, causal stacks never pipelining,
and the data-first check.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseclip_vit_multimodal_tpu.parallel import pipeline as j_pipe
from denseclip_vit_multimodal_tpu.parallel.mesh import make_mesh
from denseclip_vit_multimodal_tpu_torch.models import layers as t_layers
from denseclip_vit_multimodal_tpu_torch.parallel import mesh as port_mesh
from denseclip_vit_multimodal_tpu_torch.parallel import pipeline as t_pipe

import torch_ddp
import torch_shard_cases as cases
from test_torch_ddp_step import _batch

MICROBATCHES = (2, 4)
MESH = {"pipe": 2}
DATA_PIPE = {"data": 2, "pipe": 2}


def _toy():
    """`tests/test_pipeline.py`'s toy, as numpy."""
    n_layers, b, n, d = 8, 4, 6, 16
    rng = np.random.RandomState(0)
    return {"w": (rng.randn(n_layers, d, d) * 0.2).astype(np.float32),
            "b": (rng.randn(n_layers, d) * 0.1).astype(np.float32),
            "x": rng.randn(b, n, d).astype(np.float32),
            "rates": np.linspace(0.0, 0.5, n_layers).astype(np.float32)}


def _jax_toy(toy, m):
    """JAX's pipeline on the toy: taps and the gradients of w, b, x."""
    mesh = make_mesh({"pipe": 2, "data": 4})
    block = lambda p, h, aux, mb_idx=0: jnp.tanh(h @ p[0] + p[1] + aux)
    rates = jnp.asarray(toy["rates"])

    def loss(params, x):
        t = j_pipe.pipeline_blocks(block, params, x, rates, mesh, microbatches=m)
        return (t[-1] ** 2).sum() + t.sum(), t

    (_, taps), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        (jnp.asarray(toy["w"]), jnp.asarray(toy["b"])), jnp.asarray(toy["x"]))
    return {"taps": np.asarray(taps), "w": np.asarray(grads[0][0]),
            "b": np.asarray(grads[0][1]), "x": np.asarray(grads[1])}


@pytest.fixture(scope="module")
def runs():
    toy = _toy()
    cfg = cases.vit()
    jm, texts, params, stats, state_dict = cases.weights(cfg, seed=3)
    batch = _batch(8, cases.HW, True, 5)
    step = {"task": "pipelined_steps", "cfg": cfg, "state_dict": state_dict, "mesh": MESH,
            "microbatches": 2, "batches": [batch], "training": cases.training(),
            "frozen": cases.FROZEN, "aug": cases.AUG}
    odd = {**step, "batches": [],
           "odd_rows": np.random.RandomState(8).rand(3, *cases.HW, 3).astype(np.float32)}
    dropout = {**step, "cfg": _with_head_dropout(cfg), "seed": 11}
    ranks = torch_ddp.start({"toy": {"task": "pipeline_toy", **toy,
                                     "microbatches": MICROBATCHES},
                             "step": step, "remat": {**step, "remat": True},
                             "dropout": dropout, "odd": odd}, world=2)
    data_pipe = torch_ddp.start({"step": {**step, "mesh": DATA_PIPE}}, world=4)
    want = {m: _jax_toy(toy, m) for m in MICROBATCHES}
    want_step = cases.jax_step(jm, texts, params, stats, batch, MESH, False)
    want_dropout = torch_ddp.pipelined_steps(0, 1, dropout)
    want_odd = torch_ddp.pipelined_steps(0, 1, odd)["odd"]
    return (want, want_step, ranks.join(), state_dict, want_dropout, want_odd,
            data_pipe.join())


def _with_head_dropout(cfg):
    return {**cfg, "decode_head": {**cfg["decode_head"], "dropout_ratio": 0.5},
            "depth_head": {**cfg["depth_head"], "dropout_ratio": 0.5}}


@pytest.mark.parametrize("m", MICROBATCHES)
def test_pipeline_blocks_match_jax(runs, m):
    """Every rank gets all 8 taps; each stage holds the gradients of its 4
    layers (the others' are not read there), and every rank the input's."""
    want, _, ranks, *_ = runs
    w_grad, b_grad = np.zeros_like(want[m]["w"]), np.zeros_like(want[m]["b"])
    for r in ranks:
        got = r["toy"][m]
        np.testing.assert_allclose(got["taps"].numpy(), want[m]["taps"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["x"].numpy(), want[m]["x"], rtol=1e-4, atol=1e-5)
        mine = slice(4 * got["stage"], 4 * got["stage"] + 4)
        others = np.ones(8, bool)
        others[mine] = False
        assert not got["w"].numpy()[others].any() and not got["b"].numpy()[others].any()
        w_grad[mine], b_grad[mine] = got["w"].numpy()[mine], got["b"].numpy()[mine]
    assert sorted(r["toy"][m]["stage"] for r in ranks) == [0, 1]
    np.testing.assert_allclose(w_grad, want[m]["w"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(b_grad, want[m]["b"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", ["step", "remat"])
def test_pipelined_step_matches_jax(runs, case):
    """One SGD step over `{pipe: 2}` (a block a stage, 2 microbatches of 4
    rows): JAX's loss, every parameter's update (`contexts` among them, as
    JAX's `test_pp_train_step_matches_dp` asserts), the frozen text tower
    unchanged, the BatchNorm statistics; the one-process file put together
    from the stages, the same on both ranks; each rank holds its block."""
    _, want, ranks, initial, *_ = runs
    assert [r[case]["fallbacks"] for r in ranks] == [0, 0]  # the stack ran as a pipeline
    cases.check_against_jax(want, [r[case] for r in ranks], initial)
    held = [r[case]["resident"][0] for r in ranks]
    full = sum(v.numel() for k, v in initial.items()
               if not k.endswith(("running_mean", "running_var", "num_batches_tracked")))
    block = sum(v.numel() for k, v in initial.items() if k.startswith("backbone.transformer."))
    assert held == [full - block // 2] * 2


def test_data_by_pipe_step_matches_jax(runs):
    """One SGD step over `{data: 2, pipe: 2}` (4 ranks: each data rank's 4
    rows in 2 microbatches, its two stages a block each), the depth loss on
    (SILog at JAX's weight 0.1): JAX's loss, every parameter's update (the
    depth head's among them), the BatchNorm statistics over the data axis.
    JAX's step on the same global batch is the reference, as for `{pipe: 2}`
    (JAX's `test_pp_train_step_matches_dp` holds its dp x pp step to it)."""
    _, want, _, initial, *_ = runs
    ranks = [r["step"] for r in runs[6]]
    assert [r["fallbacks"] for r in ranks] == [0] * 4  # the stack ran as a pipeline
    assert "loss_silog" in ranks[0]["metrics"][0]
    cases.check_against_jax(want, ranks, initial)
    full = sum(v.numel() for k, v in initial.items()
               if not k.endswith(("running_mean", "running_var", "num_batches_tracked")))
    block = sum(v.numel() for k, v in initial.items() if k.startswith("backbone.transformer."))
    assert [r["resident"][0] for r in ranks] == [full - block // 2] * 4


def test_pipelined_step_draws_the_heads_dropout_of_one_process(runs):
    """With the heads' dropout on (and no drop path) the pipeline leaves the
    step's generator as the plain stack does: the replicated heads draw the
    one-process port's masks, so the loss and the state are its."""
    want, ranks = runs[4], runs[2]
    for r in ranks:
        got = r["dropout"]
        assert got["metrics"][0]["loss_total"] == pytest.approx(
            want["metrics"][0]["loss_total"], rel=cases.TOL_LOSS)
        for key, value in want["state"].items():
            np.testing.assert_allclose(got["state"][key].numpy(), value.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=key)


def test_indivisible_batch_runs_the_staged_blocks_replicated(runs):
    """3 rows at 2 microbatches on a state whose blocks live on their
    stages: the stack warns and runs replicated, each block broadcast from
    its stage; the one-process port's segmentation and, from the
    broadcast's backward, its blocks' gradients (each put together from its
    stage)."""
    ranks, want = runs[2], runs[5]
    for r in ranks:
        got = r["odd"]["odd"]
        np.testing.assert_allclose(got["seg"].numpy(), want["seg"].numpy(), rtol=1e-4, atol=1e-5)
        assert set(got["grads"]) == set(want["grads"])
        for name, g in want["grads"].items():
            np.testing.assert_allclose(got["grads"][name].numpy(), g.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=name)


def test_context_and_config_functions_match_jax():
    """`test_pipeline.py`'s context plumbing, in both packages."""
    for spec, micro in (({"pipe": 2, "data": 4}, 2), ({"pipe": 1, "data": 8}, None)):
        with j_pipe.activate_pipeline(make_mesh(spec), microbatches=micro):
            want = j_pipe.current_pipeline()
        with t_pipe.activate_pipeline(spec, microbatches=micro):
            got = t_pipe.current_pipeline()
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.stages, got.microbatches) == (want.stages, want.microbatches)
    assert t_pipe.current_pipeline() is None
    for tpu, spec in (({"pipeline": {"microbatches": 4}}, {"pipe": 2, "data": 4}),
                      ({}, {"pipe": 2, "data": 4}), ({"pipeline": {}}, {"data": 8})):
        with j_pipe.pipeline_from_config(tpu, make_mesh(spec)):
            want = j_pipe.current_pipeline()
        with t_pipe.pipeline_from_config(tpu, spec):
            got = t_pipe.current_pipeline()
        assert (got is None) == (want is None)
        if got is not None:
            assert got.microbatches == want.microbatches
    try:
        assert t_pipe.enable_pipeline_from_config({"pipeline": {}}, {"pipe": 2, "data": 4})
        assert t_pipe.current_pipeline().stages == 2
        assert t_pipe.enable_pipeline_from_config({"pipeline": {"microbatches": 8}},
                                                  {"pipe": 4, "data": 2})
        assert (t_pipe.current_pipeline().stages, t_pipe.current_pipeline().microbatches) == (4, 8)
        assert not t_pipe.enable_pipeline_from_config({}, {"pipe": 2, "data": 4})
        assert t_pipe.current_pipeline() is None
    finally:
        t_pipe.enable_pipeline_from_config({}, {})
    with pytest.raises(ValueError, match="has no 'pipe' axis"):
        t_pipe.PipelineContext({"data": 8})


def test_pipeline_blocks_rejects_indivisible():
    toy = _toy()
    _, _, layers = torch_ddp.toy_layers(toy)
    x = torch.from_numpy(toy["x"])
    with pytest.raises(ValueError, match="batch 4 not divisible by 3 microbatches"):
        t_pipe.pipeline_blocks(torch_ddp.toy_block, layers, x, toy["rates"], MESH,
                               microbatches=3)
    with pytest.raises(ValueError, match="7 layers not divisible by 2 pipeline stages"):
        t_pipe.pipeline_blocks(torch_ddp.toy_block, layers[:7], x, toy["rates"], MESH)


def _transformer(layers=4, causal=False):
    return t_layers.Transformer(32, layers, 4, causal=causal, attn_impl="xla",
                                gen=torch.Generator().manual_seed(0))


def test_fallback_warns_replicated_compute():
    """Layers or batch that do not divide: JAX's warning, once a shape, and
    the plain stack's result; a causal stack stays silent."""
    t_layers._PIPELINE_FALLBACK_WARNED.clear()
    x = torch.randn(4, 10, 32, generator=torch.Generator().manual_seed(9))
    for tf, xx in ((_transformer(layers=5), x), (_transformer(), x[:3])):
        with torch.no_grad():
            want = tf(xx)[0]
            with t_pipe.activate_pipeline({"pipe": 2, "data": 4}):
                with pytest.warns(UserWarning, match="REPLICATED"):
                    got = tf(xx)[0]
                with warnings.catch_warnings():
                    warnings.simplefilter("error")
                    tf(xx)  # warned once for this shape
        assert torch.equal(got, want)
    t_layers._PIPELINE_FALLBACK_WARNED.clear()
    tfc = _transformer(layers=5, causal=True)
    with torch.no_grad(), t_pipe.activate_pipeline({"pipe": 2, "data": 4}):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            tfc(x)


def test_causal_stack_never_pipelines():
    """A causal stack (the text towers) keeps the plain loop under an active
    pipeline: no pipe group is touched, the result is the plain stack's."""
    tf = _transformer(causal=True)
    x = torch.randn(4, 10, 32, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = tf(x)[0]
        with t_pipe.activate_pipeline({"pipe": 4, "data": 2}):
            assert torch.equal(tf(x)[0], want)


def test_data_axis_process_locality_check(monkeypatch):
    """`{pipe: 2, data: 4}` over 2 processes does not give each process one
    device of the mesh: the training loop's data-first check refuses it, as
    JAX's (`test_pipeline.py::test_data_axis_process_locality_check`)."""
    spec = {"pipe": 2, "data": 4}
    assert port_mesh.data_axis_is_process_local(spec)  # one process: trivially
    monkeypatch.setattr(port_mesh, "world_size", lambda: 2)
    assert not port_mesh.data_axis_is_process_local(spec)
    monkeypatch.setattr(port_mesh, "world_size", lambda: 8)
    assert port_mesh.data_axis_is_process_local(spec)
