"""The port's mesh (`parallel/mesh.py`) against the JAX package's
`make_mesh` / `mesh_from_config` on the CPU (the virtual 8-device mesh of
conftest.py): the same axis sizes, or the same error type and text, at 1 and
at 8 devices; a rank's coordinates (row-major over the spec's order, as JAX
reshapes its devices) and its data and model groups for `{data, model}` and
`{model, data}`; what the port refuses over more than one device (a pipe
axis, the GPipe pipeline, the ring), and the training loop at the tiny
config of `test_torch_train_loop.py`: JAX's `ValueError` texts where the
spec or the global batch cannot be honoured, and `{data: -1}` with
`tpu.fsdp` on one process.  A world of two is simulated by the group's size
alone: the loop refuses before it builds anything (`tests/test_torch_ddp_*.py`
and `tests/test_torch_{fsdp,tp}_step.py` run real groups); the bootstrap's
card pin from torchrun's environment is recorded, not made."""

import os

import re

import jax
import numpy as np
import pytest
import torch

from denseclip_vit_multimodal_tpu.parallel import mesh as jax_mesh
from denseclip_vit_multimodal_tpu_torch.parallel import mesh as port_mesh
from denseclip_vit_multimodal_tpu_torch.train import loop
from test_torch_train_loop import _cfg

SPECS = [{"data": -1}, {"data": 2}, {"data": 1, "model": 2}, {"data": -1, "model": 3},
         {"data": -1, "model": -1}]


def _outcome(build):
    """("mesh", sizes) or ("error", type, text)."""
    try:
        return ("mesh", build())
    except Exception as e:  # the comparison is of the exception itself
        return ("error", type(e), str(e))


@pytest.mark.parametrize("devices", [1, 8])
@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_make_mesh_resolves_or_refuses_as_jax_does(spec, devices):
    def jax_sizes():
        m = jax_mesh.make_mesh(spec, devices=jax.devices()[:devices])
        return dict(zip(m.axis_names, m.devices.shape))

    want = _outcome(jax_sizes)
    assert _outcome(lambda: port_mesh.make_mesh(spec, devices)) == want


@pytest.mark.parametrize("tpu_cfg", [None, {}, {"mesh": {"data": -1}}, {"mesh": {"data": 4}},
                                     {"mesh": {"data": 3}}], ids=str)
def test_mesh_from_config_matches_jax_over_every_device(tpu_cfg):
    def jax_sizes():
        m = jax_mesh.mesh_from_config(tpu_cfg)
        return dict(zip(m.axis_names, m.devices.shape))

    want = _outcome(jax_sizes)
    assert _outcome(lambda: port_mesh.mesh_from_config(tpu_cfg, jax.device_count())) == want


def test_a_mesh_over_several_devices_is_refused_with_what_would_act():
    """The data axis, a model axis and FSDP train over any number of
    processes, so do GPipe over `{data, pipe}` and the ring over the data
    axis; another axis, a pipe axis with a model axis or FSDP, and the ring
    with a model or pipe axis are refused, naming what acts and ROADMAP §1
    item 2."""
    port_mesh.check_ported({"data": 1}, {"fsdp": True}, world=1)  # one device: the identity
    port_mesh.check_ported({"data": 2}, {}, world=2)
    port_mesh.check_ported({"data": 8}, {"attn_impl": "auto"}, world=8)
    port_mesh.check_ported({"data": 1}, {"attn_impl": "ring"}, world=1)
    port_mesh.check_ported({"data": 4}, {"fsdp": True}, world=4)
    port_mesh.check_ported({"data": 1, "model": 2}, {}, world=2)
    port_mesh.check_ported({"model": 2, "data": 2}, {"fsdp": True}, world=4)
    port_mesh.check_ported({"data": 2, "pipe": 1}, {"pipeline": {"microbatches": 4}}, world=2)
    port_mesh.check_ported({"data": 4, "pipe": 2}, {"pipeline": {"microbatches": 4}}, world=8)
    port_mesh.check_ported({"pipe": 2}, {}, world=2)
    port_mesh.check_ported({"data": 2}, {"attn_impl": "ring"}, world=2)
    with pytest.raises(NotImplementedError, match=r"a 2-way pipe axis with tpu.fsdp: not "
                                                  r"ported yet \(ROADMAP §1 item 2\)"):
        port_mesh.check_ported({"data": 4, "pipe": 2},
                               {"fsdp": True, "pipeline": {"microbatches": 4}}, world=8)
    with pytest.raises(NotImplementedError, match=r"tpu.mesh axis 'seq' over 2 devices, a 2-way "
                                                  r"pipe axis with a 2-way model axis.*item 2"):
        port_mesh.check_ported({"seq": 2, "pipe": 2, "model": 2}, {"pipeline": {}}, world=8)
    with pytest.raises(NotImplementedError, match="attn_impl: ring over 4 processes with a "
                                                  "2-way model axis"):
        port_mesh.check_ported({"data": 2, "model": 2}, {"attn_impl": "ring"}, world=4)


@pytest.mark.parametrize("spec", ["{data: 2}", "{data: 1, model: 2}"])
def test_training_refuses_a_mesh_it_cannot_honour(tmp_path, monkeypatch, spec):
    """On one process the spec needs more devices than there are: JAX's
    ValueError and the launcher's hint, before any data or model is built.
    Over a group of two the mesh spans it (FSDP over the data axis and the
    model axis train, and so does the ring over the data axis), and what the
    port does not do over two (here the ring with a model axis) raises
    NotImplementedError before anything is built."""
    cfg = _cfg(f"tpu.mesh={spec}", "tpu.fsdp=true", "tpu.attn_impl=ring")
    with pytest.raises(ValueError, match="needs 2 devices, have 1 .*tools/dist_train.sh"):
        loop.train(cfg, str(tmp_path / "one"), max_steps=1, no_validate=True, device="cpu")
    assert not os.path.exists(tmp_path / "one" / "train_log.jsonl")
    monkeypatch.setattr(port_mesh, "world_size", lambda: 2)
    if "model" not in spec:
        port_mesh.check_ported(port_mesh.mesh_over_group(cfg.tpu), cfg.tpu)
        return
    with pytest.raises(NotImplementedError, match="attn_impl: ring over 2 processes with a "
                                                  "2-way model axis"):
        loop.train(cfg, str(tmp_path / "two"), max_steps=1, no_validate=True, device="cpu")
    assert not os.path.exists(tmp_path / "two" / "train_log.jsonl")


def test_training_refuses_a_pipe_axis(tmp_path, monkeypatch):
    """A pipe axis with tpu.fsdp over two processes (not ported) is refused
    before anything is built, naming ROADMAP §1 item 2."""
    monkeypatch.setattr(port_mesh, "world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="2-way pipe axis with tpu.fsdp.*ROADMAP §1 "
                                                  "item 2"):
        loop.train(_cfg("tpu.mesh={data: 1, pipe: 2}", "tpu.fsdp=true"), str(tmp_path),
                   max_steps=1, no_validate=True, device="cpu")
    assert not os.path.exists(tmp_path / "train_log.jsonl")


def test_the_global_batch_must_divide_by_the_data_axis(tmp_path, monkeypatch):
    """JAX's text (`train/loop.py:360-366`): `training.batch_size` is global."""
    monkeypatch.setattr(port_mesh, "world_size", lambda: 2)
    with pytest.raises(ValueError, match=re.escape(
            "training.batch_size=3 must be divisible by the data mesh axis (2 ways); adjust "
            "batch_size or tpu.mesh (batch_size is GLOBAL, unlike torch's per-process)")):
        loop.train(_cfg("training.batch_size=3"), str(tmp_path), max_steps=1, no_validate=True,
                   device="cpu")


def test_a_microbatch_must_divide_by_the_world(tmp_path, monkeypatch):
    monkeypatch.setattr(port_mesh, "world_size", lambda: 2)
    with pytest.raises(ValueError, match=r"a microbatch of 1 rows \(batch 2 / grad_accum_steps "
                                         r"2\) does not divide by the 2 processes"):
        loop.train(_cfg("training.grad_accum_steps=2"), str(tmp_path), max_steps=1,
                   no_validate=True, device="cpu")


def test_local_batch_and_process_local_data_axis(monkeypatch):
    """The local batch is the global batch over the data axis, and every
    mesh that gives each process one device is process-local: under
    `{data: 2, model: 2}` the two ranks of a model group read the same half."""
    assert port_mesh.local_batch_size(8) == 8 and port_mesh.data_axis_is_process_local({"data": 1})
    monkeypatch.setattr(port_mesh, "world_size", lambda: 4)
    assert port_mesh.local_batch_size(8) == 2
    with pytest.raises(ValueError, match="global batch 6 not divisible by 4 processes"):
        port_mesh.local_batch_size(6)
    assert port_mesh.data_axis_is_process_local({"data": 4})
    assert port_mesh.data_axis_is_process_local({"data": 2, "model": 2})
    assert not port_mesh.data_axis_is_process_local({"data": 2})
    monkeypatch.setattr(port_mesh, "_LAYOUT", port_mesh.Layout({"data": 2, "model": 2}, 3))
    assert port_mesh.local_batch_size(8) == 4
    assert (port_mesh.data_rank(), port_mesh.data_size()) == (1, 2)
    assert (port_mesh.model_rank(), port_mesh.model_size()) == (1, 2)


@pytest.mark.parametrize("spec", [{"data": 2, "model": 2}, {"model": 2, "data": 2},
                                  {"data": 2, "model": 3}, {"model": 3, "data": 2}], ids=str)
def test_coordinates_are_jax_row_major_device_order(spec):
    """Rank r sits where JAX's `make_mesh` puts device r: the device array's
    index of r, the spec's axes in order; its data group shares its model
    coordinate, its model group its data coordinate."""
    n = int(np.prod(list(spec.values())))
    m = jax_mesh.make_mesh(spec, devices=jax.devices()[:n])
    ids = np.vectorize(lambda d: d.id)(m.devices)
    base = min(d.id for d in jax.devices()[:n])
    for r in range(n):
        where = dict(zip(m.axis_names, (int(i) for i in np.argwhere(ids == base + r)[0])))
        assert port_mesh.mesh_coords(spec, r) == where
        layout = port_mesh.Layout(spec, r)
        assert (layout.data_rank, layout.model_rank) == (where["data"], where["model"])
        for axis in ("data", "model"):
            group = port_mesh.axis_ranks(spec, r, axis)
            assert len(group) == spec[axis] and r in group
            others = [a for a in spec if a != axis]
            assert all(port_mesh.mesh_coords(spec, g)[o] == where[o] for g in group for o in others)
            assert [port_mesh.mesh_coords(spec, g)[axis] for g in group] == list(range(spec[axis]))


def test_the_layout_makes_every_group_in_the_same_order(monkeypatch):
    """`setup_layout` over 4 ranks of `{model: 2, data: 2}`: every rank asks
    for the data groups, then the model groups, in the same order (so that
    `dist.new_group`'s collective calls line up), and keeps its own."""
    made = []
    monkeypatch.setattr(port_mesh, "world_size", lambda: 4)
    monkeypatch.setattr(port_mesh.dist, "new_group", lambda ranks: made.append(ranks) or
                        tuple(ranks))
    try:
        for r in range(4):
            monkeypatch.setattr(port_mesh, "rank", lambda r=r: r)
            layout = port_mesh.setup_layout({"model": 2, "data": 2})
            assert r in layout.data_group and r in layout.model_group
            assert port_mesh.data_group() == tuple(port_mesh.axis_ranks(
                {"model": 2, "data": 2}, r, "data"))
    finally:
        port_mesh.reset_layout()
    assert made == [[0, 1], [2, 3], [0, 2], [1, 3]] * 4
    assert port_mesh.data_size() == 4 and port_mesh.model_size() == 1  # no layout: the world


def test_no_group_without_torchrun_environment(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert port_mesh.maybe_initialize_distributed(device="cpu") is False
    assert (port_mesh.rank(), port_mesh.world_size(), port_mesh.is_distributed()) == (0, 1, False)
    x = torch.arange(4.0, requires_grad=True)
    assert port_mesh.all_reduce_sum(x) is x and port_mesh.sum_across(x) is x
    assert port_mesh.gather_rows(x, [4]) is x and port_mesh.all_gather_object(3) == [3]
    m = torch.nn.Linear(2, 2)
    assert port_mesh.replicate(m) is m


@pytest.mark.parametrize("backend,local_rank,cards,card,chosen", [
    (None, 1, 2, 1, "nccl"),     # NCCL: rank LOCAL_RANK on card LOCAL_RANK
    ("gloo", 1, 1, 0, "gloo"),   # Gloo: the ranks go round the visible cards
    ("gloo", 3, 2, 1, "gloo"),
    (None, 1, 1, None, None),    # NCCL cannot put two ranks on one card
])
def test_bootstrap_pins_the_card_torchrun_names(monkeypatch, backend, local_rank, cards, card,
                                                chosen):
    """`maybe_initialize_distributed` on CUDA from torchrun's environment
    (the card count, the pin and the group's creation recorded, not made)."""
    monkeypatch.setenv("RANK", str(local_rank))
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", str(local_rank))
    calls = {}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: calls.setdefault("card", i))
    monkeypatch.setattr(port_mesh.dist, "init_process_group",
                        lambda b, **kw: calls.update(backend=b, **kw))
    if chosen is None:
        with pytest.raises(ValueError, match="LOCAL_RANK 1 has no card of its own"):
            port_mesh.maybe_initialize_distributed(backend, "cuda")
        assert calls == {}
        return
    assert port_mesh.maybe_initialize_distributed(backend, "cuda", timeout_s=7) is True
    assert calls["card"] == card and calls["backend"] == chosen
    assert (calls["rank"], calls["world_size"]) == (local_rank, 4)
    assert calls["timeout"].total_seconds() == 7


@pytest.mark.parametrize("fsdp", ["true", "false"])
def test_data_minus_one_trains_on_one_device_with_or_without_fsdp(tmp_path, fsdp):
    wd = str(tmp_path)
    out = loop.train(_cfg("tpu.mesh={data: -1}", f"tpu.fsdp={fsdp}"), wd, max_steps=1,
                     no_validate=True, device="cpu")
    assert out["step"] == 1 and np.isfinite(out["loss_total"])
    with open(os.path.join(wd, "train.log")) as f:
        assert "mesh {'data': 1} over 1 devices (cpu)" in f.read()
