"""The port's mesh check (`parallel/mesh.py`) against the JAX package's
`make_mesh` / `mesh_from_config` on the CPU (the virtual 8-device mesh of
conftest.py): the same axis sizes, or the same error type and text, at 1 and
at 8 devices; then the port's training loop at the tiny config of
`test_torch_train_loop.py`, which refuses a mesh it cannot honour and trains
`{data: -1}` with `tpu.fsdp` on one device."""

import os

import jax
import numpy as np
import pytest

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
    port_mesh.check_single_device({"data": 1}, {"fsdp": True})  # one device: the identity
    with pytest.raises(NotImplementedError, match=r"tpu.mesh \{'data': 2\} spans 2 devices.*"
                                                  r"ROADMAP §1 item 3"):
        port_mesh.check_single_device({"data": 2}, {})
    with pytest.raises(NotImplementedError, match="tpu.fsdp over the 4-way data axis, "
                                                  "tpu.pipeline over the 2-way pipe axis"):
        port_mesh.check_single_device({"data": 4, "pipe": 2},
                                      {"fsdp": True, "pipeline": {"microbatches": 4}})


@pytest.mark.parametrize("spec", ["{data: 2}", "{data: 1, model: 2}"])
def test_training_refuses_a_mesh_it_cannot_honour(tmp_path, monkeypatch, spec):
    """On one device the spec needs more devices than there are: JAX's
    ValueError, before any data or model is built.  Where the devices exist
    (two, here by the device count), the mesh spans them and the port, which
    trains on one, raises NotImplementedError."""
    cfg = _cfg(f"tpu.mesh={spec}", "tpu.fsdp=true")
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        loop.train(cfg, str(tmp_path / "one"), max_steps=1, no_validate=True, device="cpu")
    assert not os.path.exists(tmp_path / "one" / "train_log.jsonl")
    monkeypatch.setattr(port_mesh, "device_count", lambda device: 2)
    with pytest.raises(NotImplementedError, match="spans 2 devices"):
        loop.train(cfg, str(tmp_path / "two"), max_steps=1, no_validate=True, device="cpu")


@pytest.mark.parametrize("fsdp", ["true", "false"])
def test_data_minus_one_trains_on_one_device_with_or_without_fsdp(tmp_path, fsdp):
    wd = str(tmp_path)
    out = loop.train(_cfg("tpu.mesh={data: -1}", f"tpu.fsdp={fsdp}"), wd, max_steps=1,
                     no_validate=True, device="cpu")
    assert out["step"] == 1 and np.isfinite(out["loss_total"])
    with open(os.path.join(wd, "train.log")) as f:
        assert "mesh {'data': 1} over 1 devices (cpu)" in f.read()
