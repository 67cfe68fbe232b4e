"""The `tpu.mesh` spec, resolved as the JAX package's `parallel/mesh.py`
resolves it (`make_mesh`, `mesh_from_config`), for the port's training loop.

JAX builds a `jax.sharding.Mesh` over every device from the spec
(``{data: -1}`` by default, or e.g. ``{data: 4, model: 2}``): at most one
axis may be -1 and takes the devices the fixed axes leave, which must divide
the device count (or, with no -1, equal it), with the same `ValueError`
texts as here.  The port resolves the spec over a device count instead:
`torch.cuda.device_count()` on the card, 1 on the CPU.

The port trains on one device.  `check_single_device` refuses a resolved
mesh over more than one device, and so `tpu.fsdp` and `tpu.pipeline` where
they would act over more than one, with `NotImplementedError` (ROADMAP §1
item 3: DDP over the data axis, FSDP, tensor and pipeline parallelism), so
that no such configuration trains unsharded.  On one device `{data: -1}`
resolves to ``{data: 1}``, over which JAX's data sharding and FSDP are the
identity, so it trains as it does without a mesh.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

import torch

DATA_AXIS = "data"
PIPE_AXIS = "pipe"


def device_count(device) -> int:
    """The devices a mesh on `device` spans: every visible card for CUDA, 1
    on the CPU."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def make_mesh(spec: Optional[Mapping[str, int]] = None, n_devices: int = 1) -> Dict[str, int]:
    """The axis sizes of `spec` over `n_devices` devices; a single -1 axis
    takes the devices the fixed axes leave."""
    spec = dict(spec or {DATA_AXIS: -1})
    sizes = list(spec.values())
    n_free = sizes.count(-1)
    if n_free > 1:
        raise ValueError(f"at most one mesh axis may be -1, got {spec}")
    fixed = math.prod(s for s in sizes if s != -1)
    if n_free:
        if n_devices % fixed != 0:
            raise ValueError(f"{n_devices} devices not divisible by fixed axes {spec}")
        sizes = [n_devices // fixed if s == -1 else s for s in sizes]
    elif fixed != n_devices:
        raise ValueError(f"mesh {spec} needs {fixed} devices, have {n_devices}")
    return dict(zip(spec, sizes))


def mesh_from_config(tpu_cfg: Optional[Mapping[str, Any]], n_devices: int) -> Dict[str, int]:
    """The mesh of the `tpu:` config section (``mesh: {data: -1}``)."""
    spec = tpu_cfg.get("mesh") if tpu_cfg else None
    return make_mesh(None if spec is None else dict(spec), n_devices)


def check_single_device(mesh: Mapping[str, int], tpu_cfg: Optional[Mapping[str, Any]]) -> None:
    """Raise NotImplementedError where `mesh` spans more than one device,
    naming the options that would act over them."""
    devices = math.prod(mesh.values())
    if devices <= 1:
        return
    tpu_cfg = tpu_cfg or {}
    acting = [f"tpu.mesh {dict(mesh)}"]
    if tpu_cfg.get("fsdp"):
        acting.append(f"tpu.fsdp over the {mesh.get(DATA_AXIS, 1)}-way data axis")
    if tpu_cfg.get("pipeline") is not None and PIPE_AXIS in mesh:
        acting.append(f"tpu.pipeline over the {mesh[PIPE_AXIS]}-way pipe axis")
    raise NotImplementedError(
        f"{', '.join(acting)} spans {devices} devices: training over more than one device is "
        "not ported yet (parallelism, ROADMAP §1 item 3)")
