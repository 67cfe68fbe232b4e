"""Serve from a `tools/export.py` bundle: no model-building code, no config.

The PyTorch port of the JAX package's `infer/exported.py`.  It loads the
`torch.export` program in `program.pt2`, whose weights are inside it, and
`meta.json`, which `tools/export.py` wrote.  It gives the `predict` surface
that the serving daemon (`infer/server.py::InferenceService`) uses.  A
serving host needs only torch and this loader.  It imports the port's
kernel modules (`ops/`), which register the `denseclip_torch` ops that the
program calls, and never the models or the config system.

The program is specialised to one input shape, one mode and one crop and
stride.  So `predict` checks every request against `meta.json`: it does not
trace again.  `aug_test` is refused: export one program per scale for
multi-scale serving.

A bundle runs on the device it was exported on.  Its graph and weights are
on that device, so a CUDA bundle asked for `device="cpu"` (or a CPU bundle
for `"cuda"`) raises: it never moves quietly.  A kernel that fails to build
or launch inside the program raises, as it does on the live path.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np
import torch

from denseclip_vit_multimodal_tpu_torch.infer.outputs import package_outputs


def register_ops() -> None:
    """Import the kernel modules, which register the `denseclip_torch` ops
    (`ops/_library.py`) that an exported program calls."""
    from denseclip_vit_multimodal_tpu_torch.ops import (  # noqa: F401
        attention,
        lnqkv_kernel,
        mha_kernel,
    )


def without_metadata_asserts(module: torch.fx.GraphModule) -> torch.fx.GraphModule:
    """`module` without its `aten._assert_tensor_metadata` nodes.

    `torch.export` puts one before each dtype cast of the traced program, to
    check on every call that the tensor still has the dtype it had while
    tracing.  The program is specialised to one input shape and dtype, which
    `predict` enforces, and holds its weights, so every intermediate's dtype
    is fixed and each check holds by construction; each would still cost a
    dispatch on the host, several hundred a flagship frame.  The nodes have
    no users, so the rest of the graph is unchanged."""
    graph = module.graph
    for node in list(graph.nodes):
        if node.op == "call_function" and node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
    module.recompile()
    return module


class ExportedInferencer:
    """`Inferencer`-compatible wrapper over an export directory.

    Duck-types the part of `Inferencer` that `InferenceService` uses:
    `num_classes`, `with_depth`, `device` and `predict(images, mode=...,
    crop=..., stride=..., window_batch=..., fetch=...)`.  Runs on `device`,
    `cuda` by default, which must be the bundle's.
    """

    def __init__(self, export_dir: str, device="cuda"):
        with open(os.path.join(export_dir, "meta.json")) as f:
            self.meta = json.load(f)
        self.device = torch.device(device)
        bundle_device = self.meta["device"]
        if self.device.type != bundle_device:
            raise ValueError(
                f"the bundle {export_dir} was exported on {bundle_device} and runs there, got "
                f"device={str(device)!r}; re-export with --device {self.device.type}")
        register_ops()
        program = torch.export.load(os.path.join(export_dir, "program.pt2"))
        on = {t.device.type for t in program.state_dict.values()}
        if on - {bundle_device}:
            raise ValueError(f"the bundle's weights are on {sorted(on)}, its meta.json says "
                             f"{bundle_device}")
        self._program = without_metadata_asserts(program.module())

        self.export_dir = export_dir
        self.num_classes = len(self.meta["class_names"])
        self.with_depth = bool(self.meta["with_depth"])
        self.export_fetch = self.meta["fetch"]
        self.input_shape = tuple(self.meta["input_shape"])
        self.mode = self.meta["mode"]
        self.crop = tuple(self.meta["crop"])
        self.stride = tuple(self.meta["stride"])
        self.window_batch = int(self.meta.get("window_batch") or 0)
        self.depth_max = float(self.meta.get("depth_max", 80.0))
        self.model_name = self.meta.get(
            "model_name", os.path.basename(os.path.normpath(export_dir)))

    def run(self, images: np.ndarray):
        """The program's own outputs on uint8 `images` of `input_shape`: the
        fp32 canvas [B, H, W, num_outputs] of a `logits` export, else the
        baked (seg, depth?) tuple; tensors on the device."""
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        with torch.inference_mode():
            return self._program(x)

    # -- Inferencer-compatible surface ------------------------------------

    def predict(
        self,
        images: np.ndarray,
        mode: str = "whole",
        crop: Tuple[int, int] = (640, 640),
        stride: Tuple[int, int] = (426, 426),
        window_batch: int = 0,
        fetch: str = "argmax",
    ) -> Dict[str, np.ndarray]:
        """uint8 [B, H, W, 3] -> {'seg', 'depth'?} per the fetch policy.

        The CLIP normalisation is inside the program, so raw uint8 frames go
        straight in.  The request must match the export's specialisation
        exactly."""
        images = np.asarray(images)
        if tuple(images.shape) != self.input_shape:
            raise ValueError(f"exported program is specialized to input {self.input_shape}, "
                             f"got {tuple(images.shape)}")
        if images.dtype != np.uint8:
            # the live Inferencer takes uint8 or float frames; this program
            # normalises uint8, and a cast would turn 0..1 floats to black
            raise ValueError(f"exported program takes uint8 frames, got {images.dtype}; "
                             f"scale to 0..255 uint8 before predict")
        if mode != self.mode:
            raise ValueError(f"exported program runs mode={self.mode!r}, got {mode!r}")
        if self.mode == "slide" and (tuple(crop) != self.crop or tuple(stride) != self.stride):
            raise ValueError(f"exported slide protocol is crop={self.crop} stride={self.stride}, "
                             f"got crop={tuple(crop)} stride={tuple(stride)}")
        if self.export_fetch != "logits" and fetch != self.export_fetch:
            # the program emits its final dtypes: another policy needs a re-export
            raise ValueError(f"export was baked with fetch={self.export_fetch!r}; "
                             f"re-export with --fetch {fetch} to serve that policy")
        out = self.run(images)
        if self.export_fetch == "logits":
            # the whole canvas: apply the fetch policy on the device, as the
            # live Inferencer does
            depth = out[..., self.num_classes:] if self.with_depth else None
            return package_outputs(out[..., : self.num_classes], depth, fetch)
        res = {"seg": out[0].cpu().numpy()}
        if self.with_depth:
            res["depth"] = out[1].cpu().numpy()
        return res

    def aug_test(self, *args, **kwargs):
        raise ValueError("aug_test is not part of this export; export one program per scale or "
                         "serve from a config + checkpoint for multi-scale")
