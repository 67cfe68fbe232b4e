"""The device-to-host fetch policies of inference (the JAX package's
`infer/engine.py::package_outputs`), apart from the engine so that
`infer/exported.py` packages an exported program's outputs without
importing the model code."""

from __future__ import annotations

from typing import Optional

import torch


def package_outputs(seg_logits: torch.Tensor, depth: Optional[torch.Tensor], fetch: str):
    """Package (seg_logits [B,H,W,K], depth [B,H,W(,1)]) per the `fetch` policy.

    fetch='logits' — fp32 logit canvas + int32 argmax + fp32 depth as numpy.
    fetch='argmax' — int32 argmax + fp32 depth as numpy.
    fetch='packed' — argmax as uint8 (num_classes <= 256) + depth as float16,
                     cast on the device before the copy to the host.
    fetch='device' — tensors left on the device: seg_logits, seg, depth.
    """
    if depth is not None and depth.dim() == 4:
        depth = depth[..., 0]
    if fetch == "device":
        out = {"seg_logits": seg_logits, "seg": seg_logits.argmax(dim=-1)}
        if depth is not None:
            out["depth"] = depth
        return out
    if fetch == "packed":
        if seg_logits.shape[-1] > 256:
            raise ValueError(
                f"fetch='packed' needs num_classes <= 256, got {seg_logits.shape[-1]}; "
                "use fetch='argmax'"
            )
        out = {"seg": seg_logits.argmax(dim=-1).to(torch.uint8).cpu().numpy()}
        if depth is not None:
            out["depth"] = depth.to(torch.float16).cpu().numpy()
        return out
    out = {}
    if fetch == "logits":
        out["seg_logits"] = seg_logits.float().cpu().numpy()
    elif fetch != "argmax":
        raise ValueError(f"Unknown fetch policy: {fetch!r}")
    out["seg"] = seg_logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
    if depth is not None:
        out["depth"] = depth.float().cpu().numpy()
    return out
