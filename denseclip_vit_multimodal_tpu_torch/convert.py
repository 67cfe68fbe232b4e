"""Weight bridge: a Flax variables tree -> the port's `state_dict`.

Input: nested dicts of numpy arrays, `{"params": ..., "batch_stats": ...}`,
as the JAX package's `model.init` / checkpoints hold them.  Mapping:

  * scan-stacked leaves `.../transformer/blocks/block/<leaf>` carry the layer
    on axis 0 and become `transformer.blocks.{i}.<leaf>`;
  * `process_{i}` (neck levels) becomes `process.{i}`;
  * Dense `kernel` [in, out] -> `weight` [out, in]; Conv `kernel` HWIO ->
    `weight` OIHW; LayerNorm / BatchNorm `scale` -> `weight`;
    `token_embedding/embedding` -> `token_embedding.weight`;
  * `patch_embed` [P*P*3, width] (patches in (row, column, channel) order,
    as the port flattens them too) -> `patch_embed.weight` [width, P*P*3];
  * `batch_stats/*/mean|var` -> BatchNorm `running_mean|running_var`;
  * `class_embedding`, `positional_embedding`, `proj`, `text_projection`,
    `contexts`, `gamma` are copied as they are.

Every leaf must land on a tensor of the target model with the same shape,
and every parameter / buffer of the model must be filled (BatchNorm's
`num_batches_tracked` aside): anything else raises.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_AS_IS = {"class_embedding", "positional_embedding", "proj", "text_projection", "contexts", "gamma"}


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(value)


def _map_leaf(collection: str, path: Tuple[str, ...], arr: np.ndarray) -> Tuple[str, np.ndarray]:
    """One unstacked Flax leaf -> (torch key, array in torch layout)."""
    *mods, leaf = path
    mods = [f"process.{m[len('process_'):]}" if re.fullmatch(r"process_\d+", m) else m for m in mods]
    if collection == "batch_stats":
        names = {"mean": "running_mean", "var": "running_var"}
        if leaf not in names:
            raise KeyError(f"unmapped batch_stats leaf {'/'.join(path)}")
        return ".".join(mods + [names[leaf]]), arr
    if collection != "params":
        raise KeyError(f"unmapped collection {collection!r}")
    if leaf == "kernel":
        if arr.ndim == 2:
            return ".".join(mods + ["weight"]), arr.T
        if arr.ndim == 4:
            return ".".join(mods + ["weight"]), arr.transpose(3, 2, 0, 1)
        raise KeyError(f"kernel of rank {arr.ndim} at {'/'.join(path)}")
    if leaf in ("scale", "embedding"):
        return ".".join(mods + ["weight"]), arr
    if leaf == "bias":
        return ".".join(mods + ["bias"]), arr
    if leaf == "patch_embed":
        return ".".join(mods + ["patch_embed", "weight"]), arr.T
    if leaf in _AS_IS:
        return ".".join(mods + [leaf]), arr
    raise KeyError(f"unmapped params leaf {'/'.join(path)}")


def flax_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Convert a Flax variables tree to a torch state_dict (fp32 copies)."""
    out: Dict[str, torch.Tensor] = {}
    for collection, tree in variables.items():
        for path, arr in _leaves(tree):
            stacked = [i for i in range(len(path) - 1) if path[i : i + 2] == ("blocks", "block")]
            if stacked:
                i = stacked[0]
                items = [
                    (path[:i] + ("blocks", str(layer)) + path[i + 2 :], arr[layer])
                    for layer in range(arr.shape[0])
                ]
            else:
                items = [(path, arr)]
            for p, a in items:
                key, value = _map_leaf(collection, p, a)
                if key in out:
                    raise KeyError(f"two leaves map to {key}")
                out[key] = torch.from_numpy(np.array(value, dtype=np.float32))  # owned, writable copy
    return out


def load_flax_variables(model: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Load a Flax variables tree into `model` in place; strict both ways."""
    converted = flax_to_state_dict(variables)
    own = model.state_dict()
    needed = {k for k in own if not k.endswith("num_batches_tracked")}
    unknown = sorted(set(converted) - needed)
    missing = sorted(needed - set(converted))
    if unknown or missing:
        raise KeyError(f"flax tree does not match the model: unknown {unknown}, missing {missing}")
    for key, value in converted.items():
        if tuple(own[key].shape) != tuple(value.shape):
            raise ValueError(f"{key}: flax {tuple(value.shape)} vs model {tuple(own[key].shape)}")
        converted[key] = value.to(own[key].dtype)
    model.load_state_dict(converted, strict=False)
    return model
