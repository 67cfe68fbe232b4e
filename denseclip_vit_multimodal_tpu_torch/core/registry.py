"""Component registries: the extensibility point for custom modules (the
port's copy of the JAX package's `core/registry.py`).

`build_denseclip` falls back to them for any `type:` string it does not know
natively, so a user can plug in a custom backbone, text encoder, neck or
head without patching `build_denseclip`:

    from denseclip_vit_multimodal_tpu_torch.core.registry import BACKBONES

    @BACKBONES.register("MyBackbone")
    class MyBackbone(nn.Module):
        out_channels = 256   # build_denseclip reads it (and `num_levels`)
        ...

`build_denseclip` calls the registered class with the config section's keys (its
`type` removed) as keyword arguments.  A PyTorch neck must know its input
widths when it is built: `build_denseclip` gives a registered backbone's
`num_levels` levels `out_channels` channels each.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._entries: Dict[str, Any] = {}

    def register(self, key: Optional[str] = None) -> Callable:
        def decorator(obj):
            name = key or obj.__name__
            if name in self._entries:
                raise KeyError(f"{name!r} already registered in {self.name}")
            self._entries[name] = obj
            return obj

        return decorator

    def get(self, key: str):
        return self._entries.get(key)

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def keys(self):
        return self._entries.keys()


BACKBONES = Registry("backbones")
TEXT_ENCODERS = Registry("text_encoders")
NECKS = Registry("necks")
HEADS = Registry("heads")
