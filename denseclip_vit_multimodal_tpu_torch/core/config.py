"""Unified YAML config system (the PyTorch port's own copy).

Kept byte-for-byte in behaviour with the JAX package's `core/config.py`, so
both packages read the same presets the same way; the port imports nothing
from the JAX package.

The reference carries two incompatible config systems: plain YAML consumed by
the trainer (reference: segmentation/train_denseclip.py:1584-1586) and
vestigial mmseg-style Python configs with `_base_` composition
(segmentation/configs/_base_/...).  The YAML loader there performs *no*
inheritance even though one config declares `_base_:` keys.

This module provides one coherent system reproducing the working YAML schema
(`{data:…, model:…, training:…}`) with `_base_` composition done properly:

  * `_base_` may be a path or list of paths, relative to the including file;
    bases are merged depth-first (later bases and the child override earlier).
  * dict values merge recursively; any other value (including lists) replaces.
  * a key set to `__delete__` removes the inherited key.
  * dotted CLI overrides: ``training.optimizer.lr=1e-4``.

Access is attribute- or item-style with `.get()` defaults, mirroring how the
reference trainer consumes its dicts.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Any, Dict, Iterable, List, Mapping, Optional, Union

import yaml

_DELETE = "__delete__"


class Config(dict):
    """dict with attribute access; nested dicts are wrapped on the fly."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __getitem__(self, key):
        value = super().__getitem__(key)
        if isinstance(value, dict) and not isinstance(value, Config):
            value = Config(value)
            super().__setitem__(key, value)
        return value

    def get(self, key, default=None):
        if key in self:
            return self[key]  # __getitem__ wraps nested dicts (and caches)
        if isinstance(default, dict) and not isinstance(default, Config):
            # wrap for attribute access, but do NOT insert: a read accessor
            # must not grow the config (spurious empty sections would leak
            # into the final_config.yaml dump, and a caller's shared
            # mutable default must not be captured)
            return Config(default)
        return default

    def to_dict(self) -> Dict[str, Any]:
        def unwrap(v):
            if isinstance(v, Mapping):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [unwrap(x) for x in v]
            return v

        return unwrap(self)

    def dump(self, path: Union[str, Path]) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)

    def pretty(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)


def _deep_merge(base: Dict[str, Any], override: Mapping[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for key, value in override.items():
        if value == _DELETE:
            out.pop(key, None)
        elif (
            key in out
            and isinstance(out[key], Mapping)
            and isinstance(value, Mapping)
        ):
            out[key] = _deep_merge(dict(out[key]), value)
        else:
            out[key] = copy.deepcopy(value)
    return out


def _load_raw(path: Path, _stack: Optional[List[Path]] = None) -> Dict[str, Any]:
    path = path.resolve()
    stack = list(_stack or [])
    if path in stack:
        raise ValueError(f"Circular _base_ chain: {' -> '.join(map(str, stack + [path]))}")
    stack.append(path)

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    if not isinstance(raw, dict):
        raise TypeError(f"Config root must be a mapping: {path}")

    bases = raw.pop("_base_", None)
    merged: Dict[str, Any] = {}
    if bases:
        if isinstance(bases, (str, Path)):
            bases = [bases]
        for base in bases:
            base_path = (path.parent / base).resolve()
            merged = _deep_merge(merged, _load_raw(base_path, stack))
    return _deep_merge(merged, raw)


def _parse_scalar(text: str) -> Any:
    try:
        value = yaml.safe_load(text)
    except yaml.YAMLError:
        return text
    # YAML 1.1 treats "1e-4" (no dot) as a string; fix numeric intent.
    if isinstance(value, str):
        try:
            return float(value)
        except ValueError:
            return value
    return value


def apply_overrides(cfg: Dict[str, Any], overrides: Iterable[str]) -> Dict[str, Any]:
    """Apply ``a.b.c=value`` style overrides in place; returns cfg."""
    for item in overrides or []:
        if "=" not in item:
            raise ValueError(f"Override must look like key.path=value, got {item!r}")
        key_path, value = item.split("=", 1)
        node = cfg
        keys = key_path.strip().split(".")
        for key in keys[:-1]:
            nxt = node.get(key)
            if not isinstance(nxt, dict):
                nxt = {}
                node[key] = nxt
            node = nxt
        node[keys[-1]] = _parse_scalar(value)
    return cfg


def load_config(
    path: Union[str, Path],
    overrides: Optional[Iterable[str]] = None,
) -> Config:
    """Load a YAML config with `_base_` composition and CLI overrides."""
    raw = _load_raw(Path(path))
    if overrides:
        raw = apply_overrides(raw, overrides)
    return Config(raw)


def builtin_config_dir() -> Path:
    """Directory of preset configs shipped with the repo."""
    return Path(__file__).resolve().parents[2] / "configs"


def resolve_config_path(name_or_path: Union[str, Path]) -> Path:
    """Resolve a config argument: explicit path first, then builtin presets."""
    p = Path(name_or_path)
    if p.exists():
        return p
    candidates = [
        builtin_config_dir() / p.name,
        builtin_config_dir() / f"{p.name}.yaml",
    ]
    for c in candidates:
        if c.exists():
            return c
    raise FileNotFoundError(f"Config not found: {name_or_path} (tried {candidates})")


def resolve_test_protocol(cfg, crop=None, stride=None, window_batch=None):
    """Slide-eval protocol with config `test:` section defaults.

    Shared by the tools/ CLIs (test.py / infer.py / bench_suite.py):
    explicit CLI values win; otherwise the config's `test:` section (e.g.
    the ViT-L/14 preset pins crop 630 + window_batch 10 — see
    docs/PERFORMANCE.md); otherwise the reference mmseg protocol
    (crop 640, stride 426, one launch).

    Returns (crop [h, w], stride [h, w], window_batch int).
    """
    t = cfg.get("test", {}) or {}
    # both spellings accepted: `crop` (native) and `crop_size` (the
    # reference's mmseg test_cfg key, used by the heritage presets)
    crop = (
        list(crop) if crop is not None
        else list(t.get("crop", t.get("crop_size", [640, 640])))
    )
    stride = (
        list(stride) if stride is not None
        else list(t.get("stride", [426, 426]))
    )
    wb = int(
        window_batch if window_batch is not None
        else t.get("window_batch", 0)
    )
    return crop, stride, wb
