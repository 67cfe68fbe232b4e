"""Train state: frozen modules, parameter groups and the optimizer (PyTorch
port of the JAX package's `train/state.py`).

Parameters are labelled by their top-level module (`backbone`, `neck`,
`decode_head`, `contexts`, ...).  Frozen labels get `requires_grad=False` and
no optimizer state (the JAX package routes them to `optax.set_to_zero`); the
others form one group per (label, decay) with the label's lr multiplier.
`Optimizer` reproduces the optax chain of the JAX package:

  * one global-norm clip over every trainable gradient, before the groups;
  * AdamW with decoupled weight decay masked like the JAX `wd_mask`: decay
    only where the leaf has ndim > 1 and its Flax name is not `scale`,
    `bias` or `embedding` (so `positional_embedding` decays); or SGD with
    coupled weight decay on every leaf and optional momentum;
  * the lr of an update is schedule(count) * mult, where count is the number
    of updates applied so far (0 for the first).

Trainable parameters that get no gradient are given zero gradients before
each update, as JAX hands them zeros: AdamW then still decays them, where
`torch.optim.AdamW` would skip a parameter whose `.grad` is None.  Only
parameters with no path to the loss are left so: on the flagship `contexts`,
`vis_proj` and `global_proj` (nothing reads the score map); with a context
decoder or score concatenation (the ResNet presets) they, `gamma` and the
decoder get their real gradients, through the frozen text tower.

Over a sharded state (`parallel/fsdp.py`: tensor parallelism, ZeRO-3) the
optimizer runs on each rank's parts of the parameters as they are (AdamW
and SGD are elementwise, so its moments take the same parts); the decay
mask and the lr multipliers follow the full parameter's name, and the
clip's norm stays the one global norm (`_squares`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from denseclip_vit_multimodal_tpu_torch.models.layers import LayerNorm
from denseclip_vit_multimodal_tpu_torch.parallel import mesh as mesh_lib

FROZEN = "frozen"
DEFAULT_FROZEN_MODULES = ("backbone", "text_encoder")


def param_label(name: str, frozen_modules: Tuple[str, ...] = DEFAULT_FROZEN_MODULES) -> str:
    head = name.split(".", 1)[0]
    return FROZEN if head in frozen_modules else head


def label_params(model: nn.Module, frozen_modules: Tuple[str, ...] = DEFAULT_FROZEN_MODULES
                 ) -> Dict[str, str]:
    """Parameter name -> its top-level module name, or 'frozen'."""
    return {name: param_label(name, frozen_modules) for name, _ in model.named_parameters()}


def _flax_leaf_name(model: nn.Module, name: str) -> str:
    """The name the Flax tree gives this parameter's leaf (`convert.py`'s map, reversed)."""
    path, _, leaf = name.rpartition(".")
    module = model.get_submodule(path) if path else model
    if leaf == "weight" and isinstance(module, nn.Embedding):
        return "embedding"
    if leaf == "weight" and isinstance(module, (LayerNorm, nn.BatchNorm2d)):
        return "scale"
    return leaf


def decays(model: nn.Module, name: str, param: torch.Tensor) -> bool:
    """The JAX `wd_mask`: ndim > 1 and the Flax leaf is not scale/bias/embedding."""
    return param.dim() > 1 and _flax_leaf_name(model, name) not in ("scale", "bias", "embedding")


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


class Optimizer:
    """AdamW or SGD over the trainable labels, with the JAX chain's semantics
    (the JAX package's `build_optimizer`, taking the same keywords)."""

    def __init__(self, model: nn.Module, schedule: Callable[[int], float],
                 weight_decay: float = 0.01, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, clip_grad_norm: Optional[float] = None,
                 frozen_modules: Tuple[str, ...] = DEFAULT_FROZEN_MODULES,
                 lr_mults: Optional[Mapping[str, float]] = None, opt_type: str = "adamw",
                 momentum: float = 0.0):
        opt_type = str(opt_type).lower()
        if opt_type not in ("adamw", "sgd"):
            raise ValueError(f"Unsupported optimizer type: {opt_type}")
        lr_mults = dict(lr_mults or {})
        self.schedule = schedule
        self.sharding = None  # parallel/fsdp.py::Sharding, once the state is sharded
        self.clip_grad_norm = float(clip_grad_norm) if clip_grad_norm else None
        self.count = 0  # updates applied so far
        groups: Dict[Tuple[str, bool], list] = {}
        for name, p in model.named_parameters():
            label = param_label(name, frozen_modules)
            p.requires_grad_(label != FROZEN)
            if label != FROZEN:
                decay = opt_type == "sgd" or decays(model, name, p)
                groups.setdefault((label, decay), []).append(p)
        self.params = [p for ps in groups.values() for p in ps]
        self._names = {n: p for n, p in model.named_parameters() if p.requires_grad}
        param_groups = [
            {"params": ps, "mult": float(lr_mults.get(label, 1.0)),
             "weight_decay": weight_decay if decay else 0.0}
            for (label, decay), ps in groups.items()
        ]
        if opt_type == "adamw":
            self.inner = torch.optim.AdamW(param_groups, lr=0.0, betas=tuple(betas), eps=eps,
                                           weight_decay=weight_decay)
        else:
            self.inner = torch.optim.SGD(param_groups, lr=0.0, momentum=momentum,
                                         weight_decay=weight_decay)

    @property
    def lr(self) -> float:
        """The base lr the next update applies (before the group multipliers)."""
        return float(self.schedule(self.count))

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def step(self) -> None:
        """Apply one update from the parameters' `.grad` (None counts as 0)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.clip_grad_norm:
            norm = torch.sqrt(self._squares())
            factor = torch.where(norm < self.clip_grad_norm, torch.ones_like(norm),
                                 self.clip_grad_norm / norm)
            for p in self.params:
                p.grad.mul_(factor.to(p.grad.dtype))
        lr = self.lr
        for group in self.inner.param_groups:
            group["lr"] = lr * group["mult"]
        self.inner.step()
        self.count += 1

    def _squares(self) -> torch.Tensor:
        """The sum of squares of every trainable gradient: over a sharded
        state each rank adds its parts, each value once (a part held by k
        ranks weighs 1/k), and the sum is all-reduced over every rank."""
        if self.sharding is None:
            return sum((p.grad.float() ** 2).sum() for p in self.params)
        weights = {id(p): self.sharding.norm_weight(n) for n, p in self._names.items()}
        total = sum((p.grad.float() ** 2).sum() * weights[id(p)] for p in self.params)
        return mesh_lib.sum_across(total, world=True)

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.count = int(state["count"])


def _lr_mults_from_cfg(get) -> Optional[Dict[str, float]]:
    """Per-module lr multipliers: `lr_mults: {backbone: 0.1}` or the heritage
    `paramwise: {backbone_lr_mult: 0.1, text_encoder_lr_mult: 0.0}`."""
    mults = dict(get("lr_mults", None) or {})
    paramwise = get("paramwise", None) or {}
    for key in ("backbone", "text_encoder"):
        v = paramwise.get(f"{key}_lr_mult", None)
        if v is not None:
            mults.setdefault(key, float(v))
    return {k: float(v) for k, v in mults.items()} or None


def frozen_modules_from_cfg(training_cfg, default: Tuple[str, ...] = DEFAULT_FROZEN_MODULES
                            ) -> Tuple[str, ...]:
    """Frozen set implied by the lr multipliers: a positive multiplier
    unfreezes its module (heritage backbone x0.1), exactly 0 freezes it."""
    frozen = set(default)
    for name, mult in (_lr_mults_from_cfg(training_cfg.get) or {}).items():
        if float(mult) > 0.0:
            frozen.discard(name)
        else:
            frozen.add(name)
    return tuple(sorted(frozen))


@dataclass
class TrainState:
    """What a train step mutates: the model (parameters and BatchNorm
    statistics, in place), the optimizer, and the global step count (which,
    unlike `optimizer.count`, also counts non-finite steps that were skipped)."""

    model: nn.Module
    optimizer: Optimizer
    step: int = 0
    sharding: Optional[object] = None  # parallel/fsdp.py::Sharding over a model / data axis


def create_train_state(model: nn.Module, training_cfg, steps_per_epoch: int,
                       frozen_modules: Optional[Tuple[str, ...]] = None) -> TrainState:
    """TrainState from the `training:` config section (the JAX package's schema)."""
    from denseclip_vit_multimodal_tpu_torch.train.schedules import build_schedule

    opt_cfg = training_cfg.get("optimizer", {}) or {}
    if frozen_modules is None:
        frozen_modules = frozen_modules_from_cfg(training_cfg)
    optimizer = Optimizer(
        model, build_schedule(training_cfg, steps_per_epoch),
        weight_decay=float(opt_cfg.get("weight_decay", 0.01)),
        betas=tuple(opt_cfg.get("betas", (0.9, 0.999))),
        eps=float(opt_cfg.get("eps", 1e-8)),
        clip_grad_norm=training_cfg.get("clip_grad_norm", None),
        frozen_modules=frozen_modules,
        lr_mults=_lr_mults_from_cfg(training_cfg.get),
        opt_type=str(opt_cfg.get("type", "AdamW")),
        momentum=float(opt_cfg.get("momentum", 0.0)),
    )
    return TrainState(model=model, optimizer=optimizer)
