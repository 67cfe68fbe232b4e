"""Forward-FLOP accounting of the port, and the card's peak for MFU.

Port of the JAX package's `utils/flops.py`.  There, `compiled.cost_analysis()`
counts the program and an analytic make-up term adds what XLA cannot see: a
scanned ViT body counted once, and the Pallas attention counted zero.  Here:

  * `program_flops(fn, *args)` runs `fn` once and returns its forward FLOPs:
    the aten ops that ran, as `torch.utils.flop_counter.FlopCounterMode`
    counts them, plus the FLOPs of every hand-written kernel launched during
    the call.  Each kernel is a `torch.library` op (`ops/_library.py`) whose
    CUDA implementation launches through ctypes, so FlopCounterMode sees
    neither inside it: the blind spot the JAX module records for Pallas.
    The make-up term is keyed on the launches that happened, not on a copy
    of the dispatch rule: each forward launch calls `record_kernel_flops`
    next to its launch count, and the call appends to every open tally
    (`kernel_tally`); with no tally open it does nothing.  A run on the CPU,
    where the ops run the kernels' plain versions, launches nothing and so
    adds nothing: FlopCounterMode counts each op there by the formula
    registered with it (`ops/_library.py::define`), its plain version's
    count below, and counts it zero on CUDA, where the tally has it.
  * Each kernel's FLOPs (`attention_flops`, `projection_flops`) are the count
    FlopCounterMode gives its plain version at the same shapes, so the total
    is the same whichever implementation ran: K1, K3 and K4 4·B·N·kv_len·H·D
    (Q Kᵀ and P V); K5 the same, counted as operations at the bf16 peak, as
    the JAX accounting counts it; K6 that plus its qkv projection
    2·B·N·D·3·H·D, which it performs inside the kernel; K7 the attention plus
    its out-projection 2·B·N·(H·D)²; K5's prologue 0 (elementwise work).
    Backward kernels (K2, K3's backward, K4b) record nothing: the accounting
    is forward-only, as in JAX.
  * The port has no `nn.scan`: every ViT block runs as its own ops, so the
    JAX "scanned body counts once" term has no counterpart.

Convention, and how it differs from the JAX package's: FLOPs = 2 × MACs of
matmuls, convolutions and attention at the token counts the model runs,
padded (the ViT pads sequences of 1024 tokens or more to a multiple of 128:
dense layers count every padded row, attention N × kv_len with kv_len the
real tokens; plain attention, which masks rather than skips, counts N × N).
Elementwise work, normalisation and softmax count zero.  XLA's `flops` also
counts elementwise work, and the JAX make-up term uses real token counts, so
the port's MFU is not comparable with a TPU `mfu_pct`.

`vit_layer_dense_flops`, `vit_layer_attn_flops` and
`vit_backbone_flop_correction` are the JAX module's analytic terms, kept
equal to it so that the two accountings can be set side by side.
`device_peak_bf16_tflops` is keyed on `torch.cuda.get_device_name()` and
raises for a card it does not know: there is no default peak.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, List, NamedTuple, Tuple

# Dense (no sparsity) bf16 tensor-core peak by `torch.cuda.get_device_name()`,
# TFLOP/s, from NVIDIA's data sheets at the full power limit.
PEAK_BF16_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4,  # H100 SXM5 data sheet (1,979 with sparsity)
}

_OPEN_TALLIES: List[List[Tuple[str, int]]] = []


def peak_bf16_tflops(kind: str) -> float:
    """Dense bf16 peak of the card named `kind`, TFLOP/s; KeyError if unknown."""
    if kind not in PEAK_BF16_TFLOPS:
        raise KeyError(f"no bf16 peak known for {kind!r} (have {sorted(PEAK_BF16_TFLOPS)}); "
                       "add its data-sheet figure to PEAK_BF16_TFLOPS")
    return PEAK_BF16_TFLOPS[kind]


def device_peak_bf16_tflops(device=None) -> float:
    """Dense bf16 peak of the CUDA `device` (default: the current one), TFLOP/s."""
    import torch

    return peak_bf16_tflops(torch.cuda.get_device_name(device))


def vit_layer_dense_flops(tokens_total: int, width: int) -> int:
    """Dense-matmul FLOPs of one residual block over `tokens_total` tokens:
    qkv projection 6TW² + out projection 2TW² + MLP (4× expansion) 16TW²."""
    return 24 * tokens_total * width * width


def vit_layer_attn_flops(batch: int, tokens_per_seq: int, width: int) -> int:
    """Attention-matmul FLOPs of one block over full N × N scores: 4BN²W."""
    return 4 * batch * tokens_per_seq * tokens_per_seq * width


def vit_backbone_flop_correction(
    layers: int,
    width: int,
    batch: int,
    tokens_per_seq: int,
    attn_counted: bool = False,
) -> int:
    """The JAX package's make-up term for a scanned ViT backbone, which it
    adds to `cost_analysis()['flops']`: the dense term repeats (layers - 1)
    times, the attention term `layers` times when the attention ran as a
    Pallas kernel (`attn_counted=False`), else (layers - 1) times."""
    t = batch * tokens_per_seq
    dense = vit_layer_dense_flops(t, width)
    attn = vit_layer_attn_flops(batch, tokens_per_seq, width)
    n_attn = layers - 1 if attn_counted else layers
    return (layers - 1) * dense + n_attn * attn


def attention_flops(batch: int, queries: int, keys: int, width: int) -> int:
    """Q Kᵀ and P V over `queries` × `keys` scores of every head, H·D = `width`."""
    return 4 * batch * queries * keys * width


def projection_flops(batch: int, rows: int, in_dim: int, out_dim: int) -> int:
    """A [batch·rows, in_dim] × [in_dim, out_dim] product."""
    return 2 * batch * rows * in_dim * out_dim


def record_kernel_flops(name: str, flops: int) -> None:
    """Add one launch of kernel `name` doing `flops` to every open tally;
    nothing when none is open.  Called by the forward kernel wrappers next
    to their launch counts."""
    for tally in _OPEN_TALLIES:
        tally.append((name, int(flops)))


@contextlib.contextmanager
def kernel_tally() -> Iterator[List[Tuple[str, int]]]:
    """Collect (name, flops) of every forward kernel launched inside the block."""
    tally: List[Tuple[str, int]] = []
    _OPEN_TALLIES.append(tally)
    try:
        yield tally
    finally:
        _OPEN_TALLIES.remove(tally)


class FlopCount(NamedTuple):
    """Forward FLOPs of one call: `aten` by FlopCounterMode, `kernels` the
    make-up of the hand-written kernels launched (`by_kernel` by name)."""

    aten: int
    kernels: int
    by_kernel: Dict[str, int]

    @property
    def total(self) -> int:
        return self.aten + self.kernels


def program_flops(fn: Callable, *args, **kwargs) -> FlopCount:
    """Run `fn(*args, **kwargs)` once and count its forward FLOPs (module
    docstring).  Count forward calls only: FlopCounterMode would also count
    the aten ops of a backward run inside `fn`, and the tally would not.
    Warm `fn` up first where its first call differs: FlopCounterMode's
    module tracker fails on a module called under inference mode with a
    tensor that requires grad, as the `Inferencer`'s first call runs the
    text tower on its learnable contexts (later calls reuse its cache)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with kernel_tally() as launched, counter:
        fn(*args, **kwargs)
    by_kernel: Dict[str, int] = {}
    for name, flops in launched:
        by_kernel[name] = by_kernel.get(name, 0) + flops
    return FlopCount(int(counter.get_total_flops()), sum(by_kernel.values()), by_kernel)
