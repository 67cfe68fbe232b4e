"""The port's forward kernels as `torch.library` ops, in the namespace `denseclip_torch`.

`torch.export` and `torch.compile` cannot trace a ctypes launch (it reads
`data_ptr()` of real tensors), so each forward launch is an op with three
implementations, registered through the low-level API (`Library.define` /
`impl` and `register_fake`; `torch.library.custom_op` adds a Python layer to
every call):

* CUDA: the kernel's launch as it was, with its launch count and its FLOPs
  handed to `utils/flops.py::record_kernel_flops`;
* CPU: the kernel's plain version;
* fake: the output shapes and dtypes, touching no data (tracing and export);
* a FLOP formula for `torch.utils.flop_counter.FlopCounterMode`: on the CPU
  the count FlopCounterMode would give the plain version's own ops, which it
  cannot see inside the op; on CUDA zero, since the launch hands its FLOPs
  to `utils/flops.py`'s tally (`program_flops` adds both).

The dispatcher picks the implementation by the inputs' device.  The kernel
wrappers call the op on every device; the autograd functions' forwards that
also write row statistics for a backward kernel launch directly, since the
backward kernels are not ops.  The ops are registered when their module is
imported (`ops/mha_kernel.py`: K1, K3, K5 and its prologue; `ops/attention.py`:
K4; `ops/lnqkv_kernel.py`: K6); `infer/exported.py` imports all three before
it loads an exported program.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.flop_counter import register_flop_formula

NAMESPACE = "denseclip_torch"
_LIB = torch.library.Library(NAMESPACE, "FRAGMENT")


def define(schema: str, cpu: Callable, cuda: Callable, fake: Callable,
           flops: Optional[Callable[..., int]] = None) -> torch._ops.OpOverload:
    """Define the op `schema` in the namespace with its CPU, CUDA and fake
    implementations and, where it does matmul work, `flops(*args)`: its
    plain version's FLOPs.  Returns its overload, which the wrappers call."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    packet = getattr(getattr(torch.ops, NAMESPACE), name)
    if flops is not None:
        def formula(*args, out_val=None, **kwargs) -> int:
            return flops(*args) if args[0].device.type == "cpu" else 0

        register_flop_formula(packet, get_raw=True)(formula)
    return packet.default
