"""Parallelism of the port: `mesh` resolves the `tpu.mesh` spec over a
`torch.distributed` process group (one card a rank) and carries the group's
reductions; the data axis trains, and the other axes, FSDP and the ring
are refused."""
