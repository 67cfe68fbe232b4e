"""Parallelism of the port over a `torch.distributed` process group (one card
a rank): `mesh` resolves the `tpu.mesh` spec and carries the group's
collectives; `sharding_rules`, `tensor_parallel` and `fsdp` shard the train
state over the model and data axes; `ring_attention` shards the sequence over
the ring; `pipeline` runs the ViT's blocks as a GPipe pipeline over a pipe
axis.  What the port does not do yet is refused (`mesh.check_ported`)."""
