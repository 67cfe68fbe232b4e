"""Parallelism of the port: `mesh` resolves the `tpu.mesh` spec as the JAX
package does and refuses a mesh over more than one device (the port trains
on one)."""
