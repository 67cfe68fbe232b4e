"""Helpers of the port's parity tests against the JAX package (not a test
module): numpy-seeded inputs, perturbed Flax variables carried into the port,
and the fp32 tolerance check.

Flax parameters from `init` are perturbed with numpy noise (no LayerNorm scale
exactly 1, no BatchNorm statistic exactly 0 / 1) and loaded into the port
with `convert.load_flax_variables`.
"""

import jax
import numpy as np
import torch

from denseclip_vit_multimodal_tpu_torch.convert import load_flax_variables

# fp32 module parity: the same arithmetic summed in another order
MAX_ABS = 1e-4
REL_L2 = 1e-5


def randn(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


def perturb(variables, seed=1):
    """Numpy-noised copy of a Flax variables tree (BatchNorm variances in [0.5, 1.5])."""
    rs = np.random.RandomState(seed)
    out = {"params": jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rs.randn(*np.shape(a)).astype(np.float32),
        variables["params"])}
    if "batch_stats" in variables:
        out["batch_stats"] = jax.tree.map(
            lambda a: (rs.rand(*np.shape(a)) + 0.5).astype(np.float32), variables["batch_stats"])
    return out


def init(module, *args, seed=0, **kwargs):
    """`module.init` at PRNGKey(seed), perturbed, as numpy."""
    variables = module.init(jax.random.PRNGKey(seed), *args, **kwargs)
    return perturb(jax.tree.map(np.asarray, dict(variables)), seed=seed + 1)


def port(module, variables):
    return load_flax_variables(module, variables).eval()


def t(x):
    return torch.from_numpy(np.asarray(x))


def errors(want, got):
    """(max abs error, relative L2 error) of the port's `got` against `want`."""
    a = np.asarray(want, np.float32)
    b = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max()), float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def assert_parity(want, got, max_abs=MAX_ABS, rel_l2=REL_L2, what=""):
    err, rel = errors(want, got)
    assert err <= max_abs and rel <= rel_l2, f"{what}: max abs {err:.3g}, rel L2 {rel:.3g}"
