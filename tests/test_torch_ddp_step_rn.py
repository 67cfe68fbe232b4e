"""A 2-rank data-parallel train step of the port's tiny ResNet DenseCLIP
(BatchNorm in the trunk, context decoder, FPN) against the JAX package's
train step over a `{data: 2}` mesh of two virtual CPU devices, on the same
global batch at dropout 0: the loss, every trainable gradient and the
global BatchNorm statistics (`tests/test_torch_ddp_step.py` holds the ViT
the same way, and says how)."""

import pytest

import torch_ddp
from test_torch_ddp_step import _case, _jax_two_device_step, _rn_cfg, check_step


@pytest.fixture(scope="module")
def runs():
    case = _case(_rn_cfg(), (64, 96), False, 1, seed=5)
    ranks = torch_ddp.start({"rn": case[-1]})
    want = _jax_two_device_step(*case[:-1])
    return want, [r["rn"] for r in ranks.join()]


def test_two_rank_resnet_step_matches_jax_two_device_step(runs):
    check_step(*runs)
