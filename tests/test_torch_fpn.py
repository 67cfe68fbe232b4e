"""The port's FPN neck (`models/necks.py::FPN`) and the fusion neck's
per-level widths, against the JAX package's, on the CPU, at odd sizes.
fp32: max abs 1e-4 and relative L2 1e-5 (`torch_parity.py`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseclip_vit_multimodal_tpu.models import necks as j_necks
from denseclip_vit_multimodal_tpu_torch.models import necks as t_necks
from torch_parity import assert_parity, init, port, randn, t

# c1..c4 of a 72 x 100 input to CLIPResNet at width 8: odd and non-multiple sizes
SIZES = ((18, 25), (9, 12), (4, 6), (2, 3))
WIDTHS = (32, 64, 128, 256 + 19)  # the score map concatenated onto c4


def _feats(n=4):
    return [randn(2, *SIZES[i], WIDTHS[i], seed=i) for i in range(n)]


@pytest.mark.parametrize("num_outs", [None, 4, 5, 2], ids=lambda n: f"num_outs={n}")
def test_fpn_matches_jax(num_outs):
    feats = _feats()
    jm = j_necks.FPN(num_inputs=4, out_channels=16, num_outs=num_outs)
    v = init(jm, [jnp.asarray(f) for f in feats])
    tm = port(t_necks.FPN(4, WIDTHS, out_channels=16, num_outs=num_outs), v)
    want = jm.apply(v, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = tm([t(f) for f in feats])
    assert len(got) == len(want) == (num_outs or 4)
    for i, (a, b) in enumerate(zip(want, got)):
        assert_parity(a, b, what=f"level {i}")
    if num_outs == 5:  # LastLevelMaxPool: a 1x1 window at stride 2 over 2 x 3
        assert tuple(got[-1].shape) == (2, 1, 2, 16)


def test_fpn_guards():
    feats = [t(f) for f in _feats()]
    with pytest.raises(ValueError, match=r"FPN num_outs=6 > num_inputs\+1=5"):
        t_necks.FPN(4, WIDTHS, out_channels=8, num_outs=6)(feats)
    with pytest.raises(ValueError, match="FPN expected 4 inputs, got 3"):
        t_necks.FPN(4, WIDTHS, out_channels=8)(feats[:3])
    with pytest.raises(ValueError, match="3 input widths for 4 inputs"):
        t_necks.FPN(4, WIDTHS[:3], out_channels=8)


def test_fpn_topdown_is_torch_floor_nearest():
    """With identity laterals and output conv, the finest level is the
    coarse one upsampled by torch's nearest (src = floor(dst * src / dst)),
    not half-pixel rounding: 3 x 3 -> 5 x 7."""
    fpn = t_necks.FPN(2, 4, out_channels=4)
    with torch.no_grad():
        for conv in (fpn.lateral[0], fpn.lateral[1], fpn.output[0]):
            conv.bias.zero_()
            conv.weight.zero_()
        fpn.lateral[1].weight[:, :, 0, 0] = torch.eye(4)
        fpn.output[0].weight[:, :, 1, 1] = torch.eye(4)
        coarse = torch.from_numpy(np.random.RandomState(0).rand(1, 3, 3, 4).astype(np.float32))
        out = fpn([torch.zeros(1, 5, 7, 4), coarse])[0]
    ref = torch.nn.functional.interpolate(coarse.permute(0, 3, 1, 2), size=(5, 7), mode="nearest")
    torch.testing.assert_close(out, ref.permute(0, 2, 3, 1), atol=1e-6, rtol=0)


def test_fusion_neck_takes_per_level_widths():
    """A ViT level carrying the score map is wider than the others."""
    feats = [randn(2, 5, 7, c, seed=i) for i, c in enumerate((16, 16 + 19, 16))]
    jm = j_necks.ViTFeatureFusionNeck(num_inputs=3, out_channels=24, inter_channels=8)
    v = init(jm, [jnp.asarray(f) for f in feats])
    tm = port(t_necks.ViTFeatureFusionNeck(3, [16, 35, 16], 24, inter_channels=8), v)
    with torch.no_grad():
        assert_parity(jm.apply(v, [jnp.asarray(f) for f in feats]), tm([t(f) for f in feats]))
