"""ColorJitter of the port against the JAX package's, on the CPU.

The HSV helpers and the gray weights on the same inputs; the jitter with
its factors, hue offset and order given explicitly, against the JAX
function with its random draws replaced by the same values (the two
packages draw from different generators); the config mapping; and the
distribution checks of `tests/test_color_jitter.py` on the port's draws.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseclip_vit_multimodal_tpu.data import augment as j_aug
from denseclip_vit_multimodal_tpu_torch.core.config import Config
from denseclip_vit_multimodal_tpu_torch.data import augment as t_aug

# fp32 on [0, 255]: the same formulas evaluated by two libraries (the
# contrast mean summed in another order, the port's factors Python floats),
# through up to four ops and HSV: a few units of fp32's last place at 255
TOL = 1e-3

CFG = t_aug.AugmentConfig(brightness=0.4, contrast=0.4, saturation=0.4, hue=0.1,
                          color_jitter_prob=0.8)


def _img(seed=1, shape=(24, 32, 3)):
    img = np.random.RandomState(seed).randint(0, 256, shape).astype(np.float32)
    img[0, :6] = [[0, 0, 0], [255, 255, 255], [128, 128, 128], [255, 0, 0], [0, 255, 255],
                  [10, 200, 10]]  # gray (delta 0), primaries, a hue on each sector
    return img


def test_hsv_helpers_and_gray_match_jax():
    rgb = _img() / 255.0
    want = j_aug._rgb_to_hsv(jnp.asarray(rgb))
    got = t_aug._rgb_to_hsv(torch.from_numpy(rgb))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)
    h, s, v = (np.array(a) for a in want)
    h = (h + 0.37) % 1.0
    np.testing.assert_allclose(
        t_aug._hsv_to_rgb(*(torch.from_numpy(a) for a in (h, s, v))).numpy(),
        np.asarray(j_aug._hsv_to_rgb(jnp.asarray(h), jnp.asarray(s), jnp.asarray(v))),
        atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_aug._gray(torch.from_numpy(_img())).numpy(),
                               np.asarray(j_aug._gray(jnp.asarray(_img()))), atol=1e-5 * 255)


def _jax_jitter_with(monkeypatch, img, factors, order):
    """JAX's `_color_jitter` with its draws replaced: uniform -> the given
    factors in call order (brightness, contrast, saturation, hue),
    permutation -> `order`, bernoulli -> apply."""
    draws = iter(factors)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda *a, **k: jnp.asarray(next(draws), jnp.float32))
    monkeypatch.setattr(jax.random, "permutation", lambda *a, **k: jnp.asarray(order))
    monkeypatch.setattr(jax.random, "bernoulli", lambda *a, **k: jnp.asarray(True))
    cfg = j_aug.AugmentConfig(brightness=0.4, contrast=0.4, saturation=0.4, hue=0.1)
    return np.asarray(j_aug._color_jitter(jax.random.PRNGKey(0), jnp.asarray(img), cfg))


ORDERS = [(0, 1, 2, 3), (3, 2, 1, 0), (1, 3, 0, 2), (2, 0, 3, 1)]
FACTORS = [(1.3, 0.7, 1.25, 0.08), (0.65, 1.35, 0.6, -0.1), (1.0, 1.0, 1.0, 0.0)]


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("factors", FACTORS)
def test_explicit_jitter_matches_jax(monkeypatch, factors, order):
    img = _img()
    want = _jax_jitter_with(monkeypatch, img, factors, order)
    got = t_aug.color_jitter(torch.from_numpy(img), (*factors, order)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert got.min() >= 0.0 and got.max() <= 255.0


DATA_CFGS = [
    {},
    {"color_jitter": True},
    {"color_jitter": True, "augment": {"hue": 0.05, "brightness": 0.2}},
    {"color_jitter": False, "augment": {"saturation": 0.3, "color_jitter_prob": 0.5}},
]


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("data", DATA_CFGS)
def test_config_mapping_matches_jax(data, train):
    got = t_aug.augment_config_from_data_cfg(Config(data), train=train)
    want = j_aug.augment_config_from_data_cfg(data, train=train)
    for key in ("brightness", "contrast", "saturation", "hue", "color_jitter_prob", "hflip_prob"):
        assert getattr(got, key) == getattr(want, key), key
    if data.get("color_jitter") and train:
        assert (got.brightness, got.contrast, got.saturation, got.hue,
                got.color_jitter_prob) == (0.4 if "augment" not in data else 0.2, 0.4, 0.4,
                                           0.1 if "augment" not in data else 0.05, 0.8)


def test_draw_ranges_and_apply_probability():
    """Factors in [max(0, 1 - x), 1 + x], the hue offset in [-hue, hue], the
    order a permutation, and the jitter applied ~80% of the time at p 0.8."""
    gen = torch.Generator().manual_seed(0)
    draws = [t_aug._sample_jitter(gen, CFG) for _ in range(400)]
    applied = [d for d in draws if d is not None]
    assert 0.74 <= len(applied) / len(draws) <= 0.86, len(applied)
    for fb, fc, fs, fh, order in applied:
        assert all(0.6 <= f <= 1.4 for f in (fb, fc, fs)) and -0.1 <= fh <= 0.1
        assert sorted(order) == [0, 1, 2, 3]
    assert len({d[4] for d in applied}) > 10  # the order is drawn, not fixed
    for values in zip(*[d[:4] for d in applied]):
        assert np.std(values) > 0.02


def test_disabled_or_zero_probability_draws_no_jitter():
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    assert t_aug._sample_jitter(gen, t_aug.AugmentConfig()) is None
    assert torch.equal(gen.get_state(), state)  # no draw at all: the geometry stream is unchanged
    zero = CFG._replace(color_jitter_prob=0.0)
    assert all(t_aug._sample_jitter(gen, zero) is None for _ in range(50))


def test_op_order_changes_the_result():
    img = torch.from_numpy(_img())
    outs = {order: t_aug.color_jitter(img, (1.3, 0.7, 1.25, 0.08, order))
            for order in itertools.permutations(range(4))}
    distinct = {tuple(np.round(o.numpy().ravel()[:200], 3)) for o in outs.values()}
    assert len(distinct) > 12


def test_hue_only_keeps_the_value_channel():
    img = torch.from_numpy(_img())
    out = t_aug.color_jitter(img, (1.0, 1.0, 1.0, 0.5, (3, 0, 1, 2)))
    np.testing.assert_allclose(out.max(-1).values.numpy(), img.max(-1).values.numpy(), atol=1e-2)


def test_augment_batch_jitters_after_the_flip_and_before_normalisation():
    """augment_batch = per sample: geometry, then jitter, drawn in that order
    from one generator; the jitter acts on the resampled [0, 255] crop."""
    rs = np.random.RandomState(4)
    batch = {"image": torch.from_numpy(rs.randint(0, 256, (2, 32, 48, 3)).astype(np.uint8)),
             "seg": torch.from_numpy(rs.randint(0, 19, (2, 32, 48)).astype(np.uint8))}
    cfg = CFG._replace(crop_size=(24, 40), color_jitter_prob=1.0)
    got = t_aug.augment_batch(batch, cfg, torch.Generator().manual_seed(9))
    gen = torch.Generator().manual_seed(9)
    for i in range(2):
        geometry = t_aug._sample_geometry(gen, (32, 48), cfg)
        jitter = t_aug._sample_jitter(gen, cfg)
        assert jitter is not None
        plain = t_aug.augment_sample(batch["image"][i], batch["seg"][i], None,
                                     cfg._replace(brightness=0.0, contrast=0.0, saturation=0.0,
                                                  hue=0.0), geometry)
        resampled = plain["image"] * torch.tensor(cfg.norm_std) + torch.tensor(cfg.norm_mean)
        want = t_aug.normalize_image(t_aug.color_jitter(resampled * 255.0, jitter),
                                     cfg.norm_mean, cfg.norm_std)
        np.testing.assert_allclose(got["image"][i].numpy(), want.numpy(), atol=1e-3)
        assert torch.equal(got["seg"][i], plain["seg"])
