"""The port's data-parallel input on the CPU, in one process: the loader's
per-process index lists against the JAX package's `DataLoader(...,
process_index, process_count)`, the microbatch grouping against JAX's
reshape of the global batch, and a rank's augmentation draws and dropout /
drop-path masks against the one-process run's rows (which are the
one-process port's draws, bit for bit)."""

from typing import Dict

import numpy as np
import pytest
import torch

from denseclip_vit_multimodal_tpu.data.loader import DataLoader as JLoader
from denseclip_vit_multimodal_tpu_torch.data import augment as t_aug
from denseclip_vit_multimodal_tpu_torch.data.loader import DataLoader as TLoader
from denseclip_vit_multimodal_tpu_torch.models import layers as t_layers
from denseclip_vit_multimodal_tpu_torch.train.step import microbatch_rows


class _Indices:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.asarray(i)}


def _lists(loader, epoch):
    return [b["i"].tolist() for b in loader.epoch(epoch)]


@pytest.mark.parametrize("world", [1, 2, 3, 8])
@pytest.mark.parametrize("n", [5, 16, 17])
def test_loader_index_lists_are_jax(n, world):
    """Every rank, both epochs, shuffled or not, with and without the last
    partial batch: the same batches of the same indices, and every rank the
    same count (wrap-padded)."""
    for shuffle in (True, False):
        for drop_last in (True, False):
            kw = dict(batch_size=2, seed=3, num_threads=2, shuffle=shuffle, drop_last=drop_last)
            counts = set()
            for rank in range(world):
                t = TLoader(_Indices(n), process_index=rank, process_count=world, **kw)
                j = JLoader(_Indices(n), process_index=rank, process_count=world, **kw)
                assert len(t) == len(j)
                counts.add(len(t))
                for epoch in (0, 1):
                    np.testing.assert_array_equal(t._epoch_indices(epoch), j._epoch_indices(epoch))
                    assert _lists(t, epoch) == _lists(j, epoch)
            assert len(counts) == 1


@pytest.mark.parametrize("world,local,accum", [(2, 2, 2), (2, 4, 2), (3, 2, 2), (2, 4, 4)])
def test_microbatch_rows_are_jax_grouping_of_the_global_batch(world, local, accum):
    """JAX's global batch is the ranks' batches in rank order, reshaped to
    (accum, micro): rank r's loader batch is its micro / world rows of each
    microbatch, in order, and the step's row map names the same rows."""
    n = 23
    kw = dict(batch_size=local, seed=5, num_threads=2)
    for epoch in (0, 1):
        jax_batches = [JLoader(_Indices(n), process_index=r, process_count=world, **kw)
                       ._epoch_indices(epoch) for r in range(world)]
        nb = len(jax_batches[0]) // local
        for b in range(nb):
            glob = np.concatenate([jb[b * local:(b + 1) * local] for jb in jax_batches])
            micro = glob.reshape(accum, -1)
            for rank in range(world):
                t = TLoader(_Indices(n), process_index=rank, process_count=world,
                            microbatches=accum, **kw)
                got = t.batch_indices(epoch)[b]
                per = local // accum
                want = np.concatenate([m[rank * per:(rank + 1) * per] for m in micro])
                np.testing.assert_array_equal(got, want)
                rows = microbatch_rows(local, accum, world, rank)[0]
                np.testing.assert_array_equal(glob[rows], want)


def test_microbatch_that_does_not_divide_by_the_world_raises():
    with pytest.raises(ValueError, match="batch 3 is not divisible by grad_accum_steps 2"):
        microbatch_rows(3, 2, 1, 0)
    with pytest.raises(ValueError, match="a microbatch of 1 rows .* does not divide by the 2"):
        microbatch_rows(1, 2, 2, 0)
    with pytest.raises(ValueError, match="microbatches of whole rows"):
        TLoader(_Indices(8), batch_size=3, microbatches=2)


def _parent_augment_batch(batch, cfg, gen):
    """The one-process port's augmentation before data parallelism: per
    sample, its geometry, then its jitter, then its resampling."""
    image = batch["image"]
    src_hw = (image.shape[1], image.shape[2])
    samples = []
    for i in range(image.shape[0]):
        geometry = t_aug._sample_geometry(gen, src_hw, cfg)
        samples.append(t_aug.augment_sample(image[i], batch["seg"][i], batch["depth"][i], cfg,
                                            geometry, t_aug._sample_jitter(gen, cfg)))
    return {k: torch.stack([s[k] for s in samples]) for k in samples[0]}


def _batch(b=6) -> Dict[str, torch.Tensor]:
    rs = np.random.RandomState(0)
    return {"image": torch.from_numpy(rs.randint(0, 256, (b, 40, 56, 3)).astype(np.uint8)),
            "seg": torch.from_numpy(rs.randint(0, 19, (b, 40, 56)).astype(np.int32)),
            "depth": torch.from_numpy(rs.uniform(0, 80, (b, 40, 56)).astype(np.float32))}


CFG = t_aug.AugmentConfig(crop_size=(32, 48), brightness=0.4, contrast=0.4, saturation=0.4,
                          hue=0.1, color_jitter_prob=0.8)


def test_augmentation_one_process_is_the_parents_bit_for_bit():
    batch = _batch()
    got = t_aug.augment_batch(batch, CFG, torch.Generator().manual_seed(11))
    want = _parent_augment_batch(batch, CFG, torch.Generator().manual_seed(11))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("world,accum", [(2, 1), (3, 1), (2, 3)])
def test_a_ranks_augmented_rows_are_the_one_process_rows(world, accum):
    glob = _batch(6)
    whole = t_aug.augment_batch(glob, CFG, torch.Generator().manual_seed(4))
    local = 6 // world
    for rank in range(world):
        rows, total, _, _ = microbatch_rows(local, accum, world, rank)
        mine = {k: v[rows] for k, v in glob.items()}
        got = t_aug.augment_batch(mine, CFG, torch.Generator().manual_seed(4), rows=rows,
                                  total=total)
        for k in whole:
            assert torch.equal(got[k], whole[k][rows]), (k, rank)


@pytest.mark.parametrize("kind", ["dropout", "drop_path"])
def test_a_ranks_masks_are_the_global_draws_rows(kind):
    x = torch.randn(6, 5, 7)
    fn = t_layers.dropout if kind == "dropout" else t_layers.drop_path
    whole = fn(x, 0.3, torch.Generator().manual_seed(9))
    # outside a data-parallel forward: the one-process draw, as the port drew it
    keep = torch.rand(x.shape if kind == "dropout" else (6, 1, 1),
                      generator=torch.Generator().manual_seed(9)) < 0.7
    assert torch.equal(whole, torch.where(keep, x * (1.0 / 0.7) if kind == "drop_path"
                                          else x / 0.7, torch.zeros_like(x)))
    for first, rows in ((0, 3), (3, 3), (2, 2)):
        with t_layers.batch_rows(first, 6):
            got = fn(x[first:first + rows], 0.3, torch.Generator().manual_seed(9))
        assert torch.equal(got, whole[first:first + rows])
    assert t_layers._BATCH_ROWS is None
