"""Host data loader (PyTorch port of the JAX package's `data/loader.py`).

  * decode threads instead of worker processes (the augmentation math runs on
    the device, `data/augment.py`, so the host only decodes and stacks);
  * an epoch-seeded shuffle, `np.random.RandomState(seed + epoch)`, the same
    order as the JAX loader's (`shuffle=False`: dataset order, for
    evaluation); the last partial batch is dropped unless `drop_last=False`;
  * failed samples are resampled (next index), so every batch keeps its shape;
  * `to_device` copies a host batch into pinned memory and then to the card
    with `non_blocking`, so the copy overlaps the previous step's kernels.

One process: the JAX loader's per-process sharding has no counterpart until
the port's parallel slice.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
from typing import Dict, Iterator

import numpy as np
import torch


def _stack_batch(samples) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class DataLoader:
    """Epoch-based loader over a map-style dataset returning dict samples."""

    def __init__(self, dataset, batch_size: int, seed: int = 0, num_threads: int = 8,
                 shuffle: bool = True, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.num_threads = max(1, num_threads)
        self.shuffle = shuffle
        self.drop_last = drop_last

    def __len__(self) -> int:
        if self.drop_last:
            return len(self.dataset) // self.batch_size
        return -(-len(self.dataset) // self.batch_size)

    def _fetch(self, idx: int) -> Dict[str, np.ndarray]:
        n = len(self.dataset)
        for attempt in range(16):
            sample = self.dataset[(idx + attempt) % n]
            if sample is not None:
                return sample
        raise RuntimeError(f"16 consecutive decode failures starting at index {idx}")

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Yield stacked host batches for one epoch, decoding in threads."""
        n = len(self.dataset)
        indices = (np.random.RandomState(self.seed + epoch).permutation(n) if self.shuffle
                   else np.arange(n))
        nb = len(self)
        with cf.ThreadPoolExecutor(self.num_threads) as pool:
            window = collections.deque()  # ~2 batches of decodes in flight

            def submit(b):
                lo = b * self.batch_size
                return [pool.submit(self._fetch, int(i)) for i in indices[lo:lo + self.batch_size]]

            cursor = 0
            while cursor < min(2, nb):
                window.append(submit(cursor))
                cursor += 1
            while window:
                futures = window.popleft()
                if cursor < nb:
                    window.append(submit(cursor))
                    cursor += 1
                yield _stack_batch([f.result() for f in futures])


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Host batch -> tensors on `device` (pinned and non-blocking on CUDA)."""
    device = torch.device(device)
    out = {}
    for key, value in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(value))
        if device.type == "cuda":
            t = t.pin_memory()
        out[key] = t.to(device, non_blocking=True)
    return out


def build_dataset(data_cfg, split: str):
    """Dataset dispatch on `data.dataset_type`; only the synthetic backend
    (`data.synthetic: true` or type SyntheticDataset) is ported."""
    dtype_name = data_cfg.get("dataset_type", "CityscapesDepthSegDataset")
    if dtype_name == "SyntheticDataset" or data_cfg.get("synthetic", False):
        from denseclip_vit_multimodal_tpu_torch.data.synthetic import SyntheticDataset

        syn = data_cfg.get("synthetic_options", {}) or {}
        seg_only = dtype_name in ("CityscapesDataset", "ADE20KSegmentation", "ADE20K")
        return SyntheticDataset(
            length=int(syn.get("length", 64)),
            image_size=tuple(syn.get("image_size", (512, 1024))),
            num_classes=int(data_cfg.get("classes", 150 if "ADE20K" in dtype_name else 19)),
            with_depth=not seg_only and bool(syn.get("with_depth", True)),
            depth_max=float(data_cfg.get("depth_max", 80.0)),
            seed=int(syn.get("seed", 0)) + (0 if split == "train" else 7919),
            learnable=bool(syn.get("learnable", False)),
        )
    raise ValueError(f"dataset_type {dtype_name!r} not yet ported to the PyTorch package "
                     "(set data.synthetic=true)")
