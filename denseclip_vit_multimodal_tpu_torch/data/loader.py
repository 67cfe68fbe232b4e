"""Host data loader (PyTorch port of the JAX package's `data/loader.py`).

  * decode threads instead of worker processes (the augmentation math runs on
    the device, `data/augment.py`, so the host only decodes and stacks);
  * an epoch-seeded shuffle, `np.random.RandomState(seed + epoch)`, the same
    order as the JAX loader's (`shuffle=False`: dataset order, for
    evaluation); the last partial batch is dropped unless `drop_last=False`;
  * per-process sharding as JAX's: the epoch's order tiled by `np.resize`
    to ceil(n / P) * P indices, and rank r reads `order[r::P]`, so every
    rank has the same count (the tail wraps round, duplicates included);
    `process_index` / `process_count` default to the process group's;
  * `microbatches` > 1 (gradient accumulation over a group): the global
    batch b is the ranks' JAX batches in rank order, its microbatch i the
    global rows [i m, (i+1) m), and rank r reads its m / P rows of each, in
    microbatch order, so the step needs no exchange (`train/step.py`);
  * failed samples are resampled (next index), so every batch keeps its shape;
  * `to_device` copies a host batch into pinned memory and then to the card
    with `non_blocking`, so the copy overlaps the previous step's kernels.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from denseclip_vit_multimodal_tpu_torch.parallel import mesh as mesh_lib


def _stack_batch(samples) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class DataLoader:
    """Epoch-based loader over a map-style dataset returning dict samples."""

    def __init__(self, dataset, batch_size: int, seed: int = 0, num_threads: int = 8,
                 shuffle: bool = True, drop_last: bool = True,
                 process_index: Optional[int] = None, process_count: Optional[int] = None,
                 microbatches: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.num_threads = max(1, num_threads)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.process_index = mesh_lib.rank() if process_index is None else process_index
        self.process_count = mesh_lib.world_size() if process_count is None else process_count
        self.microbatches = int(microbatches)
        if self.microbatches > 1 and (batch_size % self.microbatches or not drop_last):
            raise ValueError(f"batch {batch_size} a process does not split into "
                             f"{self.microbatches} microbatches of whole rows")

    def _per_process_count(self) -> int:
        return -(-len(self.dataset) // self.process_count)

    def __len__(self) -> int:
        n = self._per_process_count()
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _order(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        order = np.random.RandomState(self.seed + epoch).permutation(n) if self.shuffle \
            else np.arange(n)
        total = self._per_process_count() * self.process_count
        return np.resize(order, total) if total > n else order

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        """This process's indices of the epoch (JAX's `_epoch_indices`)."""
        return self._order(epoch)[self.process_index::self.process_count]

    def batch_indices(self, epoch: int = 0) -> List[np.ndarray]:
        """The dataset indices of each batch this process reads in `epoch`."""
        bs, nb = self.batch_size, len(self)
        if self.microbatches == 1:
            idx = self._epoch_indices(epoch)
            return [idx[b * bs:(b + 1) * bs] for b in range(nb)]
        order, procs = self._order(epoch), self.process_count
        per = bs // self.microbatches  # rows of each microbatch on one process
        out = []
        for b in range(nb):
            glob = np.concatenate([order[q::procs][b * bs:(b + 1) * bs] for q in range(procs)])
            micro = per * procs
            out.append(np.concatenate([glob[i * micro + self.process_index * per:][:per]
                                       for i in range(self.microbatches)]))
        return out

    def _fetch(self, idx: int) -> Dict[str, np.ndarray]:
        n = len(self.dataset)
        for attempt in range(16):
            sample = self.dataset[(idx + attempt) % n]
            if sample is not None:
                return sample
        raise RuntimeError(f"16 consecutive decode failures starting at index {idx}")

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Yield stacked host batches for one epoch, decoding in threads."""
        batches = self.batch_indices(epoch)
        nb = len(batches)
        with cf.ThreadPoolExecutor(self.num_threads) as pool:
            window = collections.deque()  # ~2 batches of decodes in flight

            def submit(b):
                return [pool.submit(self._fetch, int(i)) for i in batches[b]]

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
    """Dataset dispatch on `data.dataset_type`: the synthetic backend
    (`data.synthetic: true` or type SyntheticDataset), the Cityscapes readers
    (CityscapesDepthSegDataset, CityscapesDataset) and ADE20K
    (ADE20KSegmentation / ADE20K), rooted at `data.path`."""
    dtype_name = data_cfg.get("dataset_type", "CityscapesDepthSegDataset")
    root = str(data_cfg.get("path", "data/cityscapes"))
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
    if dtype_name == "CityscapesDepthSegDataset":
        from denseclip_vit_multimodal_tpu_torch.data.cityscapes import CityscapesDepthSegDataset

        return CityscapesDepthSegDataset(root, split=split,
                                         depth_max=float(data_cfg.get("depth_max", 80.0)))
    if dtype_name == "CityscapesDataset":
        from denseclip_vit_multimodal_tpu_torch.data.cityscapes import CityscapesDataset

        return CityscapesDataset(root, split=split)
    if dtype_name in ("ADE20KSegmentation", "ADE20K"):
        from denseclip_vit_multimodal_tpu_torch.data.ade20k import ADE20KSegmentation

        return ADE20KSegmentation(root, split=split)
    raise ValueError(f"Unsupported dataset_type: {dtype_name}")
