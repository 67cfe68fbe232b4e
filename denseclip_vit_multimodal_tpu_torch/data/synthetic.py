"""Synthetic dataset: structured random Cityscapes-like samples.

The PyTorch port's own copy of the JAX package's `data/synthetic.py` (numpy
only; the port imports nothing of the JAX package).  It backs smoke tests and
training runs without any data on disk; samples are deterministic in
(seed, idx) and identical to the JAX package's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class SyntheticDataset:
    """Random image / seg / (optional) depth triplets at a fixed size."""

    def __init__(
        self,
        length: int = 64,
        image_size: Tuple[int, int] = (1024, 2048),
        num_classes: int = 19,
        with_depth: bool = True,
        depth_max: float = 80.0,
        seed: int = 0,
        ignore_index: int = 255,
        cache: bool = False,
        learnable: bool = False,
    ):
        self.length = length
        self.image_size = tuple(image_size)
        self.num_classes = num_classes
        self.with_depth = with_depth
        self.depth_max = depth_max
        self.seed = seed
        self.ignore_index = ignore_index
        # learnable=True derives seg/depth DETERMINISTICALLY from the block
        # colors (class = brightness bucket, depth = red-channel ramp), so
        # a model can actually fit the mapping and validation accuracy on
        # held-out samples (different seed per split) measures real
        # end-to-end learning — the convergence test
        # (tests/test_convergence.py) and learning-curve demos use it.
        # Default False keeps the label-independent stream benchmarks use.
        self.learnable = learnable
        # cache=True memoizes generated samples by index: benchmarks use it
        # to measure the loader MACHINERY (threads/stacking/prefetch/H2D)
        # with the synthetic-generation cost amortized away, the way a real
        # dataset amortizes decode across OS page cache + many cores.
        self._cache: dict | None = {} if cache else None

    def __len__(self) -> int:
        return self.length

    @staticmethod
    def _block_upsample(small: np.ndarray, f: int, h: int, w: int) -> np.ndarray:
        """32x block upsample via broadcast+reshape: one plain copy.

        (np.kron here multiplied against a ones block — ~15x slower; at
        1024x2048 it alone capped the loader at ~8 samples/s host-side,
        caught by bench_suite workload 8.)
        """
        bh, bw = small.shape[:2]
        tail = small.shape[2:]
        out = np.broadcast_to(
            small[:, None, :, None], (bh, f, bw, f) + tail
        ).reshape((bh * f, bw * f) + tail)
        return np.ascontiguousarray(out[:h, :w])

    def __getitem__(self, idx: int):
        if not 0 <= idx < self.length:
            raise IndexError(idx)
        if self._cache is not None and idx in self._cache:
            return dict(self._cache[idx])  # shallow copy; arrays read-only
        rng = np.random.RandomState(self.seed * 100003 + idx)
        h, w = self.image_size
        # Blocky structure so downscaled labels stay self-consistent.
        bh, bw = max(h // 32, 1), max(w // 32, 1)
        img_small = rng.randint(0, 256, (bh, bw, 3), dtype=np.uint8)
        if self.learnable:
            s = img_small.astype(np.int32).sum(-1)  # 0..765 brightness
            seg_small = np.minimum(
                (s * self.num_classes) // 766, self.num_classes - 1
            ).astype(np.uint8)
        else:
            seg_small = rng.randint(0, self.num_classes, (bh, bw)).astype(
                np.uint8
            )
        # channel-trailing arrays: broadcast+reshape degenerates to a 3-byte
        # strided copy (34 ms vs repeat's 5.4 ms at 1024x2048, measured)
        image = np.repeat(np.repeat(img_small, 32, axis=0), 32, axis=1)[:h, :w]
        seg = self._block_upsample(seg_small, 32, h, w)
        # Sprinkle ignore pixels like real gtFine borders (~2%); one uint8
        # byte stream thresholded — full-res float64 rand() fields were the
        # other host-pipeline bottleneck at 1024x2048.
        noise = np.frombuffer(rng.bytes(h * w), np.uint8).reshape(h, w)
        seg[noise < 5] = self.ignore_index
        sample = {"image": image, "seg": seg}
        if self.with_depth:
            if self.learnable:
                depth_small = (
                    1.0
                    + img_small[..., 0].astype(np.float32)
                    / 255.0
                    * (self.depth_max * 0.25)
                )
            else:
                depth_small = rng.uniform(
                    1.0, self.depth_max, (bh, bw)
                ).astype(np.float32)
            depth = self._block_upsample(depth_small, 32, h, w)
            holes = np.frombuffer(rng.bytes(h * w), np.uint8).reshape(h, w)
            depth[holes < 26] = 0.0  # ~10% invalid holes
            sample["depth"] = depth
        if self._cache is not None:
            # freeze cached arrays: an in-place consumer mutation must fail
            # loudly instead of silently corrupting every later epoch
            for v in sample.values():
                v.setflags(write=False)
            self._cache[idx] = sample
            # hand out a shallow copy like cache hits do, so a consumer
            # reassigning a key can't mutate the cached dict itself
            return dict(sample)
        return sample
