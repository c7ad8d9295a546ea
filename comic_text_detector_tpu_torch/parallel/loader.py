"""Multi-process input sharding.

Counterpart of the JAX package's ``parallel/loader.py``:
``HostShardedDataset`` wraps any indexable dataset and exposes this
process's strided slice, with the rank and world size of
``torch.distributed`` in place of ``jax.process_index()`` and
``jax.process_count()``.

The trainers do not use it under a mesh: their datasets draw augments from
one sequential generator in fetch order, so a strided split would draw
other augments than the global batch; each rank runs the one-process
loader and takes its contiguous block of every global batch instead
(``training/steps.py``).
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist


class HostShardedDataset:
    """View of ``dataset`` holding every process_count-th item, offset by
    this process's index (deterministic, disjoint, near-equal shards).
    Without an initialised process group the process is rank 0 of 1."""

    def __init__(self, dataset, process_index: Optional[int] = None, process_count: Optional[int] = None):
        launched = dist.is_available() and dist.is_initialized()
        self.dataset = dataset
        if process_index is None:
            process_index = dist.get_rank() if launched else 0
        if process_count is None:
            process_count = dist.get_world_size() if launched else 1
        self.pi = process_index
        self.pc = process_count

    def __len__(self) -> int:
        n = len(self.dataset)
        return (n - self.pi + self.pc - 1) // self.pc

    def __getitem__(self, i: int):
        return self.dataset[self.pi + i * self.pc]

    def initialize(self):
        if hasattr(self.dataset, "initialize"):
            self.dataset.initialize()

    @property
    def img_size(self):
        return getattr(self.dataset, "img_size", None)
