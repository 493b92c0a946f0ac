"""Capacity buckets for the sparse serving engine (port of
``repro.serve.bucketing``).

Batches are padded to the smallest of a short ladder of static row
capacities.  PyTorch does not recompile per shape, but the ladder still
bounds the set of shapes the kernels see and keeps the capacity contract
that makes a batched forward bit-identical to the per-scene one.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class BucketLadder:
    """A strictly ascending ladder of static row capacities; ``max_batch``
    scenes per packed batch (the batched tensor's declared ``batch_bound``)."""

    capacities: Tuple[int, ...]
    max_batch: int = 8

    def __post_init__(self):
        caps = tuple(int(c) for c in self.capacities)
        if not caps or any(c <= 0 for c in caps):
            raise ValueError(f"capacities must be positive: {caps}")
        if list(caps) != sorted(set(caps)):
            raise ValueError(f"ladder must ascend: {caps}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        object.__setattr__(self, "capacities", caps)

    @property
    def max_capacity(self) -> int:
        return self.capacities[-1]

    def select(self, n_rows: int) -> int:
        """Smallest bucket capacity that fits ``n_rows``."""
        for cap in self.capacities:
            if n_rows <= cap:
                return cap
        raise ValueError(
            f"{n_rows} rows exceed the largest bucket ({self.max_capacity}); "
            f"ladder={self.capacities}")
