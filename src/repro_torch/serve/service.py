"""Serving configuration (port of ``repro.serve.service.ServiceConfig``:
the fields the serial ``Engine`` reads).

Two values are accepted but not yet served: ``max_inflight > 1`` (the
pipelined flush) and ``map_strategy`` "composed"/"incremental" (scene-
granular map reuse); the ``Engine`` raises ``NotImplementedError`` for
them (see ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.serve.bucketing import BucketLadder


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    buckets: Tuple[int, ...] = (512, 1024, 2048)
    max_batch: int = 4
    spatial_bound: int = 256
    seed: int = 0
    map_strategy: Optional[str] = None   # None: the plan's declared strategy
    maps_cache_size: int = 32
    max_inflight: int = 1
    plan_key: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "buckets", tuple(int(b) for b in self.buckets))
        self.ladder()   # validate

    def ladder(self) -> BucketLadder:
        return BucketLadder(self.buckets, max_batch=self.max_batch)
