"""Synthetic request streams (port of ``repro.serve.workload.lidar_stream``)."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.core.device import DeviceLike
from repro_torch.data.synthetic import lidar_scene, scene_bound
from repro_torch.serve.batcher import Scene, scene_from_tensor


def lidar_stream(seed: int, count: int, channels: int,
                 n_range: Tuple[int, int] = (200, 1200),
                 extent: float = 50.0, voxel: float = 0.4,
                 device: DeviceLike = None) -> Tuple[List[Scene], int]:
    """``count`` mixed-size LiDAR scenes (point counts drawn from
    ``n_range``) and the spatial bound they all respect.  Deterministic in
    ``seed``; voxelization runs on ``device`` (None → the CUDA card)."""
    rng = np.random.default_rng(seed)
    lo, hi = n_range
    scenes: List[Scene] = []
    for i in range(count):
        n = int(rng.integers(lo, hi + 1))
        st = lidar_scene(np.random.default_rng((seed, i)), n, n, channels,
                         extent=extent, voxel=voxel, device=device)
        scenes.append(scene_from_tensor(st))
    return scenes, scene_bound(extent, voxel)
