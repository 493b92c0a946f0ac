"""Synthetic LiDAR-like point clouds (port of ``repro.data.synthetic``).

Drawn from a numpy ``Generator``, with the same distributions as the JAX
generator (a ground plane plus 32 Gaussian clusters, clipped to a declared
region, one point per voxel after ``voxelize``); the numbers differ from the
JAX ones because the random streams do.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.sparse_tensor import SparseTensor, voxelize


def scene_bound(extent: float, voxel: float, margin: float = 8.0) -> int:
    """Declared |voxel coord| bound of scenes clipped to [-margin, extent+margin]."""
    return int(np.ceil((extent + margin) / voxel)) + 2


def lidar_scene(rng: np.random.Generator, n_points: int, capacity: int,
                channels: int, extent: float = 100.0, voxel: float = 0.2,
                batch_size: int = 1, device: DeviceLike = None) -> SparseTensor:
    """Point cloud with ground-plane + cluster structure, voxelized on
    ``device`` (None → the CUDA card)."""
    dev = resolve_device(device)
    n_ground = n_points // 2
    ground = np.stack([rng.uniform(size=n_ground) * extent,
                       rng.uniform(size=n_ground) * extent,
                       rng.normal(size=n_ground) * 0.2 + 1.0], axis=1)
    n_obj = n_points - n_ground
    centers = rng.uniform(size=(32, 3)) * np.array([extent, extent, 4.0])
    assign = rng.integers(0, 32, size=n_obj)
    objs = centers[assign] + rng.normal(size=(n_obj, 3)) * np.array([1.5, 1.5, 0.8])
    margin = 8.0
    pts = np.clip(np.concatenate([ground, objs], axis=0), -margin, extent + margin)
    feats = rng.normal(size=(n_points, channels))
    bidx = rng.integers(0, batch_size, size=n_points)
    return voxelize(torch.as_tensor(pts, dtype=torch.float32, device=dev),
                    torch.as_tensor(feats, dtype=torch.float32, device=dev),
                    voxel, capacity,
                    batch_idx=torch.as_tensor(bidx, dtype=torch.int32, device=dev),
                    batch_size=batch_size,
                    spatial_bound=scene_bound(extent, voxel, margin))
