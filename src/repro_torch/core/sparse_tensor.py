"""Capacity-padded sparse tensors (port of ``repro.core.sparse_tensor``).

Every sparse tensor carries a static row capacity plus the number of valid
rows; padded rows hold ``INVALID_COORD`` in every column and zero features,
so kernel-map machinery never matches them.  PyTorch runs eagerly, but the
serving engine keeps the capacity contract: it is what makes a batched
forward bit-identical to the per-scene one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# Sentinel for padded coordinate rows (shifted/strided variants of a padded
# coordinate never collide with a real voxel key).
INVALID_COORD = 0x3FFFFFF


@dataclasses.dataclass(frozen=True)
class SparseTensor:
    """A batched, quantized point cloud.

    coords: (Nmax, 1 + D) int32 — [batch, x, y, z]; padded rows INVALID_COORD.
    feats:  (Nmax, C) — padded rows zero.
    num_valid: () int32 tensor — number of real rows.
    stride / batch_bound / spatial_bound: static ints, as in the JAX
        package (bounds feed the packed-key bit budget of ``core.hashing``).
    """

    coords: torch.Tensor
    feats: torch.Tensor
    num_valid: torch.Tensor
    stride: int = 1
    batch_bound: int = 0
    spatial_bound: int = 0

    @property
    def capacity(self) -> int:
        return self.coords.shape[0]

    @property
    def ndim_space(self) -> int:
        return self.coords.shape[1] - 1

    @property
    def device(self) -> torch.device:
        return self.coords.device

    @property
    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.device) < self.num_valid

    def replace_feats(self, feats: torch.Tensor) -> "SparseTensor":
        return dataclasses.replace(self, feats=feats)


def make_sparse_tensor(coords: torch.Tensor, feats: torch.Tensor, num_valid,
                       stride: int = 1, batch_bound: int = 0,
                       spatial_bound: int = 0) -> SparseTensor:
    """Build a SparseTensor, forcing padded rows to sentinel/zero."""
    n = coords.shape[0]
    nv = torch.as_tensor(num_valid, dtype=torch.int32, device=coords.device)
    mask = torch.arange(n, device=coords.device) < nv
    coords = torch.where(mask[:, None], coords.to(torch.int32),
                         torch.full_like(coords, INVALID_COORD, dtype=torch.int32))
    feats = torch.where(mask[:, None], feats, torch.zeros_like(feats))
    return SparseTensor(coords=coords, feats=feats, num_valid=nv, stride=stride,
                        batch_bound=batch_bound, spatial_bound=spatial_bound)


def voxelize(points: torch.Tensor, feats: torch.Tensor, voxel_size: float,
             capacity: int, batch_idx: Optional[torch.Tensor] = None,
             batch_size: int = 1, spatial_bound: int = 0) -> SparseTensor:
    """Quantize raw points to voxel coordinates and deduplicate.

    First occurrence wins (stable lexicographic sort), coordinates clamp to
    ``spatial_bound`` when one is declared, rows come out in lexicographic
    order — the JAX ``voxelize`` contract.  Runs on ``points.device``.
    """
    from repro_torch.core import hashing

    n, d = points.shape
    dev = points.device
    if batch_idx is None:
        batch_idx = torch.zeros((n,), dtype=torch.int32, device=dev)
    q = torch.floor(points / voxel_size).to(torch.int32)
    if spatial_bound > 0:
        q = torch.clamp(q, -spatial_bound, spatial_bound)
    coords = torch.cat([batch_idx[:, None].to(torch.int32), q], dim=1)
    order = hashing.lex_argsort(coords).long()
    coords_s = coords[order]
    is_first = torch.ones((n,), dtype=torch.bool, device=dev)
    if n > 1:
        is_first[1:] = ~hashing.rows_equal(coords_s[1:], coords_s[:-1])
    keep_c = coords_s[is_first][:capacity]
    keep_f = feats[order][is_first][:capacity]
    m = keep_c.shape[0]
    out_coords = torch.full((capacity, d + 1), INVALID_COORD, dtype=torch.int32,
                            device=dev)
    out_feats = torch.zeros((capacity, feats.shape[1]), dtype=feats.dtype,
                            device=dev)
    out_coords[:m] = keep_c
    out_feats[:m] = keep_f
    return SparseTensor(coords=out_coords, feats=out_feats,
                        num_valid=torch.tensor(m, dtype=torch.int32, device=dev),
                        stride=1, batch_bound=batch_size,
                        spatial_bound=spatial_bound)
