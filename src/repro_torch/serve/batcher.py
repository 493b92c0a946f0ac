"""Scene queueing and (un)packing (port of ``repro.serve.batcher``, without
streaming deltas).

Scenes group FIFO into bucket-fitting batches, pack into one
capacity-padded batched ``SparseTensor`` (batch index in coordinate column
0, padding at ``INVALID_COORD``, declared ``batch_bound``/``spatial_bound``
so every batch takes the single-word packed-key path), and unpack back out
of a batched output by batch index.  Padding is host-side numpy; the device
sees only the final tensors.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.sparse_tensor import INVALID_COORD, SparseTensor
from repro_torch.serve.bucketing import BucketLadder


@dataclasses.dataclass(frozen=True)
class Scene:
    """One request: quantized voxel coordinates + per-voxel features."""

    coords: np.ndarray  # (n, D) int32 spatial voxel coords (no batch column)
    feats: np.ndarray   # (n, C)

    def __post_init__(self):
        object.__setattr__(self, "coords", np.asarray(self.coords, np.int32))
        object.__setattr__(self, "feats", np.asarray(self.feats))
        if self.coords.ndim != 2 or self.feats.ndim != 2 \
                or self.coords.shape[0] != self.feats.shape[0]:
            raise ValueError(f"scene coords {self.coords.shape} and feats "
                             f"{self.feats.shape} do not match")

    @property
    def num_points(self) -> int:
        return self.coords.shape[0]


def scene_from_tensor(st: SparseTensor) -> Scene:
    """The valid rows of a single-scene SparseTensor as a Scene."""
    n = int(st.num_valid)
    coords = st.coords[:n].cpu().numpy()
    if coords.size and not (coords[:, 0] == coords[0, 0]).all():
        raise ValueError("scene_from_tensor expects a single-batch tensor")
    return Scene(coords=coords[:, 1:], feats=st.feats[:n].cpu().numpy())


@dataclasses.dataclass(frozen=True)
class SceneResult:
    """Per-scene output rows unpacked from a batched forward."""

    coords: np.ndarray  # (m, D) int32 output voxel coords
    feats: np.ndarray   # (m, C_out)
    stride: int


@dataclasses.dataclass(frozen=True)
class PackedBatch:
    """One batched request: the padded tensor plus its unpack manifest."""

    st: SparseTensor
    scene_sizes: Tuple[int, ...]
    bucket: int
    digest: str        # content hash of the packed coords (map-cache key)

    @property
    def num_scenes(self) -> int:
        return len(self.scene_sizes)


class SceneBatcher:
    """Deterministic FIFO grouping + pack/unpack onto ``device``."""

    def __init__(self, ladder: BucketLadder, spatial_bound: int,
                 device: torch.device):
        if spatial_bound <= 0:
            raise ValueError("serving requires a declared spatial bound")
        self.ladder = ladder
        self.spatial_bound = int(spatial_bound)
        self.device = device

    def plan(self, sizes: Sequence[int]) -> List[List[int]]:
        """Greedy FIFO grouping: a batch closes when the next scene would
        overflow the largest bucket or exceed ``max_batch`` scenes."""
        groups: List[List[int]] = []
        cur: List[int] = []
        cur_rows = 0
        for i, n in enumerate(sizes):
            if n > self.ladder.max_capacity:
                raise ValueError(f"scene {i} ({n} rows) exceeds largest "
                                 f"bucket ({self.ladder.max_capacity})")
            if cur and (cur_rows + n > self.ladder.max_capacity
                        or len(cur) >= self.ladder.max_batch):
                groups.append(cur)
                cur, cur_rows = [], 0
            cur.append(i)
            cur_rows += n
        if cur:
            groups.append(cur)
        return groups

    def pack(self, scenes: Sequence[Scene]) -> PackedBatch:
        """Pack 1..max_batch scenes into one bucket-padded SparseTensor."""
        if not 1 <= len(scenes) <= self.ladder.max_batch:
            raise ValueError(f"cannot pack {len(scenes)} scenes "
                             f"(max_batch {self.ladder.max_batch})")
        sizes = tuple(s.num_points for s in scenes)
        total = sum(sizes)
        cap = self.ladder.select(total)
        d = scenes[0].coords.shape[1]
        c = scenes[0].feats.shape[1]
        coords = np.full((cap, 1 + d), INVALID_COORD, np.int32)
        feats = np.zeros((cap, c), dtype=np.float32)
        off = 0
        for b, s in enumerate(scenes):
            if s.coords.shape[1] != d or s.feats.shape[1] != c:
                raise ValueError(f"scene {b} has another width than scene 0")
            if s.num_points and int(np.abs(s.coords).max()) > self.spatial_bound:
                raise ValueError(
                    f"scene {b} violates declared spatial_bound "
                    f"{self.spatial_bound}: max |coord| = {np.abs(s.coords).max()}")
            coords[off:off + s.num_points, 0] = b
            coords[off:off + s.num_points, 1:] = s.coords
            feats[off:off + s.num_points] = s.feats
            off += s.num_points
        digest = hashlib.blake2b(coords.tobytes(), digest_size=16).hexdigest()
        dev = self.device
        st = SparseTensor(coords=torch.from_numpy(coords).to(dev),
                          feats=torch.from_numpy(feats).to(dev),
                          num_valid=torch.tensor(total, dtype=torch.int32, device=dev),
                          stride=1, batch_bound=self.ladder.max_batch,
                          spatial_bound=self.spatial_bound)
        return PackedBatch(st=st, scene_sizes=sizes, bucket=cap, digest=digest)

    @staticmethod
    def unpack(batch: PackedBatch, out_coords: torch.Tensor,
               out_feats: torch.Tensor, n_out: int,
               out_stride: int = 1) -> List[SceneResult]:
        """Split a batched output into per-scene rows by the batch column
        of ``out_coords`` (valid rows only, row order preserved)."""
        out_coords = out_coords.cpu().numpy()
        out_feats = out_feats.cpu().numpy()
        valid = np.arange(out_coords.shape[0]) < int(n_out)
        return [SceneResult(coords=out_coords[valid & (out_coords[:, 0] == b), 1:],
                            feats=out_feats[valid & (out_coords[:, 0] == b)],
                            stride=out_stride)
                for b in range(batch.num_scenes)]
