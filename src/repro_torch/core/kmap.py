"""Kernel-map construction (port of ``repro.core.kmap``, main path).

A kernel map relates output points to input points for every kernel offset:

* output-stationary ``m_out[n, k]`` — input neighbour of output ``n`` at
  offset ``k`` (or -1); consumed by implicit GEMM;
* weight-stationary ``(ws_in[k, i], ws_out[k, i])`` for ``i < ws_count[k]``
  — the per-offset gather/scatter pair lists; consumed by gather-scatter and
  fetch-on-demand.

Everything runs on the device of the input tensor as plain torch ops and is
bit-identical to the JAX package: one stable sort per coordinate table, all
``K^D`` shifted queries as one flattened binary search, sort-free
weight-stationary compaction, and the strided unique pass on masked packed
keys.  Maps are built at the capacity of the output tensor and padded with
-1 rows (the paper's §3.2 padding trick).

The scene-granular composition and streaming helpers of the JAX module are
not ported yet (see ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.core.hashing import PAD, CoordTable, KeySpec
from repro_torch.core.sparse_tensor import INVALID_COORD, SparseTensor

_I32_MAX = hashing._I32_MAX


def kernel_offsets(kernel_size: int, ndim: int) -> np.ndarray:
    """Δ^D(K) as a (K^D, D) int32 array, centre offset first (odd K:
    centred window; even K: forward window {0..K-1}^D)."""
    if kernel_size % 2 == 1:
        r = range(-(kernel_size // 2), kernel_size // 2 + 1)
    else:
        r = range(kernel_size)
    offs = np.array(list(itertools.product(r, repeat=ndim)), dtype=np.int32)
    norm = np.abs(offs).sum(axis=1)
    order = np.argsort(norm, kind="stable")
    return offs[order]


def _bitmask(hit: torch.Tensor) -> torch.Tensor:
    """Neighbour bitmask in int32: exact for volumes ≤ 31, else the
    (popcount << 24 | low-24-bits) rank-preserving composite."""
    kd = hit.shape[-1]
    dev = hit.device
    if kd <= 31:
        w = torch.ones((), dtype=torch.int32, device=dev) << torch.arange(
            kd, dtype=torch.int32, device=dev)
        return torch.where(hit, w, 0).sum(dim=-1, dtype=torch.int32)
    pop = hit.sum(dim=-1, dtype=torch.int32)
    w = torch.ones((), dtype=torch.int32, device=dev) << torch.arange(
        24, dtype=torch.int32, device=dev)
    low = torch.where(hit[..., :24], w, 0).sum(dim=-1, dtype=torch.int32)
    return (pop << 24) | low


@dataclasses.dataclass(frozen=True)
class KernelMap:
    """All map representations for one (layer-group) convolution."""

    m_out: torch.Tensor       # (N_out_cap, KD) int32, -1 = missing
    out_coords: torch.Tensor  # (N_out_cap, 1+D) int32
    n_out: torch.Tensor       # () int32
    ws_in: torch.Tensor       # (KD, cap) int32 gather indices (-1 pad)
    ws_out: torch.Tensor      # (KD, cap) int32 scatter indices (-1 pad)
    ws_count: torch.Tensor    # (KD,) int32
    bitmask: torch.Tensor     # (N_out_cap,) int32 (0 pad)
    out_stride: int = 1
    kernel_size: int = 3

    @property
    def volume(self) -> int:
        return self.m_out.shape[1]

    @property
    def capacity(self) -> int:
        return self.m_out.shape[0]


class MapCache:
    """Sidecar cache of sorted ``CoordTable``s keyed by coordinate-array
    identity (or a caller-supplied key), sharing one ``KeySpec`` across a
    model's map program: layers at one stride share one sorted table, and
    strided maps adopt their output table for the next pyramid level."""

    def __init__(self, spec: KeySpec):
        self.spec = spec
        self._tables: dict = {}
        self.hits = 0
        self.misses = 0

    @classmethod
    def for_tensor(cls, st: SparseTensor) -> "MapCache":
        return cls(hashing.key_spec_for(st.ndim_space, st.batch_bound,
                                        st.spatial_bound))

    def table(self, st: SparseTensor, key=None) -> CoordTable:
        key = id(st.coords) if key is None else key
        ent = self._tables.get(key)
        if ent is None:
            self.misses += 1
            t = CoordTable.build(st.coords, st.valid_mask, self.spec)
            # hold the coords so their id stays unique for the cache's life
            self._tables[key] = (st.coords, t)
            return t
        self.hits += 1
        return ent[1]

    def adopt(self, coords: torch.Tensor, table: CoordTable, key=None) -> None:
        self._tables.setdefault(id(coords) if key is None else key,
                                (coords, table))

    def clear(self) -> None:
        self._tables.clear()

    def __len__(self) -> int:
        return len(self._tables)


def _unique_coords(coords: torch.Tensor, valid: torch.Tensor, capacity: int):
    """Sort-unique of coordinate rows → (coords[capacity], count) (the
    multi-word fallback for non-power-of-two strides)."""
    words = torch.where(valid[:, None], coords.to(torch.int32),
                        torch.full_like(coords, _I32_MAX, dtype=torch.int32))
    order = hashing.lex_argsort(words).long()
    coords_s = coords[order]
    valid_s = valid[order]
    is_first = torch.ones_like(valid_s)
    if coords.shape[0] > 1:
        is_first[1:] = ~hashing.rows_equal(coords_s[1:], coords_s[:-1])
    is_first = is_first & valid_s
    sel = coords_s[is_first][:capacity]
    out = torch.full((capacity, coords.shape[1]), INVALID_COORD,
                     dtype=torch.int32, device=coords.device)
    out[:sel.shape[0]] = sel
    n = torch.clamp(is_first.sum(dtype=torch.int32), max=capacity)
    return out, n


def _grid_mask_ints(spec: KeySpec, out_stride: int):
    """Per-key-column AND masks (MSB-first python ints) clearing the low
    ``log2(out_stride)`` bits of every spatial field; None when the stride
    is not a power of two or a field is too narrow."""
    if out_stride & (out_stride - 1):
        return None
    log2s = out_stride.bit_length() - 1
    if log2s == 0:
        return None
    if spec.raw:
        return (-1,) + (~(out_stride - 1),) * spec.ndim_space
    masks = [2 ** 31 - 1, 2 ** 31 - 1]
    for f, (word, shift, width) in enumerate(spec.layout()):
        if f == 0:
            continue
        if log2s > width - 1:
            return None
        masks[word] &= ~(((1 << log2s) - 1) << shift) & (2 ** 32 - 1)
    cols = [int(np.int64(m).astype(np.int32)) for m in masks]
    return (cols[0],) if spec.words == 1 else (cols[1], cols[0])


def _grid_key_mask(spec: KeySpec, out_stride: int, device=None):
    """Tensor view of ``_grid_mask_ints`` for the unique pass."""
    ints = _grid_mask_ints(spec, out_stride)
    if ints is None:
        return None
    return torch.tensor(ints, dtype=torch.int32, device=device)


def _unique_from_keys(table: CoordTable, out_stride: int, capacity: int):
    """Floor-grid unique pass over the input table's packed sorted keys:
    mask the low stride bits, stable-sort once, compact first occurrences.
    Returns ``(out_coords, n_out, child_table)`` or None."""
    spec = table.spec
    w = spec.words
    sk = table.sorted_keys
    masks = _grid_key_mask(spec, out_stride, sk.device)
    if masks is None:
        return None
    pad = torch.full_like(sk, PAD)
    if w == 1:
        row_valid = sk != PAD
        masked = torch.where(row_valid, sk & masks[0], pad)
    else:
        row_valid = sk[:, 0] != PAD
        masked = torch.where(row_valid[:, None], sk & masks, pad)
    order, ks = hashing.sort_keys(masked, spec)
    first_valid = row_valid[order.long()]
    is_first = torch.ones_like(first_valid)
    if ks.shape[0] > 1:
        is_first[1:] = ~hashing.keys_equal(ks[1:], ks[:-1], w)
    is_first = is_first & first_valid
    sel = ks[is_first][:capacity]
    out_keys = torch.full((capacity,) + tuple(sk.shape[1:]), PAD,
                          dtype=torch.int32, device=sk.device)
    out_keys[:sel.shape[0]] = sel
    n_out = torch.clamp(is_first.sum(dtype=torch.int32), max=capacity)
    key_valid = torch.arange(capacity, device=sk.device) < n_out
    out_coords = torch.where(key_valid[:, None], hashing.unpack_keys(out_keys, spec),
                             torch.full((1,), INVALID_COORD, dtype=torch.int32,
                                        device=sk.device))
    child = CoordTable.from_sorted_keys(spec, out_keys)
    return out_coords, n_out, child


def _compact_ws(m_out: torch.Tensor):
    """Weight-stationary pair lists by rank-select over the per-column hit
    cumsum — no sorts; hits first in row order, -1 padding after."""
    cap, kd = m_out.shape
    dev = m_out.device
    # scan along the inner dim of the transposed hit matrix: PyTorch's
    # outer-dim integer scan on CUDA is ~60 ms at (262144, 27), the
    # inner-dim one is not; the integers are the same
    hit = (m_out >= 0).t().contiguous()                          # (kd, cap)
    cs = torch.cumsum(hit, dim=1, dtype=torch.int32)
    ws_count = cs[:, -1].contiguous()
    slot = torch.arange(cap, dtype=torch.int32, device=dev)
    target = (slot + 1).expand(kd, cap).contiguous()
    src = torch.searchsorted(cs, target, side="left", out_int32=True)
    src = torch.clamp(src, 0, cap - 1)
    ok = slot[None, :] < ws_count[:, None]
    mk = m_out.t().gather(1, src.long())
    neg = torch.full_like(src, -1)
    return torch.where(ok, mk, neg), torch.where(ok, src, neg), ws_count


def build_kmap(x: SparseTensor, kernel_size: int, stride: int = 1,
               transposed: bool = False,
               out_coords: Optional[torch.Tensor] = None,
               n_out: Optional[torch.Tensor] = None,
               out_capacity: Optional[int] = None,
               cache: Optional[MapCache] = None) -> KernelMap:
    """Build the kernel map of a sparse convolution over ``x``.

    stride == 1: submanifold (outputs = inputs); stride > 1: downsample
    (outputs = unique floor-grid cells); transposed: upsample onto the
    given finer ``out_coords``/``n_out``.  ``cache`` shares sorted tables
    across calls and adopts strided outputs' tables.
    """
    d = x.ndim_space
    t = x.stride
    dev = x.device
    offs = kernel_offsets(kernel_size, d)
    kd = offs.shape[0]
    cap_in = x.capacity
    spec = cache.spec if cache is not None else hashing.key_spec_for(
        d, x.batch_bound, x.spatial_bound)
    table = cache.table(x) if cache is not None else \
        CoordTable.build(x.coords, x.valid_mask, spec)

    child_table = None
    if transposed:
        if out_coords is None or n_out is None:
            raise ValueError("transposed maps need out_coords and n_out")
        out_stride = t // stride
        n_out_cap = out_capacity or out_coords.shape[0]
        out_coords = out_coords[:n_out_cap]
        delta_scale = -out_stride
    elif stride == 1:
        out_coords, n_out = x.coords, x.num_valid
        out_stride = t
        n_out_cap = out_capacity or cap_in
        out_coords = out_coords[:n_out_cap]
        delta_scale = t
    else:
        out_stride = t * stride
        n_out_cap = out_capacity or cap_in
        uniq = _unique_from_keys(table, out_stride, n_out_cap)
        if uniq is not None:
            out_coords, n_out, child_table = uniq
        else:
            grid = torch.cat([x.coords[:, :1],
                              torch.div(x.coords[:, 1:], out_stride,
                                        rounding_mode="floor") * out_stride],
                             dim=1)
            grid = torch.where(x.valid_mask[:, None], grid,
                               torch.full_like(grid, INVALID_COORD))
            out_coords, n_out = _unique_coords(grid, x.valid_mask, n_out_cap)
        delta_scale = t

    out_valid = torch.arange(n_out_cap, device=dev) < n_out

    # output-stationary map: ONE flattened batched lookup over K^D·N queries
    shifts = np.concatenate([np.zeros((kd, 1), np.int32),
                             offs * np.int32(delta_scale)], axis=1)
    shifts_t = torch.as_tensor(shifts, device=dev)
    q = out_coords[None, :, :] + shifts_t[:, None, :]          # (KD, N, 1+D)
    qkeys = hashing.pack_keys(q.reshape(kd * n_out_cap, d + 1), spec,
                              query=True)
    m_out = table.lookup_keys(qkeys).reshape(kd, n_out_cap).t()
    m_out = torch.where(out_valid[:, None], m_out,
                        torch.full_like(m_out, -1)).contiguous()

    ws_in, ws_out, ws_count = _compact_ws(m_out)
    bm = torch.where(out_valid, _bitmask(m_out >= 0), 0).to(torch.int32)

    kmap = KernelMap(m_out=m_out, out_coords=out_coords,
                     n_out=torch.as_tensor(n_out, dtype=torch.int32, device=dev),
                     ws_in=ws_in, ws_out=ws_out, ws_count=ws_count, bitmask=bm,
                     out_stride=out_stride, kernel_size=kernel_size)
    if cache is not None and child_table is not None:
        cache.adopt(kmap.out_coords, child_table)
    return kmap


def transpose_kmap(fwd: KernelMap, x_fine: SparseTensor) -> KernelMap:
    """Kernel map of the transposed conv from a cached forward map: the
    fine side's output-stationary map is rebuilt by swapping the forward
    map's weight-stationary pair lists (within one offset column each fine
    row appears at most once, so the scatter is order-free)."""
    kd = fwd.volume
    cap = x_fine.capacity
    dev = fwd.m_out.device
    m_out = torch.full((cap, kd), -1, dtype=torch.int32, device=dev)
    ok = fwd.ws_in >= 0
    cols = torch.arange(kd, device=dev)[:, None].expand_as(fwd.ws_in)
    m_out[fwd.ws_in[ok].long(), cols[ok]] = fwd.ws_out[ok]
    return KernelMap(m_out=m_out, out_coords=x_fine.coords,
                     n_out=x_fine.num_valid, ws_in=fwd.ws_out,
                     ws_out=fwd.ws_in, ws_count=fwd.ws_count,
                     bitmask=_bitmask(m_out >= 0), out_stride=x_fine.stride,
                     kernel_size=fwd.kernel_size)


# ---------------------------------------------------------------------------
# Sorting + mask splits (Sparse Autotuner design space, paper §4.1)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """Row orders and offset ranges for s-split (un)sorted implicit GEMM.

    order / inv_order: (S, N_out_cap) int32 permutations and their inverses.
    ranges: static ((start, end), ...) partition of the KD offsets.
    sorted_: False ⇒ identity order.
    occupancy: optional (S, n_tiles, KD) per-(split, tile, δ) occupancy,
        fused into the plan pass when ``make_split_plan(tile_m=...)``.
    worklists: optional per-split CSR worklists compacted from
        ``occupancy`` (``implicit_gemm.ops.with_worklists``), so a worklist
        forward launches without syncing the host.
    """

    order: torch.Tensor
    inv_order: torch.Tensor
    ranges: Tuple[Tuple[int, int], ...]
    sorted_: bool = True
    occupancy: Optional[torch.Tensor] = None
    tile_m: int = 0
    worklists: Optional[Tuple[Optional[Tuple[torch.Tensor, ...]], ...]] = None

    @property
    def num_splits(self) -> int:
        return len(self.ranges)


def split_ranges(volume: int, n_splits: int) -> Tuple[Tuple[int, int], ...]:
    """Partition KD offsets into ~equal contiguous ranges."""
    n_splits = max(1, min(n_splits, volume))
    bounds = np.linspace(0, volume, n_splits + 1).round().astype(int)
    return tuple((int(bounds[i]), int(bounds[i + 1])) for i in range(n_splits))


def make_split_plan(kmap: KernelMap, n_splits: int, sort: bool = True,
                    tile_m: Optional[int] = None) -> SplitPlan:
    """Split the δ loop into parts, stable-argsort each split's bitmask
    (valid rows first, padding last) and optionally fuse the per-(split,
    tile, δ) occupancy (``tile_m``)."""
    ranges = split_ranges(kmap.volume, n_splits)
    cap = kmap.capacity
    kd = kmap.volume
    dev = kmap.m_out.device
    hit = kmap.m_out >= 0
    valid = torch.arange(cap, device=dev) < kmap.n_out
    arange = torch.arange(cap, dtype=torch.int32, device=dev)

    orders = []
    for (a, b) in ranges:
        if not sort:
            orders.append(arange)
            continue
        if kd <= 31:
            bm = (kmap.bitmask >> a) & ((1 << (b - a)) - 1)
        else:
            bm = _bitmask(hit[:, a:b])
        key = torch.where(valid, bm, torch.full_like(bm, _I32_MAX))
        orders.append(torch.argsort(key, stable=True).to(torch.int32))
    order = torch.stack(orders)
    inv = torch.empty_like(order)
    inv.scatter_(1, order.long(), arange.expand_as(order).contiguous())

    occ = None
    if tile_m is not None:
        hit_i = hit.to(torch.int32)
        occ = torch.stack([_split_occupancy(hit_i, order[s], r, tile_m)
                           for s, r in enumerate(ranges)])
    return SplitPlan(order=order, inv_order=inv, ranges=ranges, sorted_=sort,
                     occupancy=occ, tile_m=tile_m or 0)


def _split_occupancy(hit: torch.Tensor, order: torch.Tensor,
                     rng: Tuple[int, int], tile_m: int) -> torch.Tensor:
    """(n_tiles, KD) occupancy of one split: 1 iff any row of the permuted
    tile has a neighbour at δ, zeroed outside the split's offset range."""
    cap, kd = hit.shape
    if cap % tile_m:
        raise ValueError(f"capacity {cap} must be padded to tile_m {tile_m}")
    a, b = rng
    h = hit[order.long()].reshape(cap // tile_m, tile_m, kd)
    col = torch.arange(kd, device=hit.device)
    in_range = ((col >= a) & (col < b)).to(torch.int32)
    return h.amax(dim=1) * in_range[None, :]


def tile_occupancy(kmap: KernelMap, plan: SplitPlan, tile_m: int) -> torch.Tensor:
    """Per-(split, tile, δ) occupancy (S, n_tiles, KD) int32; reuses the
    plan's fused occupancy when it was built for the same ``tile_m``."""
    if plan.occupancy is not None and plan.tile_m == tile_m:
        return plan.occupancy
    hit = (kmap.m_out >= 0).to(torch.int32)
    return torch.stack([_split_occupancy(hit, plan.order[i], r, tile_m)
                        for i, r in enumerate(plan.ranges)])
