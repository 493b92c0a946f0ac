"""Host glue and wrappers of the implicit-GEMM kernels.

Turns a (KernelMap, SplitPlan) pair into per-split kernel launches plus the
split-sum of paper Fig. 10, as ``repro/kernels/implicit_gemm/ops.py`` does:
the requested ``tile_m`` is clamped to a divisor of the capacity
(``gcd``), each split's map slice is row-permuted by ``plan.order``, the
per-split partials are summed back through ``inv_order`` in ``x.dtype``,
and (worklist mode) tiles that were never visited are zeroed.

Two launch geometries, both CUDA kernels in ``csrc/implicit_gemm.cu``:

* dense — one block per (m-tile, 64-column tile), looping over the split's
  δ range and skipping unoccupied (tile, δ) steps;
* worklist (``worklist=True``) — one block per *visited* m-tile, walking a
  CSR worklist of its occupied δ's, built on the device from the concrete
  occupancy.  PyTorch runs eagerly, so the occupancy is always concrete and
  the worklist kernel always runs (the JAX wrapper falls back to the dense
  grid under ``jit``).  ``with_worklists`` builds the worklists once per
  plan (the serving engine caches plans with its maps), so a forward
  launches without syncing the host.

Each kernel wrapper launches its kernel for CUDA tensors and runs the plain
version in ``ref.py`` for CPU tensors; there is no fallback from the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.core.kmap import KernelMap, SplitPlan
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import build as kbuild
from repro_torch.kernels.implicit_gemm import ref

#: m-tile heights the CUDA kernels are instantiated for
CUDA_TILES = (8, 16, 32, 64, 128)


def _check(x: torch.Tensor, w: torch.Tensor, ints, tile_m: int) -> None:
    if x.dtype not in kbuild.DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"implicit GEMM takes float32 or bfloat16 x and w of "
                        f"one dtype, got {x.dtype} and {w.dtype}")
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"shapes x {tuple(x.shape)} w {tuple(w.shape)} "
                         f"do not match (N_in, Cin) and (KD, Cin, Cout)")
    for t in (x, w, *ints):
        if t.device != x.device:
            raise ValueError("all operands must lie on one device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"index tensors must be int32, got {t.dtype}")
    if x.device.type == "cuda" and tile_m not in CUDA_TILES:
        raise ValueError(f"tile_m {tile_m} not in the CUDA kernel's {CUDA_TILES}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def implicit_gemm_split(midx: torch.Tensor, occ: torch.Tensor, x: torch.Tensor,
                        w: torch.Tensor, *, tile_m: int) -> torch.Tensor:
    """One split of dense-grid implicit GEMM (replaces
    ``implicit_gemm_pallas``).  midx (N_pad, KD_s) int32, occ (N_pad /
    tile_m, KD_s) int32, x (N_in, Cin), w (KD_s, Cin, Cout) → (N_pad, Cout)
    in ``x.dtype``."""
    _check(x, w, (midx, occ), tile_m)
    n, kd = midx.shape
    if n % tile_m or occ.shape != (n // tile_m, kd) or w.shape[0] != kd:
        raise ValueError(f"midx {tuple(midx.shape)} occ {tuple(occ.shape)} "
                         f"w {tuple(w.shape)} do not fit tile_m {tile_m}")
    if x.device.type == "cpu":
        return ref.implicit_gemm_split_ref(midx, occ, x, w, tile_m)
    out = torch.empty((n, w.shape[-1]), dtype=x.dtype, device=x.device)
    rc = kbuild.library("implicit_gemm").igemm_dense(
        midx.data_ptr(), occ.data_ptr(), x.data_ptr(), w.data_ptr(),
        out.data_ptr(), n, kd, x.shape[1], w.shape[-1], tile_m,
        kbuild.DTYPE_CODE[x.dtype], kbuild.current_stream())
    kbuild.check("implicit_gemm", rc, "implicit_gemm dense kernel")
    LAUNCHES["implicit_gemm"] += 1
    return out


def implicit_gemm_worklist_split(wl_ptr: torch.Tensor, wl_tile: torch.Tensor,
                                 wl_delta: torch.Tensor, midx: torch.Tensor,
                                 x: torch.Tensor, w: torch.Tensor, *,
                                 tile_m: int) -> torch.Tensor:
    """One split of tile-skipping implicit GEMM over a CSR worklist
    (replaces ``implicit_gemm_worklist_pallas``).  Rows of tiles with no
    worklist entry are left unwritten; callers zero them."""
    _check(x, w, (wl_ptr, wl_tile, wl_delta, midx), tile_m)
    n, kd = midx.shape
    n_visited = wl_tile.shape[0]
    if n % tile_m or wl_ptr.shape != (n_visited + 1,) or w.shape[0] != kd \
            or n_visited == 0:
        raise ValueError(f"worklist ptr {tuple(wl_ptr.shape)} tiles "
                         f"{n_visited} midx {tuple(midx.shape)} w "
                         f"{tuple(w.shape)} do not fit tile_m {tile_m}")
    if x.device.type == "cpu":
        return ref.implicit_gemm_worklist_ref(wl_ptr, wl_tile, wl_delta, midx,
                                              x, w, tile_m)
    out = torch.empty((n, w.shape[-1]), dtype=x.dtype, device=x.device)
    rc = kbuild.library("implicit_gemm").igemm_worklist(
        wl_ptr.data_ptr(), wl_tile.data_ptr(), wl_delta.data_ptr(),
        midx.data_ptr(), x.data_ptr(), w.data_ptr(), out.data_ptr(),
        n_visited, kd, x.shape[1], w.shape[-1], tile_m,
        kbuild.DTYPE_CODE[x.dtype], kbuild.current_stream())
    kbuild.check("implicit_gemm", rc, "implicit_gemm worklist kernel")
    LAUNCHES["implicit_gemm_worklist"] += 1
    return out


def _build_worklist(occ: torch.Tensor) -> Optional[Tuple[torch.Tensor, ...]]:
    """Compact a concrete (n_tiles, KD_s) occupancy into a CSR worklist by
    tile, on the occupancy's device.  Returns None for an empty split, else
    ``(wl_ptr, wl_tile, wl_delta, visited)``: int32 CSR offsets (n_visited
    + 1,), the visited tiles ascending, their occupied δ's ascending, and
    the (n_tiles,) visited mask."""
    occ = occ != 0
    _, ds = torch.nonzero(occ, as_tuple=True)   # row-major: sorted by (tile, δ)
    if ds.numel() == 0:
        return None
    counts = occ.sum(dim=1)
    visited = counts > 0
    wl_tile = torch.nonzero(visited).flatten().to(torch.int32)
    wl_ptr = torch.zeros((wl_tile.shape[0] + 1,), dtype=torch.int32,
                         device=occ.device)
    wl_ptr[1:] = torch.cumsum(counts[visited], dim=0)
    return wl_ptr, wl_tile, ds.to(torch.int32), visited


def with_worklists(plan: SplitPlan) -> SplitPlan:
    """``plan`` with each split's CSR worklist compacted once from its fused
    occupancy (one host sync per split, at plan time)."""
    if plan.occupancy is None:
        raise ValueError("worklists need a plan built with make_split_plan(tile_m=...)")
    return dataclasses.replace(plan, worklists=tuple(
        _build_worklist(plan.occupancy[s][:, a:b])
        for s, (a, b) in enumerate(plan.ranges)))


def implicit_gemm(x: torch.Tensor, w: torch.Tensor, kmap: KernelMap,
                  plan: SplitPlan, *, tile_m: int = 128,
                  worklist: bool = False) -> torch.Tensor:
    """Full sparse conv via (split, sorted) implicit GEMM → (N_out_cap, Cout).
    The CUDA kernels tile output columns by 64."""
    cap = kmap.capacity
    cout = w.shape[-1]
    tile_m = math.gcd(tile_m, cap)
    n_tiles = cap // tile_m
    if worklist and (plan.worklists is None or plan.tile_m != tile_m):
        raise ValueError(f"worklist mode needs a plan with worklists for tile_m "
                         f"{tile_m} (dataflows.plan_for or with_worklists)")
    out = torch.zeros((cap, cout), dtype=x.dtype, device=x.device)
    x = x.contiguous()
    for s, (a, b) in enumerate(plan.ranges):
        midx = kmap.m_out[plan.order[s].long()][:, a:b].contiguous()
        ws = w[a:b].contiguous()
        if worklist:
            wl = plan.worklists[s]
            if wl is None:
                continue                      # empty split contributes zero
            wl_ptr, wl_tile, wl_delta, visited = wl
            partial = implicit_gemm_worklist_split(
                wl_ptr, wl_tile, wl_delta, midx, x, ws, tile_m=tile_m)
            # unvisited tiles have no neighbours in this split: zero IS
            # their partial sum, and the kernel never wrote them
            partial = partial.masked_fill(
                ~visited.repeat_interleave(tile_m)[:, None], 0)
        else:
            occ = (midx.view(n_tiles, tile_m, b - a) >= 0).any(dim=1)
            partial = implicit_gemm_split(midx, occ.to(torch.int32).contiguous(),
                                          x, ws, tile_m=tile_m)
        out = out + partial[plan.inv_order[s].long()]
    return out
