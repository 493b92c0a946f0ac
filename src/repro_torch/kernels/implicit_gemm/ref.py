"""Plain PyTorch versions of the implicit-GEMM sparse convolution.

``implicit_gemm_ref`` is the port of the JAX oracle (the ``torch`` backend
runs it): ``out[n] = Σ_k x[m[n, k]] @ w[k]`` with ``-1`` contributing zero.

``implicit_gemm_split_ref`` / ``implicit_gemm_worklist_ref`` are the plain
versions of the two CUDA kernels in ``csrc/implicit_gemm.cu``: same
contract, same fp32 accumulation, one write in ``x.dtype``.  Their wrappers
in ``ops.py`` run them for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core.precision import gemm_operand


def implicit_gemm_ref(x: torch.Tensor, w: torch.Tensor, m: torch.Tensor,
                      acc_dtype=torch.float32, compute_dtype=None,
                      out_dtype=None) -> torch.Tensor:
    """x: (N_in, Cin); w: (KD, Cin, Cout); m: (N_out, KD) int32 → (N_out, Cout).

    ``compute_dtype`` (default ``acc_dtype``) is the GEMM operand dtype;
    partial sums accumulate in ``acc_dtype``; ``out_dtype`` defaults to
    ``x.dtype``."""
    n_out, kd = m.shape
    ct = acc_dtype if compute_dtype is None else compute_dtype
    xq, wq = gemm_operand(x, ct, acc_dtype), gemm_operand(w, ct, acc_dtype)
    acc = torch.zeros((n_out, w.shape[-1]), dtype=acc_dtype, device=x.device)
    for k in range(kd):
        idx = m[:, k]
        rows = torch.where((idx >= 0)[:, None], xq[idx.clamp(min=0).long()],
                           torch.zeros((), dtype=xq.dtype, device=x.device))
        acc = acc + rows @ wq[k]
    return acc.to(x.dtype if out_dtype is None else out_dtype)


def implicit_gemm_split_ref(midx: torch.Tensor, occ: torch.Tensor,
                            x: torch.Tensor, w: torch.Tensor,
                            tile_m: int) -> torch.Tensor:
    """Plain version of the dense-grid kernel for one split.

    midx: (N_pad, KD_s) int32 row-permuted map slice; occ: (N_pad / tile_m,
    KD_s) int32 per-(tile, δ) occupancy — an unoccupied step adds nothing;
    x: (N_in, Cin); w: (KD_s, Cin, Cout).  Returns (N_pad, Cout) in
    ``x.dtype`` from an fp32 accumulator.
    """
    n, kd = midx.shape
    xf, wf = x.float(), w.float()
    acc = torch.zeros((n, w.shape[-1]), dtype=torch.float32, device=x.device)
    for d in range(kd):
        step = occ[:, d].bool().repeat_interleave(tile_m) & (midx[:, d] >= 0)
        rows = torch.where(step[:, None], xf[midx[:, d].clamp(min=0).long()],
                           torch.zeros((), device=x.device))
        acc = acc + rows @ wf[d]
    return acc.to(x.dtype)


def implicit_gemm_worklist_ref(wl_ptr: torch.Tensor, wl_tile: torch.Tensor,
                               wl_delta: torch.Tensor, midx: torch.Tensor,
                               x: torch.Tensor, w: torch.Tensor,
                               tile_m: int) -> torch.Tensor:
    """Plain version of the worklist kernel: visited tiles sum their listed
    (tile, δ) steps exactly as the dense kernel does; tiles with no entry
    are never written by the kernel, so they come back as NaN here (the
    caller must zero them, as the wrapper does)."""
    n_tiles = midx.shape[0] // tile_m
    counts = (wl_ptr[1:] - wl_ptr[:-1]).long()
    occ = torch.zeros((n_tiles, midx.shape[1]), dtype=torch.int32,
                      device=midx.device)
    occ[wl_tile.long().repeat_interleave(counts), wl_delta.long()] = 1
    out = implicit_gemm_split_ref(midx, occ, x, w, tile_m)
    visited = torch.zeros((n_tiles,), dtype=torch.bool, device=midx.device)
    visited[wl_tile.long()] = True
    return out.masked_fill(~visited.repeat_interleave(tile_m)[:, None],
                           float("nan"))
