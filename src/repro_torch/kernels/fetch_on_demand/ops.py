"""Host glue and wrapper of the fused fetch-on-demand kernel.

``fetch_on_demand`` pads the pair lists with -1 to a multiple of ``tile_r``
and starts from a zero output in ``x.dtype``, as the JAX wrapper does;
``fetch_on_demand_fused`` launches the CUDA kernel for CUDA tensors and runs
the plain version in ``ref.py`` for CPU tensors (no fallback from the card).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.kmap import KernelMap
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import build as kbuild
from repro_torch.kernels.fetch_on_demand import ref

#: pair-tile heights the CUDA kernel is instantiated for
CUDA_TILES = (8, 16, 32, 64, 128)


def fetch_on_demand_fused(ws_in: torch.Tensor, ws_out: torch.Tensor,
                          x: torch.Tensor, w: torch.Tensor, out0: torch.Tensor,
                          *, tile_r: int = 128) -> torch.Tensor:
    """Replaces ``fetch_on_demand_pallas``: ws_in/ws_out (KD, cap_pad)
    int32 (-1 padded, compacted to the front, cap_pad a multiple of
    ``tile_r``), x (N_in, Cin), w (KD, Cin, Cout), out0 (N_out, Cout) in
    ``x.dtype``.  Accumulates into ``out0`` in place and returns it."""
    if x.dtype not in kbuild.DTYPE_CODE or w.dtype != x.dtype \
            or out0.dtype != x.dtype:
        raise TypeError(f"fetch-on-demand takes float32 or bfloat16 x, w, out0 "
                        f"of one dtype, got {x.dtype}, {w.dtype}, {out0.dtype}")
    kd, cap_pad = ws_in.shape
    if ws_out.shape != ws_in.shape or w.dim() != 3 or w.shape[0] != kd \
            or w.shape[1] != x.shape[1] or out0.shape[1] != w.shape[2] \
            or cap_pad % tile_r:
        raise ValueError(f"shapes ws {tuple(ws_in.shape)} x {tuple(x.shape)} "
                         f"w {tuple(w.shape)} out0 {tuple(out0.shape)} "
                         f"do not fit tile_r {tile_r}")
    for t in (ws_in, ws_out, x, w, out0):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("operands must be contiguous and on one device")
    if ws_in.dtype != torch.int32 or ws_out.dtype != torch.int32:
        raise TypeError("pair lists must be int32")
    if x.device.type == "cpu":
        return ref.fetch_on_demand_fused_ref(ws_in, ws_out, x, w, out0)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if tile_r not in CUDA_TILES:
        raise ValueError(f"tile_r {tile_r} not in the CUDA kernel's {CUDA_TILES}")
    rc = kbuild.library("fetch_on_demand").fod_forward(
        ws_in.data_ptr(), ws_out.data_ptr(), x.data_ptr(), w.data_ptr(),
        out0.data_ptr(), kd, cap_pad, x.shape[1], w.shape[-1], tile_r,
        kbuild.DTYPE_CODE[x.dtype], kbuild.current_stream())
    kbuild.check("fetch_on_demand", rc, "fetch_on_demand kernel")
    LAUNCHES["fetch_on_demand"] += 1
    return out0


def fetch_on_demand(x: torch.Tensor, w: torch.Tensor, kmap: KernelMap, *,
                    tile_r: int = 128) -> torch.Tensor:
    """Full sparse conv via the fused fetch-on-demand dataflow."""
    cap = kmap.ws_in.shape[1]
    pad = (-cap) % tile_r
    ws_in = F.pad(kmap.ws_in, (0, pad), value=-1).contiguous()
    ws_out = F.pad(kmap.ws_out, (0, pad), value=-1).contiguous()
    out0 = torch.zeros((kmap.capacity, w.shape[-1]), dtype=x.dtype,
                       device=x.device)
    return fetch_on_demand_fused(ws_in, ws_out, x.contiguous(), w.contiguous(),
                                 out0, tile_r=tile_r)
