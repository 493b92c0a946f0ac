"""Plain PyTorch versions of the fetch-on-demand dataflow.

``fetch_on_demand_ref`` is the port of the JAX oracle (the ``torch``
backend runs it): per offset, gather the paired input rows, multiply by
``W_δ`` and scatter-add into an ``acc_dtype`` accumulator, rounded once at
the end.

``fetch_on_demand_fused_ref`` is the plain version of the CUDA kernel in
``csrc/fetch_on_demand.cu`` (and of the TPU kernel it replaces): the
running output row is rounded to ``out0.dtype`` after every offset.  In
fp32 the two agree; in bf16 the per-offset rounding differs from the
oracle's single rounding, and this version mirrors the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core.precision import gemm_operand


def fetch_on_demand_ref(x: torch.Tensor, w: torch.Tensor, ws_in: torch.Tensor,
                        ws_out: torch.Tensor, n_out: int,
                        acc_dtype=torch.float32, compute_dtype=None,
                        out_dtype=None) -> torch.Tensor:
    """x: (N_in, Cin); w: (KD, Cin, Cout); ws_in/ws_out: (KD, cap) int32
    compacted pair lists (-1 padded) → (n_out, Cout)."""
    kd = w.shape[0]
    ct = acc_dtype if compute_dtype is None else compute_dtype
    xq, wq = gemm_operand(x, ct, acc_dtype), gemm_operand(w, ct, acc_dtype)
    acc = torch.zeros((n_out, w.shape[-1]), dtype=acc_dtype, device=x.device)
    for k in range(kd):
        sel = ws_in[k] >= 0
        i_in, i_out = ws_in[k][sel].long(), ws_out[k][sel].long()
        acc.index_add_(0, i_out, xq[i_in] @ wq[k])
    return acc.to(x.dtype if out_dtype is None else out_dtype)


def fetch_on_demand_fused_ref(ws_in: torch.Tensor, ws_out: torch.Tensor,
                              x: torch.Tensor, w: torch.Tensor,
                              out0: torch.Tensor) -> torch.Tensor:
    """Plain version of the fused kernel: ``out0`` (N_out, Cout) is updated
    in place, offset by offset: ``out[o] = round(out[o] + x[i] @ w[δ])``
    with the product in fp32 and the rounding to ``out0.dtype``."""
    xf, wf = x.float(), w.float()
    zero = torch.zeros((), device=x.device)
    for k in range(w.shape[0]):
        i_in, sel = ws_in[k], ws_out[k] >= 0
        # the product runs over the whole padded list (a fixed row count),
        # so each row's value does not depend on how many pairs are live
        rows = torch.where((i_in >= 0)[:, None], xf[i_in.clamp(min=0).long()], zero)
        y = (rows @ wf[k])[sel]
        i_out = ws_out[k][sel].long()
        out0[i_out] = (out0[i_out].float() + y).to(out0.dtype)
    return out0
