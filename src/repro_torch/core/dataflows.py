"""The three sparse-convolution dataflows behind one config (port of
``repro.core.dataflows``, forward only).

* ``gather_scatter``  — weight-stationary ``index_select`` → ``mm`` →
  ``index_add_`` per offset: the vendor path, no hand kernel;
* ``fetch_on_demand`` — fused weight-stationary CUDA kernel;
* ``implicit_gemm``   — output-stationary CUDA kernel (dense grid or
  worklist) with tunable mask splits and sorting.

Backends: ``torch`` runs the plain PyTorch versions (the JAX package's
``xla``); ``cuda`` runs the hand-written kernels (the JAX package's
``pallas``).  ``DataflowConfig.from_dict`` accepts either vocabulary, so a
config persisted by the JAX package loads here.  dgrad and wgrad belong to
the training slice and are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core.kmap import KernelMap, SplitPlan, make_split_plan
from repro_torch.core.precision import FP32, PrecisionPolicy, gemm_operand
from repro_torch.kernels.fetch_on_demand.ops import fetch_on_demand as fod_cuda_op
from repro_torch.kernels.fetch_on_demand.ref import fetch_on_demand_ref
from repro_torch.kernels.implicit_gemm.ops import implicit_gemm as igemm_cuda_op
from repro_torch.kernels.implicit_gemm.ops import with_worklists
from repro_torch.kernels.implicit_gemm.ref import implicit_gemm_ref

DATAFLOWS = ("gather_scatter", "fetch_on_demand", "implicit_gemm")
BACKENDS = ("torch", "cuda")

#: JAX backend name → port backend name (persisted JAX configs load)
BACKEND_FROM_JAX = {"xla": "torch", "pallas": "cuda"}


@dataclasses.dataclass(frozen=True)
class DataflowConfig:
    """One point in the Sparse Autotuner design space (paper Fig. 9)."""

    dataflow: str = "implicit_gemm"
    n_splits: int = 1          # 0 = unsorted; ≥1 = sorted splits
    tile_m: int = 128
    tile_n: int = 128          # TPU launch knob, kept for the plan schema
    backend: str = "torch"     # 'torch' | 'cuda'
    worklist: bool = False     # cuda implicit GEMM: tile-skipping worklist

    def __post_init__(self):
        if self.dataflow not in DATAFLOWS:
            raise ValueError(f"unknown dataflow {self.dataflow!r}")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; have {BACKENDS}")

    @property
    def sorted(self) -> bool:
        return self.n_splits >= 1

    @property
    def effective_splits(self) -> int:
        return max(1, self.n_splits)

    def effective_backend(self, kernel: str = "fwd") -> str:
        """The backend that actually executes ``kernel`` under this config:
        gather-scatter has no hand kernel, and dgrad/wgrad are not ported
        yet, so those always run the ``torch`` path."""
        if kernel not in ("fwd", "dgrad", "wgrad"):
            raise ValueError(f"unknown kernel {kernel!r}")
        if self.backend == "cuda" and kernel == "fwd" and \
                self.dataflow in ("implicit_gemm", "fetch_on_demand"):
            return "cuda"
        return "torch"

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["effective_backend"] = self.effective_backend("fwd")
        return d

    @staticmethod
    def from_dict(d: dict) -> "DataflowConfig":
        d = dict(d)
        d.pop("effective_backend", None)   # derived stamp, not a field
        unknown = set(d) - {f.name for f in dataclasses.fields(DataflowConfig)}
        if unknown:
            raise ValueError(f"unknown DataflowConfig fields: {sorted(unknown)}")
        if "backend" in d:
            d["backend"] = BACKEND_FROM_JAX.get(d["backend"], d["backend"])
        return DataflowConfig(**d)


DEFAULT_CONFIG = DataflowConfig()


def plan_for(kmap: KernelMap, cfg: DataflowConfig) -> SplitPlan:
    if cfg.backend == "cuda" and cfg.dataflow == "implicit_gemm" \
            and cfg.worklist:
        # fuse the per-(split, tile, δ) occupancy into the plan pass and
        # compact the worklist kernel's launch lists from it once
        return with_worklists(make_split_plan(
            kmap, cfg.effective_splits, sort=cfg.sorted,
            tile_m=math.gcd(cfg.tile_m, kmap.capacity)))
    return make_split_plan(kmap, cfg.effective_splits, sort=cfg.sorted)


def _gather_scatter_torch(x: torch.Tensor, w: torch.Tensor, kmap: KernelMap,
                          precision: PrecisionPolicy = FP32) -> torch.Tensor:
    """Vanilla gather-GEMM-scatter: per offset ``index_select`` → ``mm`` →
    ``index_add_`` (each output row appears at most once per offset, so the
    scatter is deterministic on every device)."""
    ct, at = precision.compute_dtype, precision.accum_dtype
    xq, wq = gemm_operand(x, ct, at), gemm_operand(w, ct, at)
    acc = torch.zeros((kmap.capacity, w.shape[-1]), dtype=at, device=x.device)
    for k in range(w.shape[0]):
        sel = kmap.ws_in[k] >= 0
        i_in, i_out = kmap.ws_in[k][sel].long(), kmap.ws_out[k][sel].long()
        acc.index_add_(0, i_out, torch.mm(xq.index_select(0, i_in), wq[k]))
    return acc.to(precision.output_dtype(x.dtype))


def sparse_conv_forward(x: torch.Tensor, w: torch.Tensor, kmap: KernelMap,
                        cfg: DataflowConfig = DEFAULT_CONFIG,
                        plan: Optional[SplitPlan] = None,
                        precision: PrecisionPolicy = FP32) -> torch.Tensor:
    """Dispatch one sparse convolution. x: (N_in_cap, Cin), w: (KD, Cin,
    Cout) → (N_out_cap, Cout) in ``precision.output`` (input dtype by
    default).

    The ``cuda`` kernels take their operands in ``policy.compute_dtype``
    and emit it; the result is then cast to the output dtype (under
    ``BF16_AMP`` one extra bf16 rounding of the output compared with the
    ``torch`` path)."""
    out = precision.output_dtype(x.dtype)
    if cfg.backend == "cuda" and cfg.dataflow != "gather_scatter":
        xc = x.to(precision.compute_dtype)
        wc = w.to(precision.compute_dtype)
        if cfg.dataflow == "implicit_gemm":
            if plan is None:
                plan = plan_for(kmap, cfg)
            return igemm_cuda_op(xc, wc, kmap, plan, tile_m=cfg.tile_m,
                                 worklist=cfg.worklist).to(out)
        return fod_cuda_op(xc, wc, kmap, tile_r=cfg.tile_m).to(out)
    if cfg.dataflow == "implicit_gemm":
        return implicit_gemm_ref(x, w, kmap.m_out,
                                 acc_dtype=precision.accum_dtype,
                                 compute_dtype=precision.compute_dtype,
                                 out_dtype=out)
    if cfg.dataflow == "fetch_on_demand":
        return fetch_on_demand_ref(x, w, kmap.ws_in, kmap.ws_out,
                                   kmap.capacity,
                                   acc_dtype=precision.accum_dtype,
                                   compute_dtype=precision.compute_dtype,
                                   out_dtype=out)
    return _gather_scatter_torch(x, w, kmap, precision)
