"""SparseConv layer (port of ``repro.core.sparse_conv``, serving half).

``TrainDataflowConfig`` keeps the fwd / dgrad / wgrad triple and its JSON
schema so persisted plans round-trip, but only the forward runs here:
``sparse_conv_apply`` becomes a ``torch.autograd.Function`` with dgrad and
wgrad in the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import dataflows as df
from repro_torch.core.kmap import KernelMap, MapCache, build_kmap, transpose_kmap
from repro_torch.core.precision import FP32, PrecisionPolicy
from repro_torch.core.sparse_tensor import SparseTensor


@dataclasses.dataclass(frozen=True)
class TrainDataflowConfig:
    """Per-layer(-group) dataflow parameters for fwd / dgrad / wgrad."""

    fwd: df.DataflowConfig = df.DEFAULT_CONFIG
    dgrad: df.DataflowConfig = df.DEFAULT_CONFIG
    wgrad: df.DataflowConfig = df.DEFAULT_CONFIG

    @staticmethod
    def bind_all(cfg: df.DataflowConfig) -> "TrainDataflowConfig":
        return TrainDataflowConfig(cfg, cfg, cfg)

    def to_dict(self) -> dict:
        return {"fwd": self.fwd.to_dict(), "dgrad": self.dgrad.to_dict(),
                "wgrad": self.wgrad.to_dict()}

    @staticmethod
    def from_dict(d: dict) -> "TrainDataflowConfig":
        unknown = set(d) - {"fwd", "dgrad", "wgrad"}
        if unknown:
            raise ValueError(
                f"unknown TrainDataflowConfig fields: {sorted(unknown)}")
        return TrainDataflowConfig(fwd=df.DataflowConfig.from_dict(d["fwd"]),
                                   dgrad=df.DataflowConfig.from_dict(d["dgrad"]),
                                   wgrad=df.DataflowConfig.from_dict(d["wgrad"]))


DEFAULT_TRAIN_CONFIG = TrainDataflowConfig()


def sparse_conv_apply(feats: torch.Tensor, w: torch.Tensor, kmap: KernelMap,
                      cfg: TrainDataflowConfig = DEFAULT_TRAIN_CONFIG,
                      precision: PrecisionPolicy = FP32,
                      plan=None) -> torch.Tensor:
    """Forward of the sparse conv under the layer's forward dataflow.
    ``plan``: optional pre-built ``SplitPlan`` (the serving engine builds
    them once per batch)."""
    return df.sparse_conv_forward(feats, w, kmap, cfg.fwd, plan=plan,
                                  precision=precision)


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    in_channels: int
    out_channels: int
    kernel_size: int = 3
    stride: int = 1
    transposed: bool = False
    bias: bool = False

    @property
    def volume(self) -> int:
        return self.kernel_size ** 3  # models here are 3D


def init_conv(gen: torch.Generator, spec: ConvSpec, ndim: int = 3,
              dtype=torch.float32) -> dict:
    """He-normal conv weights (KD, Cin, Cout) from a CPU ``torch.Generator``
    (matches the JAX initialiser in distribution, not in bits)."""
    kd = spec.kernel_size ** ndim
    fan_in = spec.in_channels * kd
    w = torch.randn((kd, spec.in_channels, spec.out_channels), generator=gen,
                    dtype=dtype) * (fan_in ** -0.5)
    params = {"w": w}
    if spec.bias:
        params["b"] = torch.zeros((spec.out_channels,), dtype=dtype)
    return params


def apply_conv(params: dict, x: SparseTensor, kmap: KernelMap,
               cfg: TrainDataflowConfig = DEFAULT_TRAIN_CONFIG,
               precision: PrecisionPolicy = FP32,
               plan=None) -> SparseTensor:
    """Sparse conv on a prebuilt kernel map → output SparseTensor on the
    map's coordinates, padded rows zeroed, declared bounds propagated."""
    y = sparse_conv_apply(x.feats, params["w"], kmap, cfg, precision=precision,
                          plan=plan)
    if "b" in params:
        y = y + params["b"][None, :].to(y.dtype)
    valid = torch.arange(kmap.capacity, device=y.device) < kmap.n_out
    y = torch.where(valid[:, None], y, torch.zeros((), dtype=y.dtype,
                                                   device=y.device))
    return SparseTensor(coords=kmap.out_coords, feats=y, num_valid=kmap.n_out,
                        stride=kmap.out_stride, batch_bound=x.batch_bound,
                        spatial_bound=x.spatial_bound)


def conv_kmap(x: SparseTensor, spec: ConvSpec,
              cached_fine: Optional[SparseTensor] = None,
              cached_fwd: Optional[KernelMap] = None,
              cache: Optional[MapCache] = None) -> KernelMap:
    """Build (or, for transposed convs, derive from the encoder's forward
    map) the kernel map for ``spec`` applied to ``x``."""
    if spec.transposed:
        if cached_fwd is None or cached_fine is None:
            raise ValueError("transposed convs reuse a cached forward map")
        return transpose_kmap(cached_fwd, cached_fine)
    return build_kmap(x, spec.kernel_size, spec.stride, cache=cache)
