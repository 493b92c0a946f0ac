"""MinkUNet (3D semantic segmentation U-Net) on the port's sparse-conv stack.

Port of ``repro.models.minkunet``: the same declaration (layers, execution
program, 4-level map program with transposed decoder maps), compiled into
a ``NetworkPlan``.  ``MinkUNet`` is the ``nn.Module`` that holds the
parameters and the compiled plan; its state-dict keys are
``"<layer>.<leaf>"`` (``stem1.w``, ``stem1_bn.scale``, ``head.w``, …), which
is also what ``params_from_jax`` produces from a JAX parameter tree.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.plan import (LayerPlan, ModelDecl, NetworkPlan, bn_relu_init,
                                   compile_plan, pyramid_map_specs)
from repro_torch.core.sparse_conv import ConvSpec, TrainDataflowConfig, init_conv
from repro_torch.core.sparse_tensor import SparseTensor


@dataclasses.dataclass(frozen=True)
class MinkUNetConfig:
    in_channels: int = 4
    num_classes: int = 19
    width: float = 1.0
    enc_channels: tuple = (32, 64, 128, 256)
    dec_channels: tuple = (256, 128, 96, 96)
    blocks_per_stage: int = 2

    def ch(self, c: float) -> int:
        return max(8, int(c * self.width))


def declare(cfg: MinkUNetConfig) -> ModelDecl:
    """Layer list, execution program and kernel-map program (identical to
    the JAX declaration, including the declared "composed" table axis)."""
    w = cfg.ch
    c0 = w(cfg.enc_channels[0])
    layers = [
        LayerPlan("stem1", ConvSpec(cfg.in_channels, c0, 3), ("sub", 1), (1, 3, "sub")),
        LayerPlan("stem2", ConvSpec(c0, c0, 3), ("sub", 1), (1, 3, "sub")),
    ]
    ops = [("conv", "stem1"), ("conv", "stem2"), ("push",)]

    def res_block(prefix: str, cin_b: int, c: int, sig, ref):
        layers.append(LayerPlan(f"{prefix}_1", ConvSpec(cin_b, c, 3), ref, sig))
        layers.append(LayerPlan(f"{prefix}_2", ConvSpec(c, c, 3), ref, sig,
                                relu=False))
        ops.extend([("res_begin",), ("conv", f"{prefix}_1"),
                    ("conv", f"{prefix}_2"), ("res_end",)])

    cin = c0
    stride = 1
    for i, ce in enumerate(cfg.enc_channels):
        ce = w(ce)
        layers.append(LayerPlan(f"down{i}", ConvSpec(cin, ce, 2, stride=2),
                                ("down", stride), (stride, 2, "down")))
        ops.append(("conv", f"down{i}"))
        stride *= 2
        for b in range(cfg.blocks_per_stage):
            res_block(f"enc{i}b{b}", ce, ce, (stride, 3, "sub"), ("sub", stride))
        if i < len(cfg.enc_channels) - 1:
            ops.append(("push",))
        cin = ce

    skips = [c0] + [w(c) for c in cfg.enc_channels[:-1]]
    n = len(cfg.dec_channels)
    for i, cd in enumerate(cfg.dec_channels):
        cd = w(cd)
        lvl = n - i - 1
        s = 2 ** lvl
        layers.append(LayerPlan(f"up{i}", ConvSpec(cin, cd, 2, stride=2, transposed=True),
                                ("up", s), (s, 2, "up")))
        ops.extend([("conv", f"up{i}"), ("concat",)])
        cskip = skips[-(i + 1)]
        for b in range(cfg.blocks_per_stage):
            cin_b = cd + cskip if b == 0 else cd
            res_block(f"dec{i}b{b}", cin_b, cd, (s, 3, "sub"), ("sub", s))
        cin = cd
    ops.append(("head", "head"))
    return ModelDecl(arch="minkunet", layers=tuple(layers), ops=tuple(ops),
                     map_specs=pyramid_map_specs(len(cfg.enc_channels),
                                                 with_up=True, table="composed"))


def network_plan(cfg: MinkUNetConfig,
                 assignment: Optional[Dict[tuple, TrainDataflowConfig]] = None,
                 precision=None) -> NetworkPlan:
    return compile_plan(declare(cfg), assignment=assignment, precision=precision)


def init_params(cfg: MinkUNetConfig, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random parameters as a flat ``"<layer>.<leaf>"`` dict, drawn from a
    seeded CPU ``torch.Generator`` (the JAX initialisers' distributions)."""
    gen = torch.Generator().manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    for lp in declare(cfg).layers:
        for k, v in init_conv(gen, lp.spec).items():
            out[f"{lp.name}.{k}"] = v
        for k, v in bn_relu_init(lp.spec.out_channels).items():
            out[f"{lp.name}_bn.{k}"] = v
    cin = cfg.ch(cfg.dec_channels[-1])
    out["head.w"] = torch.randn((cin, cfg.num_classes), generator=gen) * cin ** -0.5
    return out


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """Carry a JAX parameter tree ({layer: {leaf: array}}, as numpy or any
    array with ``__array__``) across as a flat ``"<layer>.<leaf>"`` dict:
    conv ``w`` (KD, Cin, Cout), BN ``scale``/``bias``, head ``w``."""
    return {f"{layer}.{leaf}": torch.from_numpy(np.array(v, copy=True))
            for layer, leaves in tree.items() for leaf, v in leaves.items()}


class MinkUNet(nn.Module):
    """MinkUNet holding its parameters and its compiled ``NetworkPlan``.

    params: a flat ``"<layer>.<leaf>"`` dict (``params_from_jax`` output);
    None draws random ones from ``seed``.  device: None → the CUDA card."""

    def __init__(self, cfg: MinkUNetConfig, nplan: Optional[NetworkPlan] = None,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 seed: int = 0, device: DeviceLike = None):
        super().__init__()
        self.cfg = cfg
        self.nplan = nplan if nplan is not None else network_plan(cfg)
        flat = params if params is not None else init_params(cfg, seed)
        dev = resolve_device(device)
        groups: Dict[str, Dict[str, torch.Tensor]] = {}
        for key, v in flat.items():
            layer, leaf = key.split(".")
            groups.setdefault(layer, {})[leaf] = v
        for layer, leaves in groups.items():
            self.add_module(layer, nn.ParameterDict(
                {k: nn.Parameter(v.to(dev), requires_grad=False)
                 for k, v in leaves.items()}))

    def param_tree(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{layer: {leaf: tensor}} — the parameter layout ``NetworkPlan.apply``
        reads."""
        return {name: dict(mod.items()) for name, mod in self.named_children()}

    def build_maps(self, st: SparseTensor) -> dict:
        return self.nplan.build_maps(st)

    def forward(self, st: SparseTensor, maps: Optional[dict] = None,
                bn_mode: str = "batch", plans: Optional[dict] = None
                ) -> torch.Tensor:
        """Per-point class logits (capacity, num_classes)."""
        return self.nplan.apply(self.param_tree(), st, maps, bn_mode=bn_mode,
                                plans=plans)
