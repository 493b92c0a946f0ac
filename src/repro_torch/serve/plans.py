"""Persisted execution plans (port of ``repro.serve.plans.PlanRegistry``,
schema version 2).

Schema::

    {"version": 2,
     "plans": {"minkunet_kitti": {
         "assignment": {"1:3:sub": {"fwd": {...}, "dgrad": ..., "wgrad": ...}},
         "network": {...serialized NetworkPlan...} | null,
         "service": {...} | null}}}

A file written by the JAX package loads here: its ``xla``/``pallas``
backend names map to ``torch``/``cuda``.  The ``service`` block is kept as
written and saved back unchanged.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

from repro_torch.core.plan import NetworkPlan
from repro_torch.core.sparse_conv import TrainDataflowConfig

_VERSION = 2

Assignment = Dict[tuple, TrainDataflowConfig]


def _sig_to_str(sig: tuple) -> str:
    stride, k, kind = sig
    return f"{int(stride)}:{int(k)}:{kind}"


def _sig_from_str(s: str) -> tuple:
    stride, k, kind = s.split(":")
    return (int(stride), int(k), kind)


class PlanRegistry:
    """arch name → tuned plan (assignment + optional NetworkPlan), JSON-persisted."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._plans: Dict[str, Assignment] = {}
        self._networks: Dict[str, NetworkPlan] = {}
        self._services: Dict[str, dict] = {}

    def set(self, arch: str, assignment: Assignment,
            network: Optional[NetworkPlan] = None) -> None:
        self._plans[arch] = dict(assignment)
        if network is not None:
            self._networks[arch] = network
        else:
            self._networks.pop(arch, None)

    def get(self, arch: str) -> Assignment:
        return dict(self._plans.get(arch, {}))

    def network(self, arch: str) -> Optional[NetworkPlan]:
        return self._networks.get(arch)

    def to_dict(self) -> dict:
        names = sorted(set(self._plans) | set(self._services))
        return {"version": _VERSION,
                "plans": {arch: {
                    "assignment": {_sig_to_str(s): c.to_dict()
                                   for s, c in self._plans.get(arch, {}).items()},
                    "network": (self._networks[arch].to_dict()
                                if arch in self._networks else None),
                    "service": self._services.get(arch)}
                    for arch in names}}

    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path
        if not path:
            raise ValueError("PlanRegistry.save needs a path")
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)   # atomic: a crashed save never corrupts plans
        self.path = path
        return path

    @classmethod
    def load(cls, path: str, missing_ok: bool = True) -> "PlanRegistry":
        reg = cls(path=path)
        if not os.path.exists(path):
            if missing_ok:
                return reg
            raise FileNotFoundError(path)
        with open(path) as f:
            doc = json.load(f)
        if doc.get("version") != _VERSION:
            raise ValueError(f"unsupported plan version {doc.get('version')!r} "
                             f"in {path} (expected {_VERSION})")
        for arch, entry in doc.get("plans", {}).items():
            reg._plans[arch] = {_sig_from_str(s): TrainDataflowConfig.from_dict(c)
                                for s, c in entry.get("assignment", {}).items()}
            if entry.get("network") is not None:
                reg._networks[arch] = NetworkPlan.from_dict(entry["network"])
            if entry.get("service") is not None:
                reg._services[arch] = entry["service"]
        return reg
