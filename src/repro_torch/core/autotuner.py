"""Layer grouping of the Sparse Autotuner (port of the part of
``repro.core.autotuner`` that ``compile_plan`` needs; the tuners
themselves come in a later slice)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List


@dataclasses.dataclass
class GroupInfo:
    """A set of layers sharing one kernel map (same in/out coords, stride, K)."""

    name: str
    layer_names: List[str]


def partition_groups(layer_signatures: Dict[str, tuple]) -> List[GroupInfo]:
    """Group layers by map signature (paper Fig. 12)."""
    by_sig: Dict[tuple, List[str]] = {}
    for name, sig in layer_signatures.items():
        by_sig.setdefault(sig, []).append(name)
    return [GroupInfo(name=f"g{i}_{sig}", layer_names=layers)
            for i, (sig, layers) in enumerate(sorted(by_sig.items(), key=str))]
