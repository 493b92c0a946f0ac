"""Hand-written CUDA kernels of the port and their launch counters.

Each wrapper adds one to ``LAUNCHES[<kernel name>]`` where it launches its
kernel on the card, and nowhere else (the CPU path runs the kernel's plain
version and counts nothing), so a run can show that its main path really
went through the kernels.
"""
from __future__ import annotations

from typing import Dict

KERNEL_NAMES = ("implicit_gemm", "implicit_gemm_worklist", "fetch_on_demand")

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNEL_NAMES}


def reset_launches() -> None:
    for name in KERNEL_NAMES:
        LAUNCHES[name] = 0


def launches() -> Dict[str, int]:
    return dict(LAUNCHES)
