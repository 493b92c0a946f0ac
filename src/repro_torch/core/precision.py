"""Mixed-precision policies (port of ``repro.core.precision``).

Same dataclass and ``to_dict`` schema as the JAX package, with dtype names
as strings ("float32" / "bfloat16") so persisted plans load in both.
"""
from __future__ import annotations

import dataclasses

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def to_dtype(name) -> torch.dtype:
    """dtype name ("float32", "bfloat16", …) or torch.dtype → torch.dtype."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype name {name!r}; have "
                         f"{sorted(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Per-layer numeric policy: GEMM operands in ``compute``, partial sums
    in ``accum``, results in ``output`` ("" = the input features' dtype),
    parameter storage in ``params`` ("" = unchanged)."""

    compute: str = "float32"
    accum: str = "float32"
    output: str = ""
    params: str = ""
    master_weights: bool = False

    def __post_init__(self):
        for f in ("compute", "accum"):
            to_dtype(getattr(self, f))
        for f in ("output", "params"):
            if getattr(self, f):
                to_dtype(getattr(self, f))

    @property
    def compute_dtype(self) -> torch.dtype:
        return to_dtype(self.compute)

    @property
    def accum_dtype(self) -> torch.dtype:
        return to_dtype(self.accum)

    def output_dtype(self, like: torch.dtype) -> torch.dtype:
        return to_dtype(self.output) if self.output else like

    def cast_param(self, p: torch.Tensor) -> torch.Tensor:
        if not self.params:
            return p
        t = to_dtype(self.params)
        return p.to(t) if p.dtype != t and p.is_floating_point() else p

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "PrecisionPolicy":
        unknown = set(d) - {f.name for f in dataclasses.fields(PrecisionPolicy)}
        if unknown:
            raise ValueError(f"unknown PrecisionPolicy fields: {sorted(unknown)}")
        return PrecisionPolicy(**d)


def gemm_operand(a: torch.Tensor, compute_dtype, accum_dtype) -> torch.Tensor:
    """Round a GEMM operand to the compute dtype, then carry it for the dot.

    Products of bf16-rounded values are exact in fp32, so rounding to bf16
    and multiplying in fp32 equals a native bf16 GEMM with an fp32
    accumulator.  The rounded operands are upcast to the accumulator dtype
    on every device: that is the JAX package's CPU branch, and on the card
    it keeps ``torch.mm`` from rounding its output to bf16 (a bf16 ``mm``
    returns bf16, where the reference returns the fp32 accumulator).
    """
    ct, at = to_dtype(compute_dtype), to_dtype(accum_dtype)
    a = a.to(ct)
    if ct != at:
        a = a.to(at)
    return a


FP32 = PrecisionPolicy()
BF16 = PrecisionPolicy(compute="bfloat16", output="bfloat16",
                       params="bfloat16", master_weights=True)
BF16_AMP = PrecisionPolicy(compute="bfloat16")

POLICIES = {"fp32": FP32, "bf16": BF16, "bf16_amp": BF16_AMP}


def resolve(policy) -> PrecisionPolicy:
    """Accept a PrecisionPolicy, a name ("fp32"/"bf16"/"bf16_amp"), or None."""
    if policy is None:
        return FP32
    if isinstance(policy, PrecisionPolicy):
        return policy
    if isinstance(policy, str):
        try:
            return POLICIES[policy]
        except KeyError:
            raise ValueError(f"unknown precision policy {policy!r}; "
                             f"have {sorted(POLICIES)}") from None
    raise TypeError(f"cannot resolve precision policy from {type(policy)}")
