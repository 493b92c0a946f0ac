"""Execution-plan IR (port of ``repro.core.plan``, serving half).

Models declare their layers (``ModelDecl``); ``compile_plan`` partitions the
tuner groups and binds per-group dataflow configs and precision policies
into a ``NetworkPlan``, which builds the kernel-map program and executes the
network.  ``NetworkPlan.to_dict`` / ``from_dict`` keep the JAX package's
schema (``PLAN_VERSION = 2``), so a plan persisted by either package loads
in the other's vocabulary (backend names map on load, see
``dataflows.DataflowConfig.from_dict``).

Not ported yet: the plan tuners, measured ``resolve_tiles``, the
scene-entry builders and pre-composed ``tables=`` (see ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core import precision as prec
from repro_torch.core.autotuner import partition_groups
from repro_torch.core.dataflows import plan_for
from repro_torch.core.kmap import MapCache, build_kmap, transpose_kmap
from repro_torch.core.precision import FP32, PrecisionPolicy
from repro_torch.core.sparse_conv import ConvSpec, TrainDataflowConfig, apply_conv
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.kernels.implicit_gemm.ops import implicit_gemm_split

PLAN_VERSION = 2


# ---------------------------------------------------------------------------
# Shared layers: masked batch norm (+ ReLU)
# ---------------------------------------------------------------------------

def bn_relu_init(c: int) -> dict:
    return {"scale": torch.ones((c,)), "bias": torch.zeros((c,))}


def bn_relu(p: dict, st: SparseTensor, relu: bool = True,
            mode: str = "batch") -> SparseTensor:
    """Masked batch norm (statistics over valid rows) + ReLU.

    ``mode="affine"`` is the serving mode — a per-channel scale and bias
    only, so each row depends on itself alone and a batched forward equals
    the per-scene one bit for bit.  Statistics and the affine map run in
    fp32; the result is cast back to the feature dtype."""
    mask = st.valid_mask[:, None]
    x = st.feats.float()
    if mode == "affine":
        y = x * p["scale"] + p["bias"]
    elif mode == "batch":
        n = torch.clamp(st.num_valid, min=1).float()
        zero = torch.zeros((), device=x.device)
        mean = torch.where(mask, x, zero).sum(dim=0) / n
        var = torch.where(mask, torch.square(x - mean), zero).sum(dim=0) / n
        y = (x - mean) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]
    else:
        raise ValueError(f"unknown bn mode {mode!r}")
    if relu:
        y = torch.relu(y)
    y = torch.where(mask, y, torch.zeros((), device=y.device))
    return st.replace_feats(y.to(st.feats.dtype))


def head_projection(st: SparseTensor, w: torch.Tensor) -> torch.Tensor:
    """Dense per-row projection ``feats @ w`` as a one-offset implicit GEMM
    over the identity map (padding rows → 0).

    A GEMM library picks its algorithm — and so its summation order — from
    the row count, so ``feats @ w`` on the card gives a row other bits in a
    batch than in its own scene's smaller bucket.  The implicit-GEMM kernel
    sums every output element in one fixed fp32 order whatever rows share
    its tile, which keeps the serving contract (batched ≡ per-scene, bit for
    bit); on the CPU its plain version runs."""
    cap = st.capacity
    tile_m = math.gcd(128, cap)
    rows = torch.arange(cap, dtype=torch.int32, device=st.device)
    midx = torch.where(st.valid_mask, rows, -1)[:, None].contiguous()
    occ = st.valid_mask.view(cap // tile_m, tile_m).any(dim=1)
    dt = torch.promote_types(st.feats.dtype, w.dtype)
    return implicit_gemm_split(midx, occ.to(torch.int32)[:, None].contiguous(),
                               st.feats.to(dt).contiguous(),
                               w.to(dt)[None].contiguous(), tile_m=tile_m)


def _split_key(lp: "LayerPlan") -> tuple:
    """Key of the ``SplitPlan`` a layer's forward consumes: map, split count,
    sorting, and the tile height its worklists were built for (0: none)."""
    fwd = lp.dataflow.fwd
    return (lp.map_ref, fwd.effective_splits, fwd.sorted,
            fwd.tile_m if fwd.worklist else 0)


# ---------------------------------------------------------------------------
# The IR
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One conv layer: its spec, kernel map ref, map-sharing signature,
    tuner group, fwd/dgrad/wgrad dataflows, precision, and BN/ReLU."""

    name: str
    spec: ConvSpec
    map_ref: Tuple
    sig: Tuple
    group: str = ""
    dataflow: TrainDataflowConfig = TrainDataflowConfig()
    precision: PrecisionPolicy = FP32
    bn: bool = True
    relu: bool = True

    def to_dict(self) -> dict:
        return {"name": self.name, "spec": dataclasses.asdict(self.spec),
                "map_ref": list(self.map_ref), "sig": list(self.sig),
                "group": self.group, "dataflow": self.dataflow.to_dict(),
                "precision": self.precision.to_dict(),
                "bn": self.bn, "relu": self.relu}

    @staticmethod
    def from_dict(d: dict) -> "LayerPlan":
        unknown = set(d) - {f.name for f in dataclasses.fields(LayerPlan)}
        if unknown:
            raise ValueError(f"unknown LayerPlan fields: {sorted(unknown)}")
        return LayerPlan(
            name=d["name"], spec=ConvSpec(**d["spec"]),
            map_ref=tuple(d["map_ref"]), sig=tuple(d["sig"]),
            group=d.get("group", ""),
            dataflow=TrainDataflowConfig.from_dict(d["dataflow"]),
            precision=PrecisionPolicy.from_dict(d["precision"]),
            bn=d.get("bn", True), relu=d.get("relu", True))


@dataclasses.dataclass(frozen=True)
class KmapSpec:
    """One kernel-map build step with its explicit dependency edges
    ("sub" submanifold, "down" strided adopting its output table, "up"
    transposed reusing ``transpose_of``).  ``table`` is the declared
    coordinate-table strategy; this port executes "sort" semantics."""

    ref: Tuple
    kind: str
    kernel_size: int
    stride: int
    tensor_stride: int
    adopts_output_table: bool = False
    transpose_of: Optional[Tuple] = None
    table: str = "sort"

    TABLE_STRATEGIES = ("sort", "composed", "incremental")

    def __post_init__(self):
        if self.kind not in ("sub", "down", "up"):
            raise ValueError(f"unknown map kind {self.kind!r}")
        if self.table not in self.TABLE_STRATEGIES:
            raise ValueError(f"unknown table strategy {self.table!r}")
        if self.kind == "up" and self.transpose_of is None:
            raise ValueError("an 'up' map needs transpose_of")

    def to_dict(self) -> dict:
        return {"ref": list(self.ref), "kind": self.kind,
                "kernel_size": self.kernel_size, "stride": self.stride,
                "tensor_stride": self.tensor_stride,
                "adopts_output_table": self.adopts_output_table,
                "transpose_of": (None if self.transpose_of is None
                                 else list(self.transpose_of)),
                "table": self.table}

    @staticmethod
    def from_dict(d: dict) -> "KmapSpec":
        unknown = set(d) - {f.name for f in dataclasses.fields(KmapSpec)}
        if unknown:
            raise ValueError(f"unknown KmapSpec fields: {sorted(unknown)}")
        t = d.get("transpose_of")
        return KmapSpec(ref=tuple(d["ref"]), kind=d["kind"],
                        kernel_size=d["kernel_size"], stride=d["stride"],
                        tensor_stride=d["tensor_stride"],
                        adopts_output_table=d.get("adopts_output_table", False),
                        transpose_of=None if t is None else tuple(t),
                        table=d.get("table", "sort"))


@dataclasses.dataclass(frozen=True)
class ModelDecl:
    """What a model declares: layers, execution program, map program."""

    arch: str
    layers: Tuple[LayerPlan, ...]
    ops: Tuple[Tuple, ...]
    map_specs: Tuple[KmapSpec, ...]


def pyramid_map_specs(levels: int, with_up: bool, sub_kernel: int = 3,
                      down_kernel: int = 2,
                      table: str = "sort") -> Tuple[KmapSpec, ...]:
    """The standard encoder(/decoder) map program: a submanifold map per
    stride level, a strided map per downsample (adopting its output
    table), and transposed maps reusing the strided ones for U-Nets."""
    specs = [KmapSpec(("sub", 1), "sub", sub_kernel, 1, 1, table=table)]
    stride = 1
    for _ in range(levels):
        specs.append(KmapSpec(("down", stride), "down", down_kernel, 2, stride,
                              adopts_output_table=True, table=table))
        stride *= 2
        specs.append(KmapSpec(("sub", stride), "sub", sub_kernel, 1, stride,
                              table=table))
    if with_up:
        for lvl in range(levels - 1, -1, -1):
            s = 2 ** lvl
            specs.append(KmapSpec(("up", s), "up", down_kernel, 2, s,
                                  transpose_of=("down", s), table=table))
    return tuple(specs)


def build_maps_from_specs(specs: Sequence[KmapSpec], st: SparseTensor,
                          cache: Optional[MapCache] = None) -> dict:
    """Execute a kernel-map program with one ``MapCache`` across the
    pyramid (tables shared per stride, strided maps adopting the next
    level's table)."""
    if cache is None:   # NOT `or`: an empty caller cache is falsy but wanted
        cache = MapCache.for_tensor(st)
    maps: dict = {}
    tensors = {st.stride: st}
    for ms in specs:
        cur = tensors[ms.tensor_stride]
        if ms.kind == "sub":
            maps[ms.ref] = build_kmap(cur, ms.kernel_size, 1, cache=cache)
        elif ms.kind == "down":
            kd = build_kmap(cur, ms.kernel_size, ms.stride, cache=cache)
            maps[ms.ref] = kd
            tensors[kd.out_stride] = SparseTensor(
                coords=kd.out_coords,
                feats=torch.zeros((kd.capacity, 1), dtype=st.feats.dtype,
                                  device=st.device),
                num_valid=kd.n_out, stride=kd.out_stride,
                batch_bound=st.batch_bound, spatial_bound=st.spatial_bound)
        else:
            maps[ms.ref] = transpose_kmap(maps[ms.transpose_of], cur)
    return maps


@dataclasses.dataclass(frozen=True)
class NetworkPlan:
    """The compiled, serializable execution plan of one sparse network."""

    arch: str
    layers: Tuple[LayerPlan, ...]
    ops: Tuple[Tuple, ...]
    map_specs: Tuple[KmapSpec, ...]
    version: int = PLAN_VERSION

    def assignment(self) -> Dict[tuple, TrainDataflowConfig]:
        """Per-signature dataflow assignment (layers in a group share one)."""
        out: Dict[tuple, TrainDataflowConfig] = {}
        for lp in self.layers:
            out.setdefault(lp.sig, lp.dataflow)
        return out

    def with_assignment(self, assignment: Dict[tuple, TrainDataflowConfig]
                        ) -> "NetworkPlan":
        layers = tuple(dataclasses.replace(lp, dataflow=assignment[lp.sig])
                       if lp.sig in assignment else lp for lp in self.layers)
        return dataclasses.replace(self, layers=layers)

    @property
    def table_strategy(self) -> str:
        return self.map_specs[0].table if self.map_specs else "sort"

    def with_precision(self, policy) -> "NetworkPlan":
        """One policy for the whole network, or a ``{sig: policy}`` dict."""
        if isinstance(policy, dict):
            layers = tuple(dataclasses.replace(lp, precision=prec.resolve(policy[lp.sig]))
                           if lp.sig in policy else lp for lp in self.layers)
        else:
            pol = prec.resolve(policy)
            layers = tuple(dataclasses.replace(lp, precision=pol)
                           for lp in self.layers)
        return dataclasses.replace(self, layers=layers)

    def cast_params(self, params: dict) -> dict:
        """Cast each conv layer's leaves to its declared storage dtype."""
        out = dict(params)
        for lp in self.layers:
            out[lp.name] = {k: lp.precision.cast_param(v)
                            for k, v in params[lp.name].items()}
        return out

    def build_maps(self, st: SparseTensor,
                   cache: Optional[MapCache] = None) -> dict:
        return build_maps_from_specs(self.map_specs, st, cache)

    def _split_layers(self) -> Dict[tuple, "LayerPlan"]:
        """First layer per ``_split_key`` among the layers whose forward
        consumes a ``SplitPlan`` (cuda implicit GEMM)."""
        out: Dict[tuple, LayerPlan] = {}
        for lp in self.layers:
            fwd = lp.dataflow.fwd
            if fwd.backend == "cuda" and fwd.dataflow == "implicit_gemm":
                out.setdefault(_split_key(lp), lp)
        return out

    def split_plan_specs(self) -> Tuple[tuple, ...]:
        """Deduped (map_ref, n_splits, sorted, worklist tile_m) keys."""
        return tuple(self._split_layers())

    def build_split_plans(self, maps: dict) -> dict:
        """Every split plan the forward consumes, worklists included."""
        return {key: plan_for(maps[lp.map_ref], lp.dataflow.fwd)
                for key, lp in self._split_layers().items()}

    def apply(self, params: dict, st: SparseTensor,
              maps: Optional[dict] = None, bn_mode: str = "batch",
              plans: Optional[dict] = None) -> torch.Tensor:
        """Run the compiled program → features (or head logits).  Ops:
        ("conv", layer), "push"/"concat" (U-Net skips as a stack),
        "res_begin"/"res_end" (residual block), ("head", params name)."""
        if maps is None:
            maps = self.build_maps(st)
        by_name = {lp.name: lp for lp in self.layers}
        x = st
        skips: list = []
        resid: list = []
        for op in self.ops:
            kind = op[0]
            if kind == "conv":
                lp = by_name[op[1]]
                plan = (plans or {}).get(_split_key(lp))
                x = apply_conv(params[lp.name], x, maps[lp.map_ref],
                               lp.dataflow, precision=lp.precision, plan=plan)
                if lp.bn:
                    x = bn_relu(params[f"{lp.name}_bn"], x, relu=lp.relu,
                                mode=bn_mode)
            elif kind == "push":
                skips.append(x)
            elif kind == "concat":
                skip = skips.pop()
                x = x.replace_feats(torch.cat([x.feats, skip.feats], dim=1))
            elif kind == "res_begin":
                resid.append(x.feats)
            elif kind == "res_end":
                idn = resid.pop()
                y = torch.relu(x.feats + idn if idn.shape == x.feats.shape
                               else x.feats)
                x = x.replace_feats(torch.where(
                    x.valid_mask[:, None], y,
                    torch.zeros((), dtype=y.dtype, device=y.device)))
            elif kind == "head":
                return head_projection(x, params[op[1]]["w"])
            else:
                raise ValueError(f"unknown plan op {op!r}")
        return x.feats

    def to_dict(self) -> dict:
        return {"version": self.version, "arch": self.arch,
                "layers": [lp.to_dict() for lp in self.layers],
                "ops": [list(op) for op in self.ops],
                "map_specs": [ms.to_dict() for ms in self.map_specs]}

    @staticmethod
    def from_dict(d: dict) -> "NetworkPlan":
        version = d.get("version", PLAN_VERSION)
        if version != PLAN_VERSION:
            raise ValueError(f"unsupported NetworkPlan version {version!r} "
                             f"(expected {PLAN_VERSION})")
        unknown = set(d) - {"version", "arch", "layers", "ops", "map_specs"}
        if unknown:
            raise ValueError(f"unknown NetworkPlan fields: {sorted(unknown)}")
        return NetworkPlan(
            arch=d["arch"],
            layers=tuple(LayerPlan.from_dict(x) for x in d["layers"]),
            ops=tuple(tuple(op) for op in d["ops"]),
            map_specs=tuple(KmapSpec.from_dict(x) for x in d["map_specs"]))


def compile_plan(decl: ModelDecl,
                 assignment: Optional[Dict[tuple, TrainDataflowConfig]] = None,
                 precision=None) -> NetworkPlan:
    """Compile a model declaration: partition tuner groups from the layers'
    map-sharing signatures, bind the per-group dataflow ``assignment`` and
    the numeric policy."""
    groups = partition_groups({lp.name: lp.sig for lp in decl.layers})
    group_of = {name: g.name for g in groups for name in g.layer_names}
    assignment = assignment or {}
    layers = []
    for lp in decl.layers:
        lp = dataclasses.replace(lp, group=group_of[lp.name])
        if lp.sig in assignment:
            lp = dataclasses.replace(lp, dataflow=assignment[lp.sig])
        layers.append(lp)
    nplan = NetworkPlan(arch=decl.arch, layers=tuple(layers), ops=decl.ops,
                        map_specs=decl.map_specs)
    if precision is not None:
        nplan = nplan.with_precision(precision)
    return nplan
