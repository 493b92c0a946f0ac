"""The serial sparse serving engine (port of ``repro.serve.engine``).

``submit()`` scenes, ``flush()`` to run them: queued scenes group FIFO into
bucket-fitting batches, each batch packs into one capacity-padded
``SparseTensor``, its kernel maps (and, for ``cuda`` implicit-GEMM layers,
split plans) are built on the device — or taken from a small LRU keyed by
the packed coordinates' digest, so a replayed batch skips mapping — and the
compiled ``NetworkPlan`` runs in affine (inference) normalization under
``torch.inference_mode()``.

Contract (as in the JAX package): a batched forward is bit-identical to
the per-scene forward.  Batch bits in every voxel key keep scenes from
seeing each other's neighbours, affine normalization keeps every row a
function of its own scene, and the CUDA kernels (the ``cuda`` backend's
convs and, on every backend, the head projection) give each output
element the same sequence of fp32 operations whatever rows share its tile.
The contract holds on the CPU and for ``cuda`` assignments on the card.
The ``torch`` backend's convs on the card are cuBLAS GEMMs over
bucket-sized row counts, and cuBLAS picks its algorithm by row count, so
there it is not guaranteed (``chip_smoke.py`` reports whether it held).
An engine built without a ``PlanRegistry`` runs that ``torch`` default;
pass an all-``cuda`` registry to serve through the kernels.

Not ported yet (they raise ``NotImplementedError``; see ROADMAP.md): the
pipelined flush (``max_inflight > 1``), scene-granular map reuse
(``map_strategy`` "composed"/"incremental"), streaming deltas, deadline
admission, the tuner, and tracing.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device, synchronize
from repro_torch.core.plan import NetworkPlan
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.configs import minkunet_kitti
from repro_torch.models import minkunet
from repro_torch.serve.batcher import PackedBatch, Scene, SceneBatcher, SceneResult
from repro_torch.serve.plans import PlanRegistry
from repro_torch.serve.service import ServiceConfig

#: per-scene latencies / per-phase durations kept for percentiles
LATENCY_WINDOW = 8192
PHASE_WINDOW = 4096


#: servable architectures (CenterPoint is not ported yet, see ROADMAP.md)
ARCHS = ("minkunet_kitti",)


def percentiles_ms(values) -> Tuple[Optional[float], Optional[float]]:
    """(p50, p95) of a window, ``(None, None)`` when empty."""
    if not len(values):
        return (None, None)
    lat = np.asarray(values, dtype=np.float64)
    return (float(np.percentile(lat, 50)), float(np.percentile(lat, 95)))


@dataclasses.dataclass
class EngineStats:
    submitted: int = 0
    completed: int = 0
    batches: int = 0
    flushes: int = 0
    busy_s: float = 0.0
    map_hits: int = 0
    map_misses: int = 0
    latencies_ms: "collections.deque" = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=LATENCY_WINDOW))
    #: (valid rows, bucket capacity) of each served batch
    batch_rows: "collections.deque" = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=LATENCY_WINDOW))
    phases: Dict[str, "collections.deque"] = dataclasses.field(default_factory=dict)

    def observe(self, phase: str, ms: float) -> None:
        window = self.phases.get(phase)
        if window is None:
            window = self.phases[phase] = collections.deque(maxlen=PHASE_WINDOW)
        window.append(ms)

    def summary(self) -> dict:
        p50, p95 = percentiles_ms(self.latencies_ms)
        phases = {}
        for name, window in sorted(self.phases.items()):
            q50, q95 = percentiles_ms(window)
            phases[name] = {"count": len(window), "p50_ms": q50, "p95_ms": q95}
        return {"scenes": self.completed, "batches": self.batches,
                "batch_rows": [list(r) for r in self.batch_rows],
                "p50_ms": p50, "p95_ms": p95,
                "scenes_per_s": self.completed / self.busy_s if self.busy_s else 0.0,
                "map_cache": {"hits": self.map_hits, "misses": self.map_misses},
                "phases": phases}


class Engine:
    """Front end: ``submit()`` scenes, ``flush()`` to run queued work.

    arch: "minkunet_kitti".  config: a ``ServiceConfig``.  model_config:
    the model width/depth (default: the arch's benchmark config).  params:
    a flat ``"<layer>.<leaf>"`` parameter dict (e.g. from
    ``minkunet.params_from_jax``); None draws them from ``config.seed``.
    plans: a ``PlanRegistry`` (or a path to one) with a persisted plan.
    precision: a policy (or name) bound onto every layer.  device: None →
    the CUDA card; ``"cpu"`` runs the plain PyTorch versions.
    """

    def __init__(self, arch: str, config: Optional[ServiceConfig] = None,
                 model_config=None, params=None,
                 plans: Optional[PlanRegistry] = None, precision=None,
                 device: DeviceLike = None):
        if arch not in ARCHS:
            raise ValueError(f"unknown arch {arch!r}; have {sorted(ARCHS)} "
                             f"(other archs are not ported yet, see ROADMAP.md)")
        self.config = config if config is not None else ServiceConfig()
        if self.config.max_inflight > 1:
            raise NotImplementedError(
                "the pipelined flush (max_inflight > 1) is not ported yet; "
                "use max_inflight=1 (see ROADMAP.md)")
        self.arch = arch
        self.device = resolve_device(device)
        self.cfg = model_config if model_config is not None \
            else minkunet_kitti.CONFIG_BENCH
        if isinstance(plans, str):
            plans = PlanRegistry.load(plans)
        self.plans = plans or PlanRegistry()
        self.plan_key = self.config.plan_key or arch
        self.assignment = self.plans.get(self.plan_key)
        # a persisted NetworkPlan is used as-is when it matches this model
        # config (same layer names + specs); otherwise one is compiled from
        # the declaration with the registry's assignment
        nplan = self.plans.network(self.plan_key)
        compiled = minkunet.network_plan(self.cfg, assignment=self.assignment)
        if nplan is None or [(lp.name, lp.spec) for lp in nplan.layers] != \
                [(lp.name, lp.spec) for lp in compiled.layers]:
            nplan = compiled
        if precision is not None:
            nplan = nplan.with_precision(precision)
        self.map_strategy = self.config.map_strategy or nplan.table_strategy
        if self.map_strategy != "sort":
            raise NotImplementedError(
                f"map_strategy {self.map_strategy!r} (scene-granular map "
                f"reuse) is not ported yet; pass map_strategy='sort' "
                f"(see ROADMAP.md)")
        self.model = minkunet.MinkUNet(self.cfg, nplan=nplan, params=params,
                                       seed=self.config.seed, device=self.device)
        self.ladder = self.config.ladder()
        self.batcher = SceneBatcher(self.ladder, self.config.spatial_bound,
                                    self.device)
        self.stats = EngineStats()
        self._queue: List[tuple] = []       # (ticket, Scene, t_submit)
        self._next_ticket = 0
        self._map_store: "collections.OrderedDict[str, tuple]" = \
            collections.OrderedDict()

    @property
    def nplan(self) -> NetworkPlan:
        return self.model.nplan

    def _phase_done(self, name: str, t0: float) -> float:
        """Record a phase that started at ``t0`` once the device finished it."""
        synchronize(self.device)
        t1 = time.perf_counter()
        self.stats.observe(name, (t1 - t0) * 1e3)
        return t1

    def _maps_for(self, batch: PackedBatch) -> Tuple[dict, dict]:
        """Batch kernel maps + split plans, from the digest LRU or built
        fresh on the device (the "sort" strategy's cold branch)."""
        cached = self._map_store.get(batch.digest)
        if cached is not None:
            self.stats.map_hits += 1
            self._map_store.move_to_end(batch.digest)
            return cached
        self.stats.map_misses += 1
        t0 = time.perf_counter()
        maps = self.nplan.build_maps(batch.st)
        t0 = self._phase_done("map_build", t0)
        plans = self.nplan.build_split_plans(maps)
        self._phase_done("plan_build", t0)
        self._map_store[batch.digest] = (maps, plans)
        while len(self._map_store) > self.config.maps_cache_size:
            self._map_store.popitem(last=False)
        return maps, plans

    def _execute(self, st: SparseTensor, maps: dict, plans: dict) -> torch.Tensor:
        return self.model(st, maps, bn_mode="affine", plans=plans)

    def _run_group(self, scenes: Sequence[Scene]) -> List[SceneResult]:
        t0 = time.perf_counter()
        batch = self.batcher.pack(scenes)
        t0 = self._phase_done("pack", t0)
        maps, plans = self._maps_for(batch)
        t0 = self._phase_done("map", t0)
        feats = self._execute(batch.st, maps, plans)
        t0 = self._phase_done("execute", t0)
        # MinkUNet's logits are per input voxel: rows align with the coords
        per_scene = self.batcher.unpack(batch, batch.st.coords, feats,
                                        int(batch.st.num_valid))
        self._phase_done("unpack", t0)
        self.stats.batches += 1
        self.stats.completed += batch.num_scenes
        self.stats.batch_rows.append((sum(batch.scene_sizes), batch.bucket))
        return per_scene

    # ------------------------------------------------------------------ api
    def submit(self, scene: Scene) -> int:
        """Enqueue one scene; returns a ticket resolved by the next flush."""
        if scene.num_points > self.ladder.max_capacity:
            raise ValueError(f"scene of {scene.num_points} rows exceeds the "
                             f"largest bucket ({self.ladder.max_capacity})")
        t = self._next_ticket
        self._next_ticket += 1
        self._queue.append((t, scene, time.perf_counter()))
        self.stats.submitted += 1
        return t

    def flush(self) -> Dict[int, SceneResult]:
        """Pack and run everything queued → {ticket: SceneResult}."""
        if not self._queue:
            return {}
        queue, self._queue = self._queue, []
        t0 = time.perf_counter()
        results: Dict[int, SceneResult] = {}
        groups = self.batcher.plan([s.num_points for _, s, _ in queue])
        with torch.inference_mode():
            for g in groups:
                per_scene = self._run_group([queue[i][1] for i in g])
                t_done = time.perf_counter()
                for slot, i in enumerate(g):
                    ticket, _, t_sub = queue[i]
                    results[ticket] = per_scene[slot]
                    self.stats.latencies_ms.append((t_done - t_sub) * 1e3)
        self.stats.busy_s += time.perf_counter() - t0
        self.stats.flushes += 1
        return results

    def serve(self, scenes: Sequence[Scene],
              flush_every: int = 0) -> List[SceneResult]:
        """Submit all, flush (every ``flush_every`` scenes), return in order."""
        out: Dict[int, SceneResult] = {}
        tickets = []
        for i, s in enumerate(scenes):
            tickets.append(self.submit(s))
            if flush_every and (i + 1) % flush_every == 0:
                out.update(self.flush())
        out.update(self.flush())
        return [out[t] for t in tickets]

    def warmup(self, channels: Optional[int] = None) -> None:
        """Run one synthetic batch filling each bucket through the real
        path (kernel libraries load, allocator and library handles warm)
        before the request stream arrives."""
        c = channels or self.cfg.in_channels
        with torch.inference_mode():
            for cap in self.ladder.capacities:
                rng = np.random.default_rng(cap)
                coords = rng.integers(-self.batcher.spatial_bound,
                                      self.batcher.spatial_bound,
                                      size=(cap, 3), dtype=np.int32)
                batch = self.batcher.pack([Scene(
                    coords=coords,
                    feats=rng.normal(size=(cap, c)).astype(np.float32))])
                maps, plans = self._maps_for(batch)
                self._execute(batch.st, maps, plans)
        synchronize(self.device)
