#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the CUDA kernels from
``src/repro_torch/csrc`` with nvcc, holds each kernel against its plain
PyTorch version at the shapes of a real served batch (fp32 and bf16), then
serves a MinkUNet-1x LiDAR stream through the port's ``Engine`` once per
all-``cuda`` dataflow assignment (dense implicit GEMM, worklist implicit
GEMM, fetch-on-demand) plus one mixed assignment loaded from a persisted
plan, checking every scene against the plain per-scene forward and the
per-scene kernel forward (bit for bit); a last serve with the engine's
default ``torch`` assignment reports whether its cuBLAS path kept the
batched ≡ per-scene contract.  Each phase prints one JSON line;
the line before the last is the card's ``nvidia-smi`` name and power limit,
and the last line is ``{"ok": true, "device": {...}}``.  Any failed check
raises, so the script exits non-zero and prints no result.  Without a CUDA
device, or outside a checkout, it exits non-zero at once.
"""
from __future__ import annotations

import json
import math
import pathlib
import re
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM published peaks (NVIDIA's data sheet, dense rates at the
# full 700 W power limit): HBM bytes/s, FLOP/s by operand type.  A kernel's
# bound_ms is the larger of bytes / HBM rate and operations / peak for the
# operands' type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

#: per-kernel tolerance against the plain version (tests/test_kernels.py:19-20)
TOL = {"float32": dict(rtol=1e-4, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}

#: served stream (lidar_stream defaults: extent 50 m, 0.4 m voxels → spatial
#: bound 147, single-word keys) and bucket ladder
STREAM = dict(seed=0, count=8, channels=4, n_range=(60000, 120000))
BUCKETS = (65536, 131072, 262144)
MAX_BATCH = 4
FLUSH_EVERY = 4

#: (case name, layer) whose maps and widths the kernel cases take from a
#: real served batch: the stem (Cin 4), a stride-1 27-offset layer, a
#: down (8-offset) layer, an up (transposed) layer, the deep concat layer
LAYER_CASES = (("stem", "stem1"), ("sub1", "stem2"), ("down", "down0"),
               ("up", "up3"), ("concat", "dec0b0_1"))


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_close(name: str, got, ref, dtype: str) -> float:
    import torch

    err = float((got.float() - ref.float()).abs().max())
    tol = TOL[dtype]
    bad = (got.float() - ref.float()).abs() > tol["atol"] + tol["rtol"] * ref.float().abs()
    if bool(bad.any()) or not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs err {err}, tolerance {tol})")
    return err


def kernel_cases(dev, batch, maps, cfg) -> dict:
    """Every kernel against its plain version at one served batch's shapes;
    returns per-kernel fp32 totals for the ``kernels`` line."""
    import torch

    from repro_torch.core import kmap as km
    from repro_torch.core.plan import head_projection
    from repro_torch.kernels.fetch_on_demand import ops as fod_ops
    from repro_torch.kernels.fetch_on_demand.ref import fetch_on_demand_fused_ref
    from repro_torch.kernels.implicit_gemm import ops as ig_ops
    from repro_torch.kernels.implicit_gemm.ref import implicit_gemm_ref
    from repro_torch.models import minkunet

    decl = {lp.name: lp for lp in minkunet.declare(cfg).layers}
    sums = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "t_bytes": 0.0,
                "t_ops": 0.0} for k in
            ("implicit_gemm", "implicit_gemm_worklist", "fetch_on_demand")}
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = batch.st.capacity           # every level keeps the bucket capacity

    def record(name, dtype, got, ref, kern, plain, nbytes, ops, line,
               library=None) -> None:
        err = check_close(f"{name}/{line['case']}/{dtype}", got, ref, dtype)
        ms = time_ms(kern, iters=10)
        plain_ms = time_ms(plain, iters=2, warmup=1)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_FLOPS[dtype] * 1e3
        emit({"phase": "kernel_case", "name": name, **line, "dtype": dtype,
              "max_abs_err": err, "tolerance": TOL[dtype], "ms": ms,
              "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
              "bound_by": "bytes" if t_bytes >= t_ops else "operations",
              "library_ms": None if library is None else time_ms(library, iters=10),
              "library_note": ("torch.mm over the same rows" if library else
                               "no single PyTorch call computes a sparse conv")})
        if dtype == "float32":
            t = sums[name]
            t["max_abs_err"] = max(t["max_abs_err"], err)
            t["ms"] += ms
            t["plain_ms"] += plain_ms
            t["t_bytes"] += t_bytes
            t["t_ops"] += t_ops

    # the head: a one-offset implicit GEMM over the identity map of the
    # batch's valid rows (padding rows are zero, as in the forward)
    hcin, hcout = cfg.ch(cfg.dec_channels[-1]), cfg.num_classes
    valid = batch.st.valid_mask
    n_valid = int(batch.st.num_valid)
    hmidx = torch.where(valid, torch.arange(rows, dtype=torch.int32, device=dev),
                        -1)[:, None].contiguous()
    for dtype in ("float32", "bfloat16"):
        td = getattr(torch, dtype)
        feats = torch.where(valid[:, None], torch.randn((rows, hcin), device=dev,
                                                        generator=gen), 0).to(td)
        st = batch.st.replace_feats(feats)
        hw = (torch.randn((hcin, hcout), device=dev, generator=gen)
              * hcin ** -0.5).to(td)
        kern = lambda: head_projection(st, hw)
        plain = lambda: implicit_gemm_ref(feats, hw[None], hmidx)
        nbytes = (n_valid * hcin + hcin * hcout + rows * hcout) * feats.element_size() \
            + rows * 4
        record("implicit_gemm", dtype, kern(), plain(), kern, plain, nbytes,
               2.0 * n_valid * hcin * hcout,
               {"case": "head", "layer": "head", "map": "identity", "rows": rows,
                "n_out": n_valid, "kd": 1, "cin": hcin, "cout": hcout,
                "hits": n_valid},
               library=lambda: torch.mm(feats, hw))
        del feats, st, hw

    for case, layer in LAYER_CASES:
        lp = decl[layer]
        kmap = maps[lp.map_ref]
        cin, cout = lp.spec.in_channels, lp.spec.out_channels
        plan = km.make_split_plan(kmap, 1)
        # the worklist path as served: CSR worklists built with the plan
        wl_plan = ig_ops.with_worklists(
            km.make_split_plan(kmap, 1, tile_m=math.gcd(128, kmap.capacity)))
        hits = int((kmap.m_out >= 0).sum())
        # input rows the map references: each is read once at least
        n_rows_in = int(torch.unique(kmap.m_out[kmap.m_out >= 0]).numel())
        map_bytes = {"implicit_gemm": (kmap.m_out.numel() + 2 * kmap.capacity) * 4,
                     "fetch_on_demand": 2 * kmap.ws_in.numel() * 4}
        for dtype in ("float32", "bfloat16"):
            td = getattr(torch, dtype)
            x = torch.randn((rows, cin), device=dev, generator=gen).to(td)
            w = (torch.randn((kmap.volume, cin, cout), device=dev, generator=gen)
                 * (cin * kmap.volume) ** -0.5).to(td)
            plain_ig = implicit_gemm_ref(x, w, kmap.m_out)
            runs = {
                "implicit_gemm": (lambda: ig_ops.implicit_gemm(x, w, kmap, plan),
                                  lambda: implicit_gemm_ref(x, w, kmap.m_out),
                                  "implicit_gemm"),
                "implicit_gemm_worklist": (
                    lambda: ig_ops.implicit_gemm(x, w, kmap, wl_plan, worklist=True),
                    lambda: implicit_gemm_ref(x, w, kmap.m_out), "implicit_gemm"),
                "fetch_on_demand": (
                    lambda: fod_ops.fetch_on_demand(x, w, kmap),
                    lambda: fetch_on_demand_fused_ref(
                        kmap.ws_in, kmap.ws_out, x, w,
                        torch.zeros((kmap.capacity, cout), dtype=td, device=dev)),
                    "fetch_on_demand"),
            }
            outs = {}
            for name, (kern, plain, mapkind) in runs.items():
                got = outs[name] = kern()
                ref = plain_ig if mapkind == "implicit_gemm" else plain()
                nbytes = (n_rows_in * cin + kmap.volume * cin * cout
                          + kmap.capacity * cout) * x.element_size() \
                    + map_bytes[mapkind]
                record(name, dtype, got, ref, kern, plain, nbytes,
                       2.0 * hits * cin * cout,
                       {"case": case, "layer": layer, "map": list(lp.map_ref),
                        "rows": kmap.capacity, "n_out": int(kmap.n_out),
                        "kd": kmap.volume, "cin": cin, "cout": cout, "hits": hits})
            if not torch.equal(outs["implicit_gemm"], outs["implicit_gemm_worklist"]):
                raise AssertionError(f"{case}/{dtype}: worklist kernel is not "
                                     f"bit-identical to the dense kernel")
            del x, w, outs, plain_ig, runs
    # the kernels line: fp32 totals over the cases (the five conv layers,
    # and the head for implicit_gemm); the bound of the calls together is
    # total bytes or total operations over the peak
    totals = {}
    for name, t in sums.items():
        totals[name] = {"max_abs_err": t["max_abs_err"], "ms": t["ms"],
                        "plain_ms": t["plain_ms"],
                        "bound_ms": max(t["t_bytes"], t["t_ops"]),
                        "bound_by": ("bytes" if t["t_bytes"] >= t["t_ops"]
                                     else "operations")}
    return totals


def serve_phase(dev, scenes, bound, cfg) -> dict:
    """Serve the stream once per assignment; returns {assignment: launches
    per kernel during that serve}.  Every ``cuda`` assignment must give
    batched ≡ per-scene bit for bit; the default ``torch`` assignment's
    convs run cuBLAS on the card, so for it the result is reported only."""
    import numpy as np
    import torch

    from repro_torch.core import dataflows as df
    from repro_torch.core.sparse_conv import TrainDataflowConfig
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models import minkunet
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.plans import PlanRegistry
    from repro_torch.serve.service import ServiceConfig

    service = ServiceConfig(buckets=BUCKETS, max_batch=MAX_BATCH,
                            spatial_bound=bound, map_strategy="sort")
    sigs = minkunet.network_plan(cfg).assignment()
    dense = df.DataflowConfig(backend="cuda")
    worklist = df.DataflowConfig(backend="cuda", worklist=True)
    fod = df.DataflowConfig("fetch_on_demand", backend="cuda")
    mixed = {s: (worklist if s[2] == "sub" else fod) for s in sigs}
    assignments = {"dense": {s: dense for s in sigs},
                   "worklist": {s: worklist for s in sigs},
                   "fetch_on_demand": {s: fod for s in sigs},
                   "mixed": mixed,
                   "torch": None}          # no registry: the engine's default

    # plain-version per-scene reference (the torch backend's plain convs, same
    # params; its head is the implicit-GEMM kernel, held against its plain
    # version in the kernel cases)
    plain_eng = Engine("minkunet_kitti", service, model_config=cfg, device=dev)
    ref = []
    with torch.inference_mode():
        for s in scenes:
            single = plain_eng.batcher.pack([s])
            t0 = time.perf_counter()
            logits = plain_eng.model(single.st, plain_eng.model.build_maps(single.st),
                                     bn_mode="affine")
            torch.cuda.synchronize()
            ref.append((logits[:s.num_points].cpu().numpy(),
                        (time.perf_counter() - t0) * 1e3))
    del plain_eng
    emit({"phase": "plain_reference", "scenes": len(scenes),
          "per_scene_ms": [r[1] for r in ref]})

    by_path = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for name, assign in assignments.items():
            plans = None
            if assign is not None:
                plans = PlanRegistry()
                plans.set("minkunet_kitti", {s: TrainDataflowConfig.bind_all(c)
                                             for s, c in assign.items()})
            if name == "mixed":       # through the persisted-plan path
                plans = plans.save(str(pathlib.Path(tmp) / "plans.json"))
            eng = Engine("minkunet_kitti", service, model_config=cfg, plans=plans,
                         device=dev)
            eng.warmup()
            eng.stats = type(eng.stats)()
            reset_launches()
            results = eng.serve(scenes, flush_every=FLUSH_EVERY)
            torch.cuda.synchronize()
            counts = by_path[name] = launches()
            used = {"implicit_gemm"} | {      # the head, and each cuda conv's kernel
                c.fwd.dataflow + ("_worklist" if c.fwd.worklist else "")
                for c in eng.nplan.assignment().values()
                if c.fwd.effective_backend() == "cuda"}
            for k in used:
                if counts[k] == 0:
                    raise AssertionError(f"{name}: kernel {k} never launched")
            rel_errs, identical = [], True
            with torch.inference_mode():
                for s, res, (plain_logits, _) in zip(scenes, results, ref):
                    if res.feats.shape != plain_logits.shape \
                            or not np.isfinite(res.feats).all():
                        raise AssertionError(f"{name}: bad output {res.feats.shape}")
                    scale = float(np.abs(plain_logits).max())
                    diff = np.abs(res.feats - plain_logits)
                    err = float(diff.max())
                    if (diff > 1e-5 * scale + 1e-4 * np.abs(plain_logits)).any():
                        raise AssertionError(f"{name}: served logits differ from the "
                                             f"plain forward by {err} (scale {scale})")
                    rel_errs.append(err / scale)
                    single = eng.batcher.pack([s])
                    own = eng.model(single.st, eng.model.build_maps(single.st),
                                    bn_mode="affine")[:s.num_points].cpu().numpy()
                    identical &= bool(np.array_equal(own, res.feats))
            if not identical and assign is not None:
                raise AssertionError(f"{name}: batched output is not bit-identical "
                                     f"to the per-scene kernel forward")
            summ = eng.stats.summary()
            emit({"phase": "serve", "assignment": name, "scenes": summ["scenes"],
                  "batches": summ["batches"], "batch_rows": summ["batch_rows"],
                  "p50_ms": summ["p50_ms"], "p95_ms": summ["p95_ms"],
                  "scenes_per_s": summ["scenes_per_s"],
                  "map_ms": summ["phases"]["map"]["p50_ms"],
                  "execute_ms": summ["phases"]["execute"]["p50_ms"],
                  "phases": summ["phases"], "launches": counts,
                  "max_rel_err_vs_plain": max(rel_errs),
                  "bit_identical_to_per_scene": identical})
            del eng, results
    return by_path


def profile_phase(dev, batch, cfg) -> None:
    """Where one served batch's time goes: ``torch.profiler`` over a cold
    map build (+ split plans) and one forward under the all-``cuda`` dense
    assignment; prints the top ops by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import dataflows as df
    from repro_torch.core.sparse_conv import TrainDataflowConfig
    from repro_torch.models import minkunet

    nplan = minkunet.network_plan(cfg)
    dense = TrainDataflowConfig.bind_all(df.DataflowConfig(backend="cuda"))
    nplan = nplan.with_assignment({s: dense for s in nplan.assignment()})
    model = minkunet.MinkUNet(cfg, nplan=nplan, device=dev)

    def stages():
        maps = nplan.build_maps(batch.st)
        plans = nplan.build_split_plans(maps)
        torch.cuda.synchronize()
        yield "map_build"
        model(batch.st, maps, bn_mode="affine", plans=plans)
        torch.cuda.synchronize()
        yield "execute"

    with torch.inference_mode():
        for _ in stages():       # warm: kernel libraries, allocator
            pass
        for stage_name in ("map_build", "execute"):
            run = stages()
            if stage_name == "execute":
                next(run)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                next(run)
                wall = (time.perf_counter() - t0) * 1e3
            ops = [e for e in prof.key_averages() if e.key.startswith("aten::")]
            dev_us = {e.key: e.self_device_time_total for e in ops}
            top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:6]
            emit({"phase": "profile", "stage": stage_name, "rows": batch.st.capacity,
                  "wall_ms": wall, "aten_device_ms": sum(dev_us.values()) / 1e3,
                  "top_ops_device_ms": {k: v / 1e3 for k, v in top},
                  "kernel_device_ms": {
                      re.search(r"(igemm|fod)_\w+_kernel", e.key).group(0):
                      e.self_device_time_total / 1e3
                      for e in prof.key_averages()
                      if re.search(r"(igemm|fod)_\w+_kernel", e.key)}})


def main(argv=None) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: run from a checkout ({SRC / 'repro_torch'} missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import minkunet_kitti
    from repro_torch.kernels import build as kbuild
    from repro_torch.serve.workload import lidar_stream

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    emit({"phase": "build", "seconds": kbuild.build(),
          "sources": {n: f"src/repro_torch/csrc/{s}" for n, (s, _) in
                      kbuild.LIBRARIES.items()}})

    cfg = minkunet_kitti.CONFIG_1X
    t0 = time.perf_counter()
    scenes, bound = lidar_stream(device=dev, **STREAM)
    emit({"phase": "stream", "scenes": len(scenes), "spatial_bound": bound,
          "voxels": [s.num_points for s in scenes],
          "seconds": time.perf_counter() - t0})

    # kernel cases at the shapes of the first served batch
    from repro_torch.models.minkunet import network_plan
    from repro_torch.serve.batcher import SceneBatcher
    from repro_torch.serve.bucketing import BucketLadder

    batcher = SceneBatcher(BucketLadder(BUCKETS, MAX_BATCH), bound, dev)
    first = batcher.plan([s.num_points for s in scenes])[0]
    batch = batcher.pack([scenes[i] for i in first])
    with torch.inference_mode():
        maps = network_plan(cfg).build_maps(batch.st)
        totals = kernel_cases(dev, batch, maps, cfg)
    del maps
    profile_phase(dev, batch, cfg)
    del batch

    by_path = serve_phase(dev, scenes, bound, cfg)

    sources = {"implicit_gemm": "src/repro_torch/csrc/implicit_gemm.cu",
               "implicit_gemm_worklist": "src/repro_torch/csrc/implicit_gemm.cu",
               "fetch_on_demand": "src/repro_torch/csrc/fetch_on_demand.cu"}
    replaces = {
        "implicit_gemm": "src/repro/kernels/implicit_gemm/implicit_gemm.py:84",
        "implicit_gemm_worklist": "src/repro/kernels/implicit_gemm/implicit_gemm.py:175",
        "fetch_on_demand": "src/repro/kernels/fetch_on_demand/fetch_on_demand.py:94"}
    # launches: each kernel's count in the serve of its own all-cuda
    # assignment (2 batches); launches_by_path: its count in every serve
    own = {"implicit_gemm": "dense", "implicit_gemm_worklist": "worklist",
           "fetch_on_demand": "fetch_on_demand"}
    emit({"kernels": [{"name": k, "route": "cuda", "source": sources[k],
                       "replaces": replaces[k], "launches": by_path[own[k]][k],
                       "launches_path": own[k],
                       "launches_by_path": {p: c[k] for p, c in by_path.items()},
                       **totals[k], "library_ms": None}
                      for k in sources]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
