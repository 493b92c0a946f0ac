"""The CUDA kernels on the card against their plain PyTorch versions.

Marked ``cuda``: without a card each test skips (the decision is taken in
the fixture, at run time).  On the GPU machine run
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``;
the first test builds the kernels with nvcc.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import minkunet_kitti
from repro_torch.core import dataflows as df
from repro_torch.core import kmap as km
from repro_torch.core.plan import head_projection
from repro_torch.core.sparse_conv import TrainDataflowConfig
from repro_torch.core.sparse_tensor import make_sparse_tensor
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.fetch_on_demand import ops as fod_ops
from repro_torch.kernels.fetch_on_demand.ref import fetch_on_demand_fused_ref
from repro_torch.kernels.implicit_gemm import ops as ig_ops
from repro_torch.kernels.implicit_gemm.ref import implicit_gemm_ref
from repro_torch.models import minkunet
from repro_torch.serve.batcher import Scene
from repro_torch.serve.engine import Engine
from repro_torch.serve.plans import PlanRegistry
from repro_torch.serve.service import ServiceConfig

pytestmark = pytest.mark.cuda

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels compile and run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full fp32
    return torch.device("cuda")


def _map(dev, kernel, stride, n=3000, cap=4096, extent=24, seed=0):
    rng = np.random.default_rng(seed)
    c = np.unique(np.concatenate([rng.integers(0, 2, (n, 1)),
                                  rng.integers(-extent, extent, (n, 3))], 1), axis=0)
    nv = c.shape[0]
    coords = np.concatenate([c, np.zeros((cap - nv, 4), np.int64)]).astype(np.int32)
    st = make_sparse_tensor(torch.from_numpy(coords).to(dev),
                            torch.zeros((cap, 1), device=dev), nv,
                            batch_bound=2, spatial_bound=64)
    return km.build_kmap(st, kernel, stride)


def _cpu(dc):
    """A KernelMap / SplitPlan with every tensor field moved to the CPU."""
    return dataclasses.replace(dc, **{f.name: getattr(dc, f.name).cpu()
                                      for f in dataclasses.fields(dc)
                                      if isinstance(getattr(dc, f.name), torch.Tensor)})


def _operands(dev, kmap, cin, cout, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((kmap.capacity, cin), device=dev, generator=g)
    w = torch.randn((kmap.volume, cin, cout), device=dev, generator=g) \
        * (cin * kmap.volume) ** -0.5            # He scale: outputs are O(1)
    return x.to(DTYPES[dtype]), w.to(DTYPES[dtype])


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("tile_m", [16, 128])
@pytest.mark.parametrize("kernel,stride,cin,cout", [(3, 1, 4, 32), (3, 1, 96, 64),
                                                    (2, 2, 32, 48)])
def test_implicit_gemm_kernels_match_plain(dev, dtype, tile_m, kernel, stride,
                                           cin, cout):
    """Kernel glue on the card vs the same glue with the plain split
    version on the CPU (same rounding points: one per split partial)."""
    kmap = _map(dev, kernel, stride)
    x, w = _operands(dev, kmap, cin, cout, dtype, 0)
    reset_launches()
    for splits, srt in ((1, True), (3, True), (1, False)):
        plan = km.make_split_plan(kmap, splits, sort=srt)
        dense = ig_ops.implicit_gemm(x, w, kmap, plan, tile_m=tile_m)
        wplan = ig_ops.with_worklists(
            km.make_split_plan(kmap, splits, sort=srt, tile_m=tile_m))
        wl = ig_ops.implicit_gemm(x, w, kmap, wplan, tile_m=tile_m, worklist=True)
        torch.cuda.synchronize()
        assert torch.equal(dense, wl)                     # bit-identical
        plain = ig_ops.implicit_gemm(x.cpu(), w.cpu(), _cpu(kmap), _cpu(plan),
                                     tile_m=tile_m)
        torch.testing.assert_close(dense.cpu().float(), plain.float(), **_tol(dtype))
        if splits == 1:
            ref = implicit_gemm_ref(x, w, kmap.m_out)      # the JAX oracle's port
            torch.testing.assert_close(dense.float(), ref.float(), **_tol(dtype))
    assert LAUNCHES["implicit_gemm"] >= 3 and LAUNCHES["implicit_gemm_worklist"] >= 3


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("tile_r", [8, 128])
@pytest.mark.parametrize("kernel,stride,cin,cout", [(3, 1, 4, 32), (2, 2, 96, 64)])
def test_fetch_on_demand_kernel_matches_plain(dev, dtype, tile_r, kernel, stride,
                                              cin, cout):
    kmap = _map(dev, kernel, stride)
    x, w = _operands(dev, kmap, cin, cout, dtype, 1)
    n0 = LAUNCHES["fetch_on_demand"]
    got = fod_ops.fetch_on_demand(x, w, kmap, tile_r=tile_r)
    plain = fetch_on_demand_fused_ref(kmap.ws_in, kmap.ws_out, x, w,
                                      torch.zeros_like(got))
    torch.cuda.synchronize()
    assert LAUNCHES["fetch_on_demand"] == n0 + 1
    torch.testing.assert_close(got.float(), plain.float(), **_tol(dtype))


def test_head_projection_kernel_is_row_local(dev):
    """The head on the card: the dense kernel over the identity map matches
    ``feats @ w`` and gives a row the same bits in any capacity."""
    g = torch.Generator(device=dev).manual_seed(2)
    feats = torch.randn((4096, 96), device=dev, generator=g)
    w = torch.randn((96, 19), device=dev, generator=g) * 96 ** -0.5
    coords = torch.zeros((4096, 4), dtype=torch.int32, device=dev)
    n0 = LAUNCHES["implicit_gemm"]
    big = head_projection(make_sparse_tensor(coords, feats, 3000, batch_bound=1,
                                             spatial_bound=64), w)
    small = head_projection(make_sparse_tensor(coords[:1024], feats[:1024], 1000,
                                               batch_bound=1, spatial_bound=64), w)
    torch.cuda.synchronize()
    assert LAUNCHES["implicit_gemm"] == n0 + 2
    torch.testing.assert_close(big[:3000], feats[:3000] @ w, **_tol("float32"))
    assert not big[3000:].any() and torch.equal(small[:1000], big[:1000])


def test_engine_on_card_bit_identical_to_per_scene(dev):
    cfg = df.DataflowConfig(backend="cuda", worklist=True)
    sigs = minkunet.network_plan(minkunet_kitti.CONFIG_BENCH).assignment()
    reg = PlanRegistry()
    reg.set("minkunet_kitti", {s: TrainDataflowConfig.bind_all(cfg) for s in sigs})
    eng = Engine("minkunet_kitti", ServiceConfig(buckets=(1024, 2048), max_batch=3,
                                                 spatial_bound=64, map_strategy="sort"),
                 model_config=minkunet_kitti.CONFIG_BENCH, plans=reg, device=dev)
    rng = np.random.default_rng(0)
    scenes = []
    for n in (300, 700, 500, 900):
        c = np.unique(rng.integers(-60, 60, (n, 3)), axis=0).astype(np.int32)
        scenes.append(Scene(c, rng.standard_normal((len(c), 4)).astype(np.float32)))
    reset_launches()
    results = eng.serve(scenes, flush_every=2)
    assert LAUNCHES["implicit_gemm_worklist"] > 0
    with torch.inference_mode():
        for scene, res in zip(scenes, results):
            single = eng.batcher.pack([scene])
            feats = eng.model(single.st, eng.model.build_maps(single.st),
                              bn_mode="affine")
            np.testing.assert_array_equal(res.feats,
                                          feats[:scene.num_points].cpu().numpy())
