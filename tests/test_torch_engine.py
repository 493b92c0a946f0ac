"""The slice as a whole: the port's serving ``Engine`` against the JAX
``Engine`` on the same params and the same stream, the port's own
batched ≡ per-scene bit-identity (for every dataflow assignment — on the
CPU the ``cuda`` assignments run the kernels' plain versions through the
same wrappers and glue), and plan persistence across the two packages.

Tolerances against JAX, per scene, relative to max|logit| of the JAX
output: fp32 rtol 1e-4 / atol 1e-5 × max|logit| (the kernel-test fp32
tolerance); bf16_amp the same — both packages round the same operands to
bf16 and accumulate in fp32, so only fp32 summation order differs.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import minkunet_kitti as j_configs
from repro.core import dataflows as jdf
from repro.core.sparse_conv import TrainDataflowConfig as JTrain
from repro.models import minkunet as j_minkunet
from repro.serve import Engine as JEngine
from repro.serve import PlanRegistry as JRegistry
from repro.serve import Scene as JScene
from repro.serve.service import ServiceConfig as JServiceConfig
from repro_torch.configs import minkunet_kitti as t_configs
from repro_torch.core import dataflows as tdf
from repro_torch.core.sparse_conv import TrainDataflowConfig as TTrain
from repro_torch.core.device import resolve_device
from repro_torch.kernels import LAUNCHES
from repro_torch.models import minkunet as t_minkunet
from repro_torch.serve.batcher import Scene as TScene
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.plans import PlanRegistry as TRegistry
from repro_torch.serve.service import ServiceConfig
from repro_torch.serve.workload import lidar_stream

SIZES = (80, 150, 400, 120, 300, 200)
CFG = dict(buckets=(256, 512), max_batch=3, spatial_bound=64,
           map_strategy="sort")


@pytest.fixture(scope="module")
def jax_params():
    return j_minkunet.init_params(j_configs.CONFIG_BENCH, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def port_params(jax_params):
    return t_minkunet.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             jax_params))


def _stream():
    out = []
    for i, n in enumerate(SIZES):
        rng = np.random.default_rng(i)
        c = np.unique(rng.integers(-40, 40, (n, 3)), axis=0).astype(np.int32)
        rng.shuffle(c)
        out.append((c, rng.standard_normal((c.shape[0], 4)).astype(np.float32)))
    return out


def _port_engine(params, **kw):
    return TEngine("minkunet_kitti", ServiceConfig(**CFG), params=params,
                   device="cpu", **kw)


@pytest.mark.parametrize("precision", [None, "bf16_amp"])
def test_port_engine_matches_jax_engine(jax_params, port_params, precision):
    stream = _stream()
    je = JEngine("minkunet_kitti", JServiceConfig(**CFG), params=jax_params,
                 precision=precision)
    jres = je.serve([JScene(c, f) for c, f in stream], flush_every=3)
    te = _port_engine(port_params, precision=precision)
    tres = te.serve([TScene(c, f) for c, f in stream], flush_every=3)
    assert te.stats.batches == je.stats.batches == 4
    for a, b in zip(jres, tres):
        np.testing.assert_array_equal(a.coords, b.coords)
        assert b.feats.dtype == np.float32 and b.feats.shape == a.feats.shape
        scale = float(np.abs(a.feats).max())
        np.testing.assert_allclose(b.feats, a.feats, rtol=1e-4,
                                   atol=1e-5 * scale)


def _per_scene(eng, scene):
    """Per-scene forward through the model API at the scene's own bucket."""
    with torch.inference_mode():
        single = eng.batcher.pack([scene])
        feats = eng.model(single.st, eng.model.build_maps(single.st),
                          bn_mode="affine")
    n = scene.num_points
    return single.st.coords[:n, 1:].numpy(), feats[:n].numpy()


ASSIGNMENTS = {
    "torch": tdf.DataflowConfig(),
    "cuda_dense": tdf.DataflowConfig(backend="cuda", n_splits=2, tile_m=16),
    "cuda_worklist": tdf.DataflowConfig(backend="cuda", tile_m=16,
                                        worklist=True),
    "cuda_fod": tdf.DataflowConfig("fetch_on_demand", backend="cuda",
                                   tile_m=32),
}


@pytest.mark.parametrize("name", sorted(ASSIGNMENTS))
def test_port_engine_batched_bit_identical_to_per_scene(port_params, name):
    cfg = ASSIGNMENTS[name]
    nplan = t_minkunet.network_plan(t_configs.CONFIG_BENCH)
    reg = TRegistry()
    reg.set("minkunet_kitti", {sig: TTrain.bind_all(cfg)
                               for sig in nplan.assignment()})
    eng = _port_engine(port_params, plans=reg)
    assert all(lp.dataflow.fwd == cfg for lp in eng.nplan.layers)
    scenes = [TScene(c, f) for c, f in _stream()]
    results = eng.serve(scenes, flush_every=3)
    for scene, res in zip(scenes, results):
        ref_coords, ref_feats = _per_scene(eng, scene)
        np.testing.assert_array_equal(res.coords, ref_coords)
        np.testing.assert_array_equal(res.feats, ref_feats)   # bit-identical
    s = eng.stats.summary()
    assert s["scenes"] == 6 and s["batches"] == 4
    assert s["p95_ms"] >= s["p50_ms"] > 0
    assert [r[1] for r in s["batch_rows"]] == \
        [eng.ladder.select(r[0]) for r in s["batch_rows"]]
    # replay: identical packed batches hit the digest map cache
    eng.serve(scenes, flush_every=3)
    assert eng.stats.map_hits == 4 and eng.stats.map_misses == 4
    assert LAUNCHES == {k: 0 for k in LAUNCHES}   # CPU: plain versions only


def test_jax_persisted_plan_loads_in_port(tmp_path, jax_params, port_params):
    """A PlanRegistry file written by the JAX package loads here with its
    backend names mapped (pallas → cuda, xla → torch), drives the port
    engine, and the port's own save round-trips it."""
    jplan = j_minkunet.network_plan(j_configs.CONFIG_BENCH)
    sigs = sorted(jplan.assignment(), key=str)
    pallas = jdf.DataflowConfig("implicit_gemm", n_splits=2, tile_m=16,
                                backend="pallas", worklist=True)
    assign = {sig: JTrain.bind_all(pallas if i % 2 else jdf.DataflowConfig())
              for i, sig in enumerate(sigs)}
    jreg = JRegistry()
    jreg.set("minkunet_kitti", assign, network=jplan.with_assignment(assign))
    path = str(tmp_path / "plans.json")
    jreg.save(path)

    reg = TRegistry.load(path)
    net = reg.network("minkunet_kitti")
    expect = json.loads(json.dumps(jreg.to_dict()["plans"]["minkunet_kitti"]
                                   ["network"]).replace('"pallas"', '"cuda"')
                        .replace('"xla"', '"torch"'))
    assert net.to_dict() == expect
    assert reg.get("minkunet_kitti") == {
        s: TTrain.bind_all(tdf.DataflowConfig.from_dict(c.fwd.to_dict()))
        for s, c in assign.items()}
    eng = TEngine("minkunet_kitti", ServiceConfig(**CFG), params=port_params,
                  plans=path, device="cpu")
    assert eng.nplan == net
    assert {lp.dataflow.fwd.backend for lp in eng.nplan.layers} == {"cuda", "torch"}
    assert eng.nplan.split_plan_specs()
    res = eng.serve([TScene(c, f) for c, f in _stream()[:2]])
    assert all(np.isfinite(r.feats).all() for r in res)
    out = str(tmp_path / "port.json")
    reg.save(out)
    assert TRegistry.load(out).network("minkunet_kitti") == net


def test_engine_rejects_unported_settings(port_params):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TEngine("minkunet_kitti", ServiceConfig(**{**CFG, "max_inflight": 2}),
                params=port_params, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        # MinkUNet declares the "composed" table strategy
        TEngine("minkunet_kitti",
                ServiceConfig(**{**CFG, "map_strategy": None}),
                params=port_params, device="cpu")
    with pytest.raises(ValueError):
        TEngine("centerpoint_waymo", ServiceConfig(**CFG), device="cpu")


def test_engine_warmup_and_oversize_scene(port_params):
    eng = _port_engine(port_params)
    eng.warmup()
    assert eng.stats.map_misses == 2
    with pytest.raises(ValueError):
        eng.submit(TScene(np.zeros((513, 3), np.int32),
                          np.zeros((513, 4), np.float32)))


def test_lidar_stream_and_plan_schema_match_jax():
    scenes, bound = lidar_stream(3, 2, 4, n_range=(300, 500), device="cpu")
    assert bound == 147 and len(scenes) == 2
    for s in scenes:
        assert s.coords.dtype == np.int32 and s.feats.shape[1] == 4
        assert 0 < s.num_points <= 500 and np.abs(s.coords).max() <= bound
        assert len(np.unique(s.coords, axis=0)) == s.num_points
    # the declarations compile to the same plan, backend names aside
    for cfg in ("CONFIG_1X", "CONFIG_BENCH"):
        j = j_minkunet.network_plan(getattr(j_configs, cfg)).to_dict()
        t = t_minkunet.network_plan(getattr(t_configs, cfg)).to_dict()
        assert json.dumps(j).replace('"xla"', '"torch"') == json.dumps(t)


def test_device_defaults_to_cuda():
    """Entry points run on the card unless asked for the CPU: with no card
    they raise instead of falling back."""
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cpu"):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            TEngine("minkunet_kitti", ServiceConfig(**CFG))


def test_params_from_jax_round_trip(jax_params, port_params):
    model = t_minkunet.MinkUNet(t_configs.CONFIG_BENCH, params=port_params,
                                device="cpu")
    sd = model.state_dict()
    assert set(sd) == set(port_params)
    for layer, leaves in jax_params.items():
        for leaf, v in leaves.items():
            np.testing.assert_array_equal(sd[f"{layer}.{leaf}"].numpy(),
                                          np.asarray(v))
    fresh = t_minkunet.init_params(t_configs.CONFIG_BENCH, seed=1)
    assert {k: tuple(v.shape) for k, v in fresh.items()} == \
        {k: tuple(v.shape) for k, v in port_params.items()}
    assert dataclasses.asdict(t_configs.CONFIG_1X) == \
        dataclasses.asdict(j_configs.CONFIG_1X)
