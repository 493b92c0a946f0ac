"""The port's kernel modules against the JAX Pallas kernels (interpret mode).

On the CPU each kernel wrapper runs its plain version, so these tests hold
the host glue (gcd tile clamp, split permutation, CSR worklist, zeroing of
unvisited tiles, -1 padding, split-sum through ``inv_order``) and the plain
versions' arithmetic against ``repro.kernels.*.ops`` with ``interpret=True``,
at the tolerances of ``tests/test_kernels.py`` (fp32 rtol 1e-4 / atol 1e-5,
bf16 2e-2 / 2e-2).  The CUDA kernels themselves are held against the same
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kmap as jkm
from repro.core.sparse_tensor import make_sparse_tensor as j_make
from repro.kernels.fetch_on_demand.ops import fetch_on_demand as j_fod
from repro.kernels.implicit_gemm.ops import implicit_gemm as j_igemm
from repro_torch.core import dataflows as tdf
from repro_torch.core import kmap as tkm
from repro_torch.core.plan import head_projection
from repro_torch.core.sparse_tensor import make_sparse_tensor as t_make
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.fetch_on_demand import ops as fod_ops
from repro_torch.kernels.implicit_gemm import ops as ig_ops
from repro_torch.kernels.implicit_gemm.ref import implicit_gemm_ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=1e-4, atol=1e-5)


def _case(seed, kernel, stride, cin=8, cout=16, n=90, cap=128, extent=7):
    """Same numpy map inputs, features and weights for both packages."""
    rng = np.random.default_rng(seed)
    c = np.unique(np.concatenate([np.zeros((n, 1), np.int64),
                                  rng.integers(0, extent, (n, 3))], 1), axis=0)
    nv = c.shape[0]
    coords = np.concatenate([c, np.zeros((cap - nv, 4), np.int64)]).astype(np.int32)
    feats = rng.standard_normal((cap, cin)).astype(np.float32)
    kd = kernel ** 3
    w = (rng.standard_normal((kd, cin, cout)) * 0.3).astype(np.float32)
    jm = jkm.build_kmap(j_make(jnp.asarray(coords), jnp.asarray(feats), nv,
                               batch_bound=1, spatial_bound=32), kernel, stride)
    tm = tkm.build_kmap(t_make(torch.from_numpy(coords), torch.from_numpy(feats),
                               nv, batch_bound=1, spatial_bound=32), kernel, stride)
    return jm, tm, feats, w


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("tile_m", [8, 16])
@pytest.mark.parametrize("splits,srt", [(1, True), (2, True), (3, True), (1, False)])
@pytest.mark.parametrize("kernel,stride", [(3, 1), (2, 2)])
def test_implicit_gemm_dense_and_worklist_match_jax(dtype, tile_m, splits, srt,
                                                     kernel, stride):
    jd, td = DTYPES[dtype]
    jm, tm, feats, w = _case(11, kernel, stride)
    jplan = jkm.make_split_plan(jm, splits, sort=srt)
    tplan = tkm.make_split_plan(tm, splits, sort=srt)
    ref = j_igemm(jnp.asarray(feats).astype(jd), jnp.asarray(w).astype(jd), jm,
                  jplan, tile_m=tile_m, tile_n=8, interpret=True)
    x, wt = torch.from_numpy(feats).to(td), torch.from_numpy(w).to(td)
    reset_launches()
    dense = ig_ops.implicit_gemm(x, wt, tm, tplan, tile_m=tile_m)
    wplan = ig_ops.with_worklists(
        tkm.make_split_plan(tm, splits, sort=srt, tile_m=tile_m))
    wl = ig_ops.implicit_gemm(x, wt, tm, wplan, tile_m=tile_m, worklist=True)
    assert wl.dtype == td and torch.equal(dense, wl)
    with pytest.raises(ValueError):    # worklist mode needs plan-built worklists
        ig_ops.implicit_gemm(x, wt, tm, tplan, tile_m=tile_m, worklist=True)
    assert dense.dtype == td
    np.testing.assert_allclose(_np(dense), _np(ref), **tol(dtype))
    # the CPU path runs the plain versions and launches nothing
    assert LAUNCHES == {k: 0 for k in LAUNCHES}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("tile_r", [8, 32])
@pytest.mark.parametrize("kernel,stride", [(3, 1), (2, 2)])
def test_fetch_on_demand_matches_jax(dtype, tile_r, kernel, stride):
    """Includes the per-offset rounding of the output to its dtype, which
    the port's plain version mirrors from the kernel (cap 96 is not a
    multiple of 32: the -1 padding path runs)."""
    jd, td = DTYPES[dtype]
    jm, tm, feats, w = _case(14, kernel, stride, n=70, cap=96)
    ref = j_fod(jnp.asarray(feats).astype(jd), jnp.asarray(w).astype(jd), jm,
                tile_r=tile_r, interpret=True)
    got = fod_ops.fetch_on_demand(torch.from_numpy(feats).to(td),
                                  torch.from_numpy(w).to(td), tm, tile_r=tile_r)
    assert got.dtype == td and got.shape == tuple(ref.shape)
    np.testing.assert_allclose(_np(got), _np(ref), **tol(dtype))


def test_worklist_zeroes_unvisited_tiles():
    """The worklist kernel never writes tiles without entries (its plain
    version leaves NaN there); the glue must zero them."""
    _, tm, feats, w = _case(3, 3, 1, n=20, cap=256, extent=4)
    plan = ig_ops.with_worklists(tkm.make_split_plan(tm, 3, tile_m=16))
    wl = ig_ops._build_worklist(
        (tm.m_out[plan.order[2].long()][:, 18:27] >= 0)
        .view(256 // 16, 16, 9).any(dim=1))
    assert wl is not None and not bool(wl[3].all())   # some tiles unvisited
    x, wt = torch.from_numpy(feats), torch.from_numpy(w)
    got = ig_ops.implicit_gemm(x, wt, tm, plan, tile_m=16, worklist=True)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(),
                               implicit_gemm_ref(x, wt, tm.m_out).numpy(),
                               rtol=1e-4, atol=1e-5)


def test_build_worklist_is_csr_by_tile():
    occ = torch.tensor([[0, 1, 1], [0, 0, 0], [1, 0, 1], [0, 0, 1]])
    wl_ptr, wl_tile, wl_delta, visited = ig_ops._build_worklist(occ)
    assert wl_ptr.tolist() == [0, 2, 4, 5]
    assert wl_tile.tolist() == [0, 2, 3]
    assert wl_delta.tolist() == [1, 2, 0, 2, 2]
    assert visited.tolist() == [True, False, True, True]
    assert all(t.dtype == torch.int32 for t in (wl_ptr, wl_tile, wl_delta))
    assert ig_ops._build_worklist(torch.zeros((4, 3), dtype=torch.int32)) is None


def test_plan_worklists_are_built_once(monkeypatch):
    """A worklist plan from ``plan_for`` (what the engine caches with its
    maps) carries every split's CSR worklist, so a forward over it compacts
    nothing — on the card it launches without syncing the host."""
    _, tm, feats, w = _case(5, 3, 1, n=60, cap=256)
    cfg = tdf.DataflowConfig(backend="cuda", n_splits=3, tile_m=16, worklist=True)
    plan = tdf.plan_for(tm, cfg)
    assert plan.tile_m == 16 and len(plan.worklists) == 3
    x, wt = torch.from_numpy(feats), torch.from_numpy(w)
    dense = ig_ops.implicit_gemm(x, wt, tm, plan, tile_m=16)
    monkeypatch.setattr(ig_ops, "_build_worklist",
                        lambda occ: pytest.fail("worklist rebuilt in the forward"))
    assert torch.equal(ig_ops.implicit_gemm(x, wt, tm, plan, tile_m=16,
                                            worklist=True), dense)


def test_head_projection_is_row_local():
    """The head runs the implicit-GEMM kernel's wrapper over the identity
    map: ``feats @ w`` on valid rows, zero on padding, and a row's bits do
    not depend on the capacity it is packed into."""
    rng = np.random.default_rng(7)
    feats = torch.from_numpy(rng.standard_normal((256, 24)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((24, 5)).astype(np.float32))
    coords = torch.zeros((256, 4), dtype=torch.int32)
    big = head_projection(t_make(coords, feats, 200, batch_bound=1,
                                 spatial_bound=32), w)
    np.testing.assert_allclose(big[:200].numpy(), (feats[:200] @ w).numpy(),
                               rtol=1e-4, atol=1e-5)
    assert not big[200:].any()
    small = head_projection(t_make(coords[:128], feats[:128], 90, batch_bound=1,
                                   spatial_bound=32), w)
    assert torch.equal(small[:90], big[:90])


def test_kernel_wrappers_validate_operands():
    _, tm, feats, w = _case(1, 3, 1)
    x = torch.from_numpy(feats)
    midx = tm.m_out.contiguous()
    occ = torch.ones((128 // 16, 27), dtype=torch.int32)
    with pytest.raises(TypeError):       # float64 is not a kernel dtype
        ig_ops.implicit_gemm_split(midx, occ, x.double(),
                                   torch.from_numpy(w).double(), tile_m=16)
    with pytest.raises(TypeError):       # mixed operand dtypes
        ig_ops.implicit_gemm_split(midx, occ, x, torch.from_numpy(w).bfloat16(),
                                   tile_m=16)
    with pytest.raises(ValueError):      # occupancy shape does not fit tile_m
        ig_ops.implicit_gemm_split(midx, occ, x, torch.from_numpy(w), tile_m=8)
    with pytest.raises(TypeError):       # int64 indices
        fod_ops.fetch_on_demand_fused(tm.ws_in.long(), tm.ws_out.long(), x,
                                      torch.from_numpy(w),
                                      torch.zeros((128, 16)), tile_r=16)
