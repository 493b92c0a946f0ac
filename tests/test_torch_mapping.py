"""The port's mapping layer against the JAX package: packed keys, coordinate
tables, voxelization, kernel maps and split plans must be *exactly* equal
on the same numpy inputs (one-word, two-word and raw key specs, negative
coordinates, several batches)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as jh
from repro.core import kmap as jkm
from repro.core.sparse_tensor import make_sparse_tensor as j_make
from repro.core.sparse_tensor import voxelize as j_voxelize
from repro_torch.core import hashing as th
from repro_torch.core import kmap as tkm
from repro_torch.core.sparse_tensor import make_sparse_tensor as t_make
from repro_torch.core.sparse_tensor import voxelize as t_voxelize

# (batch_bound, spatial_bound) → one-word packed, two-word packed, raw keys
SPECS = [(2, 16), (3, 4096), (0, 0)]


def _eq(a, b, what=""):
    np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy(), err_msg=what)


def _tensors(seed, bb, sb, n=300, cap=384, extent=12, channels=4):
    rng = np.random.default_rng(seed)
    c = np.concatenate([rng.integers(0, max(bb, 1), (n, 1)),
                        rng.integers(-extent, extent, (n, 3))], axis=1)
    c = np.unique(c, axis=0)
    rng.shuffle(c)                       # rows need not be lexicographic
    nv = c.shape[0]
    coords = np.concatenate([c, np.zeros((cap - nv, 4), np.int64)]).astype(np.int32)
    feats = rng.standard_normal((cap, channels)).astype(np.float32)
    js = j_make(jnp.asarray(coords), jnp.asarray(feats), nv,
                batch_bound=bb, spatial_bound=sb)
    ts = t_make(torch.from_numpy(coords), torch.from_numpy(feats), nv,
                batch_bound=bb, spatial_bound=sb)
    return js, ts


def test_key_specs_cover_every_word_layout():
    assert [th.key_spec_for(3, bb, sb).words for bb, sb in SPECS] == [1, 2, 4]
    for bb, sb in SPECS:
        assert th.key_spec_for(3, bb, sb) == th.KeySpec(
            **vars(jh.key_spec_for(3, bb, sb)))


@pytest.mark.parametrize("bb,sb", SPECS)
def test_pack_unpack_and_lookup_equal_jax(bb, sb):
    rng = np.random.default_rng(1)
    spec_j, spec_t = jh.key_spec_for(3, bb, sb), th.key_spec_for(3, bb, sb)
    lim = 2 * max(sb, 8)                 # includes out-of-range rows
    rows = np.concatenate([rng.integers(0, max(bb, 1) + 1, (500, 1)),
                           rng.integers(-lim, lim, (500, 3))], 1).astype(np.int32)
    valid = rng.random(500) < 0.9
    for query in (False, True):
        kj = jh.pack_keys(jnp.asarray(rows), spec_j, valid=jnp.asarray(valid),
                          query=query)
        kt = th.pack_keys(torch.from_numpy(rows), spec_t,
                          valid=torch.from_numpy(valid), query=query)
        _eq(kj, kt, f"pack query={query}")
    kt = th.pack_keys(torch.from_numpy(rows), spec_t)
    _eq(jh.unpack_keys(jh.pack_keys(jnp.asarray(rows), spec_j), spec_j),
        th.unpack_keys(kt, spec_t), "unpack")
    # table build + batched lookups (hits, misses, out-of-range queries)
    js, ts = _tensors(2, bb, sb)
    tj = jh.CoordTable.build(js.coords, js.valid_mask, spec_j)
    tt = th.CoordTable.build(ts.coords, ts.valid_mask, spec_t)
    _eq(tj.sorted_keys, tt.sorted_keys, "sorted keys")
    _eq(tj.order, tt.order, "order")
    q = np.concatenate([np.asarray(js.coords)[:100], rows[:200]])
    _eq(tj.lookup(jnp.asarray(q)), tt.lookup(torch.from_numpy(q)), "lookup")
    pos_j = jh.searchsorted_keys(tj.sorted_keys, tj.sorted_keys[::7],
                                 spec_j.words, side="right")
    pos_t = th.searchsorted_keys(tt.sorted_keys, tt.sorted_keys[::7],
                                 spec_t.words, side="right")
    _eq(pos_j, pos_t, "searchsorted")


def test_voxelize_equals_jax():
    rng = np.random.default_rng(3)
    pts = (rng.random((700, 3)) * 30 - 5).astype(np.float32)
    feats = rng.standard_normal((700, 4)).astype(np.float32)
    bidx = rng.integers(0, 2, 700).astype(np.int32)
    a = j_voxelize(jnp.asarray(pts), jnp.asarray(feats), 0.7, 512,
                   batch_idx=jnp.asarray(bidx), batch_size=2, spatial_bound=20)
    b = t_voxelize(torch.from_numpy(pts), torch.from_numpy(feats), 0.7, 512,
                   batch_idx=torch.from_numpy(bidx), batch_size=2,
                   spatial_bound=20)
    _eq(a.coords, b.coords)
    _eq(a.feats, b.feats)
    assert int(a.num_valid) == int(b.num_valid)
    assert (b.batch_bound, b.spatial_bound) == (2, 20)


_MAP_FIELDS = ("m_out", "ws_in", "ws_out", "ws_count", "bitmask",
               "out_coords", "n_out")


@pytest.mark.parametrize("bb,sb", SPECS)
@pytest.mark.parametrize("kernel,stride", [(3, 1), (2, 2), (3, 2)])
def test_build_kmap_and_split_plans_equal_jax(bb, sb, kernel, stride):
    js, ts = _tensors(4, bb, sb)
    a = jkm.build_kmap(js, kernel, stride)
    b = tkm.build_kmap(ts, kernel, stride)
    for f in _MAP_FIELDS:
        _eq(getattr(a, f), getattr(b, f), f)
    assert (a.out_stride, a.kernel_size) == (b.out_stride, b.kernel_size)
    for n_splits, srt in ((1, True), (2, True), (3, True), (1, False)):
        pa = jkm.make_split_plan(a, n_splits, sort=srt, tile_m=16)
        pb = tkm.make_split_plan(b, n_splits, sort=srt, tile_m=16)
        assert pa.ranges == pb.ranges
        for f in ("order", "inv_order", "occupancy"):
            _eq(getattr(pa, f), getattr(pb, f), f"{f} splits={n_splits}")
        _eq(jkm.tile_occupancy(a, pa, 8), tkm.tile_occupancy(b, pb, 8), "occ8")


@pytest.mark.parametrize("bb,sb", SPECS)
def test_transpose_kmap_and_cached_pyramid_equal_jax(bb, sb):
    """Strided map → adopted child table → submanifold map at stride 2 →
    transposed map back onto the fine level, through one MapCache."""
    js, ts = _tensors(5, bb, sb)
    cj = jkm.MapCache.for_tensor(js)
    ct = tkm.MapCache.for_tensor(ts)
    dj = jkm.build_kmap(js, 2, 2, cache=cj)
    dt = tkm.build_kmap(ts, 2, 2, cache=ct)
    cj_st = j_make(dj.out_coords, jnp.zeros((dj.capacity, 1)), dj.n_out,
                   stride=2, batch_bound=bb, spatial_bound=sb)
    ct_st = t_make(dt.out_coords, torch.zeros((dt.capacity, 1)), dt.n_out,
                   stride=2, batch_bound=bb, spatial_bound=sb)
    # the adopted child table serves the next level (keyed by coords id)
    sj = jkm.build_kmap(jkm.SparseTensor(dj.out_coords, cj_st.feats, dj.n_out,
                                         2, bb, sb), 3, 1, cache=cj)
    st_ = tkm.SparseTensor(dt.out_coords, ct_st.feats, dt.n_out, 2, bb, sb)
    s_t = tkm.build_kmap(st_, 3, 1, cache=ct)
    assert ct.hits == cj.hits and ct.misses == cj.misses
    for f in _MAP_FIELDS:
        _eq(getattr(sj, f), getattr(s_t, f), f"sub2 {f}")
    uj = jkm.transpose_kmap(dj, js)
    ut = tkm.transpose_kmap(dt, ts)
    for f in _MAP_FIELDS:
        _eq(getattr(uj, f), getattr(ut, f), f"up {f}")


def test_kernel_offsets_and_split_ranges_equal_jax():
    for k in (2, 3, 5):
        np.testing.assert_array_equal(jkm.kernel_offsets(k, 3),
                                      tkm.kernel_offsets(k, 3))
    for kd in (8, 27):
        for s in range(1, 5):
            assert jkm.split_ranges(kd, s) == tkm.split_ranges(kd, s)
    hit = np.random.default_rng(6).random((50, 64)) < 0.3   # composite path
    _eq(jkm._bitmask(jnp.asarray(hit)), tkm._bitmask(torch.from_numpy(hit)))
