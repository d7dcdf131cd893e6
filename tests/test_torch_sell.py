"""The port's sell-C-σ and BSR builders, the autotuner, and the bytes models
of the fused kernels against the JAX package: same edge lists in,
element-for-element equal arrays and equal dicts out."""
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.core import semiring as jsemiring
from repro.core.spmspv import frontier_from_dense as jfrontier
from repro.graphs import cost_model as jcost
from repro.graphs import datasets as jdatasets
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import formats as tformats
from repro_torch.core import semiring as tsemiring
from repro_torch.core.spmspv import frontier_from_dense as tfrontier
from repro_torch.graphs import cost_model as tcost
from repro_torch.kernels import ops as tops

SELL_FIELDS = ["tiles", "tile_cols", "row_meta"]


def family_coo(fam, name):
    """Transposed edge lists of the paper's three graph families, as the
    engines build them, with values of the semiring's type."""
    g = {"road": lambda: jdatasets.road_graph(256, 2.6, seed=0),
         "uniform": lambda: jdatasets.uniform_graph(192, 800, seed=0),
         "rmat": lambda: jdatasets.rmat_graph(256, 1200, skew=0.6, seed=0)}[fam]()
    rows, cols = g.cols.astype(np.int64), g.rows.astype(np.int64)
    rng = np.random.default_rng(3)
    dt = np.dtype(jsemiring.SEMIRINGS[name].dtype)
    vals = rng.integers(1, 9, rows.shape[0]).astype(dt)
    n_pad = -(-g.n // 32) * 32
    return rows, cols, vals, (n_pad, n_pad)


def assert_same(port, jax_container, fields):
    got = convert.to_numpy(port)
    for f in fields:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jax_container, f)), err_msg=f)
    assert tuple(got["shape"]) == tuple(jax_container.shape)
    assert tuple(got["block"]) == tuple(jax_container.block)


def both_sell(rows, cols, vals, shape, name, **kw):
    js = jformats.build_sell(rows, cols, vals, shape, jsemiring.SEMIRINGS[name], **kw)
    ts = tformats.build_sell(rows, cols, vals, shape, tsemiring.SEMIRINGS[name],
                             device="cpu", **kw)
    assert_same(ts, js, SELL_FIELDS)
    assert (ts.slice_height, ts.sigma) == (js.slice_height, js.sigma)
    assert (ts.real_slots, ts.slot_total, ts.n_block_rows) == (
        js.real_slots, js.slot_total, js.n_block_rows)
    np.testing.assert_array_equal(ts.to_dense(tsemiring.SEMIRINGS[name]).numpy(),
                                  np.asarray(js.to_dense(jsemiring.SEMIRINGS[name])))
    return ts, js


@pytest.mark.parametrize("name", ["plus_times", "min_plus", "bool_or_and"])
@pytest.mark.parametrize("fam", ["road", "uniform", "rmat"])
@pytest.mark.parametrize("c,sigma", [(4, None), (8, None), (4, 8), (8, 8)])
def test_sell_matches_jax_on_every_family(fam, name, c, sigma):
    rows, cols, vals, shape = family_coo(fam, name)
    both_sell(rows, cols, vals, shape, name, block=(8, 8), c=c, sigma=sigma)


def test_sell_empty_rows_and_ragged_tail():
    """mb = 10 with C = 4: two block rows hold tiles, eight are empty."""
    rows, cols = np.array([0, 3, 70, 70]), np.array([5, 64, 2, 79])
    vals = np.array([2.0, 3.0, 5.0, 7.0], np.float32)
    ts, _ = both_sell(rows, cols, vals, (80, 80), "plus_times", block=(8, 8), c=4)
    meta = ts.row_meta.numpy()
    n_real = dict(zip(meta[:, 0].tolist(), meta[:, 2].tolist()))
    assert n_real[0] == 2 and n_real[8] == 2
    assert all(n_real[b] == 0 for b in range(10) if b not in (0, 8))


def test_sell_single_hub_row():
    rows, cols = np.full(32, 20), np.arange(0, 64, 2)
    ts, _ = both_sell(rows, cols, np.ones(32, np.float32), (64, 64), "min_plus",
                      block=(8, 8), c=4, sigma=8)
    assert ts.row_meta[0].tolist() == [2, 0, 8]
    assert ts.slot_total == 8 + 3 * 8 + 1 * 4


def test_sell_sigma_smaller_than_c_raises():
    rows, cols, vals, shape = family_coo("uniform", "plus_times")
    for mod, sr in ((jformats, jsemiring.PLUS_TIMES), (tformats, tsemiring.PLUS_TIMES)):
        kw = {"device": "cpu"} if mod is tformats else {}
        with pytest.raises(ValueError, match="sigma"):
            mod.build_sell(rows, cols, vals, shape, sr, block=(8, 8), c=8, sigma=4, **kw)


@pytest.mark.parametrize("fam", ["road", "rmat"])
def test_autotune_sell_matches_jax(fam):
    rows, cols, vals, shape = family_coo(fam, "plus_times")
    kw = dict(blocks=((8, 8), (16, 16)), cs=(2, 4, 8), sigmas=(None, 4, 16))
    js, jreport = jformats.autotune_sell(rows, cols, vals, shape, jsemiring.PLUS_TIMES, **kw)
    ts, treport = tformats.autotune_sell(rows, cols, vals, shape, tsemiring.PLUS_TIMES,
                                         device="cpu", **kw)
    assert treport == jreport
    assert_same(ts, js, SELL_FIELDS)
    assert (ts.slice_height, ts.sigma) == (js.slice_height, js.sigma)


@pytest.mark.parametrize("c,sigma", [(1, 1), (4, None), (4, 8), (16, 32)])
def test_sell_stream_cost_matches_jax(c, sigma):
    counts = np.random.default_rng(c).zipf(1.6, 77) % 50
    assert (tformats.sell_stream_cost(counts, (16, 8), c, sigma)
            == jformats.sell_stream_cost(counts, (16, 8), c, sigma))


@pytest.mark.parametrize("name", ["plus_times", "min_plus", "bool_or_and"])
@pytest.mark.parametrize("t_max", [None, 900])
def test_bsr_matches_jax(name, t_max):
    rows, cols, vals, shape = family_coo("rmat", name)
    jsr, tsr = jsemiring.SEMIRINGS[name], tsemiring.SEMIRINGS[name]
    jb = jformats.build_bsr(rows, cols, vals, shape, jsr, block=(16, 8), t_max=t_max)
    tb = tformats.build_bsr(rows, cols, vals, shape, tsr, block=(16, 8), t_max=t_max,
                            device="cpu")
    assert_same(tb, jb, ["tiles", "tile_cols", "tile_row_ptr"])
    assert (tb.n_block_rows, tb.t_max) == (jb.n_block_rows, jb.t_max)


def test_bsr_t_max_too_small_raises():
    rows, cols, vals, shape = family_coo("road", "plus_times")
    with pytest.raises(ValueError, match="t_max"):
        tformats.build_bsr(rows, cols, vals, shape, tsemiring.PLUS_TIMES, block=(8, 8),
                           t_max=3, device="cpu")


@pytest.mark.parametrize("name", ["min_plus", "bool_or_and"])
def test_coo_from_dense_and_convert_carry_across(name):
    jsr, tsr = jsemiring.SEMIRINGS[name], tsemiring.SEMIRINGS[name]
    rng = np.random.default_rng(5)
    dense = np.where(rng.random((40, 24)) < 0.1, rng.integers(1, 5, (40, 24)),
                     0).astype(np.dtype(jsr.dtype))
    if jsr.collective == "pmin":
        dense[dense == 0] = np.inf
    got, want = tformats.coo_from_dense(dense, tsr), jformats.coo_from_dense(dense, jsr)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    js = jformats.build_sell(*want, (40, 24), jsr, block=(8, 8), c=2)
    ts = convert.sliced_ell_from_numpy(np.asarray(js.tiles), np.asarray(js.tile_cols),
                                       np.asarray(js.row_meta), js.shape, js.block,
                                       js.slice_height, js.sigma, device="cpu")
    assert_same(ts, js, SELL_FIELDS)
    assert (ts.slice_height, ts.sigma) == (js.slice_height, js.sigma)
    jb = jformats.build_bsr(*want, (40, 24), jsr, block=(8, 8))
    tb = convert.bsr_from_numpy(np.asarray(jb.tiles), np.asarray(jb.tile_cols),
                                np.asarray(jb.tile_row_ptr), jb.shape, jb.block, device="cpu")
    assert_same(tb, jb, ["tiles", "tile_cols", "tile_row_ptr"])


@pytest.mark.parametrize("fam", ["road", "uniform", "rmat"])
@pytest.mark.parametrize("density", [0.0, 0.05, 0.5])
def test_stream_stats_match_jax(fam, density):
    name = "plus_times"
    jsr, tsr = jsemiring.SEMIRINGS[name], tsemiring.SEMIRINGS[name]
    rows, cols, vals, shape = family_coo(fam, name)
    ja = jformats.build_bsr_padded(rows, cols, vals, shape, jsr, block=(16, 16))
    ta = tformats.build_bsr_padded(rows, cols, vals, shape, tsr, block=(16, 16), device="cpu")
    js = jformats.build_sell(rows, cols, vals, shape, jsr, block=(16, 16), c=4)
    ts = tformats.build_sell(rows, cols, vals, shape, tsr, block=(16, 16), c=4, device="cpu")
    assert tops.spmv_stream_stats(ta) == jops.spmv_stream_stats(ja)
    assert tops.sell_stream_stats(ts, ta) == jops.sell_stream_stats(js, ja)
    x = np.where(np.random.default_rng(1).random(shape[1]) < density, 1.0, 0.0).astype(np.float32)
    assert (tops.spmspv_stream_stats(ta, tfrontier(torch.from_numpy(x), tsr), tsr)
            == jops.spmspv_stream_stats(ja, jfrontier(x, jsr), jsr))
    mb, t = ta.tile_cols.shape
    args = (mb, t, ts.real_slots, (16, 16), shape[1])
    assert tcost.kernel_stream_cost(*args) == jcost.kernel_stream_cost(*args)
    assert (tcost.kernel_stream_cost(*args)["fused_bytes"]
            == tops.sell_stream_stats(ts, ta)["fused_bytes"])
