"""BFS/SSSP/PPR/PageRank through the port's ``build_engine`` against the JAX
package, element route (CSR SpMV, CSC SpMSpV), all three policies, on the
``tests/test_graphs.py`` fixture graph. The tile route is in
``test_torch_graphs_tiles.py``.

levels, dist, iterations, densities and kernel_used must be equal; rank
within rtol 1e-4, atol 1e-7, because the f32 sums are taken in another
order over up to ~50 iterations."""
import importlib

import numpy as np
import pytest

from repro.core import semiring as jsemiring
from repro.graphs import cost_model as jcost
from repro.graphs import datasets as jdatasets
from repro.graphs import engine as jengine
from repro_torch.core import semiring as tsemiring
from repro_torch.graphs import cost_model as tcost
from repro_torch.graphs import datasets as tdatasets
from repro_torch.graphs import engine as tengine

# the packages' __init__ re-export functions named like these modules
jbfs, jsssp, jppr = (importlib.import_module(f"repro.graphs.{m}") for m in ("bfs", "sssp", "ppr"))
tbfs, tsssp, tppr = (importlib.import_module(f"repro_torch.graphs.{m}")
                     for m in ("bfs", "sssp", "ppr"))

POLICIES = ["spmv", "spmspv", "adaptive"]

# app -> (semiring, build_engine kwargs, result field, runner(module, engine, src, policy))
APPS = {
    "bfs": ("bool_or_and", {}, "levels",
            lambda m, e, s, p: (m[0].bfs(e, s, policy=p))),
    "sssp": ("min_plus", {"weighted": True, "seed": 5}, "dist",
             lambda m, e, s, p: m[1].sssp(e, s, policy=p)),
    "ppr": ("plus_times", {"normalize": True}, "rank",
            lambda m, e, s, p: m[2].ppr(e, s, policy=p)),
    # tol 1.5e-6: at the default 1e-6 the 13th residual on the face fixture
    # lies within 1% of tol, where XLA's fused loop body and an unfused
    # evaluation of the same JAX code already stop one iteration apart
    "pagerank": ("plus_times", {"normalize": True}, "rank",
                 lambda m, e, s, p: m[2].pagerank(e, policy=p, tol=1.5e-6)),
}
JAX_APPS = (jbfs, jsssp, jppr)
TORCH_APPS = (tbfs, tsssp, tppr)


def graph_pair(abbrev, scale, seed):
    jg = jdatasets.generate(abbrev, scale=scale, seed=seed)
    tg = tdatasets.generate(abbrev, scale=scale, seed=seed)
    return jg, tg, int(np.argmax(jg.out_degrees()))


def run_both(app, fmt, policy, jg, tg, src):
    """Run ``app`` in both packages on the same graph; hold the port to the
    JAX result and return both."""
    name, kw, field, runner = APPS[app]
    jeng = jengine.build_engine(jg, jsemiring.SEMIRINGS[name], jcost.trained_stump(),
                                fmt_spmv=fmt, fmt_spmspv="csc" if fmt == "csr" else fmt, **kw)
    teng = tengine.build_engine(tg, tsemiring.SEMIRINGS[name], tcost.trained_stump(),
                                fmt_spmv=fmt, fmt_spmspv="csc" if fmt == "csr" else fmt,
                                device="cpu", **kw)
    assert (teng.n, teng.n_true, teng.threshold, teng.graph_class) == (
        jeng.n, jeng.n_true, jeng.threshold, jeng.graph_class)
    jr = runner(JAX_APPS, jeng, src, policy)
    tr = runner(TORCH_APPS, teng, src, policy)
    assert tr.iterations == int(jr.iterations)
    np.testing.assert_array_equal(tr.densities.numpy(), np.asarray(jr.densities))
    np.testing.assert_array_equal(tr.kernel_used.numpy(), np.asarray(jr.kernel_used))
    got, want = getattr(tr, field).numpy(), np.asarray(getattr(jr, field))
    assert got.dtype == want.dtype
    if field == "rank":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    else:
        np.testing.assert_array_equal(got, want)
    return jr, tr


@pytest.fixture(scope="module")
def face():
    return graph_pair("face", 0.15, 1)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("app", list(APPS))
def test_element_route_matches_jax(face, app, policy):
    run_both(app, "csr", policy, *face)


def test_element_route_matches_oracles(face):
    jg, tg, src = face
    eng = tengine.build_engine(tg, tsemiring.BOOL_OR_AND, tcost.trained_stump(), device="cpu")
    np.testing.assert_array_equal(tbfs.bfs(eng, src).levels.numpy(),
                                  tbfs.bfs_reference(tg.rows, tg.cols, tg.n, src))
    eng = tengine.build_engine(tg, tsemiring.PLUS_TIMES, tcost.trained_stump(),
                               normalize=True, device="cpu")
    np.testing.assert_allclose(tppr.pagerank(eng).rank.numpy(),
                               tppr.pagerank_reference(tg.rows, tg.cols, tg.n),
                               rtol=1e-3, atol=1e-6)
    dense = tppr.ppr_reference(tg.rows, tg.cols, tg.n, src)
    np.testing.assert_allclose(tppr.ppr(eng, src).rank.numpy(), dense, rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(tppr.ppr_reference(tg.rows, tg.cols, tg.n, src, sparse=True),
                               dense, rtol=1e-12, atol=1e-15)


def test_calibrate_threshold_returns_a_probe(face):
    _, tg, _ = face
    eng = tengine.build_engine(tg, tsemiring.BOOL_OR_AND, device="cpu")
    probes = (0.01, 0.2)
    assert tengine.calibrate_threshold(eng, probes, iters=1) in (0.0, *probes)


def test_density_and_switch_compare_in_f32():
    """density_of is the live count times the f32 reciprocal of n, as XLA
    compiles the JAX loops (229/629 and 229·(1/629) differ in f32; the ca-Q
    case of test_torch_graphs_tiles.py meets it). The switch compares in
    f32: 1/5 rounds to the f32 nearest 0.2, not above the f32 threshold
    0.2, though in double it is above 0.2."""
    import jax.numpy as jnp
    import torch

    from repro_torch.core.adaptive import select_kernel

    x = torch.zeros(629, dtype=torch.int32)
    x[:229] = 1
    got = tengine.density_of(x, tsemiring.BOOL_OR_AND, 629).item()
    assert got == np.float32(229) * (np.float32(1) / np.float32(629))
    assert got != np.float32(229) / np.float32(629)

    x = np.array([1, 0, 0, 0, 0], np.int32)
    td = tengine.density_of(torch.from_numpy(x), tsemiring.BOOL_OR_AND, 5)
    jd = jengine.density_of(jnp.asarray(x), jsemiring.BOOL_OR_AND, 5)
    assert td.item() == float(jd)
    assert td.item() > 0.2
    assert int(select_kernel(td, 0.2)) == int(jd > 0.2) == 0
