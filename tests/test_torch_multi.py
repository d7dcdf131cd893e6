"""The port's multi-source traversals (``repro_torch.graphs.multi``) against
the JAX package's, on the element route (CSR SpMV, CSC union SpMSpV), B = 8,
on the scale-free and the regular stand-ins of ``tests/test_multi_query.py``.

Every row must equal the JAX row and the port's own single-source run:
levels and distances exactly, with iteration counts, densities and kernel
traces; PPR ranks within rtol 1e-3 (another f32 summation order), its
iteration counts and traces exactly. Also: frozen converged rows,
``relax_multi``'s cold seed ≡ ``sssp_multi``, the adaptive mixed branch's
blanking, ``density_of_batch``'s arithmetic at the threshold,
``spmspv_batch_union`` against JAX and ``traverse_multi_buckets``. The tile
route is in ``test_torch_multi_tiles.py``."""
import importlib

import numpy as np
import pytest
import torch

from repro.core import semiring as jsemiring
from repro.graphs import cost_model as jcost
from repro.graphs import datasets as jdatasets
from repro.graphs import engine as jengine
from repro_torch.core import semiring as tsemiring
from repro_torch.graphs import cost_model as tcost
from repro_torch.graphs import datasets as tdatasets
from repro_torch.graphs import engine as tengine

jmulti = importlib.import_module("repro.graphs.multi")
tmulti = importlib.import_module("repro_torch.graphs.multi")
tbfs, tsssp, tppr = (importlib.import_module(f"repro_torch.graphs.{m}")
                     for m in ("bfs", "sssp", "ppr"))

B = 8
POLICIES = ["adaptive", "spmv", "spmspv"]
GRAPHS = {"scale_free": ("face", 0.15), "regular": ("p2p-24", 0.12)}

# app -> (semiring, build kwargs, result field, port single-source runner)
APPS = {
    "bfs": ("bool_or_and", {}, "levels", lambda e, s, p: tbfs.bfs(e, s, policy=p)),
    "sssp": ("min_plus", {"weighted": True, "seed": 5}, "dist",
             lambda e, s, p: tsssp.sssp(e, s, policy=p)),
    "ppr": ("plus_times", {"normalize": True}, "rank", lambda e, s, p: tppr.ppr(e, s, policy=p)),
}


def graph_pair(abbrev, scale, seed=1):
    jg = jdatasets.generate(abbrev, scale=scale, seed=seed)
    tg = tdatasets.generate(abbrev, scale=scale, seed=seed)
    sources = [int(s) for s in np.random.default_rng(42).integers(0, tg.n, B)]
    return jg, tg, sources


def engines(app, fmt, jg, tg):
    name, kw, _, _ = APPS[app]
    msv = "csc" if fmt == "csr" else fmt
    jeng = jengine.build_engine(jg, jsemiring.SEMIRINGS[name], jcost.trained_stump(),
                                fmt_spmv=fmt, fmt_spmspv=msv, **kw)
    teng = tengine.build_engine(tg, tsemiring.SEMIRINGS[name], tcost.trained_stump(),
                                fmt_spmv=fmt, fmt_spmspv=msv, device="cpu", **kw)
    assert (teng.n, teng.n_true, teng.threshold) == (jeng.n, jeng.n_true, jeng.threshold)
    return jeng, teng


def check_rows(app, policy, res, teng, sources):
    """Every row of the port's batched result against the port's
    single-source run on the same engine."""
    field, single = APPS[app][2], APPS[app][3]
    for i, s in enumerate(sources):
        ref = single(teng, s, policy)
        assert int(res.iterations[i]) == ref.iterations
        assert torch.equal(res.kernel_used[i], ref.kernel_used)
        assert torch.equal(res.densities[i], ref.densities)
        got, want = getattr(res, field)[i], getattr(ref, field)
        if app == "ppr":
            torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-6)
            torch.testing.assert_close(res.residual[i], ref.residual, rtol=1e-3, atol=1e-9)
        else:
            assert torch.equal(got, want)


def run_both(app, fmt, policy, jg, tg, sources):
    """The app's batched run in both packages; the port held to JAX and to
    its own single-source runs."""
    jeng, teng = engines(app, fmt, jg, tg)
    jr = getattr(jmulti, f"{app}_multi")(jeng, sources, policy=policy)
    tr = getattr(tmulti, f"{app}_multi")(teng, sources, policy=policy)
    np.testing.assert_array_equal(tr.iterations.numpy(), np.asarray(jr.iterations))
    np.testing.assert_array_equal(tr.kernel_used.numpy(), np.asarray(jr.kernel_used))
    np.testing.assert_array_equal(tr.densities.numpy(), np.asarray(jr.densities))
    field = APPS[app][2]
    got, want = getattr(tr, field).numpy(), np.asarray(getattr(jr, field))
    assert got.dtype == want.dtype
    if app == "ppr":
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
    check_rows(app, policy, tr, teng, sources)
    return jr, tr


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def graphs(request):
    return graph_pair(*GRAPHS[request.param])


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("app", list(APPS))
def test_element_route_matches_jax_and_single(graphs, app, policy):
    run_both(app, "csr", policy, *graphs)


def test_multi_freezes_converged_queries():
    """A batch mixing a hub and a near-isolated source: the early finisher's
    iteration count stops and its trace stops recording."""
    _, tg, _ = graph_pair("face", 0.15)
    eng = tengine.build_engine(tg, tsemiring.BOOL_OR_AND, tcost.trained_stump(), device="cpu")
    deg = np.bincount(tg.rows, minlength=tg.n)
    hub = int(np.argmax(deg))
    lone = int(np.argmin(deg + (deg == 0) * tg.n))
    res = tmulti.bfs_multi(eng, [hub, lone, hub, lone])
    iters = res.iterations.tolist()
    assert iters[0] == iters[2] == tbfs.bfs(eng, hub).iterations
    assert iters[1] == iters[3] == tbfs.bfs(eng, lone).iterations
    assert iters[0] != iters[1]
    early = int(np.argmin(iters[:2]))
    assert (res.kernel_used[early, iters[early]:] == -1).all()
    assert (res.densities[early, iters[early]:] == -1).all()
    assert (res.kernel_used[1 - early, : iters[1 - early]] >= 0).all()
    check_rows("bfs", "adaptive", res, eng, [hub, lone, hub, lone])


def test_relax_multi_cold_seed_equals_sssp_multi():
    _, tg, sources = graph_pair("p2p-24", 0.12)
    eng = tengine.build_engine(tg, tsemiring.MIN_PLUS, weighted=True, seed=5,
                               content_keyed=True, device="cpu")
    d0 = np.full((B, tg.n), np.inf, np.float32)
    d0[np.arange(B), sources] = 0.0
    got = tmulti.relax_multi(eng, d0, d0.copy(), max_iters=256)
    want = tmulti.sssp_multi(eng, sources, max_iters=256)
    for field in ("dist", "iterations", "densities", "kernel_used"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field


def test_adaptive_mixed_branch_blanks_dense_rows():
    """The mixed branch hands the sparse kernel a block whose above-threshold
    rows are the ⊕-identity, and selects SpMV's rows for them."""
    from repro_torch.core.adaptive import adaptive_matvec_batch

    seen = []

    def sparse(xs):
        seen.append(xs.clone())
        return xs * 10

    xs = torch.arange(1, 13, dtype=torch.float32).reshape(3, 4)
    dens = torch.tensor([0.1, 0.9, 0.2])
    out = adaptive_matvec_batch(sparse, lambda xs: xs * 100, xs, dens, 0.5, zero=0.0)
    assert torch.equal(seen[0][1], torch.zeros(4)) and torch.equal(seen[0][0], xs[0])
    assert torch.equal(out, torch.stack([xs[0] * 10, xs[1] * 100, xs[2] * 10]))
    seen.clear()
    assert torch.equal(adaptive_matvec_batch(sparse, None, xs, dens * 0, 0.5), xs * 10)
    assert torch.equal(adaptive_matvec_batch(None, lambda xs: -xs, xs, dens + 1, 0.5), -xs)


def test_mixed_block_keys_the_ladder_on_sparse_rows():
    """With one dense row in the block, the tile route's capacity rung is
    chosen from the blanked block: the sparse rows' largest live count."""
    _, tg, _ = graph_pair("face", 0.15)
    eng = tengine.build_engine(tg, tsemiring.BOOL_OR_AND, tcost.trained_stump(),
                               fmt_spmv="bsr", fmt_spmspv="bsr", device="cpu")
    from repro_torch.kernels import ops

    caps = []
    real = ops.semiring_spmspv_batch

    def spy(a, xs, sr, f_max=None):
        caps.append(f_max)
        return real(a, xs, sr, f_max)

    xs = torch.zeros((3, eng.n), dtype=torch.int32)
    xs[0, :3] = 1
    xs[1, : tg.n] = 1                  # dense: above the 50% threshold
    xs[2, 10:12] = 1
    dens = tengine.density_of_batch(xs, eng.sr, eng.n_true)
    ops.semiring_spmspv_batch = spy
    try:
        ys = eng.adaptive_batch_fn(xs, dens)
    finally:
        ops.semiring_spmspv_batch = real
    assert caps == [max(64, tg.n // 16)]
    for i in range(3):
        want = eng.spmv_fn(xs[i]) if i == 1 else eng.spmspv_fn(xs[i])
        assert torch.equal(ys[i], want)


def test_density_of_batch_at_the_threshold():
    """Each row's density is the live count times the f32 reciprocal of
    n_true, as density_of computes it, and as the JAX loop compiles it:
    229/629 and 229·(1/629) differ in f32. The kernel codes compare in
    f32: a row at exactly 1/5 is not above the f32 threshold 0.2."""
    from repro_torch.core.adaptive import select_kernel_batch

    xs = torch.zeros((3, 640), dtype=torch.int32)
    xs[0, :229] = 1
    xs[1, :126] = 1
    xs[2, :127] = 1
    got = tengine.density_of_batch(xs, tsemiring.BOOL_OR_AND, 629)
    for i in range(3):
        assert got[i].item() == tengine.density_of(xs[i], tsemiring.BOOL_OR_AND, 629).item()
    assert got[0].item() == np.float32(229) * (np.float32(1) / np.float32(629))
    assert got[0].item() != np.float32(229) / np.float32(629)
    five = torch.zeros((2, 5), dtype=torch.int32)
    five[0, 0] = 1
    five[1, :2] = 1
    d = tengine.density_of_batch(five, tsemiring.BOOL_OR_AND, 5)
    assert select_kernel_batch(d, 0.2).tolist() == [0, 1]


@pytest.mark.parametrize("f_max", [None, 40])
@pytest.mark.parametrize("name", ["bool_or_and", "min_plus", "plus_times"])
def test_spmspv_batch_union_matches_jax(name, f_max):
    import jax.numpy as jnp

    from repro.core import formats as jformats
    from repro_torch.core import formats as tformats

    jspmspv = importlib.import_module("repro.core.spmspv")
    tspmspv = importlib.import_module("repro_torch.core.spmspv")

    rng = np.random.default_rng(3)
    n, nnz = 200, 1500
    rows = rng.integers(0, n, nnz).astype(np.int32)
    cols = rng.integers(0, n, nnz).astype(np.int32)
    jsr, tsr = jsemiring.SEMIRINGS[name], tsemiring.SEMIRINGS[name]
    if tsr.dtype == torch.int32:
        vals = np.ones(nnz, np.int32)
        xs = (rng.random((5, n)) < 0.05).astype(np.int32)
    else:
        vals = rng.integers(1, 9, nnz).astype(np.float32)
        xs = np.where(rng.random((5, n)) < 0.05, rng.uniform(0.5, 3.0, (5, n)),
                      jsr.zero).astype(np.float32)
    ja = jformats.build_csc(rows, cols, vals, (n, n), jsr)
    ta = tformats.build_csc(rows, cols, vals, (n, n), tsr, device="cpu")
    want = np.asarray(jspmspv.spmspv_batch_union(ja, jnp.asarray(xs), jsr, f_max=f_max))
    got = tspmspv.spmspv_batch_union(ta, torch.from_numpy(xs), tsr, f_max=f_max).numpy()
    if name == "plus_times":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
    if f_max is None:       # the union covers every row: each row is its spmspv
        for i in range(5):
            single = tspmspv.spmspv(ta, tspmspv.frontier_from_dense(torch.from_numpy(xs[i]),
                                                                    tsr), tsr)
            torch.testing.assert_close(torch.from_numpy(got[i]), single, rtol=1e-5, atol=1e-6)


def test_batched_closures_match_unbatched():
    """spmv_batch_fn/spmspv_batch_fn rows equal the single-vector closures
    (the union path's ⟨+,×⟩ sums in another order)."""
    _, tg, _ = graph_pair("face", 0.15)
    eng = tengine.build_engine(tg, tsemiring.PLUS_TIMES, tcost.trained_stump(), normalize=True,
                               device="cpu")
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(np.where(rng.random((4, eng.n)) < 0.1, rng.random((4, eng.n)),
                                   0.0).astype(np.float32))
    ys_mv, ys_msv = eng.spmv_batch_fn(xs), eng.spmspv_batch_fn(xs)
    for i in range(4):
        torch.testing.assert_close(ys_mv[i], eng.spmv_fn(xs[i]), rtol=1e-6, atol=0)
        torch.testing.assert_close(ys_msv[i], eng.spmspv_fn(xs[i]), rtol=1e-6, atol=0)


@pytest.mark.parametrize("alg", list(APPS))
def test_bucket_pipeline_depths_and_pad_to(alg):
    """traverse_multi_buckets at depth 0 and 2 gives identical results;
    ``pad_to`` repeats a bucket's last source and keeps its rows; every row
    equals the single-source run."""
    _, tg, sources = graph_pair("face", 0.15)
    name, kw, field, _ = APPS[alg]
    eng = tengine.build_engine(tg, tsemiring.SEMIRINGS[name], tcost.trained_stump(),
                               device="cpu", **kw)
    buckets = [sources[:4], sources[4:7], sources[7:]]
    seq = tmulti.traverse_multi_buckets(eng, alg, buckets, pipeline_depth=0)
    for depth in (2,):
        for a, b in zip(seq, tmulti.traverse_multi_buckets(eng, alg, buckets,
                                                           pipeline_depth=depth)):
            for x, y in zip(a, b):
                assert torch.equal(x, y)
    padded = tmulti.traverse_multi_buckets(eng, alg, buckets, pipeline_depth=2, pad_to=4)
    assert [getattr(r, field).shape[0] for r in seq] == [4, 3, 1]
    assert [getattr(r, field).shape[0] for r in padded] == [4, 4, 4]
    for bucket, r, p in zip(buckets, seq, padded):
        k = len(bucket)
        assert torch.equal(getattr(p, field)[:k], getattr(r, field))
        assert torch.equal(getattr(p, field)[k:], getattr(r, field)[-1:].expand(4 - k, -1))
        check_rows(alg, "adaptive", r, eng, bucket)
    assert len(eng.__dict__["_multi_runners"]) == 3     # sizes 4, 3, 1; pad_to=4 reuses 4


def test_bucket_materialize_sees_submitted_buckets():
    _, tg, sources = graph_pair("face", 0.15)
    eng = tengine.build_engine(tg, tsemiring.BOOL_OR_AND, device="cpu")
    buckets = [sources[:2], sources[2:3]]
    out = tmulti.traverse_multi_buckets(
        eng, "bfs", buckets, pipeline_depth=1, pad_to=2,
        materialize=lambda b, res: (list(b), res.levels.shape[0]))
    assert out == [(buckets[0], 2), (buckets[1], 2)]


def test_runner_checks():
    _, tg, _ = graph_pair("face", 0.15)
    eng = tengine.build_engine(tg, tsemiring.BOOL_OR_AND, device="cpu")
    with pytest.raises(ValueError, match="min_plus"):
        tmulti.sssp_multi(eng, [0])
    with pytest.raises(ValueError, match="flat"):
        tmulti.bfs_multi(eng, [[0, 1]])
    assert tmulti._cached_runner(eng, "bfs", 2, max_iters=8, policy="spmv") is \
        tmulti._cached_runner(eng, "bfs", 2, policy="spmv", max_iters=8)


@pytest.mark.parametrize("alg", ["bfs", "relax"])
def test_cached_runners_leave_no_reference_cycle(alg):
    """A runner cached in the engine holds the engine's closures, not the
    engine: dropping the last reference frees the engine (and its matrices)
    at once, without waiting for the cycle collector."""
    import gc
    import weakref

    _, tg, sources = graph_pair("face", 0.15)
    sr = tsemiring.BOOL_OR_AND if alg == "bfs" else tsemiring.MIN_PLUS
    eng = tengine.build_engine(tg, sr, device="cpu", fmt_spmv="bsr", fmt_spmspv="bsr")
    if alg == "bfs":
        tmulti.bfs_multi(eng, sources[:2])
    else:
        d0 = np.full((1, tg.n), np.inf, np.float32)
        d0[0, sources[0]] = 0.0
        tmulti.relax_multi(eng, d0, d0.copy())
    assert eng.__dict__["_multi_runners"]
    ref = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        assert ref() is None
    finally:
        gc.enable()
