"""The rank bodies of ``tests/test_torch_rank_multi.py``, importable by the
ranks' processes (no ``jax``, no ``repro``): the row-sharded multi-source
traversals, the bucket drain and ``GraphQueryServer`` on a
``core.rank_mesh.RankMesh`` of gloo ranks on the CPU. Every rank runs the
same cases in the same order (a mesh is built where its first case needs
it, which is collective) and returns, for each, what the test holds to
the ``mesh=None`` run and to the virtual mesh: the gathered result, the
rank's own rows before the gather, the rows of every step call and the
collectives the case issued.
"""
import dataclasses
import importlib
from collections import Counter

import numpy as np
import torch

from repro_torch.core import semiring as tsemiring
from repro_torch.core.delta import EdgeDelta
from repro_torch.core.mesh import Mesh
from repro_torch.graphs import cost_model as tcost
from repro_torch.graphs import datasets as tdatasets
from repro_torch.graphs import engine as tengine
from repro_torch.graphs import multi as tmulti

GRAPH = ("face", 0.15, 1)
APPS = {
    "bfs": ("bool_or_and", {}),
    "sssp": ("min_plus", {"weighted": True, "seed": 5}),
    "ppr": ("plus_times", {"normalize": True}),
}
ROUTES = ("csr", "bsr")
BATCHES = (8, 32, 6)
#: (label, mesh shape, axis names, axis_name, app, route, B) by world size:
#: on 4 ranks every app and route at every B on ("batch",); on 8 the
#: reference's (8,) cases (B = 6: ranks 6 and 7 hold no rows), the tuple
#: axis of a (2, 4) mesh (8 positions; B = 6 leaves two empty) and its
#: axis "b" alone (4 positions, the ranks along "a" holding copies)
TRAVERSALS = {
    4: [(f"{app}/{fmt}/B{b}", (4,), ("batch",), "batch", app, fmt, b)
        for app in APPS for fmt in ROUTES for b in BATCHES],
    8: ([(f"{app}/csr/B6/8", (8,), ("batch",), "batch", app, "csr", 6) for app in ("bfs", "ppr")]
        + [(f"{app}/bsr/B{b}/ab", (2, 4), ("a", "b"), ("a", "b"), app, "bsr", b)
           for app in APPS for b in (8, 6)]
        + [(f"{app}/bsr/B8/b", (2, 4), ("a", "b"), "b", app, "bsr", 8) for app in APPS]
        + [("sssp/csr/B8/ab", (2, 4), ("a", "b"), ("a", "b"), "sssp", "csr", 8)]),
}
BUCKET_SOURCES = 11
QUERIES = [("bfs", 0), ("bfs", 3), ("bfs", 5), ("bfs", 3), ("bfs", 7), ("bfs", 11),
           ("sssp", 1), ("sssp", 2), ("sssp", 9), ("ppr", 4), ("ppr", 9), ("ppr", 13),
           ("ppr", 17), ("ppr", 21), ("cc", None)]
MATVECS = (("bfs", "spmv"), ("sssp", "spmspv"), ("ppr", "spmv"))


def graph():
    abbrev, scale, seed = GRAPH
    return tdatasets.generate(abbrev, scale=scale, seed=seed)


def build_engines(g, device="cpu") -> dict:
    out = {}
    for app, (name, kw) in APPS.items():
        for fmt in ROUTES:
            msv = "csc" if fmt == "csr" else fmt
            out[app, fmt] = tengine.build_engine(
                g, tsemiring.SEMIRINGS[name], tcost.trained_stump(), fmt_spmv=fmt,
                fmt_spmspv=msv, device=device, **kw)
    return out


def sources_of(n, b, seed=42):
    return [int(s) for s in np.random.default_rng(seed).integers(0, n, b)]


def run_app(app, eng, sources, **kw):
    return getattr(tmulti, f"{app}_multi")(eng, sources, **kw)


def relax_inputs(eng, n):
    """(dist0, changed0) [6, n_true]: the cold SSSP rows with every third
    vertex stale, as ``test_torch_multi_mesh.test_relax_multi`` seeds them."""
    dist0 = tmulti.sssp_multi(eng, sources_of(n, 6)).dist.clone()
    dist0[:, ::3] = float("inf")
    return dist0, torch.where(torch.isinf(dist0), float("inf"), dist0)


def mutation(g):
    """A small edge delta: four inserts and one delete."""
    rng = np.random.default_rng(9)
    ins = rng.integers(0, g.n, (4, 2))
    return EdgeDelta(insert_rows=ins[:, 0], insert_cols=ins[:, 1],
                     delete_rows=[g.rows[0]], delete_cols=[g.cols[0]])


def serve(g, mesh=None, device="cpu") -> dict:
    """``QUERIES`` through a ``GraphQueryServer``, a ``mutate``, the same
    queries again: every payload, the counters and the LRU's keys."""
    from repro_torch.serve.graph_engine import GraphQueryServer
    srv = GraphQueryServer(g, batch_size=4, mesh=mesh, device=device)
    rounds = []
    for phase in range(2):
        reqs = [srv.submit(a, s) for a, s in QUERIES]
        srv.flush()
        rounds.append([(r.algorithm, r.source, r.cached, r.result) for r in reqs])
        if phase == 0:
            report = srv.mutate(mutation(g))
    return {"rounds": rounds, "report": report, "counters": dict(srv.counters),
            "lru": list(srv.cache._d.keys())}


def matvec_input(algorithm, pm, sr, n):
    """A seeded x of ``n`` entries in ``algorithm``'s domain, padded with
    the semiring's zero to the partition's columns."""
    rng = np.random.default_rng(7)
    if algorithm == "bfs":
        x = (rng.random(n) < 0.3).astype(np.int32)
    elif algorithm == "sssp":
        x = np.where(rng.random(n) < 0.3, rng.integers(1, 50, n), np.inf).astype(np.float32)
    else:
        x = rng.random(n).astype(np.float32)
    xp = np.full(pm.plan.shape[1], sr.zero, x.dtype)
    xp[:n] = x
    return torch.from_numpy(xp)


def partitioned(g, mesh) -> dict:
    """``GraphQueryServer.partitioned_matvec`` on ``mesh`` for ``MATVECS``:
    the output block(s) and the parts' leading dim."""
    tpart = importlib.import_module("repro_torch.core.partition")
    from repro_torch.serve.graph_engine import GraphQueryServer
    srv = GraphQueryServer(g, device="cpu")
    out = {}
    for algorithm, kernel in MATVECS:
        pm, fn, choice = srv.partitioned_matvec(algorithm, mesh, kernel=kernel)
        sr = srv.engine(algorithm).sr
        xs = mesh.local(tpart.shard_tensor(pm.plan, matvec_input(algorithm, pm, sr, g.n),
                                           sr.zero))
        stacks = {int(getattr(pm.parts, f.name).shape[0])
                  for f in dataclasses.fields(pm.parts)
                  if isinstance(getattr(pm.parts, f.name), torch.Tensor)}
        out[algorithm, kernel] = {"y": fn(pm.parts, xs), "strategy": choice.strategy,
                                  "stacks": stacks}
    return out


def run_multi(rank: int, world: int, init: str) -> dict:
    """A rank's results of every case of ``world`` (see the module)."""
    from repro_torch.core.rank_mesh import init_rank_mesh
    torch.set_num_threads(1)
    g = graph()
    engines = build_engines(g)
    seen: list = []
    for eng in engines.values():
        for attr in ("spmv_batch_fn", "spmspv_batch_fn"):
            inner = getattr(eng, attr)
            setattr(eng, attr, lambda xs, inner=inner: seen.append(int(xs.shape[0])) or inner(xs))
    meshes: dict = {}
    own_rows: list = []

    def mesh_of(shape, names):
        if (shape, names) not in meshes:
            m = init_rank_mesh(shape, names, "gloo", device="cpu", init_method=init, rank=rank,
                               world_size=world)
            gather = m.gather_rows
            # the rank's own rows, as the runner hands them to the gather
            m.gather_rows = lambda ts, b, ax: (own_rows.append([t.clone() for t in ts])
                                               or gather(ts, b, ax))
            meshes[shape, names] = m
        return meshes[shape, names]

    def case(m, fn):
        seen.clear()
        own_rows.clear()
        calls = Counter(m.calls)
        res = fn()
        return {"result": res, "own": list(own_rows), "rows_seen": list(seen),
                "calls": dict(Counter(m.calls) - calls)}

    out = {"traversals": {}}
    for label, shape, names, axis, app, fmt, b in TRAVERSALS[world]:
        m = mesh_of(shape, names)
        rec = case(m, lambda: tuple(run_app(app, engines[app, fmt], sources_of(g.n, b), mesh=m,
                                            axis_name=axis)))
        rec["share"] = m.row_shares(b, axis)[0]
        out["traversals"][label] = rec
    if world == 4:
        m = mesh_of((4,), ("batch",))
        out["relax"] = {}
        for fmt in ROUTES:
            eng = engines["sssp", fmt]
            d0, c0 = relax_inputs(eng, g.n)
            out["relax"][fmt] = case(m, lambda: tuple(tmulti.relax_multi(eng, d0, c0, mesh=m)))
        src = sources_of(g.n, BUCKET_SOURCES)
        buckets = [src[:4], src[4:7], src[7:]]
        out["buckets"] = {}
        for app in APPS:
            for depth in (0, 2):
                out["buckets"][app, depth] = case(m, lambda: [tuple(r) for r in (
                    tmulti.traverse_multi_buckets(engines[app, "bsr"], app, buckets,
                                                  pipeline_depth=depth, mesh=m, pad_to=4))])
        # a RankMesh and a Mesh of one layout never share a runner
        eng = engines["bfs", "csr"]
        before = len(eng.__dict__["_multi_runners"])
        virtual = tuple(tmulti.bfs_multi(eng, sources_of(g.n, 8),
                                         mesh=Mesh((4,), ("batch",), device="cpu")))
        out["runners"] = {"added": len(eng.__dict__["_multi_runners"]) - before,
                          "virtual": virtual}
        out["server"] = case(m, lambda: serve(g, m))
    else:
        m = mesh_of((2, 4), ("dr", "dc"))
        out["partitioned"] = case(m, lambda: partitioned(g, m))
    out["wire"] = {str(k): dict(v.wire_bytes) for k, v in meshes.items()}
    return out
