"""``AsyncGraphServer`` with a tenant on a ``core.rank_mesh.RankMesh`` of 4
gloo ranks on the CPU, beside a local tenant, each rank on a ``FakeClock``
of its own that advances 1 / (1 + 3r) as far as rank 0's, rank 0 deciding
every flush (``torch_rank_async_cases.run_async``). On face 0.15, the
seeded mixed workload of ``test_torch_async_server.py``'s differential
(bfs/sssp/ppr, cc and pagerank, a ``mutate`` between two epochs, polls at
random points, ``close()``):

* on every rank every ticket's payload equals the mesh-less port server's
  (exactly) and the JAX package's ``AsyncGraphServer``'s (ppr/pagerank
  within rtol 1e-3, atol 1e-6, as ``test_async_matches_jax_async_server``);
* rank 0's decision rules: every poll dispatches the same tickets on every
  rank though their own clocks hold other windows due, one share a poll,
  a drain, the drain in ``mutate`` and ``close``;
* conservation holds in every snapshot on every rank; ``admitted``,
  ``dispatched`` and ``resolved`` agree across ranks;
* at ``max_pending`` every rank refuses the same submit;
* a ticket's ``wait`` that times out on one rank abandons nothing: the
  ticket stays queued on every rank and the shared ``close`` serves it;
* ``start()`` raises, and so does a tenant on another process group.
"""
import numpy as np
import pytest
import torch

import torch_rank_async_cases as cases
from repro.core.delta import EdgeDelta as JDelta
from repro.graphs import generate as jgenerate
from repro.serve.graph_engine import AsyncGraphServer as JAsync
from repro.serve.scheduler import FakeClock as JClock
from repro_torch.core.delta import EdgeDelta
from repro_torch.launch.ranks import run_ranks
from repro_torch.serve.graph_engine import AsyncGraphServer
from repro_torch.serve.scheduler import FakeClock

WORLD = 4


@pytest.fixture(scope="module")
def ranks():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run_ranks(cases.run_async, WORLD, timeout=300)
    finally:
        torch.set_num_threads(n)


def _serve(srv_cls, clock_cls, delta_cls, g, **kw) -> dict:
    srv = srv_cls(clock=clock_cls(), max_pending=1024, max_wait=0.05)
    for t in cases.TENANTS:
        srv.add_tenant(t, g, batch_size=4, pipeline_depth=2, **kw)
    out = cases.workload(srv, srv.clock, delta_cls)
    out["tickets"] = {t: [(tk.algorithm, tk.source, tk.seq, tk.done(), tk.result)
                          for tk in tks] for t, tks in out["tickets"].items()}
    return out


@pytest.fixture(scope="module")
def meshless():
    return _serve(AsyncGraphServer, FakeClock, EdgeDelta, cases.graph(), device="cpu")


@pytest.fixture(scope="module")
def jax_async():
    return _serve(JAsync, JClock, JDelta, jgenerate("face", scale=0.15, seed=1))


def assert_payload_equal(got, want, label):
    assert got is not None and want is not None, f"unresolved: {label}"
    assert set(got) == set(want), label
    for k, w in want.items():
        if isinstance(w, np.ndarray) or isinstance(got[k], np.ndarray):
            np.testing.assert_array_equal(got[k], w, err_msg=f"{label}[{k}]")
        else:
            assert got[k] == w, f"{label}[{k}]: {got[k]} != {w}"


@pytest.mark.parametrize("tenant", cases.TENANTS)
def test_payloads_equal_the_mesh_less_server(ranks, meshless, tenant):
    want = meshless["tickets"][tenant]
    for rank, out in enumerate(ranks):
        got = out["tickets"][tenant]
        assert len(got) == len(want) > 0
        for i, (g, w) in enumerate(zip(got, want)):
            assert g[:4] == w[:4] and g[3], (rank, i)
            assert_payload_equal(g[4], w[4], f"rank {rank} {tenant} q{i} {g[0]}/{g[1]}")


@pytest.mark.parametrize("tenant", cases.TENANTS)
def test_payloads_match_the_jax_async_server(ranks, jax_async, tenant):
    want = jax_async["tickets"][tenant]
    for rank, out in enumerate(ranks):
        for i, (g, w) in enumerate(zip(out["tickets"][tenant], want)):
            assert g[:3] == w[:3], (rank, i)
            a, got, exp = g[0], g[4], w[4]
            assert got.keys() == exp.keys()
            for k, v in exp.items():
                if a in ("ppr", "pagerank") and k != "iterations":
                    np.testing.assert_allclose(got[k], v, rtol=1e-3, atol=1e-6)
                elif a == "pagerank":
                    assert abs(got[k] - v) <= 1     # tol crossing, ROADMAP §3
                else:
                    np.testing.assert_array_equal(got[k], v, err_msg=f"rank {rank} q{i} {k}")


def test_mutate_report_is_the_mesh_less_servers(ranks, meshless, jax_async):
    for out in ranks:
        assert out["report"] == meshless["report"] == jax_async["report"]


def test_rank_zero_decides_under_skewed_clocks(ranks):
    polls = ranks[0]["polls"]
    assert sum(polls) > 0
    for rank, out in enumerate(ranks):
        assert out["polls"] == polls, rank
        # a poll, a drain an epoch, the drain in mutate, close: each one share
        assert out["share_calls"] == len(polls) + 4, rank
        assert (out["share_bytes"] > 0) == (rank > 0), rank
    # the ranks' own clocks held other windows due: the decision mattered
    assert any(out["due"] != ranks[0]["due"] for out in ranks[1:])


def test_conservation_on_every_rank(ranks):
    for rank, out in enumerate(ranks):
        assert out["snapshots"]
        for snap in out["snapshots"] + [out["final"]]:
            for t, st in snap.items():
                assert cases.snapshot_ok(st), (rank, t, st["slo"])
        for t in cases.TENANTS:
            s, s0 = out["final"][t]["slo"], ranks[0]["final"][t]["slo"]
            for k in ("admitted", "dispatched", "resolved", "pending"):
                assert s[k] == s0[k], (rank, t, k)
            assert s["pending"] == 0 and s["resolved"] == s["admitted"]


def test_backpressure_refuses_the_same_submit(ranks):
    refused = ranks[0]["refused"]
    assert any(refused) and not all(refused)
    for rank, out in enumerate(ranks):
        assert out["refused"] == refused, rank
        assert cases.snapshot_ok({"slo": out["bp_stats"]})


def test_a_wait_timeout_on_one_rank_abandons_nothing(ranks):
    for rank, out in enumerate(ranks):
        waited = {0, 1} & {rank}
        assert set(out["wait_errors"]) == waited, rank
        for w in waited:
            assert "stays queued" in out["wait_errors"][w]
        assert out["wait_pending"] == 2, rank
        s = out["wait_slo"]
        assert (s["abandoned"], s["wait_timeouts"], s["pending"]) == (0, 0, 0), rank
        assert s["resolved"] == s["admitted"] == 2 and cases.snapshot_ok({"slo": s})
        for i, (done, result) in enumerate(out["wait_tickets"]):
            assert done, (rank, i)
            assert_payload_equal(result, ranks[0]["wait_tickets"][i][1], f"rank {rank} t{i}")


def test_start_raises_on_a_rank_tenant(ranks):
    for out in ranks:
        assert out["start"] is not None and "loop thread" in out["start"]


def test_tenants_on_another_world_raise(ranks):
    for out in ranks:
        assert out["other_is_rank_mesh"]
        assert out["other_world"] is not None and "process group" in out["other_world"]
