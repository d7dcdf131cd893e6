"""The port's ``obs.metrics`` and ``obs.calibrate`` against the JAX
package's copies: the same seeded observation streams through both
``Histogram``/``Counter``/``Gauge``/``MetricsRegistry`` give equal
snapshots, and calibration (``spearman``, ``predicted_phases``,
``phase_measurements``, ``calibration_cell``, ``calibration_report``,
``format_report``) gives equal results on the same span rows, and on the
spans that the port's traced ``build_phase_fns`` emits on the virtual
mesh."""
import importlib
import math
import threading

import numpy as np
import pytest
import torch

from repro.obs import calibrate as jcal
from repro.obs import metrics as jmet
from repro.obs import trace as jtrace
from repro_torch.core import distributed as dist
from repro_torch.core import semiring as tsemiring
from repro_torch.core.mesh import Mesh
from repro_torch.core.pipeline import run_phases_once
from repro_torch.graphs.cost_model import estimate_phase_costs
from repro_torch.obs import calibrate as tcal
from repro_torch.obs import metrics as tmet
from repro_torch.obs import trace as ttrace

tpart = importlib.import_module("repro_torch.core.partition")

SEEDS = range(6)
HIST_SHAPES = [(1e-6, 2 ** 0.25), (1e-3, 2.0), (0.5, 1.1)]


def stream(seed: int, k: int = 400) -> list:
    """Latencies from µs to s, with zeros, negatives and repeats."""
    rng = np.random.default_rng(seed)
    xs = np.exp(rng.normal(-6.0, 3.0, k))
    xs[rng.random(k) < 0.05] = 0.0
    xs[rng.random(k) < 0.05] *= -1.0
    xs[rng.random(k) < 0.1] = xs[0]
    return [float(x) for x in xs]


def same_number(a, b) -> bool:
    return (math.isnan(a) and math.isnan(b)) or a == b


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("least,growth", HIST_SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_histogram_matches_jax(seed, least, growth):
    hj, ht = jmet.Histogram("h", least, growth), tmet.Histogram("h", least, growth)
    xs = stream(seed)
    for i, x in enumerate(xs):
        hj.observe(x)
        ht.observe(x)
        if i % 97 == 0:
            assert ht.summary() == hj.summary()
    assert ht.buckets == hj.buckets
    assert ht.summary() == hj.summary()
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert ht.quantile(q) == hj.quantile(q)
    assert ht.mean == hj.mean


def test_histogram_rejects_bad_shape_and_empty_summary():
    for least, growth in ((0.0, 2.0), (1.0, 1.0)):
        with pytest.raises(ValueError):
            tmet.Histogram("h", least, growth)
    assert tmet.Histogram("h").summary() == jmet.Histogram("h").summary() == {"count": 0}
    assert tmet.Histogram("h").quantile(0.5) == 0.0


@pytest.mark.parametrize("seed", SEEDS)
def test_counter_and_gauge_match_jax(seed):
    rng = np.random.default_rng(seed)
    cj, ct = jmet.Counter("c"), tmet.Counter("c")
    gj, gt = jmet.Gauge("g"), tmet.Gauge("g")
    for _ in range(200):
        amount = int(rng.integers(0, 5))
        assert ct.inc(amount) == cj.inc(amount)
        v = float(rng.normal())
        assert gt.set(v) == gj.set(v)
    assert ct.value == cj.value
    assert (gt.value, gt.lo, gt.hi, gt.writes) == (gj.value, gj.lo, gj.hi, gj.writes)


@pytest.mark.parametrize("seed", SEEDS)
def test_registry_snapshot_matches_jax(seed):
    """Random create-or-observe actions on named instruments, snapshots
    compared after every 25 actions (gauges never written stay out)."""
    rng = np.random.default_rng(seed)
    rj, rt = jmet.MetricsRegistry(), tmet.MetricsRegistry()
    names = ["a", "b", "c"]
    xs = stream(seed, 300)
    for i, x in enumerate(xs):
        kind, name = int(rng.integers(0, 4)), names[int(rng.integers(0, 3))]
        for reg in (rj, rt):
            if kind == 0:
                reg.counter(name).inc(int(abs(x) * 10) + 1)
            elif kind == 1:
                reg.gauge(name).set(x)
            elif kind == 2:
                reg.histogram(name).observe(x)
            else:
                reg.gauge("never_" + name)          # created, never written
        if i % 25 == 0:
            assert rt.snapshot() == rj.snapshot()
    snap = rt.snapshot()
    assert snap == rj.snapshot()
    assert not any(k.startswith("never_") for k in snap["gauges"])
    snap["counters"]["a"] = -1                       # a copy, not the live state
    assert rt.snapshot()["counters"].get("a") != -1
    assert rt.histogram("a") is rt.histogram("a")    # create-or-return


@pytest.mark.parametrize("seed", SEEDS)
def test_percentile_exact_matches_jax(seed):
    xs = stream(seed, 50)
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert tmet.percentile_exact(xs, q) == jmet.percentile_exact(xs, q)
    assert tmet.percentile_exact([], 0.5) == 0.0


def test_default_registry_is_one_per_process():
    assert tmet.default_registry() is tmet.default_registry()
    assert tmet.default_registry() is not jmet.default_registry()


@pytest.mark.timeout(30)
def test_concurrent_observations_are_not_lost():
    """Four threads observe into one registry; every update lands."""
    reg = tmet.MetricsRegistry()
    per = 2000

    def work(tid):
        for i in range(per):
            reg.counter("n").inc()
            reg.histogram("h").observe(1e-6 * (i + tid))
            reg.gauge("g").set(float(i))

    threads = [threading.Thread(target=work, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
        assert not t.is_alive()
    snap = reg.snapshot()
    assert snap["counters"]["n"] == 4 * per
    assert snap["histograms"]["h"]["count"] == 4 * per
    assert snap["gauges"]["g"]["writes"] == 4 * per


# ---------------------------------------------------------------------------
# calibrate on the same rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_spearman_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for k in (1, 2, 3, 7, 20):
        xs = rng.integers(0, 4, k).tolist()          # ties
        ys = rng.normal(size=k).tolist()
        assert same_number(tcal.spearman(xs, ys), jcal.spearman(xs, ys))
        assert same_number(tcal.spearman(xs, xs), jcal.spearman(xs, xs))
    assert math.isnan(tcal.spearman([1.0, 1.0], [1.0, 2.0]))
    with pytest.raises(ValueError):
        tcal.spearman([1, 2], [1, 2, 3])


def cost_row(rng) -> dict:
    c = {k: float(rng.uniform(1.0, 1e4)) for k in ("load", "kernel", "retrieve", "merge_wire")}
    c["total"] = sum(c.values())
    return c


SPAN_ROWS = [  # (name, t0, t1, attrs)
    ("phase/load", 0.0, 0.1, {"phase": "load", "strategy": "row"}),
    ("phase/kernel", 0.1, 0.5, {"phase": "kernel", "strategy": "row"}),
    ("phase/kernel", 1.0, 1.2, {"phase": "kernel", "strategy": "col"}),
    ("phase/kernel", 1.3, 1.4, {"phase": "kernel", "strategy": "col"}),
    ("phase/retrieve_merge", 1.4, 1.7, {"phase": "retrieve_merge", "strategy": "col"}),
    ("phase/load", 2.0, 2.05, {"phase": "load", "strategy": "2d"}),
    ("phase/kernel", 2.05, 2.6, {"phase": "kernel", "strategy": "2d"}),
    ("phase/retrieve_merge", 2.6, 2.7, {"phase": "retrieve_merge", "strategy": "2d"}),
    ("phase/e2e", 3.0, 3.9, {"strategy": "2d"}),        # no phase attr: name's tail
    ("serve/flush", 0.0, 9.9, {"n_requests": 3}),       # not a phase span
]


def tracers():
    tj, tt = jtrace.Tracer(), ttrace.Tracer()
    for name, t0, t1, attrs in SPAN_ROWS:
        tj.add_span(name, t0, t1, **attrs)
        tt.add_span(name, t0, t1, **attrs)
    return tj, tt


@pytest.mark.parametrize("strategy", ["row", "col", "2d", None])
def test_phase_measurements_match_jax(strategy):
    tj, tt = tracers()
    kw = {} if strategy is None else {"strategy": strategy}
    got, want = tcal.phase_measurements(tt, **kw), jcal.phase_measurements(tj, **kw)
    assert got == want
    assert "serve/flush" not in got


@pytest.mark.parametrize("seed", SEEDS)
def test_calibration_report_matches_jax(seed):
    """Cells, report and its text through both packages on the same cost
    rows and measured phase sums (with a phase missing in one cell)."""
    rng = np.random.default_rng(seed)
    tj, tt = tracers()
    cells_t, cells_j = [], []
    for family in ("rmat", "road"):
        for strategy, topology in (("row", "flat"), ("col", "ring"), ("2d", "staged2d")):
            cost = cost_row(rng)
            assert tcal.predicted_phases(cost, strategy) == jcal.predicted_phases(cost, strategy)
            meas_t = tcal.phase_measurements(tt, strategy=strategy)
            meas_j = jcal.phase_measurements(tj, strategy=strategy)
            if family == "road" and strategy == "2d":
                meas_t.pop("load")
                meas_j.pop("load")
            wall = float(rng.uniform(0.1, 1.0)) if strategy != "row" else None
            ct = tcal.calibration_cell(family, strategy, topology, cost, meas_t, wall)
            cj = jcal.calibration_cell(family, strategy, topology, cost, meas_j, wall)
            assert ct.keys() == cj.keys()
            for k in ct:
                if k == "rho":
                    assert same_number(ct[k], cj[k])
                else:
                    assert ct[k] == cj[k], k
            cells_t.append(ct)
            cells_j.append(cj)
    rep_t, rep_j = tcal.calibration_report(cells_t), jcal.calibration_report(cells_j)
    assert rep_t["ordering"].keys() == rep_j["ordering"].keys() == {"rmat", "road"}
    for fam in rep_t["ordering"]:
        ot, oj = rep_t["ordering"][fam], rep_j["ordering"][fam]
        assert {k: v for k, v in ot.items() if k != "rho"} == \
            {k: v for k, v in oj.items() if k != "rho"}
        assert same_number(ot["rho"], oj["rho"])
    assert tcal.format_report(rep_t) == jcal.format_report(rep_j)


# ---------------------------------------------------------------------------
# calibrate on the port's own phase spans (virtual mesh, CPU)
# ---------------------------------------------------------------------------

N = 128
STRATEGIES = {"row": (8, 1), "col": (1, 8), "2d": (2, 4)}


@pytest.fixture(scope="module")
def traced_phases():
    """One traced step of each strategy's phase closures (⟨+,×⟩, 0/1 data)
    on a 2×4 virtual mesh, and the plan of each."""
    rng = np.random.default_rng(3)
    rows, cols = np.nonzero(rng.random((N, N)) < 0.08)
    vals = np.ones(rows.shape[0], np.float32)
    x = torch.from_numpy((rng.random(N) < 0.3).astype(np.float32))
    sr = tsemiring.PLUS_TIMES
    mesh = Mesh((2, 4), device="cpu")
    out = {}
    with ttrace.tracing() as tr:
        for strategy, grid in STRATEGIES.items():
            pm = tpart.partition(rows, cols, vals, (N, N), grid, "csr", sr, device="cpu")
            xs = tpart.shard_tensor(pm.plan, x, sr.zero)
            fns = dist.build_phase_fns(mesh, pm, sr, strategy, "spmv")
            y = run_phases_once(fns, pm.parts, xs)
            out[strategy] = (pm.plan, tpart.unshard_tensor(pm.plan, y))
    return tr, out, (rows, cols, vals, x)


@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_calibration_on_traced_phase_spans(traced_phases, strategy):
    """Every phase the strategy runs leaves a span carrying ``phase`` and
    ``strategy``; the two packages' calibration agrees on those spans;
    the traced step's values are those of the dense product."""
    tr, out, (rows, cols, vals, x) = traced_phases
    plan, y = out[strategy]
    dense = np.zeros((N, N), np.float32)
    dense[rows, cols] = vals
    np.testing.assert_array_equal(y.numpy(), dense @ x.numpy())

    spans = tr.filter("phase/", strategy=strategy)
    assert spans and all(s.attrs["devices"] == 8 for s in spans)
    meas_t = tcal.phase_measurements(tr, strategy=strategy)
    assert set(tcal.PHASES_BY_STRATEGY[strategy]) <= set(meas_t)
    assert all(v >= 0.0 for v in meas_t.values())

    tj = jtrace.Tracer()
    for s in tr.spans:
        tj.add_span(s.name, s.t0, s.t1, **s.attrs)
    assert jcal.phase_measurements(tj, strategy=strategy) == meas_t

    cost = estimate_phase_costs(plan, strategy, mesh_grid=(2, 4))
    ct = tcal.calibration_cell("rand", strategy, "flat", cost, meas_t)
    cj = jcal.calibration_cell("rand", strategy, "flat", cost, meas_t)
    assert ct["phases"] == list(tcal.PHASES_BY_STRATEGY[strategy]) == cj["phases"]
    assert ct["predicted"] == cj["predicted"] and ct["measured"] == cj["measured"]
    assert same_number(ct["rho"], cj["rho"])
    assert tcal.format_report(tcal.calibration_report([ct])) == \
        jcal.format_report(jcal.calibration_report([cj]))
