"""The port's partition layer (``repro_torch.core.partition``) against the
JAX package's ``repro.core.partition``: the plans (cuts, block-cyclic
orders, tile nnz, local shapes) and every stacked leaf of ``partition`` are
equal for every family × balance × grid × format of
``tests/test_partition.py``; the layout helpers, the tensor layouts and
``unpartition`` round-trip exactly; ``convert.partitioned_from_numpy``
carries a JAX partition across leaf for leaf. All comparisons are exact."""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro.core.semiring import BOOL_OR_AND as J_BOOL, MIN_PLUS as J_MINPLUS
from repro.core.semiring import PLUS_TIMES as J_PT
from repro.graphs.datasets import rmat_graph, road_graph, uniform_graph
from repro_torch import convert
from repro_torch.core.semiring import BOOL_OR_AND, MIN_PLUS, PLUS_TIMES

# the packages' core/__init__ export the function ``partition`` under the
# module's name, so the modules are taken from the import system
jpart = importlib.import_module("repro.core.partition")
tpart = importlib.import_module("repro_torch.core.partition")

GRIDS = [(8, 1), (1, 8), (2, 4), (1, 1)]
FMTS = ["coo", "csr", "csc", "bsr"]
SEMIRINGS = {"plus_times": (J_PT, PLUS_TIMES), "min_plus": (J_MINPLUS, MIN_PLUS),
             "bool_or_and": (J_BOOL, BOOL_OR_AND)}
BLOCK = (16, 16)


def _family_graph(family: str):
    if family == "road":
        return road_graph(900, 2.6, seed=3)
    if family == "uniform":
        return uniform_graph(800, 3200, seed=3)
    return rmat_graph(1024, 8000, skew=0.6, seed=3)


def _edges(g, sr_name, seed=0):
    rng = np.random.default_rng(seed)
    rows, cols = g.cols.astype(np.int64), g.rows.astype(np.int64)
    if sr_name == "bool_or_and":
        vals = np.ones(rows.shape[0], np.int32)
    else:
        vals = rng.integers(1, 9, rows.shape[0]).astype(np.float32)
    return rows, cols, vals


@pytest.fixture(scope="module")
def graphs():
    return {f: _family_graph(f) for f in ("road", "uniform", "rmat")}


def plan_fields(plan) -> dict:
    return {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)}


def assert_plans_equal(tplan, jplan):
    for name, jv in plan_fields(jplan).items():
        tv = getattr(tplan, name)
        if jv is None or tv is None:
            assert jv is None and tv is None, name
        else:
            np.testing.assert_array_equal(np.asarray(tv), np.asarray(jv), err_msg=name)


def jax_leaves(pm) -> dict:
    """The stacked leaves of a JAX PartitionedMatrix by field name."""
    return {f.name: np.asarray(getattr(pm.parts, f.name))
            for f in dataclasses.fields(pm.parts)
            if f.name not in ("shape", "block", "max_col_nnz")}


def assert_partitions_equal(tpm, jpm):
    assert tpm.grid == tuple(jpm.grid) and tpm.fmt == jpm.fmt
    assert tpm.shape == tuple(jpm.shape) and tpm.local_shape == tuple(jpm.local_shape)
    assert tpm.parts.shape == tuple(jpm.parts.shape)
    for name, jv in jax_leaves(jpm).items():
        tv = getattr(tpm.parts, name)
        tv = np.asarray(tv) if name == "nnz" else tv.cpu().numpy()
        assert tv.shape == jv.shape, name
        np.testing.assert_array_equal(tv, jv, err_msg=name)
    if jpm.fmt == "csc":
        assert tpm.parts.max_col_nnz == jpm.parts.max_col_nnz
    if jpm.fmt == "bsr":
        assert tpm.parts.block == tuple(jpm.parts.block)
    assert_plans_equal(tpm.plan, jpm.plan)


@pytest.mark.parametrize("family", ["road", "uniform", "rmat"])
@pytest.mark.parametrize("balance", ["rows", "nnz"])
@pytest.mark.parametrize("grid", GRIDS)
def test_plan_partition_equals_jax(graphs, family, balance, grid):
    g = graphs[family]
    rows, cols, _ = _edges(g, "plus_times")
    tplan = tpart.plan_partition(rows, cols, (g.n, g.n), grid, balance)
    jplan = jpart.plan_partition(rows, cols, (g.n, g.n), grid, balance)
    assert_plans_equal(tplan, jplan)
    assert tplan.imbalance() == jplan.imbalance()
    for side in ("input_index", "output_index"):
        try:
            want = getattr(jplan, side)()
        except ValueError:
            with pytest.raises(ValueError):
                getattr(tplan, side)()
            continue
        np.testing.assert_array_equal(getattr(tplan, side)(), want)


@pytest.mark.parametrize("family", ["road", "uniform", "rmat"])
@pytest.mark.parametrize("balance", ["rows", "nnz"])
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("fmt", FMTS)
def test_partition_leaves_equal_jax(graphs, family, balance, grid, fmt):
    """Every stacked leaf, the grid, shapes and plan of the port's
    partition equal the JAX package's, and both unpartition to the input
    edge list. Semiring by family: ⟨+,×⟩, ⟨min,+⟩ (+inf background) and
    ⟨∨,∧⟩ (int32)."""
    name = {"road": "min_plus", "uniform": "plus_times", "rmat": "bool_or_and"}[family]
    jsr, tsr = SEMIRINGS[name]
    g = graphs[family]
    rows, cols, vals = _edges(g, name)
    jpm = jpart.partition(rows, cols, vals, (g.n, g.n), grid, fmt, jsr, block=BLOCK,
                          balance=balance)
    tpm = tpart.partition(rows, cols, vals, (g.n, g.n), grid, fmt, tsr, block=BLOCK,
                          balance=balance, device="cpu")
    assert_partitions_equal(tpm, jpm)
    r2, c2, v2 = tpart.unpartition(tpm, tsr)
    order = np.lexsort((cols, rows))
    np.testing.assert_array_equal(r2, rows[order])
    np.testing.assert_array_equal(c2, cols[order])
    np.testing.assert_array_equal(v2, vals[order])
    assert tpm.stored_bytes() == sum(v.nbytes for k, v in jax_leaves(jpm).items() if k != "nnz")


@pytest.mark.parametrize("balance", ["rows", "nnz"])
@pytest.mark.parametrize("grid", GRIDS)
def test_layout_helpers_equal_jax_and_round_trip(graphs, balance, grid):
    """The numpy shard/unshard helpers equal JAX's, and the tensor layouts
    (``shard_tensor``/``unshard_tensor``) equal the numpy helpers for
    vectors, [B, n] blocks and row blocks, on both sides."""
    g = graphs["rmat"]
    rows, cols, _ = _edges(g, "plus_times")
    tplan = tpart.plan_partition(rows, cols, (g.n, g.n), grid, balance)
    jplan = jpart.plan_partition(rows, cols, (g.n, g.n), grid, balance)
    rng = np.random.default_rng(2)
    y = rng.random(g.n).astype(np.float32)
    yb = np.stack([y, y[::-1], y * 2])
    mat = rng.random((g.n, 3)).astype(np.float32)
    for fn, arg in (("shard_output_vector", y), ("shard_input_vector", y),
                    ("shard_input_batch", yb), ("shard_input_rows", mat),
                    ("shard_output_rows", mat)):
        np.testing.assert_array_equal(getattr(tplan, fn)(arg, 0.0), getattr(jplan, fn)(arg, 0.0),
                                      err_msg=fn)
    ys = tplan.shard_output_vector(y, 0.0)
    np.testing.assert_array_equal(tplan.unshard_output_vector(ys), y)
    np.testing.assert_array_equal(tplan.unshard_output_rows(tplan.shard_output_rows(mat, 0.0)),
                                  mat)
    t = torch.from_numpy
    np.testing.assert_array_equal(tpart.shard_tensor(tplan, t(y), 0.0).numpy(),
                                  tplan.shard_input_vector(y, 0.0))
    np.testing.assert_array_equal(tpart.shard_tensor(tplan, t(yb), 0.0, dim=1).numpy(),
                                  tplan.shard_input_batch(yb, 0.0))
    np.testing.assert_array_equal(tpart.shard_tensor(tplan, t(mat), -1.0).numpy(),
                                  tplan.shard_input_rows(mat, -1.0))
    np.testing.assert_array_equal(
        tpart.shard_tensor(tplan, t(mat), 0.0, side="output").numpy(),
        tplan.shard_output_rows(mat, 0.0))
    np.testing.assert_array_equal(tpart.unshard_tensor(tplan, t(ys)).numpy(), y)
    yd = np.stack([tplan.shard_output_vector(v, 0.0) for v in yb], axis=1)   # [D, B, out]
    np.testing.assert_array_equal(tpart.unshard_tensor(tplan, t(yd), dim=1).numpy(), yb)
    np.testing.assert_array_equal(tplan.unshard_output_batch(yd), yb)
    cs = tplan.shard_output_rows(mat, 0.0)
    np.testing.assert_array_equal(tpart.unshard_tensor(tplan, t(cs)).numpy(), mat)


@pytest.mark.parametrize("balance", ["rows", "nnz"])
def test_star_graph_and_empty_graph_plans_equal_jax(balance):
    n = 256
    hub = np.zeros(n - 1, np.int64)
    leaves = np.arange(1, n, dtype=np.int64)
    rows = np.concatenate([hub, leaves])
    cols = np.concatenate([leaves, hub])
    for grid in GRIDS:
        assert_plans_equal(tpart.plan_partition(rows, cols, (n, n), grid, balance),
                           jpart.plan_partition(rows, cols, (n, n), grid, balance))
    empty = np.zeros(0, np.int64)
    tpm = tpart.partition(empty, empty, np.zeros(0, np.int32), (64, 64), (2, 4), "coo",
                          BOOL_OR_AND, balance=balance, device="cpu")
    jpm = jpart.partition(empty, empty, np.zeros(0, np.int32), (64, 64), (2, 4), "coo",
                          J_BOOL, balance=balance)
    assert_partitions_equal(tpm, jpm)
    assert tpart.unpartition(tpm, BOOL_OR_AND)[0].shape[0] == 0


def test_balanced_cuts_and_shard_vector_equal_jax():
    rng = np.random.default_rng(0)
    w = rng.integers(0, 50, 1000)
    for parts in (1, 3, 8, 12):
        np.testing.assert_array_equal(tpart.balanced_cuts(w, parts), jpart.balanced_cuts(w, parts))
    np.testing.assert_array_equal(tpart.balanced_cuts(np.zeros(64, np.int64), 8),
                                  jpart.balanced_cuts(np.zeros(64, np.int64), 8))
    x = rng.random(100).astype(np.float32)
    np.testing.assert_array_equal(tpart.shard_vector(x, 8, np.inf), jpart.shard_vector(x, 8, np.inf))


def test_apply_delta_equals_jax(graphs):
    g = graphs["rmat"]
    rows, cols, _ = _edges(g, "plus_times")
    tplan = tpart.plan_partition(rows, cols, (g.n, g.n), (2, 4), "nnz")
    jplan = jpart.plan_partition(rows, cols, (g.n, g.n), (2, 4), "nnz")
    ins_r, ins_c = np.array([1, 2, 3]), np.array([900, 5, 77])
    assert_plans_equal(tplan.apply_delta(ins_r, ins_c, rows[:4], cols[:4]),
                       jplan.apply_delta(ins_r, ins_c, rows[:4], cols[:4]))


def test_partition_rejects_bad_balance_and_mismatched_plan(graphs):
    g = graphs["uniform"]
    rows, cols, vals = _edges(g, "plus_times")
    with pytest.raises(ValueError):
        tpart.plan_partition(rows, cols, (g.n, g.n), (8, 1), "degree")
    plan = tpart.plan_partition(rows, cols, (g.n, g.n), (8, 1), "nnz")
    with pytest.raises(ValueError):
        tpart.partition(rows, cols, vals, (g.n, g.n), (2, 4), "csr", PLUS_TIMES, plan=plan,
                        device="cpu")
    with pytest.raises(ValueError):
        tpart.partition(rows, cols, vals, (g.n, g.n), (8, 1), "ell", PLUS_TIMES, device="cpu")


def test_partition_needs_a_device_or_a_card(graphs, monkeypatch):
    """Without a card and without ``device=`` the builder raises, never
    falls back to the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = graphs["uniform"]
    rows, cols, vals = _edges(g, "plus_times")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpart.partition(rows, cols, vals, (g.n, g.n), (8, 1), "csr", PLUS_TIMES)


@pytest.mark.parametrize("fmt", FMTS)
def test_partitioned_from_numpy_carries_jax_partition(graphs, fmt):
    """A JAX partition carried across with its plan equals the port's own
    partition of the same edges, leaf for leaf."""
    g = graphs["rmat"]
    rows, cols, vals = _edges(g, "plus_times")
    jpm = jpart.partition(rows, cols, vals, (g.n, g.n), (2, 4), fmt, J_PT, block=BLOCK,
                          balance="nnz")
    carried = convert.partitioned_from_numpy(
        jax_leaves(jpm), fmt, jpm.grid, jpm.shape, jpm.local_shape, plan_fields(jpm.plan),
        block=getattr(jpm.parts, "block", None),
        max_col_nnz=getattr(jpm.parts, "max_col_nnz", None), device="cpu")
    own = tpart.partition(rows, cols, vals, (g.n, g.n), (2, 4), fmt, PLUS_TIMES, block=BLOCK,
                          balance="nnz", device="cpu")
    assert_partitions_equal(carried, jpm)
    for f in dataclasses.fields(own.parts):
        a, b = getattr(own.parts, f.name), getattr(carried.parts, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name
