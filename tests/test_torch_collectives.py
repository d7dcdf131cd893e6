"""The port's Merge collectives and partition planner against the JAX
package: ``plan_merge`` (stages, fixups, ``n_steps``, ``wire_elements``)
for every topology, order and grid, 12 devices included; the merge
schedules on ``core.mesh.Mesh``'s virtual devices against the flat merge
and a numpy fold, bit for bit; the mesh primitives against their JAX
semantics; and the planner (``merge_wire_cost``, ``choose_merge``,
``estimate_phase_costs``, ``choose_partition``, ``plan_for_graph``,
``repair_choice``) equal to JAX's on the TABLE2 generators at a small
scale. All comparisons are exact."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import collectives as jcoll
from repro.graphs import cost_model as jcost
from repro.graphs import datasets as jdata
from repro_torch.core import collectives as tcoll
from repro_torch.core.delta import EdgeDelta
from repro_torch.core.mesh import Mesh
from repro_torch.core.semiring import MIN_PLUS, PLUS_AND, PLUS_TIMES
from repro_torch.graphs import cost_model as tcost
from repro_torch.graphs import datasets as tdata

MESHES = [(2, 4), (4, 3), (1, 6), (3, 1), (1, 12), (2, 2), (8, 8), (1, 1)]
TOPOLOGIES = [(t, o) for t in tcoll.MERGE_FAMILIES
              for o in (tcoll.STAGED_ORDERS if t == "staged2d" else ("rc",))]


def assert_merge_plans_equal(tp, jp):
    if jp is None:
        assert tp is None
        return
    assert (tp.topology, tp.axis_name, tp.axis_size, tp.fixup, tp.order) == \
        (jp.topology, jp.axis_name, jp.axis_size, jp.fixup, jp.order)
    assert [dataclasses.astuple(s) for s in tp.stages] == \
        [dataclasses.astuple(s) for s in jp.stages]
    assert tp.n_steps == jp.n_steps
    for m in (0, 1, 96, 1000.5, 34560):
        assert tp.wire_elements(m) == jp.wire_elements(m)


def test_prime_factors_equal_jax():
    for n in range(1, 200):
        assert tcoll.prime_factors(n) == jcoll.prime_factors(n)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("strategy", ["row", "col", "2d"])
def test_plan_merge_equals_jax(mesh, strategy):
    for topology, order in TOPOLOGIES:
        assert_merge_plans_equal(tcoll.plan_merge(strategy, mesh, topology, order=order),
                                 jcoll.plan_merge(strategy, mesh, topology, order=order))


def test_plan_merge_rejects_unknowns():
    for bad in (dict(topology="mesh"), dict(order="zz")):
        kw = {"topology": "flat", "order": "rc", **bad}
        with pytest.raises(ValueError):
            tcoll.plan_merge("col", (2, 4), kw["topology"], order=kw["order"])
    with pytest.raises(ValueError):
        tcoll.plan_merge("diag", (2, 4), "flat")


def _expected(y: np.ndarray, grid, strategy: str, sr) -> np.ndarray:
    """The ⊕-reduce-scatter's contract in numpy: device g ends with chunk g
    of the ⊕ over its merge group, folded in position order."""
    r, c = grid
    d = r * c
    fold = {"psum": np.add, "pmin": np.minimum}[sr.collective]
    if strategy == "col":
        acc = y[0]
        for g in range(1, d):
            acc = fold(acc, y[g])
        return acc.reshape(d, -1)
    yy = y.reshape(r, c, -1)
    out = []
    for ri in range(r):
        acc = yy[ri, 0]
        for ci in range(1, c):
            acc = fold(acc, yy[ri, ci])
        out.append(acc.reshape(c, -1))
    return np.concatenate(out)


@pytest.mark.parametrize("grid", [g for g in MESHES if g != (8, 8)])
@pytest.mark.parametrize("sr", [PLUS_TIMES, MIN_PLUS, PLUS_AND], ids=lambda s: s.name)
def test_every_topology_equals_flat_and_the_fold(grid, sr):
    """Integer-valued partials: every topology and ``merge_chunks`` give
    the flat merge's bits and the numpy fold; the batched ``axis=1`` merge
    equals the vector merge column by column."""
    mesh = Mesh(grid, device="cpu")
    rng = np.random.default_rng(sum(grid))
    for strategy in ("col", "2d"):
        d = mesh.n_devices if strategy == "col" else grid[1]
        y = rng.integers(0, 9, (mesh.n_devices, d * 5)).astype(np.float32)
        if sr.collective == "pmin":
            y[rng.random(y.shape) < 0.3] = np.inf
        y = torch.from_numpy(y).to(sr.dtype)
        want = torch.from_numpy(_expected(y.numpy(), grid, strategy, sr))
        for topology, order in TOPOLOGIES:
            mp = tcoll.plan_merge(strategy, grid, topology, order=order)
            tag = f"{strategy}/{topology}:{order}"
            assert torch.equal(tcoll.merge(mesh, y, sr, mp), want), tag
            assert torch.equal(tcoll.merge_chunks(mesh, y.view(mesh.n_devices, d, 5), sr, mp),
                               want), tag
            yb = torch.stack([y, y.flip(1)], dim=1)                      # [D, 2, d·5]
            got = tcoll.merge(mesh, yb, sr, mp, axis=1)
            assert torch.equal(got[:, 0], want), tag
            assert torch.equal(got[:, 1], tcoll.merge(mesh, y.flip(1), sr, mp)), tag


def test_flat_merge_folds_floats_in_device_order():
    """On float partials the flat merge is the left-to-right fold in
    sender order, the same bits on every call; the row strategy has no
    Merge."""
    mesh = Mesh((2, 4), device="cpu")
    y = torch.from_numpy(np.random.default_rng(0).random((8, 8 * 7)).astype(np.float32))
    mp = tcoll.plan_merge("col", (2, 4), "flat")
    got = tcoll.merge(mesh, y, PLUS_TIMES, mp)
    assert torch.equal(got, torch.from_numpy(_expected(y.numpy(), (2, 4), "col", PLUS_TIMES)))
    assert torch.equal(got, tcoll.merge(mesh, y.clone(), PLUS_TIMES, mp))
    assert tcoll.merge(mesh, y, PLUS_TIMES, tcoll.plan_merge("row", (2, 4), "flat")) is y


def test_mesh_primitives():
    mesh = Mesh((2, 3), device="cpu")
    x = torch.arange(6 * 2).view(6, 2)
    assert mesh.shape == {"dr": 2, "dc": 3} and mesh.n_devices == 6
    assert mesh.axis_index("dr").tolist() == [0, 0, 0, 1, 1, 1]
    assert mesh.axis_index("dc").tolist() == [0, 1, 2, 0, 1, 2]
    assert mesh.axis_index(("dr", "dc")).tolist() == list(range(6))
    # tiled all-gather over dr: device (r, c) gets devices (0, c), (1, c)
    g = mesh.all_gather(x, "dr")
    assert g[4].tolist() == [2, 3, 8, 9] and g[1].tolist() == [2, 3, 8, 9]
    assert mesh.all_gather(x, ("dr", "dc"))[0].tolist() == list(range(12))
    xb = torch.arange(6 * 2 * 2).view(6, 2, 2)
    assert mesh.all_gather(xb, "dc", dim=2)[3].tolist() == [[12, 13, 16, 17, 20, 21],
                                                             [14, 15, 18, 19, 22, 23]]
    # ppermute along dc: position 0 → 1 only; positions 0 and 2 receive zeros
    p = mesh.ppermute(x, "dc", [(0, 1)])
    assert p.tolist() == [[0, 0], [0, 1], [0, 0], [0, 0], [6, 7], [0, 0]]
    # all_to_all over dc: out[i][j] = chunk i of device j
    chunks = torch.arange(6 * 3).view(6, 3)
    assert mesh.all_to_all(chunks, "dc").tolist() == [[0, 3, 6], [1, 4, 7], [2, 5, 8],
                                                      [9, 12, 15], [10, 13, 16], [11, 14, 17]]
    assert mesh.take(chunks, torch.tensor([2, 1, 0, 0, 1, 2])).tolist() == [2, 4, 6, 9, 13, 17]
    assert torch.equal(mesh.flat_view(mesh.grid_view(x)), x)
    for bad in (lambda: mesh.all_gather(x[:5], "dr"), lambda: mesh.all_gather(x, "dx"),
                lambda: mesh.all_to_all(x, "dc"), lambda: Mesh((0, 2), device="cpu")):
        with pytest.raises(ValueError):
            bad()


@pytest.mark.parametrize("strategy", ["row", "col", "2d"])
@pytest.mark.parametrize("grid", [(2, 4), (4, 3), (1, 8), (8, 1)])
def test_merge_wire_cost_and_choose_merge_equal_jax(strategy, grid):
    for m in (1.0, 64.0, 4096.0, 1e6):
        for lw in ((1.0, 1.0), (1.0, 4.0), (3.0, 1.0)):
            for topology, order in TOPOLOGIES:
                assert tcost.merge_wire_cost(strategy, grid, m, topology, order, lw) == \
                    jcost.merge_wire_cost(strategy, grid, m, topology, order, lw)
            assert tcost.choose_merge(strategy, grid, m, lw) == \
                jcost.choose_merge(strategy, grid, m, lw)


def test_strategy_specs_equal_jax():
    for n_dev in (1, 6, 8, 12, 64):
        for strategy in ("row", "col", "2d"):
            assert tcost.strategy_grid(strategy, n_dev) == jcost.strategy_grid(strategy, n_dev)
    for spec in ("auto", "row", "2d:nnz", "col:rows"):
        assert tcost.parse_strategy(spec) == jcost.parse_strategy(spec)
        s, b = tcost.parse_strategy(spec)
        assert tcost.candidate_space(s, b) == jcost.candidate_space(s, b)
    for bad in (("diag",), ("row:skew",), ("row:rows", "nnz")):
        with pytest.raises(ValueError):
            tcost.parse_strategy(*bad)


def assert_choices_equal(tc, jc):
    assert (tc.strategy, tc.balance, tc.grid, tc.merge, tc.merge_order) == \
        (jc.strategy, jc.balance, tuple(jc.grid), jc.merge, jc.merge_order)
    assert tc.costs == jc.costs
    for f in dataclasses.fields(jc.plan):
        a, b = getattr(tc.plan, f.name), getattr(jc.plan, f.name)
        if b is None:
            assert a is None, f.name
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f.name)


GRAPHS = [("ca-Q", 0.1), ("cit-HP", 0.02), ("r-TX", 0.002), ("p2p-24", 0.05),
          ("as00", 0.1)]


@pytest.mark.parametrize("abbrev,scale", GRAPHS)
def test_planner_choice_equals_jax(abbrev, scale):
    """plan_for_graph on a TABLE2 generator: the PlannerChoice (strategy,
    balance, grid, plan, merge, the whole cost table) equals JAX's, for
    spmv and spmspv at 5%, on 8 and 12 devices."""
    tg, jg = tdata.generate(abbrev, scale, 0), jdata.generate(abbrev, scale, 0)
    assert np.array_equal(tg.rows, jg.rows) and np.array_equal(tg.cols, jg.cols)
    for n_dev, grid2d in ((8, None), (12, (4, 3))):
        for kernel, dens in (("spmv", 1.0), ("spmspv", 0.05)):
            assert_choices_equal(
                tcost.plan_for_graph(tg, n_devices=n_dev, grid2d=grid2d, kernel=kernel,
                                     frontier_density=dens),
                jcost.plan_for_graph(jg, n_devices=n_dev, grid2d=grid2d, kernel=kernel,
                                     frontier_density=dens))
    plan = tcost.plan_for_graph(tg).plan
    jplan = jcost.plan_for_graph(jg).plan
    for strategy in ("row", "col", "2d"):
        for merge in ("auto", "ring", "staged2d"):
            assert tcost.estimate_phase_costs(plan, strategy, "spmspv", 0.3, merge=merge) == \
                jcost.estimate_phase_costs(jplan, strategy, "spmspv", 0.3, merge=merge)


@pytest.mark.parametrize("max_imbalance", [100.0, 0.5])
def test_repair_choice_equals_jax(max_imbalance):
    """After an effective delta the patched plan (or, past the imbalance
    bound, the full replan) equals JAX's."""
    tg, jg = tdata.generate("cit-HP", 0.02, 0), jdata.generate("cit-HP", 0.02, 0)
    rng = np.random.default_rng(4)
    existing = set(zip(tg.rows.tolist(), tg.cols.tolist()))
    ins = [(int(a), int(b)) for a, b in rng.integers(0, tg.n, (64, 2))
           if a != b and (int(a), int(b)) not in existing]
    delta = EdgeDelta(np.array([a for a, _ in ins]), np.array([b for _, b in ins]),
                      tg.rows[:20], tg.cols[:20])
    tchoice, jchoice = tcost.plan_for_graph(tg), jcost.plan_for_graph(jg)
    t_new, t_re = tcost.repair_choice(tchoice, tg, delta, max_imbalance=max_imbalance)
    j_new, j_re = jcost.repair_choice(jchoice, jg, delta, max_imbalance=max_imbalance)
    assert t_re == j_re == (max_imbalance < 1.0)
    assert_choices_equal(t_new, j_new)
