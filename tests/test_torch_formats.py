"""The port's builders, generators and cost model against the JAX package:
same edge lists in, element-for-element equal arrays out."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.core import semiring as jsemiring
from repro.graphs import cost_model as jcost
from repro.graphs import datasets as jdatasets
from repro.graphs import engine as jengine
from repro_torch import convert
from repro_torch.core import formats as tformats
from repro_torch.core import semiring as tsemiring
from repro_torch.graphs import cost_model as tcost
from repro_torch.graphs import datasets as tdatasets
from repro_torch.graphs import engine as tengine

NAMES = list(tsemiring.SEMIRINGS)


def edge_list(name, seed=0, n=300, nnz=2500):
    """Random edges with duplicates (so the builders' ⊕-folds are exercised)
    and values of the semiring's type."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, nnz).astype(np.int32)
    cols = rng.integers(0, n, nnz).astype(np.int32)
    rows[: nnz // 10] = rows[nnz // 10: 2 * (nnz // 10)]     # duplicate coordinates
    cols[: nnz // 10] = cols[nnz // 10: 2 * (nnz // 10)]
    if tsemiring.SEMIRINGS[name].dtype == torch.int32:
        vals = rng.integers(0, 3, nnz).astype(np.int32)
    else:
        vals = rng.uniform(0.1, 5.0, nnz).astype(np.float32)
    return rows, cols, vals, (n, n)


def assert_same(port, jax_container, fields):
    got = convert.to_numpy(port)
    for f in fields:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jax_container, f)), err_msg=f)
    assert tuple(got["shape"]) == tuple(jax_container.shape)


@pytest.mark.parametrize("name", sorted(jsemiring.SEMIRINGS))
def test_semiring_get_matches_jax(name):
    """``semiring.get`` finds each of the reference's five names, with the
    reference's identities, type and collective."""
    jsr, tsr = jsemiring.get(name), tsemiring.get(name)
    assert tsr is tsemiring.SEMIRINGS[name] and tsr.name == jsr.name == name
    assert (tsr.zero, tsr.one, tsr.collective) == (jsr.zero, jsr.one, jsr.collective)
    assert str(tsr.dtype).removeprefix("torch.") == np.dtype(jsr.dtype).name


def test_semiring_get_rejects_an_unknown_name():
    with pytest.raises(KeyError):
        tsemiring.get("max_plus")
    with pytest.raises(KeyError):
        jsemiring.get("max_plus")


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("fmt", ["coo", "csr", "csc"])
def test_element_builders_match_jax(name, fmt):
    rows, cols, vals, shape = edge_list(name)
    jsr, tsr = jsemiring.SEMIRINGS[name], tsemiring.SEMIRINGS[name]
    jm = getattr(jformats, f"build_{fmt}")(rows, cols, vals, shape, jsr)
    tm = getattr(tformats, f"build_{fmt}")(rows, cols, vals, shape, tsr, device="cpu")
    fields = {"coo": ["rows", "cols", "vals"], "csr": ["row_ptr", "cols", "vals", "seg_ids"],
              "csc": ["col_ptr", "rows", "vals"]}[fmt]
    assert_same(tm, jm, fields)
    assert tm.nnz == int(jm.nnz)
    if fmt == "csc":
        assert tm.max_col_nnz == jm.max_col_nnz


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("block", [(128, 128), (16, 16), (8, 32)])
def test_padded_bsr_matches_jax(name, block):
    rows, cols, vals, shape = edge_list(name, seed=1)
    jsr, tsr = jsemiring.SEMIRINGS[name], tsemiring.SEMIRINGS[name]
    jm = jformats.build_bsr_padded(rows, cols, vals, shape, jsr, block=block)
    tm = tformats.build_bsr_padded(rows, cols, vals, shape, tsr, block=block, device="cpu")
    assert_same(tm, jm, ["tiles", "tile_cols"])
    assert tm.block == jm.block
    assert tm.tiles.dtype == tsr.dtype


def test_padded_bsr_explicit_slots_and_empty_rows():
    sr = tsemiring.MIN_PLUS
    rows, cols = np.array([0, 0, 40], np.int32), np.array([1, 70, 3], np.int32)
    vals = np.array([2.0, 3.0, 4.0], np.float32)
    jm = jformats.build_bsr_padded(rows, cols, vals, (100, 100), jsemiring.MIN_PLUS,
                                   block=(16, 16), slots=4)
    tm = tformats.build_bsr_padded(rows, cols, vals, (100, 100), sr, block=(16, 16),
                                   slots=4, device="cpu")
    assert_same(tm, jm, ["tiles", "tile_cols"])
    with pytest.raises(ValueError, match="slots"):
        tformats.build_bsr_padded(rows, cols, vals, (100, 100), sr, block=(16, 16),
                                  slots=1, device="cpu")


@pytest.mark.parametrize("name", ["bool_or_and", "plus_times"])
def test_convert_round_trips(name):
    rows, cols, vals, shape = edge_list(name, seed=2)
    jsr = jsemiring.SEMIRINGS[name]
    jb = jformats.build_bsr_padded(rows, cols, vals, shape, jsr, block=(16, 16))
    tb = convert.padded_bsr_from_numpy(np.asarray(jb.tiles), np.asarray(jb.tile_cols),
                                       jb.shape, jb.block, device="cpu")
    assert_same(tb, jb, ["tiles", "tile_cols"])
    assert tb.block == jb.block
    jc = jformats.build_coo(rows, cols, vals, shape, jsr)
    tc = convert.coo_from_numpy(np.asarray(jc.rows), np.asarray(jc.cols), np.asarray(jc.vals),
                                jc.nnz, jc.shape, device="cpu")
    assert_same(tc, jc, ["rows", "cols", "vals"])
    jr = jformats.build_csr(rows, cols, vals, shape, jsr)
    tr = convert.csr_from_numpy(np.asarray(jr.row_ptr), np.asarray(jr.cols), np.asarray(jr.vals),
                                np.asarray(jr.seg_ids), jr.nnz, jr.shape, device="cpu")
    assert_same(tr, jr, ["row_ptr", "cols", "vals", "seg_ids"])
    js = jformats.build_csc(rows, cols, vals, shape, jsr)
    ts = convert.csc_from_numpy(np.asarray(js.col_ptr), np.asarray(js.rows), np.asarray(js.vals),
                                js.nnz, js.shape, js.max_col_nnz, device="cpu")
    assert_same(ts, js, ["col_ptr", "rows", "vals"])
    assert ts.max_col_nnz == js.max_col_nnz


@pytest.mark.parametrize("abbrev,scale,seed", [
    ("face", 0.15, 1), ("ca-Q", 0.12, 2), ("r-TX", 0.01, 0), ("A302", 0.01, 3),
    ("cit-HP", 0.05, 0),
])
def test_generators_give_identical_edge_lists(abbrev, scale, seed):
    jg = jdatasets.generate(abbrev, scale=scale, seed=seed)
    tg = tdatasets.generate(abbrev, scale=scale, seed=seed)
    assert (tg.n, tg.name) == (jg.n, jg.name)
    np.testing.assert_array_equal(tg.rows, jg.rows)
    np.testing.assert_array_equal(tg.cols, jg.cols)
    assert tg.fingerprint() == jg.fingerprint()
    assert tdatasets.largest_component_source(tg) == jdatasets.largest_component_source(jg)
    assert dataclasses.astuple(tg.features()) == dataclasses.astuple(jg.features())


def test_trained_stump_is_equal():
    assert dataclasses.asdict(tcost.trained_stump()) == dataclasses.asdict(jcost.trained_stump())
    tf, tl = tcost.training_corpus(3)
    jf, jl = jcost.training_corpus(3)
    assert tl == jl
    assert [dataclasses.astuple(f) for f in tf] == [dataclasses.astuple(f) for f in jf]


@pytest.mark.parametrize("abbrev", ["r-TX", "face", "g-18", "s-S11"])
def test_stump_classes_and_thresholds_match(abbrev):
    g = tdatasets.generate(abbrev, scale=0.05, seed=3)
    jg = jdatasets.generate(abbrev, scale=0.05, seed=3)
    ts, js = tcost.trained_stump(), jcost.trained_stump()
    assert ts.classify(g.features()) == js.classify(jg.features())
    assert ts.switch_threshold(g.features()) == js.switch_threshold(jg.features())


@pytest.mark.parametrize("kw", [dict(weighted=False), dict(weighted=True, seed=5),
                                dict(weighted=True, content_keyed=True, seed=7),
                                dict(weighted=False, normalize=True)])
def test_edge_values_match(kw):
    jg = jdatasets.generate("face", scale=0.05, seed=0)
    tg = tdatasets.generate("face", scale=0.05, seed=0)
    for name in ("bool_or_and", "min_plus", "plus_times"):
        np.testing.assert_array_equal(
            tengine.edge_values(tg, tsemiring.SEMIRINGS[name], **kw),
            jengine.edge_values(jg, jsemiring.SEMIRINGS[name], **kw))
