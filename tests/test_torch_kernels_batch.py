"""Kernels 1 and 2 over a [B, n] block: the port's plain versions
(``kernels/ref.py``, the CPU path of ``semiring_spmv_padded_batch`` and
``semiring_spmspv_padded_batch``) and its block front door
(``ops.semiring_spmv_batch``, ``ops.semiring_spmspv_batch``) against
``jax.vmap`` of the JAX package's Pallas kernels in interpret mode, which is
what its multi-source traversals run on the tile route. Five semirings at
16×16 tiles, on literally the same matrix (the JAX PaddedBSR's arrays are
carried across with ``repro_torch.convert``); B = 1, 3 and 5, with an
all-⊕-identity row.

Exact for the integer and min semirings; ⟨+,×⟩ within rtol 1e-5, atol 1e-6
(the Pallas kernel's dot and the plain version sum in other orders)."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.core import semiring as jsemiring
from repro.kernels import ops as jops
from repro.kernels.semiring_spmv import semiring_spmv_padded as j_spmv_padded
from repro.kernels.spmspv_tiles import semiring_spmspv_padded as j_spmspv_padded
from repro_torch import convert
from repro_torch.core import semiring as tsemiring
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref
from repro_torch.kernels.semiring_spmv import semiring_spmv_padded_batch
from repro_torch.kernels.spmspv_tiles import semiring_spmspv_padded_batch

jspmspv = importlib.import_module("repro.core.spmspv")
tspmspv = importlib.import_module("repro_torch.core.spmspv")

NAMES = list(tsemiring.SEMIRINGS)
N = 300


def problem(name, b, seed=0):
    """One random matrix at 16×16 tiles in both packages and a block xs
    [b, n_pad] of the semiring's type, about 30% live, row 0 all ⊕-identity."""
    rng = np.random.default_rng(seed)
    nnz = 2000
    rows = rng.integers(0, N, nnz).astype(np.int32)
    cols = rng.integers(0, N, nnz).astype(np.int32)
    jsr, tsr = jsemiring.SEMIRINGS[name], tsemiring.SEMIRINGS[name]
    if tsr.dtype == torch.int32:
        vals = rng.integers(0, 2, nnz).astype(np.int32)
    else:
        vals = rng.uniform(0.5, 4.0, nnz).astype(np.float32)
    ja = jformats.build_bsr_padded(rows, cols, vals, (N, N), jsr, block=(16, 16))
    ta = convert.padded_bsr_from_numpy(np.asarray(ja.tiles), np.asarray(ja.tile_cols),
                                       ja.shape, ja.block, device="cpu")
    n_pad = ja.shape[1]
    if tsr.dtype == torch.int32:
        xs = rng.integers(1, 3, (b, n_pad)).astype(np.int32)
    else:
        xs = rng.uniform(0.5, 4.0, (b, n_pad)).astype(np.float32)
    xs[rng.random((b, n_pad)) > 0.3] = jsr.zero
    xs[0] = jsr.zero
    return ja, ta, xs


def assert_match(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if name == "plus_times":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("b", [1, 3, 5])
@pytest.mark.parametrize("name", NAMES)
def test_spmv_block_plain_matches_vmapped_pallas(name, b):
    ja, ta, xs = problem(name, b)
    jsr, tsr = jsemiring.SEMIRINGS[name], tsemiring.SEMIRINGS[name]
    want = jax.vmap(lambda x: j_spmv_padded(ja.tiles, ja.tile_cols, x, sr=jsr,
                                            interpret=True))(jnp.asarray(xs))
    got = semiring_spmv_padded_batch(ta.tiles, ta.tile_cols, torch.from_numpy(xs), sr=tsr)
    assert_match(got, want, name)
    # row b is the single-vector plain version on xs[b], bit for bit
    for i in range(b):
        assert torch.equal(got[i], ref.spmv_padded_ref(ta.tiles, ta.tile_cols,
                                                       torch.from_numpy(xs[i]), tsr))
    assert_match(tops.semiring_spmv_batch(ta, torch.from_numpy(xs), tsr), want, name)


@pytest.mark.parametrize("b", [1, 3, 5])
@pytest.mark.parametrize("name", NAMES)
def test_spmspv_block_plain_matches_vmapped_pallas(name, b):
    """Each row's meta from the JAX package's ``_spmspv_meta`` on its own
    frontier equals the port's ``_spmspv_meta_batch`` row; kernel 2 over
    the block equals the vmapped Pallas kernel on those metas."""
    ja, ta, xs = problem(name, b, seed=1)
    jsr, tsr = jsemiring.SEMIRINGS[name], tsemiring.SEMIRINGS[name]
    fronts = [jspmspv.frontier_from_dense(jnp.asarray(x[:N]), jsr) for x in xs]
    jmeta = jnp.stack([jops._spmspv_meta(ja, f, jsr) for f in fronts])
    jx = jnp.stack([jnp.pad(f.to_dense(jsr), (0, ja.shape[1] - N), constant_values=jsr.zero)
                    for f in fronts])
    want = jax.vmap(lambda m, x: j_spmspv_padded(ja.tiles, m, x, sr=jsr, interpret=True))(
        jmeta, jx)
    keep, xd = tops._frontier_block(ta, torch.from_numpy(xs[:, :N]), tsr, None)
    meta = tops._spmspv_meta_batch(ta, keep)
    np.testing.assert_array_equal(meta.numpy(), np.asarray(jmeta))
    np.testing.assert_array_equal(xd.numpy(), np.asarray(jx))
    got = semiring_spmspv_padded_batch(ta.tiles, meta, xd, sr=tsr)
    assert_match(got, want, name)
    for i in range(b):
        assert torch.equal(got[i], ref.spmspv_padded_ref(ta.tiles, meta[i], xd[i], tsr))
    assert_match(tops.semiring_spmspv_batch(ta, torch.from_numpy(xs[:, :N]), tsr), want, name)


@pytest.mark.parametrize("f_max", [1, 7, 40])
@pytest.mark.parametrize("name", ["bool_or_and", "min_plus", "plus_times"])
def test_spmspv_block_capacity_matches_jax_frontiers(name, f_max):
    """A capacity-f_max frontier keeps each row's first f_max live entries,
    as the JAX package's ``frontier_from_dense`` does: the block front door
    equals JAX's ``semiring_spmspv`` row by row."""
    ja, ta, xs = problem(name, 3, seed=2)
    jsr, tsr = jsemiring.SEMIRINGS[name], tsemiring.SEMIRINGS[name]
    got = tops.semiring_spmspv_batch(ta, torch.from_numpy(xs[:, :N]), tsr, f_max=f_max)
    for i in range(3):
        f = jspmspv.frontier_from_dense(jnp.asarray(xs[i, :N]), jsr, f_max=f_max)
        assert_match(got[i], jops.semiring_spmspv(ja, f, jsr, interpret=True), name)


def test_block_wrappers_on_cpu_launch_nothing_and_check_operands():
    _, ta, xs = problem("min_plus", 2)
    sr = tsemiring.MIN_PLUS
    x = torch.from_numpy(xs)
    before = (semiring_spmv_padded_batch.launches, semiring_spmspv_padded_batch.launches)
    semiring_spmv_padded_batch(ta.tiles, ta.tile_cols, x, sr=sr)
    tops.semiring_spmspv_batch(ta, x[:, :N], sr)
    assert (semiring_spmv_padded_batch.launches,
            semiring_spmspv_padded_batch.launches) == before
    with pytest.raises(ValueError, match="index"):
        semiring_spmv_padded_batch(ta.tiles, ta.tile_cols[:, :-1].contiguous(), x, sr=sr)
    with pytest.raises(TypeError):
        semiring_spmv_padded_batch(ta.tiles, ta.tile_cols, x, sr=sr, nb=4)   # no knob left
    with pytest.raises(ValueError, match=r"\[B, n\]"):
        semiring_spmv_padded_batch(ta.tiles, ta.tile_cols, x[0], sr=sr)
    with pytest.raises(TypeError):
        semiring_spmv_padded_batch(ta.tiles, ta.tile_cols, x.double(), sr=sr)
    with pytest.raises(ValueError, match="contiguous"):
        semiring_spmv_padded_batch(ta.tiles, ta.tile_cols, x.t().contiguous().t(), sr=sr)
    with pytest.raises(ValueError, match="multiple of bn"):
        semiring_spmv_padded_batch(ta.tiles, ta.tile_cols, x[:, :-3].contiguous(), sr=sr)
    meta = tops._spmspv_meta_batch(ta, x != sr.zero)
    with pytest.raises(ValueError, match="index"):
        semiring_spmspv_padded_batch(ta.tiles, meta[:1], x, sr=sr)
    with pytest.raises(ValueError, match="xs must be"):
        tops.semiring_spmv_batch(ta, x[:, :N], sr)
    empty = semiring_spmv_padded_batch(ta.tiles, ta.tile_cols, x[:0], sr=sr)
    assert tuple(empty.shape) == (0, ta.shape[0])


@pytest.mark.parametrize("name", ["bool_or_and", "plus_times"])
def test_core_batch_entry_points_match_single(name):
    """core.spmv.spmv_batch and core.spmspv.spmspv_batch on PaddedBSR, with
    impl "auto", "ref" and "fused": row b equals the single-vector call."""
    from repro_torch.core import spmspv_batch, spmv, spmv_batch

    _, ta, xs = problem(name, 3, seed=3)
    tsr = tsemiring.SEMIRINGS[name]
    x = torch.from_numpy(xs)
    for impl in ("auto", "ref", "fused"):
        ys = spmv_batch(ta, x, tsr, impl=impl)
        yf = spmspv_batch(ta, x[:, :N], tsr, f_max=50, impl=impl)
        for i in range(3):
            assert torch.equal(ys[i], spmv(ta, x[i], tsr, impl=impl))
            f = tspmspv.frontier_from_dense(x[i, :N], tsr, f_max=50)
            assert torch.equal(yf[i], tspmspv.spmspv(ta, f, tsr, impl=impl))
