"""The port's tile SpMV/SpMSpV front door against the JAX package's Pallas
kernels (interpret mode), on literally the same matrix: the JAX
PaddedBSR's arrays are carried across with ``repro_torch.convert``. On the
CPU the port runs each kernel's plain version (``kernels/ref.py``).

Exact for the integer and min semirings; ⟨+,×⟩ within rtol 1e-5, atol 1e-6,
because the JAX kernel's dot and the plain version sum in other orders."""
import importlib

import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.core import semiring as jsemiring
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import semiring as tsemiring
from repro_torch.core.spmv import spmv
from repro_torch.kernels import ops as tops

# the packages' __init__ re-export functions named like these modules
jspmspv = importlib.import_module("repro.core.spmspv")
jspmv = importlib.import_module("repro.core.spmv")
tspmspv = importlib.import_module("repro_torch.core.spmspv")

NAMES = list(tsemiring.SEMIRINGS)
BLOCKS = [(128, 128), (16, 16)]
FRONTIERS = ["empty", "tiny", "half", "full"]
N = 300


def problem(name, block, seed=0):
    """One random matrix in both packages plus a dense x of the semiring's
    type (min semirings use +inf as the absent value)."""
    rng = np.random.default_rng(seed)
    nnz = 2000
    rows = rng.integers(0, N, nnz).astype(np.int32)
    cols = rng.integers(0, N, nnz).astype(np.int32)
    jsr, tsr = jsemiring.SEMIRINGS[name], tsemiring.SEMIRINGS[name]
    if tsr.dtype == torch.int32:
        vals = rng.integers(0, 2, nnz).astype(np.int32)
        x = rng.integers(0, 3, N).astype(np.int32)
    else:
        vals = rng.uniform(0.5, 4.0, nnz).astype(np.float32)
        x = rng.uniform(0.5, 4.0, N).astype(np.float32)
    ja = jformats.build_bsr_padded(rows, cols, vals, (N, N), jsr, block=block)
    ta = convert.padded_bsr_from_numpy(np.asarray(ja.tiles), np.asarray(ja.tile_cols),
                                       ja.shape, ja.block, device="cpu")
    return ja, ta, x, rng


def padded(x, n, zero):
    return np.concatenate([x, np.full(n - x.shape[0], zero, x.dtype)])


def assert_match(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype
    if name == "plus_times":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("name", NAMES)
def test_spmv_matches_pallas(name, block):
    ja, ta, x, _ = problem(name, block)
    jsr, tsr = jsemiring.SEMIRINGS[name], tsemiring.SEMIRINGS[name]
    xp = padded(x, ja.shape[1], jsr.zero)
    want = jops.semiring_spmv(ja, xp, jsr, interpret=True)
    got = tops.semiring_spmv(ta, torch.from_numpy(xp), tsr)
    assert_match(got, want, name)
    assert_match(spmv(ta, torch.from_numpy(xp), tsr, impl="ref"), want, name)


@pytest.mark.parametrize("frontier", FRONTIERS)
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("name", NAMES)
def test_spmspv_and_meta_match_pallas(name, block, frontier):
    ja, ta, x, rng = problem(name, block, seed=1)
    jsr, tsr = jsemiring.SEMIRINGS[name], tsemiring.SEMIRINGS[name]
    keep = {"empty": np.zeros(N, bool), "tiny": np.arange(N) == 37,
            "half": rng.random(N) < 0.5, "full": np.ones(N, bool)}[frontier]
    xs = np.where(keep, x, np.asarray(jsr.zero, x.dtype)).astype(x.dtype)
    jf = jspmspv.frontier_from_dense(xs, jsr)
    tf = tspmspv.frontier_from_dense(torch.from_numpy(xs), tsr)
    np.testing.assert_array_equal(tf.indices.numpy(), np.asarray(jf.indices))
    np.testing.assert_array_equal(tf.values.numpy(), np.asarray(jf.values))
    assert int(tf.count) == int(jf.count)
    np.testing.assert_array_equal(tops._spmspv_meta(ta, tf, tsr).numpy(),
                                  np.asarray(jops._spmspv_meta(ja, jf, jsr)))
    want = jops.semiring_spmspv(ja, jf, jsr, interpret=True)
    assert_match(tops.semiring_spmspv(ta, tf, tsr), want, name)


@pytest.mark.parametrize("f_max", [1, 7, 64])
def test_capped_frontier_matches(f_max):
    """A capacity below the live count truncates the frontier identically."""
    _, _, x, _ = problem("min_plus", (16, 16))
    jf = jspmspv.frontier_from_dense(x, jsemiring.MIN_PLUS, f_max=f_max)
    tf = tspmspv.frontier_from_dense(torch.from_numpy(x), tsemiring.MIN_PLUS, f_max=f_max)
    np.testing.assert_array_equal(tf.indices.numpy(), np.asarray(jf.indices))
    np.testing.assert_array_equal(tf.values.numpy(), np.asarray(jf.values))
    assert int(tf.count) == int(jf.count)
    np.testing.assert_array_equal(tf.to_dense(tsemiring.MIN_PLUS).numpy(),
                                  np.asarray(jf.to_dense(jsemiring.MIN_PLUS)))


def test_spmv_folds_pad_tiles():
    """Kernel 1 folds every slot, pads included: under ⟨+,×⟩ a pad's 0 times
    an inf in x's first column block is NaN, in both packages."""
    ja, ta, x, _ = problem("plus_times", (16, 16), seed=2)
    jsr, tsr = jsemiring.PLUS_TIMES, tsemiring.PLUS_TIMES
    xp = padded(x, ja.shape[1], 0.0)
    xp[3] = np.inf
    want = np.asarray(jops.semiring_spmv(ja, xp, jsr, interpret=True))
    got = tops.semiring_spmv(ta, torch.from_numpy(xp), tsr).numpy()
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_element_formats_match_jax(name):
    """COO/CSR SpMV and the CSC/CSR/COO SpMSpV variants against the JAX ones."""
    from repro_torch.core import formats as tformats
    from repro_torch.core.spmspv import spmspv

    rng = np.random.default_rng(3)
    rows = rng.integers(0, N, 1500).astype(np.int32)
    cols = rng.integers(0, N, 1500).astype(np.int32)
    jsr, tsr = jsemiring.SEMIRINGS[name], tsemiring.SEMIRINGS[name]
    vals = (rng.integers(1, 3, 1500) if tsr.dtype == torch.int32
            else rng.uniform(0.5, 4.0, 1500)).astype(np.dtype(jsr.dtype))
    x = np.where(rng.random(N) < 0.3, rng.integers(1, 4, N), 0).astype(np.dtype(jsr.dtype))
    if jsr.collective == "pmin":
        x = np.where(x == 0, np.inf, x).astype(np.float32)
    jf = jspmspv.frontier_from_dense(x, jsr)
    tf = tspmspv.frontier_from_dense(torch.from_numpy(x), tsr)
    for fmt in ("coo", "csr", "csc"):
        jm = getattr(jformats, f"build_{fmt}")(rows, cols, vals, (N, N), jsr)
        tm = getattr(tformats, f"build_{fmt}")(rows, cols, vals, (N, N), tsr, device="cpu")
        if fmt != "csc":
            assert_match(spmv(tm, torch.from_numpy(x), tsr),
                         jspmv.spmv(jm, x, jsr), name)
        assert_match(spmspv(tm, tf, tsr), jspmspv.spmspv(jm, jf, jsr), name)


@pytest.mark.parametrize("name", NAMES)
def test_semiring_ops_match_jax(name):
    """add_reduce, segment_reduce (empty segments come back as zero) and
    the dense matvec oracle."""
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    jsr, tsr = jsemiring.SEMIRINGS[name], tsemiring.SEMIRINGS[name]
    dt = np.dtype(jsr.dtype)
    data = rng.integers(0, 5, 40).astype(dt)
    seg = rng.integers(0, 12, 40).astype(np.int32)
    seg[seg == 4] = 5                                  # segment 4 stays empty
    seg[:3] = 12                                       # out of range: dropped
    want = jsr.segment_reduce(jnp.asarray(data), jnp.asarray(seg), 12)
    got = tsr.segment_reduce(torch.from_numpy(data), torch.from_numpy(seg), 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[4].item() == tsr.zero
    a = rng.integers(0, 3, (6, 9)).astype(dt)
    v = rng.integers(0, 3, 9).astype(dt)
    np.testing.assert_array_equal(tsr.matvec(torch.from_numpy(a), torch.from_numpy(v)).numpy(),
                                  np.asarray(jsr.matvec(jnp.asarray(a), jnp.asarray(v))))
    np.testing.assert_array_equal(tsr.add_reduce(torch.from_numpy(a), 0).numpy(),
                                  np.asarray(jsr.add_reduce(jnp.asarray(a), 0)))
    assert tsr.mxu_eligible == jsr.mxu_eligible
