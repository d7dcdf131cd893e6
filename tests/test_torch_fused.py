"""The port's fused tile kernels (fused SpMV, sell-C-σ SpMV, fused SpMSpV)
against the JAX package's Pallas kernels in interpret mode, on the same
seeded edge lists: each package builds its own matrices. On the CPU the
port runs each kernel's plain version (``kernels/ref.py``).

Exact for the integer and min semirings; ⟨+,×⟩ within rtol 1e-5, atol
1e-6, because the JAX kernel's dot and the plain version sum in other
orders."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.core import semiring as jsemiring
from repro.kernels import ops as jops
from repro_torch.core import formats as tformats
from repro_torch.core import semiring as tsemiring
from repro_torch.kernels import ops as tops
from repro_torch.kernels.semiring_spmv import (
    semiring_spmv_fused_padded, semiring_spmv_padded, semiring_spmv_sell,
)
from repro_torch.kernels.spmspv_tiles import (
    semiring_spmspv_fused_padded, semiring_spmspv_padded,
)

# the packages' __init__ re-export functions named like these modules
jspmspv = importlib.import_module("repro.core.spmspv")
jspmv = importlib.import_module("repro.core.spmv")
tspmspv = importlib.import_module("repro_torch.core.spmspv")
tspmv = importlib.import_module("repro_torch.core.spmv")

NAMES = list(tsemiring.SEMIRINGS)
BLOCKS = [(32, 32), (16, 16)]
N = 128
KERNELS = (semiring_spmv_padded, semiring_spmspv_padded, semiring_spmv_fused_padded,
           semiring_spmv_sell, semiring_spmspv_fused_padded)


def skewed_problem(name, seed=0, nnz=250):
    """A skewed edge list (dense top rows, empty bottom block rows, so rows
    have ragged tile counts and pads) and a finite, nonzero x of the
    semiring's type, in both packages' semirings."""
    rng = np.random.default_rng(seed)
    rows = (N * rng.random(nnz) ** 3).astype(np.int32)
    cols = (N * rng.random(nnz) ** 2).astype(np.int32)
    jsr, tsr = jsemiring.SEMIRINGS[name], tsemiring.SEMIRINGS[name]
    if tsr.dtype == torch.int32:
        vals = rng.integers(0, 3, nnz).astype(np.int32)
        x = rng.integers(1, 3, N).astype(np.int32)
    else:
        vals = rng.uniform(0.5, 4.0, nnz).astype(np.float32)
        x = rng.uniform(0.5, 4.0, N).astype(np.float32)
    return rows, cols, vals, x, jsr, tsr, rng


def assert_match(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if name == "plus_times":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunks", [None, 4])
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("name", NAMES)
def test_fused_and_sell_spmv_match_pallas(name, block, chunks):
    rows, cols, vals, x, jsr, tsr, _ = skewed_problem(name)
    ja = jformats.build_bsr_padded(rows, cols, vals, (N, N), jsr, block=block)
    ta = tformats.build_bsr_padded(rows, cols, vals, (N, N), tsr, block=block, device="cpu")
    js = jformats.build_sell(rows, cols, vals, (N, N), jsr, block=block, c=4)
    ts = tformats.build_sell(rows, cols, vals, (N, N), tsr, block=block, c=4, device="cpu")
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(tops._spmv_fused_meta(ta).numpy(),
                                  np.asarray(jops._spmv_fused_meta(ja)))
    got = tops.semiring_spmv_fused(ta, xt, tsr, chunks=chunks)
    assert_match(got, jops.semiring_spmv_fused(ja, x, jsr, interpret=True, chunks=chunks), name)
    got_sell = tops.semiring_spmv_sliced(ts, xt, tsr, chunks=chunks)
    assert_match(got_sell, jops.semiring_spmv_sliced(js, x, jsr, interpret=True, chunks=chunks),
                 name)
    # pad ⊗ x is the ⊕-identity here, so all three folds give kernel 1's rows
    y1 = tops.semiring_spmv(ta, xt, tsr)
    assert torch.equal(got.reshape(-1), y1) and torch.equal(got_sell.reshape(-1), y1)


@pytest.mark.parametrize("density", [0.05, 0.4])
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("name", NAMES)
def test_fused_spmspv_matches_pallas(name, block, density):
    rows, cols, vals, x, jsr, tsr, rng = skewed_problem(name, seed=1)
    xs = np.where(rng.random(N) < density, x, np.asarray(jsr.zero, x.dtype)).astype(x.dtype)
    ja = jformats.build_bsr_padded(rows, cols, vals, (N, N), jsr, block=block)
    ta = tformats.build_bsr_padded(rows, cols, vals, (N, N), tsr, block=block, device="cpu")
    jf = jspmspv.frontier_from_dense(xs, jsr)
    tf = tspmspv.frontier_from_dense(torch.from_numpy(xs), tsr)
    got = tops.semiring_spmspv_fused(ta, tf, tsr)
    assert_match(got, jops.semiring_spmspv_fused(ja, jf, jsr, interpret=True), name)
    assert torch.equal(got, tops.semiring_spmspv(ta, tf, tsr))
    assert torch.equal(tops.semiring_spmspv_fused(ta, tf, tsr, chunks=4), got.view(4, -1))


def pad_case(name):
    """64×64 at 8×8 tiles: block row 0 holds 7 tiles (tile-columns 1..7),
    block row 1 one tile at tile-column 3, the other six rows none. x's
    block 0 holds one entry whose product with a pad tile is NaN: inf under
    ⟨+,×⟩ (0 · inf), 0 under ⟨min,×⟩ (inf · 0)."""
    rows = np.array([r for r in range(8) for _ in range(7)] + [8, 12], np.int32)
    cols = np.array([8 * c + r for r in range(8) for c in range(1, 8)] + [24, 30], np.int32)
    rng = np.random.default_rng(7)
    vals = rng.uniform(0.5, 2.0, rows.shape[0]).astype(np.float32)
    x = np.ones(64, np.float32)
    x[2] = np.inf if name == "plus_times" else 0.0
    return rows, cols, vals, x


@pytest.mark.parametrize("name", ["plus_times", "min_times"])
def test_pad_products_differ_as_on_the_tpu(name):
    """Where pad ⊗ x is not the ⊕-identity the three kernels compute
    different functions: kernel 1 folds every pad against x's block 0 (7
    rows of NaN), kernel 3 streams one pad slot for each empty row (6 rows),
    sell kernel 4 streams nothing for an empty row (none). The port
    reproduces each TPU kernel entry by entry."""
    rows, cols, vals, x = pad_case(name)
    jsr, tsr = jsemiring.SEMIRINGS[name], tsemiring.SEMIRINGS[name]
    ja = jformats.build_bsr_padded(rows, cols, vals, (64, 64), jsr, block=(8, 8))
    ta = tformats.build_bsr_padded(rows, cols, vals, (64, 64), tsr, block=(8, 8), device="cpu")
    js = jformats.build_sell(rows, cols, vals, (64, 64), jsr, block=(8, 8), c=4)
    ts = tformats.build_sell(rows, cols, vals, (64, 64), tsr, block=(8, 8), c=4, device="cpu")
    assert ta.slots == 7
    xt = torch.from_numpy(x)
    pairs = [(tops.semiring_spmv(ta, xt, tsr), jops.semiring_spmv(ja, x, jsr, interpret=True)),
             (tops.semiring_spmv_fused(ta, xt, tsr),
              jops.semiring_spmv_fused(ja, x, jsr, interpret=True)),
             (tops.semiring_spmv_sliced(ts, xt, tsr),
              jops.semiring_spmv_sliced(js, x, jsr, interpret=True))]
    for (got, want), n_nan in zip(pairs, (56, 48, 0)):
        got, want = got.numpy(), np.asarray(want)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert int(np.isnan(got).sum()) == n_nan
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["bool_or_and", "min_plus", "plus_times"])
def test_fused_impl_dispatch_matches_jax(name):
    """spmv/spmspv with impl="fused" and spmv on a BSRMatrix, through the
    packages' own dispatch."""
    rows, cols, vals, x, jsr, tsr, rng = skewed_problem(name, seed=2)
    ja = jformats.build_bsr_padded(rows, cols, vals, (N, N), jsr, block=(16, 16))
    ta = tformats.build_bsr_padded(rows, cols, vals, (N, N), tsr, block=(16, 16), device="cpu")
    xt = torch.from_numpy(x)
    assert_match(tspmv.spmv(ta, xt, tsr, impl="fused"), jspmv.spmv(ja, x, jsr, impl="fused"), name)
    xs = np.where(rng.random(N) < 0.2, x, np.asarray(jsr.zero, x.dtype)).astype(x.dtype)
    jf = jspmspv.frontier_from_dense(xs, jsr)
    tf = tspmspv.frontier_from_dense(torch.from_numpy(xs), tsr)
    assert_match(tspmspv.spmspv(ta, tf, tsr, impl="fused"),
                 jspmspv.spmspv(ja, jf, jsr, impl="fused"), name)
    jb = jformats.build_bsr(rows, cols, vals, (N, N), jsr, block=(16, 16), t_max=80)
    tb = tformats.build_bsr(rows, cols, vals, (N, N), tsr, block=(16, 16), t_max=80,
                            device="cpu")
    assert_match(tspmv.spmv(tb, xt, tsr), jspmv.spmv(jb, jnp.asarray(x), jsr), name)


def test_cpu_tensors_launch_no_kernel_and_chunks_are_checked():
    rows, cols, vals, x, _, tsr, rng = skewed_problem("min_plus", seed=3)
    ta = tformats.build_bsr_padded(rows, cols, vals, (N, N), tsr, block=(32, 32), device="cpu")
    ts = tformats.build_sell(rows, cols, vals, (N, N), tsr, block=(32, 32), c=4, device="cpu")
    tf = tspmspv.frontier_from_dense(torch.from_numpy(x), tsr)
    xt = torch.from_numpy(x)
    before = [k.launches for k in KERNELS]
    tops.semiring_spmv_fused(ta, xt, tsr)
    tops.semiring_spmv_sliced(ts, xt, tsr, chunks=2)
    tops.semiring_spmspv_fused(ta, tf, tsr, chunks=4)
    assert [k.launches for k in KERNELS] == before
    for call in (lambda: tops.semiring_spmv_fused(ta, xt, tsr, chunks=3),
                 lambda: tops.semiring_spmv_sliced(ts, xt, tsr, chunks=0),
                 lambda: tops.semiring_spmspv_fused(ta, tf, tsr, chunks=5)):
        with pytest.raises(ValueError, match="chunks"):
            call()
    with pytest.raises(ValueError, match="slot_total"):
        semiring_spmv_sell(ts.tiles[None], ts.tile_cols, ts.row_meta, xt, sr=tsr)
    with pytest.raises(ValueError, match="row_meta"):
        semiring_spmv_sell(ts.tiles, ts.tile_cols, ts.row_meta.long(), xt, sr=tsr)
    with pytest.raises(ValueError, match="tile_cols"):
        semiring_spmv_sell(ts.tiles, ts.tile_cols[1:], ts.row_meta, xt, sr=tsr)
    with pytest.raises(TypeError):
        semiring_spmv_sell(ts.tiles, ts.tile_cols, ts.row_meta, xt.double(), sr=tsr)
