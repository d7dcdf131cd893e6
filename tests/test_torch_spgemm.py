"""The port's masked SpGEMM (``repro_torch.core.spgemm``, the tile SpGEMM's
wrapper, operand preparation and plain version) against the JAX package on
the same seeded inputs, at ``tests/test_spgemm.py``'s sizes (37×52×29,
16×16 tiles). Matrices are built by the JAX builders and carried across
with ``repro_torch.convert``. The JAX side, including the Pallas kernel in
interpret mode, runs once per module.

Also kernel 6's decomposition as its CUDA kernel folds it
(``ref.spgemm_pad_row_ref``: each block row's real slots, then the pad row
P for its pad slots) against the plain version and the JAX package's
``semiring_spgemm_ref`` at 16×16 and 64×64, with NaN pads and a negative
row under tile-column 0; P and the group sizes on hand-built cases.

Exact for the integer and min semirings; ⟨+,×⟩ within rtol 1e-5, atol
1e-6, because the JAX dot and the port sum in other orders (the
decomposition against the plain version: exact, NaN where NaN, as both
reduce a slot alike)."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.core import semiring as jsemiring
from repro.kernels import ops as jops
from repro.kernels.spgemm_tiles import semiring_spgemm_padded as jkernel
from repro_torch import convert
from repro_torch.core import semiring as tsemiring
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import spgemm_binary, spgemm_tiles
from repro_torch.kernels.spgemm_binary import semiring_spgemm_binary
from repro_torch.kernels.spgemm_tiles import semiring_spgemm_padded

# the packages' __init__ re-export functions named like these modules
jspgemm = importlib.import_module("repro.core.spgemm")
tspgemm = importlib.import_module("repro_torch.core.spgemm")

NAMES = list(tsemiring.SEMIRINGS)
N, K, M = 37, 52, 29
BLOCK = (16, 16)
CASES = [(name, masked) for name in NAMES for masked in (True, False)]
CASE_IDS = [f"{name}-{'masked' if masked else 'unmasked'}" for name, masked in CASES]


def make_problem(name, masked, seed=7, density=0.12):
    """(a_dense, b_dense, mask, edge list) in the semiring's safe domain
    (min_times operands stay strictly positive), as tests/test_spgemm.py
    builds them."""
    sr = jsemiring.SEMIRINGS[name]
    rng = np.random.default_rng(seed)
    mask_a = rng.random((N, K)) < density
    mask_m = rng.random((N, M)) < 0.4
    if sr.collective == "pmin":
        a = np.where(mask_a, rng.integers(1, 9, (N, K)).astype(np.float32), np.inf)
        b = rng.integers(1, 9, (K, M)).astype(np.float32)
        mask = np.where(mask_m, 1.0, np.inf).astype(np.float32)
    elif sr.dtype == jnp.int32:
        a = mask_a.astype(np.int32)
        b = (rng.random((K, M)) < 0.4).astype(np.int32)
        mask = mask_m.astype(np.int32)
    else:
        a = np.where(mask_a, rng.random((N, K)).astype(np.float32), 0.0).astype(np.float32)
        b = rng.random((K, M)).astype(np.float32)
        mask = mask_m.astype(np.float32)
    rows, cols = np.nonzero(mask_a)
    vals = a[rows, cols].astype(np.dtype(sr.dtype))
    return a, b, mask if masked else None, (rows.astype(np.int32), cols.astype(np.int32), vals)


def padded_operands(sr, bsr, b, mask):
    """B padded to the tile matrix's K with ⊗-identity rows and the mask to
    its M with ⊕-identity rows, as tests/test_spgemm.py pads them."""
    bp = np.full((bsr.shape[1], M), sr.one, dtype=np.dtype(sr.dtype))
    bp[:K] = b
    if mask is None:
        return bp, None
    mp = np.full((bsr.shape[0], M), sr.zero, dtype=np.dtype(sr.dtype))
    mp[:N] = mask
    return bp, mp


def jarr(x, sr):
    return None if x is None else jnp.asarray(x, sr.dtype)


def tten(x):
    return None if x is None else torch.from_numpy(np.array(x))


def assert_match(got, want, name):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if name == "plus_times":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, equal_nan=True)
    else:
        np.testing.assert_array_equal(got, want)


# Kernel 6's decomposition: a skewed 150 × 140 A (ragged block rows, so
# pad slots, and block rows with none real at 16×16), B [K, 120] and a
# mask of density 0.4 or none; "pad-nan" puts inf (⟨+,×⟩) or 0 (⟨min,×⟩)
# in every 7th column of B's row 3, under tile-column 0, where a pad's
# products are NaN; "neg-row" puts -1 there for ⟨+,∧⟩ (B in 0..8), where
# a pad adds min(0, -1) per pad slot.
PN, PK, PM = 150, 140, 120
PAD_ROW_CASES = ([(name, bm, variant) for name in NAMES for bm in (16, 64)
                  for variant in ("masked", "unmasked")]
                 + [(name, bm, "pad-nan") for name in ("plus_times", "min_times")
                    for bm in (16, 64)]
                 + [("plus_and", bm, "neg-row") for bm in (16, 64)])
PAD_ROW_IDS = ["-".join(map(str, case)) for case in PAD_ROW_CASES]


def pad_row_problem(name, bm, variant, seed=5):
    """(rows, cols, vals, b, mask or None) for a PAD_ROW_CASES case, in the
    semiring's safe domain but for the NaN and negative rows."""
    sr = jsemiring.SEMIRINGS[name]
    rng = np.random.default_rng(seed)
    nnz = 700
    rows = (PN * rng.random(nnz) ** 3).astype(np.int32)
    cols = rng.integers(0, PK, nnz).astype(np.int32)
    cols[rows >= 100] %= 50        # the last rows in k-block 0 only, so pads at 64×64
    mask_m = rng.random((PN, PM)) < 0.4
    if sr.collective == "pmin":
        vals = rng.integers(1, 9, nnz).astype(np.float32)
        b = rng.integers(1, 9, (PK, PM)).astype(np.float32)
        mask = np.where(mask_m, 1.0, np.inf).astype(np.float32)
    elif sr.dtype == jnp.int32:
        vals = np.ones(nnz, np.int32)
        b = rng.integers(0, 9, (PK, PM)).astype(np.int32)
        mask = mask_m.astype(np.int32)
    else:
        vals = rng.random(nnz).astype(np.float32)
        b = rng.random((PK, PM)).astype(np.float32)
        mask = mask_m.astype(np.float32)
    if variant == "pad-nan":
        b[3, ::7] = np.inf if name == "plus_times" else 0.0
    if variant == "neg-row":
        b[3, ::7] = -1
    return rows, cols, vals, b, None if variant == "unmasked" else mask


def pad_row_operands(sr, bsr, b, mask):
    """B padded with ⊗-identity rows to the tile matrix's K, the mask with
    ⊕-identity rows to its M."""
    bp = np.full((bsr.shape[1], PM), sr.one, dtype=np.dtype(sr.dtype))
    bp[:PK] = b
    if mask is None:
        return bp, None
    mp = np.full((bsr.shape[0], PM), sr.zero, dtype=np.dtype(sr.dtype))
    mp[:PN] = mask
    return bp, mp


@pytest.fixture(scope="module")
def jax_side():
    """Per case: the problem, the JAX oracle, the JAX tile matrix with its
    padded operands, the JAX `_spgemm_operands` and the Pallas kernel's
    output in interpret mode; per PAD_ROW_CASES case the tile matrix, its
    padded operands and the JAX package's ``semiring_spgemm_ref``."""
    out = {}
    for name, masked in CASES:
        sr = jsemiring.SEMIRINGS[name]
        a, b, mask, (rows, cols, vals) = make_problem(name, masked)
        oracle = np.asarray(jspgemm.spgemm_dense_ref(jarr(a, sr), jarr(b, sr), sr, jarr(mask, sr)))
        bsr = jformats.build_bsr_padded(rows, cols, vals, (N, K), sr, block=BLOCK)
        bp, mp = padded_operands(sr, bsr, b, mask)
        ops_in = jops._spgemm_operands(bsr, jarr(bp, sr), sr, jarr(mp, sr))
        jb, jm, jmeta, bn, n = ops_in
        kernel = np.asarray(jkernel(bsr.tiles, jmeta, jb, jm, sr=sr, bn=bn, interpret=True))
        out[name, masked] = {
            "problem": (a, b, mask, (rows, cols, vals)), "oracle": oracle, "bsr": bsr,
            "padded": (bp, mp), "operands": [np.asarray(x) for x in (jb, jm, jmeta)] + [bn, n],
            "kernel": kernel,
            "coo": jformats.build_coo(rows, cols, vals, (N, K), sr),
            "csr": jformats.build_csr(rows, cols, vals, (N, K), sr),
        }
    for case in PAD_ROW_CASES:
        name, bm, variant = case
        sr = jsemiring.SEMIRINGS[name]
        rows, cols, vals, b, mask = pad_row_problem(*case)
        bsr = jformats.build_bsr_padded(rows, cols, vals, (PN, PK), sr, block=(bm, bm))
        bp, mp = pad_row_operands(sr, bsr, b, mask)
        out["pad_row", *case] = {
            "bsr": bsr, "padded": (bp, mp),
            "oracle": np.asarray(jops.semiring_spgemm_ref(bsr, jarr(bp, sr), sr, jarr(mp, sr)))}
    return out


def port_bsr(jb):
    return convert.padded_bsr_from_numpy(np.asarray(jb.tiles), np.asarray(jb.tile_cols),
                                         jb.shape, jb.block, device="cpu")


@pytest.mark.parametrize("name,masked", CASES, ids=CASE_IDS)
def test_element_and_blocked_paths_match_jax(jax_side, name, masked, monkeypatch):
    case = jax_side[name, masked]
    sr = tsemiring.SEMIRINGS[name]
    a, b, mask, _ = case["problem"]
    at, bt, mt = tten(a), tten(b), tten(mask)
    assert_match(tspgemm.spgemm_dense_ref(at, bt, sr, mt), case["oracle"], name)
    assert_match(tspgemm.spgemm_blocked(at, bt, sr, mt, block_k=16), case["oracle"], name)
    assert_match(tspgemm.spgemm_masked(at, bt, sr, mt), case["oracle"], name)
    # several row slabs per K-block in the non-dot semirings
    monkeypatch.setattr(tspgemm, "_BROADCAST_ELEMS", 16 * M * 5)
    assert_match(tspgemm.spgemm_blocked(at, bt, sr, mt, block_k=16), case["oracle"], name)
    jc, jr = case["coo"], case["csr"]
    coo = convert.coo_from_numpy(np.asarray(jc.rows), np.asarray(jc.cols), np.asarray(jc.vals),
                                 jc.nnz, jc.shape, device="cpu")
    csr = convert.csr_from_numpy(np.asarray(jr.row_ptr), np.asarray(jr.cols), np.asarray(jr.vals),
                                 np.asarray(jr.seg_ids), jr.nnz, jr.shape, device="cpu")
    for sp in (coo, csr):
        assert_match(tspgemm.spgemm_masked(sp, bt, sr, mt), case["oracle"], name)


@pytest.mark.parametrize("name,masked", CASES, ids=CASE_IDS)
def test_spgemm_operands_match_jax(jax_side, name, masked):
    case = jax_side[name, masked]
    sr = tsemiring.SEMIRINGS[name]
    bp, mp = case["padded"]
    bt, mt, meta, bn, n = tops._spgemm_operands(port_bsr(case["bsr"]), tten(bp), sr, tten(mp))
    jb, jm, jmeta, jbn, jn = case["operands"]
    assert (bn, n) == (jbn, jn)
    for got, want in ((bt, jb), (mt, jm), (meta, jmeta)):
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.numpy().dtype == want.dtype


@pytest.mark.parametrize("name,masked", CASES, ids=CASE_IDS)
def test_bsr_paths_match_jax_and_the_pallas_kernel(jax_side, name, masked, monkeypatch):
    """The wrapper on CPU tensors (its plain version) and ``impl="ref"``
    against the dense oracle, and the plain version against the Pallas
    kernel in interpret mode on the same padded operands; also with the
    plain version's tile chunks cut to two tiles."""
    case = jax_side[name, masked]
    sr = tsemiring.SEMIRINGS[name]
    bsr = port_bsr(case["bsr"])
    bp, mp = case["padded"]
    for impl in ("ref", "auto"):
        got = tspgemm.spgemm_masked(bsr, tten(bp), sr, tten(mp), impl=impl)
        assert got.shape == (bsr.shape[0], M)
        assert_match(got[:N], case["oracle"], name)
    jb, jm, jmeta, bn, _ = case["operands"]
    plain = semiring_spgemm_padded(bsr.tiles, tten(jmeta), tten(jb), tten(jm), sr=sr, bn=bn)
    assert_match(plain, case["kernel"], name)
    monkeypatch.setattr(tref, "SPGEMM_BROADCAST_BYTES", 2 * 16 ** 3 * 4)
    assert_match(tref.spgemm_padded_ref(bsr.tiles, tten(jmeta), tten(jb), tten(jm), sr, bn),
                 case["kernel"], name)


@pytest.mark.parametrize("name", ["plus_times", "min_times"])
def test_pad_products_give_nan_as_the_pallas_kernel(name):
    """A pad tile aliases tile-column 0 and holds the ⊕-identity. Where B's
    rows under tile-column 0 hold inf (⟨+,×⟩: 0·inf) or 0 (⟨min,×⟩: inf·0),
    every active output tile of a block row with a pad slot is NaN in those
    columns: the kernel folds pads, as the TPU kernel does. Block row 2
    holds pads only, so a kernel that skipped them would leave it the
    ⊕-identity."""
    jsr, tsr = jsemiring.SEMIRINGS[name], tsemiring.SEMIRINGS[name]
    # block row 0 fills all four tile-columns, block row 1 only tile-column
    # 2, block row 2 (rows 32..36) is empty: all pads
    rows = np.array([0, 1, 2, 3, 20], np.int32)
    cols = np.array([1, 17, 33, 49, 40], np.int32)
    vals = np.full(5, 2.0, np.float32)
    bsr = jformats.build_bsr_padded(rows, cols, vals, (N, K), jsr, block=BLOCK)
    rng = np.random.default_rng(1)
    b = rng.integers(1, 9, (bsr.shape[1], M)).astype(np.float32)
    b[3, 5] = np.inf if name == "plus_times" else 0.0
    mask = np.full((bsr.shape[0], M), 1.0, np.float32)
    jb, jm, jmeta, bn, n = jops._spgemm_operands(bsr, jnp.asarray(b), jsr, jnp.asarray(mask))
    want = np.asarray(jkernel(bsr.tiles, jmeta, jb, jm, sr=jsr, bn=bn, interpret=True))
    got = semiring_spgemm_padded(port_bsr(bsr).tiles, tten(jmeta), tten(jb), tten(jm), sr=tsr,
                                 bn=bn)
    nan = np.isnan(want)
    # column 5 of every row: the background of the real tiles meets b[3, 5]
    # in block row 0, pads do in block rows 1 and 2
    assert nan.sum() == bsr.shape[0] and nan[:, 5].all()
    assert_match(got, want, name)
    got = tops.semiring_spgemm(port_bsr(bsr), torch.from_numpy(b), tsr, torch.from_numpy(mask))
    np.testing.assert_array_equal(np.isnan(got.numpy()), nan[:, :M])


def test_mask_skips_entries():
    """Structural masking: entries outside the mask collapse to the
    ⊕-identity even where the unmasked product is nonzero."""
    sr = tsemiring.PLUS_TIMES
    ones = torch.ones((8, 8))
    mask = torch.zeros((8, 8))
    mask[2, 3] = 1.0
    c = tspgemm.spgemm_blocked(ones, ones, sr, mask, block_k=4)
    assert c[2, 3] == 8.0
    c[2, 3] = 0.0
    assert (c == 0).all()


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    sr = tsemiring.PLUS_AND
    a, b, mask, (rows, cols, vals) = make_problem("plus_and", True, seed=3)
    bsr = port_bsr(jformats.build_bsr_padded(rows, cols, vals, (N, K),
                                             jsemiring.PLUS_AND, block=BLOCK))
    bp, mp = padded_operands(jsemiring.PLUS_AND, bsr, b, mask)
    before = semiring_spgemm_padded.launches, semiring_spgemm_binary.launches
    got = tops.semiring_spgemm(bsr, tten(bp), sr, tten(mp))
    assert (semiring_spgemm_padded.launches, semiring_spgemm_binary.launches) == before
    assert torch.equal(got, tops.semiring_spgemm_ref(bsr, tten(bp), sr, tten(mp)))


def test_wrapper_rejects_bad_operands():
    sr = tsemiring.MIN_PLUS
    mb, t, bm = 2, 3, 16
    tiles = torch.zeros((mb, t, bm, bm))
    b = torch.zeros((4 * bm, 2 * bm))
    mask = torch.zeros((mb * bm, 2 * bm))
    meta = torch.zeros((mb, t + 2), dtype=torch.int32)
    semiring_spgemm_padded(tiles, meta, b, mask, sr=sr, bn=bm)
    with pytest.raises(ValueError, match="meta"):
        semiring_spgemm_padded(tiles, meta[:, :-1].contiguous(), b, mask, sr=sr, bn=bm)
    with pytest.raises(ValueError, match="meta"):
        semiring_spgemm_padded(tiles, meta.long(), b, mask, sr=sr, bn=bm)
    with pytest.raises(TypeError):
        semiring_spgemm_padded(tiles.int(), meta, b, mask, sr=sr, bn=bm)
    with pytest.raises(TypeError):
        semiring_spgemm_padded(tiles, meta, b, mask.double(), sr=sr, bn=bm)
    with pytest.raises(ValueError, match="bn = bm"):
        semiring_spgemm_padded(tiles, meta, b, mask, sr=sr, bn=8)
    big = torch.zeros((1, 1, 160, 160))
    with pytest.raises(ValueError, match="bn = bm"):
        semiring_spgemm_padded(big, torch.zeros((1, 2), dtype=torch.int32),
                               torch.zeros((160, 160)), torch.zeros((160, 160)), sr=sr, bn=160)
    with pytest.raises(ValueError, match="bn = bm"):
        semiring_spgemm_padded(torch.zeros((1, 1, 16, 130)), torch.zeros((1, 2), dtype=torch.int32),
                               torch.zeros((130, 16)), torch.zeros((16, 16)), sr=sr, bn=16)
    with pytest.raises(ValueError, match="b must be"):
        semiring_spgemm_padded(tiles, meta, b[:, :24].contiguous(), mask, sr=sr, bn=bm)
    with pytest.raises(ValueError, match="mask must be"):
        semiring_spgemm_padded(tiles, meta, b, mask[:16], sr=sr, bn=bm)
    with pytest.raises(ValueError, match="contiguous"):
        semiring_spgemm_padded(tiles.transpose(2, 3), meta, b, mask, sr=sr, bn=bm)
    with pytest.raises(ValueError, match="tiles must be"):
        semiring_spgemm_padded(tiles[0], meta, b, mask, sr=sr, bn=bm)
    with pytest.raises(ValueError, match="b has"):
        tops.semiring_spgemm(convert.padded_bsr_from_numpy(
            np.zeros((2, 3, 16, 16), np.float32), np.zeros((2, 3), np.int32), (32, 64),
            (16, 16), device="cpu"), torch.zeros((48, 5)), sr)


@pytest.mark.parametrize("name,bm,variant", PAD_ROW_CASES, ids=PAD_ROW_IDS)
def test_pad_row_decomposition_matches_plain_and_jax(jax_side, name, bm, variant):
    """Real slots densely, then P once per pad slot (``spgemm_pad_row_ref``)
    equals the plain version, which folds every slot, exactly (NaN where
    NaN), and the JAX package's ``semiring_spgemm_ref`` (⟨+,×⟩ within rtol
    1e-5, atol 1e-6). The problem has pad slots, at 16×16 block rows with
    none real; NaN and the negative row reach the output only through the
    pads."""
    case = jax_side["pad_row", name, bm, variant]
    sr = tsemiring.SEMIRINGS[name]
    bsr = port_bsr(case["bsr"])
    bp, mp = case["padded"]
    b, mk, meta, bn, n = tops._spgemm_operands(bsr, tten(bp), sr, tten(mp))
    t = bsr.tiles.shape[1]
    n_real = tref.ell_n_real(meta[:, :t])
    assert int(n_real.min()) < t                                  # pad slots exist
    got = tref.spgemm_pad_row_ref(bsr.tiles, meta, b, mk, sr, bn)
    plain = tref.spgemm_padded_ref(bsr.tiles, meta, b, mk, sr, bn)
    torch.testing.assert_close(got, plain, rtol=0, atol=0, equal_nan=True)
    if variant in ("masked", "unmasked"):
        assert torch.equal(got, plain)
    if variant == "pad-nan":
        assert bool(torch.isnan(got).any())
    assert_match(got[:, :n], case["oracle"], name)


def test_pad_row_by_hand():
    """P[c] = ⊕_{k<bk} (zero ⊗ b[k, c]) over B's first bk rows, per
    semiring: ±0 or NaN under ⟨+,×⟩, +inf or NaN under ⟨min,+⟩ and ⟨min,×⟩
    (-inf where b < 0), Σ min(0, b) under ⟨+,∧⟩, max over k of min(0, b)
    under ⟨∨,∧⟩. Row 2 lies past bk = 2 and is not read."""
    inf, nan = float("inf"), float("nan")
    b = torch.tensor([[1.0, inf, -2.0, 0.0], [3.0, 4.0, nan, -inf], [nan, nan, nan, nan]])
    got = {name: tref.pad_row(b.to(sr.dtype) if sr.dtype == torch.float32 else
                              torch.tensor([[1, 5, -2, 0], [3, 4, -7, -1], [-9, -9, -9, -9]],
                                           dtype=torch.int32), sr, 2)
           for name, sr in tsemiring.SEMIRINGS.items()}
    np.testing.assert_array_equal(got["plus_times"].numpy(), [0.0, nan, nan, nan])
    np.testing.assert_array_equal(got["min_plus"].numpy(), [inf, inf, nan, nan])
    np.testing.assert_array_equal(got["min_times"].numpy(), [inf, inf, nan, nan])
    assert got["plus_and"].tolist() == [0, 0, -9, -1]
    assert got["bool_or_and"].tolist() == [0, 0, -2, 0]
    assert all(p.dtype == tsemiring.SEMIRINGS[k].dtype and p.is_contiguous()
               for k, p in got.items())


def test_kernel6_groups_and_group_size():
    """Kernel 6's group sizes: 256 output columns up to 64 rows, one tile
    above. Its CUDA blocks group a block row's active tiles as
    ``spgemm_binary.group_tiles`` does: on a random flag pattern every
    active tile lies in exactly one group,
    each group holds up to G consecutive active tiles of one block row, the
    groups with a tile go by their first tile-column, then block row, and
    the empty ones (count 0) go last."""
    assert [spgemm_tiles.group_size(bm) for bm in (1, 16, 24, 32, 48, 64, 65, 128)] == \
        [16, 16, 8, 8, 4, 4, 1, 1]
    rng = np.random.default_rng(2)
    t, mb, nb = 3, 9, 23
    flags = torch.from_numpy((rng.random((mb, nb)) < 0.6).astype(np.int32))
    flags[4] = 0
    meta = torch.cat([torch.zeros((mb, t), dtype=torch.int32), flags], dim=1)
    for g in (1, 4, 16):
        active, groups = spgemm_binary.group_tiles(meta, t, g)
        q = -(-nb // g)
        assert active.shape == (mb * q * g, 2) and groups.shape == (mb * q, 2)
        counts = groups[:, 1]
        n_full = int((counts > 0).sum())
        assert (counts[:n_full] > 0).all() and (counts[n_full:] == 0).all()
        tiles, keys = [], []
        for first, count in groups[:n_full].tolist():
            assert 1 <= count <= g and first % g == 0
            part = active[first:first + count]
            assert len(set(part[:, 0].tolist())) == 1
            cols = part[:, 1].tolist()
            assert cols == sorted(cols) and min(cols) >= 0
            tiles += part.tolist()
            keys.append((cols[0], int(part[0, 0])))
        assert sorted(tiles) == torch.nonzero(flags).tolist()
        assert keys == sorted(keys)

