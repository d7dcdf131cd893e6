"""The tensor-core SpGEMM for 0/1 operands (``kernels/spgemm_binary.py``,
the variant of kernel 6 that ``ops.semiring_spgemm`` takes for ⟨+,∧⟩ and
⟨∨,∧⟩ on 0/1 values at blocks that are multiples of 16) against the JAX
package's Pallas ``semiring_spgemm_padded`` in interpret mode and against
kernel 6's plain version, on the same seeded inputs. Also the front
door's choice between the two, the int8 packing, the grouping of the
active tiles, the work and bytes count, and the triangle count on the
CPU. Matrices are built by the JAX builder and carried across with
``repro_torch.convert``; the JAX side runs once per module.

Everything here is exact (``np.testing.assert_array_equal`` and
``torch.equal``): the values are integers."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import formats as jformats
from repro.core import semiring as jsemiring
from repro.kernels import ops as jops
from repro.kernels.spgemm_tiles import semiring_spgemm_padded as jkernel
from repro_torch import convert
from repro_torch.core import build_bsr_padded
from repro_torch.core import semiring as tsemiring
from repro_torch.kernels import ops, ref, spgemm_binary
from repro_torch.kernels.spgemm_binary import semiring_spgemm_binary
from repro_torch.kernels.spgemm_tiles import semiring_spgemm_padded

NAMES = ["plus_and", "bool_or_and"]
BLOCKS = [16, 32, 64, 128]
MASKS = ["masked", "ones", "none"]
CASES = [(name, bm, mk) for name in NAMES for bm in BLOCKS for mk in MASKS]
CASE_IDS = [f"{name}-{bm}-{mk}" for name, bm, mk in CASES]


def make_problem(bm: int, mask_mode: str, seed: int = 11):
    """A 0/1 matrix of n = 3·bm + 7 rows (4 block rows) and k = 4·bm + 3
    columns (5 k-blocks): block row 0 fills every k-block, block row 1
    one, block row 2 none (pads only), block row 3 three, so the rows are
    ragged. B [k, m] 0/1 of density 0.4 with m = 2·bm + 9 (3 tile
    columns); a mask of density 0.4 whose tile (1, 2) is empty, all ones,
    or None."""
    rng = np.random.default_rng(seed + bm)
    n, k, m = 3 * bm + 7, 4 * bm + 3, 2 * bm + 9
    dense = np.zeros((n, k), bool)
    for lo, hi, kblocks in ((0, bm, range(5)), (bm, 2 * bm, [3]), (3 * bm, n, [0, 2, 4])):
        for kb in kblocks:
            sub = dense[lo:hi, kb * bm:min((kb + 1) * bm, k)]
            sub |= rng.random(sub.shape) < 0.3
            sub[rng.integers(sub.shape[0]), rng.integers(sub.shape[1])] = True
    rows, cols = np.nonzero(dense)
    b = (rng.random((k, m)) < 0.4).astype(np.int32)
    if mask_mode == "none":
        mask = None
    elif mask_mode == "ones":
        mask = np.ones((n, m), np.int32)
    else:
        mask = (rng.random((n, m)) < 0.4).astype(np.int32)
        mask[bm:2 * bm, 2 * bm:] = 0
    return (n, k, m), (rows.astype(np.int32), cols.astype(np.int32)), b, mask


def padded(sr, bsr, b, mask, m):
    """B padded to the tile matrix's K with ⊗-identity rows, the mask to
    its M with ⊕-identity rows."""
    bp = np.full((bsr.shape[1], m), sr.one, np.int32)
    bp[:b.shape[0]] = b
    if mask is None:
        return bp, None
    mp = np.full((bsr.shape[0], m), sr.zero, np.int32)
    mp[:mask.shape[0]] = mask
    return bp, mp


def port_bsr(jb):
    return convert.padded_bsr_from_numpy(np.asarray(jb.tiles), np.asarray(jb.tile_cols),
                                         jb.shape, jb.block, device="cpu")


def tten(x):
    return None if x is None else torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def jax_side():
    """Per case: the JAX tile matrix, the padded B and mask, the JAX
    ``_spgemm_operands`` and the Pallas kernel's output in interpret mode."""
    out = {}
    for name, bm, mk in CASES:
        sr = jsemiring.SEMIRINGS[name]
        (n, k, m), (rows, cols), b, mask = make_problem(bm, mk)
        bsr = jformats.build_bsr_padded(rows, cols, np.ones(rows.shape[0], np.int32), (n, k),
                                        sr, block=(bm, bm))
        bp, mp = padded(sr, bsr, b, mask, m)
        jb, jm, jmeta, bn, nn = jops._spgemm_operands(
            bsr, jnp.asarray(bp), sr, None if mp is None else jnp.asarray(mp))
        kernel = np.asarray(jkernel(bsr.tiles, jmeta, jb, jm, sr=sr, bn=bn, interpret=True))
        out[name, bm, mk] = {"bsr": bsr, "padded": (bp, mp), "n": nn, "kernel": kernel,
                             "operands": [np.asarray(x) for x in (jb, jm, jmeta)] + [bn]}
    return out


def test_problems_have_ragged_rows_and_a_row_with_no_real_tile():
    for bm in BLOCKS:
        (n, k, _), (rows, cols), _, _ = make_problem(bm, "masked")
        a = build_bsr_padded(rows, cols, np.ones(rows.shape[0], np.int32), (n, k),
                             tsemiring.PLUS_AND, block=(bm, bm), device="cpu")
        real = (a.tiles != 0).flatten(2).any(dim=2).sum(dim=1).tolist()
        assert real == [5, 1, 0, 3]
        assert ref.ell_n_real(a.tile_cols).tolist() == [5, 1, 1, 3]


@pytest.mark.parametrize("name,bm,mk", CASES, ids=CASE_IDS)
def test_plain_version_matches_the_pallas_kernel_and_kernel_6(jax_side, name, bm, mk):
    """The variant's plain version (the wrapper on CPU tensors) equals the
    Pallas kernel in interpret mode and kernel 6's plain version on the
    same padded operands; the front door, which takes the variant here,
    equals the Pallas kernel's columns."""
    case = jax_side[name, bm, mk]
    sr = tsemiring.SEMIRINGS[name]
    bsr = port_bsr(case["bsr"])
    jb, jm, jmeta, bn = case["operands"]
    got = semiring_spgemm_binary(bsr.tiles, tten(jmeta), tten(jb), tten(jm), sr=sr, bn=bn)
    np.testing.assert_array_equal(got.numpy(), case["kernel"])
    assert torch.equal(got, ref.spgemm_padded_ref(bsr.tiles, tten(jmeta), tten(jb), tten(jm),
                                                   sr, bn))
    bp, mp = case["padded"]
    assert ops._binary_operands(bsr, tten(bp), sr)
    front = ops.semiring_spgemm(bsr, tten(bp), sr, tten(mp))
    np.testing.assert_array_equal(front.numpy(), case["kernel"][:, :case["n"]])


def test_plain_version_with_chunks_of_two_tiles(jax_side, monkeypatch):
    """The plain version cut into chunks of two active tiles gives the same
    result (its chunk loop and per-chunk slot count)."""
    case = jax_side["plus_and", 16, "masked"]
    bsr = port_bsr(case["bsr"])
    jb, jm, jmeta, bn = case["operands"]
    monkeypatch.setattr(ref, "SPGEMM_BROADCAST_BYTES", 2 * 3 * 16 * 16 * 8)
    got = ref.spgemm_binary_ref(bsr.tiles, tten(jmeta), tten(jb), tten(jm),
                                tsemiring.PLUS_AND, bn)
    np.testing.assert_array_equal(got.numpy(), case["kernel"])


@pytest.fixture
def spy(monkeypatch):
    """Records which wrapper the front door calls."""
    calls = []

    def wrap(fn, label):
        def call(*args, **kw):
            calls.append(label)
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(ops, "semiring_spgemm_binary", wrap(semiring_spgemm_binary, "binary"))
    monkeypatch.setattr(ops, "semiring_spgemm_padded", wrap(semiring_spgemm_padded, "kernel6"))
    return calls


def dispatch_problem(sr, block, b_values=(0, 1), a_value=1, seed=5):
    rng = np.random.default_rng(seed)
    n, k, m = 70, 90, 50
    dense = rng.random((n, k)) < 0.15
    dense[40:56] = False                  # block rows with no real tile
    rows, cols = np.nonzero(dense)
    vals = np.full(rows.shape[0], a_value, np.dtype(str(sr.dtype).split(".")[1]))
    a = build_bsr_padded(rows.astype(np.int32), cols.astype(np.int32), vals, (n, k), sr,
                         block=block, device="cpu")
    b = torch.from_numpy(rng.choice(np.asarray(b_values), (a.shape[1], m))).to(sr.dtype)
    mask = torch.zeros((a.shape[0], m), dtype=sr.dtype)
    mask[:n] = torch.from_numpy((rng.random((n, m)) < 0.5)).to(sr.dtype)
    return a, b, mask


@pytest.mark.parametrize("name", NAMES)
def test_dispatch_takes_the_variant_for_0_1_operands(spy, name):
    sr = tsemiring.SEMIRINGS[name]
    a, b, mask = dispatch_problem(sr, (16, 32))
    got = ops.semiring_spgemm(a, b, sr, mask)
    assert spy == ["binary"]
    bp, mk, meta, bn, n = ops._spgemm_operands(a, b, sr, mask)
    assert torch.equal(got, ref.spgemm_padded_ref(a.tiles, meta, bp, mk, sr, bn)[:, :n])


@pytest.mark.parametrize("where", ["a", "b"])
def test_dispatch_takes_kernel_6_for_a_2(spy, where):
    sr = tsemiring.PLUS_AND
    if where == "a":
        a, b, mask = dispatch_problem(sr, (16, 16), a_value=2)
    else:
        a, b, mask = dispatch_problem(sr, (16, 16), b_values=(0, 1, 2))
    got = ops.semiring_spgemm(a, b, sr, mask)
    assert spy == ["kernel6"]
    assert torch.equal(got, ops.semiring_spgemm_ref(a, b, sr, mask))


def test_dispatch_takes_kernel_6_for_a_negative_row_under_tile_column_0(spy):
    """A negative value in B's first bk rows meets every pad tile (pads
    alias tile-column 0): min(0, -1) = -1 is not the ⊕-identity, so the
    pads are part of the function there and skipping them would differ."""
    sr = tsemiring.PLUS_AND
    a, b, mask = dispatch_problem(sr, (16, 16))
    b[3, ::3] = -1
    got = ops.semiring_spgemm(a, b, sr, mask)
    assert spy == ["kernel6"]
    bp, mk, meta, bn, n = ops._spgemm_operands(a, b, sr, mask)
    want = ref.spgemm_padded_ref(a.tiles, meta, bp, mk, sr, bn)
    assert torch.equal(got, want[:, :n])
    assert not torch.equal(ref.spgemm_binary_ref(a.tiles, meta, bp, mk, sr, bn), want)


@pytest.mark.parametrize("block", [(24, 24), (16, 24), (24, 16)])
def test_dispatch_takes_kernel_6_off_the_16_grid(spy, block):
    sr = tsemiring.PLUS_AND
    a, b, mask = dispatch_problem(sr, block)
    got = ops.semiring_spgemm(a, b, sr, mask)
    assert spy == ["kernel6"]
    assert torch.equal(got, ops.semiring_spgemm_ref(a, b, sr, mask))
    with pytest.raises(ValueError, match="multiples of 16"):
        bp, mk, meta, bn, _ = ops._spgemm_operands(a, b, sr, mask)
        semiring_spgemm_binary(a.tiles, meta, bp, mk, sr=sr, bn=bn)


@pytest.mark.parametrize("name", ["plus_times", "min_plus", "min_times"])
def test_dispatch_takes_kernel_6_for_float_semirings(spy, name):
    """0/1 values under a float semiring: ⊗ is not ∧, so kernel 6."""
    sr = tsemiring.SEMIRINGS[name]
    a, b, mask = dispatch_problem(sr, (16, 16))
    if sr.collective == "pmin":
        mask = torch.where(mask != 0, 1.0, float("inf"))
    ops.semiring_spgemm(a, b, sr, mask)
    assert spy == ["kernel6"]
    assert not ops._binary_operands(a, ops._spgemm_operands(a, b, sr, mask)[0], sr)


def test_pack_keeps_a_and_transposes_b():
    rng = np.random.default_rng(2)
    tiles = torch.from_numpy(rng.integers(0, 2, (3, 4, 16, 32)).astype(np.int32))
    b = torch.from_numpy(rng.integers(0, 2, (96, 48)).astype(np.int32))
    a8, bt8 = spgemm_binary.pack(tiles, b)
    assert a8.dtype == bt8.dtype == torch.int8
    assert a8.shape == tiles.shape and bt8.shape == (48, 96)
    assert a8.is_contiguous() and bt8.is_contiguous()
    assert torch.equal(a8.int(), tiles) and torch.equal(bt8.int(), b.T)
    # k is contiguous in both: element (n, k) of B at bt8's flat n·K + k
    assert bt8.view(-1)[5 * 96 + 7] == b[7, 5]


def test_group_tiles_by_hand():
    """Block row 0 has active tiles at columns 0, 1, 3, 4, 6; row 1 at 2;
    row 2 none; row 3 at 1, 5. Groups of up to 2 consecutive active tiles
    of a row, ordered by the column of their first tile, then row; each
    row has ceil(7 / 2) = 4 groups of 2 entries, and the empty groups go
    last."""
    t = 3
    flags = torch.tensor([[1, 1, 0, 1, 1, 0, 1],
                          [0, 0, 1, 0, 0, 0, 0],
                          [0, 0, 0, 0, 0, 0, 0],
                          [0, 1, 0, 0, 0, 1, 0]], dtype=torch.int32)
    meta = torch.cat([torch.zeros((4, t), dtype=torch.int32), flags], dim=1)
    active, groups = spgemm_binary.group_tiles(meta, t, 2)
    assert active.dtype == groups.dtype == torch.int32
    assert active.shape == (4 * 4 * 2, 2) and groups.shape == (4 * 4, 2)
    # (first, count): group q of row i starts at entry (4i + q)·2
    assert groups[:5].tolist() == [[0, 2], [24, 2], [8, 1], [2, 2], [4, 1]]
    assert [active[f:f + c].tolist() for f, c in groups[:5].tolist()] == \
        [[[0, 0], [0, 1]], [[3, 1], [3, 5]], [[1, 2]], [[0, 3], [0, 4]], [[0, 6]]]
    assert (groups[5:, 1] == 0).all()
    none = spgemm_binary.group_tiles(torch.zeros((2, t + 3), dtype=torch.int32), t, 2)
    assert none[0].shape == (8, 2) and none[1].shape == (4, 2)
    assert (none[1][:, 1] == 0).all()


def test_group_size_matches_the_kernels_configurations():
    assert [spgemm_binary.group_size(bm) for bm in (16, 32, 48, 64, 80, 128)] == [8, 8, 4, 4, 1, 1]


def test_stream_stats_by_hand():
    """Two block rows of 16 × 16 tiles over three k-blocks: row 0 holds
    tiles at k-blocks 0 and 2, row 1 none (one pad slot). Three tile
    columns; active output tiles (0, 0), (0, 1), (1, 1)."""
    sr = tsemiring.PLUS_AND
    rows = np.array([0, 3, 5], np.int32)
    cols = np.array([1, 33, 40], np.int32)
    a = build_bsr_padded(rows, cols, np.ones(3, np.int32), (32, 48), sr, block=(16, 16),
                         device="cpu")
    assert a.tile_cols.tolist() == [[0, 2], [0, 0]]
    b = torch.ones((48, 48), dtype=torch.int32)
    mask = torch.zeros((32, 48), dtype=torch.int32)
    mask[0, 0] = mask[2, 20] = mask[17, 30] = 1
    bp, mk, meta, bn, _ = ops._spgemm_operands(a, b, sr, mask)
    st = ops.spgemm_stream_stats(a, meta, bp, mk)
    tile = 16 * 16
    assert st["n_active"] == 3
    assert st["real_slots"] == 2 + 1
    assert st["ops"] == 2 * 3 * 2 * 16 ** 3                    # every slot of 3 tiles
    assert st["real_macs"] == (2 * 2 + 1 * 1) * 16 ** 3         # rows hold 2 and 1 slots
    index = 4 * (2 * (2 + 3) + 2 * 3)                          # meta [2, 5], active [3, 2]
    assert st["bytes"] == 4 * (2 * 2 * tile + 48 * 48 + 2 * 32 * 48) + index
    # real tiles 3; B blocks (k, j): row 0 meets k 0, 2 under j 0, 1 and
    # row 1 meets k 0 under j 1, so 4 blocks; 3 mask tiles; the whole output
    assert st["real_bytes"] == 4 * (3 * tile + 4 * tile + 3 * tile + 32 * 48) + index


def test_triangle_count_on_the_cpu_takes_the_variant(spy):
    from repro_torch.graphs import generate, triangle_count, triangle_reference

    g = generate("face", scale=0.15, seed=1)
    got = triangle_count(g, impl="bsr", device="cpu")
    assert spy == ["binary"]
    assert int(got.total) == triangle_reference(g.rows, g.cols, g.n)
    dense = triangle_count(g, impl="dense", device="cpu")
    assert torch.equal(got.per_edge, dense.per_edge)


def test_wrapper_rejects_other_semirings():
    sr = tsemiring.PLUS_TIMES
    tiles = torch.zeros((1, 1, 16, 16))
    with pytest.raises(ValueError, match="plus_and and bool_or_and"):
        semiring_spgemm_binary(tiles, torch.zeros((1, 2), dtype=torch.int32),
                               torch.zeros((16, 16)), torch.zeros((16, 16)), sr=sr, bn=16)


def plain_groups(flags: np.ndarray, g: int) -> list:
    """Groups of up to g consecutive active tiles of a block row, by loops:
    [(tile-column of the first tile, block row, [tile-columns])], ordered
    by first tile-column, then block row."""
    groups = []
    for i, row in enumerate(flags):
        cols = [int(j) for j in np.nonzero(row)[0]]
        groups += [(cols[s], i, cols[s:s + g]) for s in range(0, len(cols), g)]
    return sorted(groups)


@pytest.mark.parametrize("density", [0.1, 0.6, 1.0])
@pytest.mark.parametrize("g", [1, 2, 4, 8, 16])
def test_group_tiles_match_plain_grouping(g, density):
    """``group_tiles`` on a random flag pattern (13 block rows, 37
    tile-columns, one row empty) names the same groups in the same order
    as the plain loops, then only empty groups."""
    rng = np.random.default_rng(int(100 * density) + g)
    t, mb, nb = 2, 13, 37
    flags = (rng.random((mb, nb)) < density).astype(np.int32)
    flags[5] = 0
    meta = torch.cat([torch.zeros((mb, t), dtype=torch.int32), torch.from_numpy(flags)], dim=1)
    active, groups = spgemm_binary.group_tiles(meta, t, g)
    want = plain_groups(flags, g)
    got = []
    for first, count in groups[:len(want)].tolist():
        part = active[first:first + count]
        got.append((int(part[0, 1]), int(part[0, 0]), part[:, 1].tolist()))
    assert got == want
    assert (groups[len(want):, 1] == 0).all()
