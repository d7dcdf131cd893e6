"""The CUDA tile kernels on the card, held to their plain versions and the
fused kernels and the [B, n] block launches of kernels 1 and 2 also to
the single-vector kernels (``torch.equal`` where pad ⊗ x is
the ⊕-identity, as the inputs here make it); the masked tile SpGEMM, its
tensor-core variant for 0/1 operands (``torch.equal`` to its plain
version and to kernel 6, the front door's choice between them) and the
triangle count on the card against the host; kernel 6 itself for every
semiring at bm 16, 24, 64 and 128, with NaN pads, a negative row, a
non-finite B block, integer-valued ⟨+,×⟩ exact, ⟨+,×⟩ on rows of ~1,000
nonzeros within half its tolerance, no host sync in the wrapper, groups
cut at a block row's end and past 2³¹ elements; the MoE dispatch gather
(``torch.equal`` to its plain version, bf16 and f32, aligned and
misaligned rows), its transpose (kernel 7ᵀ, ``torch.equal`` to its plain
version, the gradient through the dispatch Function) and one MoE layer on
the card against the host. Needs
an NVIDIA GPU with nvcc; elsewhere every test here skips. On the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Exact for the integer and min semirings; ⟨+,×⟩ within rtol 1e-5,
atol 1e-6 (the kernel and the plain version sum in other orders)."""
import numpy as np
import pytest
import torch

from repro_torch.core import SEMIRINGS, build_bsr_padded, build_sell, frontier_from_dense
from repro_torch.kernels import ops, ref, spgemm_tiles
from repro_torch.kernels.semiring_spmv import (
    semiring_spmv_fused_padded, semiring_spmv_padded, semiring_spmv_sell,
)
from repro_torch.kernels.spgemm_binary import semiring_spgemm_binary
from repro_torch.kernels.spgemm_tiles import semiring_spgemm_padded
from repro_torch.kernels.spmspv_tiles import (
    semiring_spmspv_fused_padded, semiring_spmspv_padded,
)

BLOCKS = [(128, 128), (16, 16), (20, 12), (16, 10), (8, 130)]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def assert_match(y, y_plain, sr):
    torch.cuda.synchronize()
    if sr.name == "plus_times":
        torch.testing.assert_close(y, y_plain, rtol=1e-5, atol=1e-6, equal_nan=True)
    else:
        torch.testing.assert_close(y, y_plain, rtol=0, atol=0, equal_nan=True)


def random_problem(sr, block, device, skew=1):
    """A 700-node matrix (rows drawn as u**skew, so skew > 1 gives ragged
    block rows and pads) and an x that is finite and nonzero for the float
    semirings."""
    rng = np.random.default_rng(0)
    n, nnz = 700, 6000
    rows = (n * rng.random(nnz) ** skew).astype(np.int32)
    cols = rng.integers(0, n, nnz).astype(np.int32)
    if sr.dtype == torch.int32:
        vals = rng.integers(0, 2, nnz).astype(np.int32)
    else:
        vals = rng.uniform(1.0, 5.0, nnz).astype(np.float32)
    a = build_bsr_padded(rows, cols, vals, (n, n), sr, block=block, device=device)
    xv = (rng.integers(0, 2, a.shape[1]) if sr.dtype == torch.int32
          else rng.uniform(1.0, 3.0, a.shape[1]))
    x = torch.from_numpy(xv).to(device).to(sr.dtype)
    return (rows, cols, vals, n), a, x, rng


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("name", list(SEMIRINGS))
def test_kernels_match_plain_versions(cuda, name, block):
    sr = SEMIRINGS[name]
    (_, _, _, n), a, x, rng = random_problem(sr, block, cuda)
    before = semiring_spmv_padded.launches
    assert_match(ops.semiring_spmv(a, x, sr),
                 ref.spmv_padded_ref(a.tiles, a.tile_cols, x, sr), sr)
    assert semiring_spmv_padded.launches == before + 1
    for density in (0.0, 0.01, 0.3, 1.0):
        xs = x.clone()
        xs[torch.from_numpy(rng.random(a.shape[1]) >= density).to(cuda)] = sr.zero
        f = frontier_from_dense(xs[:n], sr)
        before = semiring_spmspv_padded.launches
        y = ops.semiring_spmspv(a, f, sr)
        assert semiring_spmspv_padded.launches == before + 1
        assert_match(y, ops.semiring_spmspv_ref(a, f, sr), sr)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("name", list(SEMIRINGS))
def test_fused_kernels_match_plain_and_unfused(cuda, name, block):
    sr = SEMIRINGS[name]
    (rows, cols, vals, n), a, x, rng = random_problem(sr, block, cuda, skew=3)
    mb = a.tiles.shape[0]
    d = next(d for d in (2, 3, 5, 7, mb) if mb % d == 0)
    y1 = ops.semiring_spmv(a, x, sr)
    before = semiring_spmv_fused_padded.launches
    y3 = ops.semiring_spmv_fused(a, x, sr)
    assert semiring_spmv_fused_padded.launches == before + 1
    assert_match(y3, ref.spmv_fused_padded_ref(a.tiles, ops._spmv_fused_meta(a), x, sr), sr)
    assert torch.equal(y3, y1)
    assert torch.equal(ops.semiring_spmv_fused(a, x, sr, chunks=d), y1.view(d, -1))
    s = build_sell(rows, cols, vals, (n, n), sr, block=block, c=4, device=cuda)
    before = semiring_spmv_sell.launches
    y4 = ops.semiring_spmv_sliced(s, x, sr)
    assert semiring_spmv_sell.launches == before + 1
    assert_match(y4, ref.spmv_sell_ref(s.tiles, s.tile_cols, s.row_meta, x, sr), sr)
    assert torch.equal(y4, y1)
    assert torch.equal(ops.semiring_spmv_sliced(s, x, sr, chunks=d), y1.view(d, -1))
    for density in (0.01, 0.3):
        xs = x.clone()
        xs[torch.from_numpy(rng.random(a.shape[1]) >= density).to(cuda)] = sr.zero
        f = frontier_from_dense(xs[:n], sr)
        before = semiring_spmspv_fused_padded.launches
        y5 = ops.semiring_spmspv_fused(a, f, sr)
        assert semiring_spmspv_fused_padded.launches == before + 1
        assert_match(y5, ops.semiring_spmspv_ref(a, f, sr), sr)
        assert torch.equal(y5, ops.semiring_spmspv(a, f, sr))
        assert torch.equal(ops.semiring_spmspv_fused(a, f, sr, chunks=d), y5.view(d, -1))


@pytest.mark.parametrize("name", ["plus_times", "min_times"])
def test_pad_products_on_the_card(cuda, name):
    """Where pad ⊗ x is NaN, kernels 1, 3 and 4 differ as the TPU kernels
    do: 56, 48 and 0 NaN entries (tests/test_torch_fused.py holds the same
    case to the JAX package on the host)."""
    sr = SEMIRINGS[name]
    rows = np.array([r for r in range(8) for _ in range(7)] + [8, 12], np.int32)
    cols = np.array([8 * c + r for r in range(8) for c in range(1, 8)] + [24, 30], np.int32)
    vals = np.random.default_rng(7).uniform(0.5, 2.0, rows.shape[0]).astype(np.float32)
    x = torch.ones(64, device=cuda)
    x[2] = float("inf") if name == "plus_times" else 0.0
    a = build_bsr_padded(rows, cols, vals, (64, 64), sr, block=(8, 8), device=cuda)
    s = build_sell(rows, cols, vals, (64, 64), sr, block=(8, 8), c=4, device=cuda)
    pairs = [(ops.semiring_spmv(a, x, sr), ref.spmv_padded_ref(a.tiles, a.tile_cols, x, sr)),
             (ops.semiring_spmv_fused(a, x, sr),
              ref.spmv_fused_padded_ref(a.tiles, ops._spmv_fused_meta(a), x, sr)),
             (ops.semiring_spmv_sliced(s, x, sr),
              ref.spmv_sell_ref(s.tiles, s.tile_cols, s.row_meta, x, sr))]
    for (y, y_plain), n_nan in zip(pairs, (56, 48, 0)):
        assert_match(y, y_plain, sr)
        assert int(torch.isnan(y).sum()) == n_nan


def test_engine_on_the_card_matches_the_host(cuda):
    from repro_torch.core import BOOL_OR_AND, MIN_PLUS, PLUS_TIMES
    from repro_torch.graphs import (
        bfs, build_engine, generate, ppr, ppr_reference, sssp, trained_stump,
    )

    g = generate("face", scale=0.15, seed=1)
    src = int(np.argmax(g.out_degrees()))
    stump = trained_stump()

    def both(sr, **kw):
        return [build_engine(g, sr, stump, fmt_spmv="bsr", fmt_spmspv="bsr", device=d, **kw)
                for d in (cuda, "cpu")]

    on_card, on_host = (bfs(e, src) for e in both(BOOL_OR_AND))
    assert torch.equal(on_card.levels.cpu(), on_host.levels)
    assert torch.equal(on_card.kernel_used.cpu(), on_host.kernel_used)
    on_card, on_host = (sssp(e, src) for e in both(MIN_PLUS, weighted=True, seed=5))
    assert torch.equal(on_card.dist.cpu(), on_host.dist)
    on_card = ppr(both(PLUS_TIMES, normalize=True)[0], src)
    np.testing.assert_allclose(on_card.rank.cpu().numpy(), ppr_reference(g.rows, g.cols, g.n, src),
                               rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("b", [1, 5, 32, 40])
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("name", list(SEMIRINGS))
def test_block_kernels_equal_single_launches_and_plain(cuda, name, block, b):
    """Kernels 1 and 2 over a [B, n] block (B = 1, one not a multiple of
    8, 32, and 40 over two vector groups), with an all-⊕-identity row and
    rows at other densities: ``torch.equal`` to the single-vector kernel
    row by row, and to the plain versions within assert_match."""
    from repro_torch.kernels.semiring_spmv import semiring_spmv_padded_batch
    from repro_torch.kernels.spmspv_tiles import semiring_spmspv_padded_batch

    sr = SEMIRINGS[name]
    (_, _, _, n), a, x, rng = random_problem(sr, block, cuda)
    xs = torch.stack([x.roll(i) for i in range(b)]).contiguous()
    xs[0] = sr.zero
    single = torch.stack([semiring_spmv_padded(a.tiles, a.tile_cols, v, sr=sr) for v in xs])
    before = semiring_spmv_padded_batch.launches
    ys = semiring_spmv_padded_batch(a.tiles, a.tile_cols, xs, sr=sr)
    assert semiring_spmv_padded_batch.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(ys, single)
    assert_match(ys, ref.spmv_padded_batch_ref(a.tiles, a.tile_cols, xs, sr), sr)
    dens = torch.tensor([(0.0, 0.01, 0.3, 1.0)[i % 4] for i in range(b)], device=cuda)
    live = torch.rand(xs.shape, device=cuda) < dens[:, None]
    xsp = torch.where(live, xs, sr.zero)[:, :n]
    keep, xd = ops._frontier_block(a, xsp, sr, None)
    meta = ops._spmspv_meta_batch(a, keep)
    before = semiring_spmspv_padded_batch.launches
    ys = semiring_spmspv_padded_batch(a.tiles, meta, xd, sr=sr)
    assert semiring_spmspv_padded_batch.launches == before + 1
    single = torch.stack([semiring_spmspv_padded(a.tiles, m, v, sr=sr) for m, v in zip(meta, xd)])
    torch.cuda.synchronize()
    assert torch.equal(ys, single)
    assert_match(ys, ref.spmspv_padded_batch_ref(a.tiles, meta, xd, sr), sr)
    assert torch.equal(ops.semiring_spmspv_batch(a, xsp, sr), ys)


@pytest.mark.parametrize("b", [8, 40])
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("name", list(SEMIRINGS))
def test_block_kernel_2_on_a_tall_sparse_frontier(cuda, name, block, b):
    """Kernel 2 over a block on a tall banded matrix (60,000 rows) whose
    frontier rows hold one or two vertices each, off tile-column 0 (which
    pad slots alias), so most block rows have an empty union:
    ``torch.equal`` to kernel 2 row by row and to its plain version within
    assert_match."""
    from repro_torch.kernels.spmspv_tiles import semiring_spmspv_padded_batch

    sr = SEMIRINGS[name]
    rng = np.random.default_rng(1)
    n, nnz = 60000, 180000
    rows = rng.integers(0, n, nnz).astype(np.int32)
    cols = np.clip(rows + rng.integers(-40, 41, nnz), 0, n - 1).astype(np.int32)
    vals = (rng.integers(0, 2, nnz).astype(np.int32) if sr.dtype == torch.int32
            else rng.uniform(1.0, 5.0, nnz).astype(np.float32))
    a = build_bsr_padded(rows, cols, vals, (n, n), sr, block=block, device=cuda)
    xs = torch.full((b, n), sr.zero, dtype=sr.dtype)
    for i in range(1, b):
        hot = torch.from_numpy(rng.integers(256, n, int(rng.integers(1, 3))))
        xs[i, hot] = 1 if sr.dtype == torch.int32 else 2.5
    keep, xd = ops._frontier_block(a, xs.to(cuda), sr, None)
    meta = ops._spmspv_meta_batch(a, keep)
    union = ops._spmspv_union_batch(meta)
    assert int((union[:, :, 0] == 0).sum()) > union.shape[0] * union.shape[1] // 2
    ys = semiring_spmspv_padded_batch(a.tiles, meta, xd, sr=sr)
    single = torch.stack([semiring_spmspv_padded(a.tiles, m, v, sr=sr) for m, v in zip(meta, xd)])
    torch.cuda.synchronize()
    assert torch.equal(ys, single)
    assert_match(ys, ref.spmspv_padded_batch_ref(a.tiles, meta, xd, sr), sr)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("name", ["min_plus", "min_times", "plus_times"])
def test_block_kernels_bit_identical_on_signed_zeros_and_nan(cuda, name, block):
    """The float semirings on tiles and x with both signs, ±0.0, ±inf and
    NaN: every row of kernels 1 and 2 over a block has the bits of the
    single-vector kernel on its vector, NaN payloads and zero signs
    included (the min semirings' outputs that are zero or NaN are the
    block fold's recomputed ones)."""
    from repro_torch.kernels.semiring_spmv import semiring_spmv_padded_batch
    from repro_torch.kernels.spmspv_tiles import semiring_spmspv_padded_batch

    sr = SEMIRINGS[name]
    (_, _, _, n), a, x, _ = random_problem(sr, block, cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    tiles = a.tiles * torch.where(torch.rand(a.tiles.shape, device=cuda, generator=gen) < 0.3,
                                  -1.0, 1.0)
    tiles[torch.rand(tiles.shape, device=cuda, generator=gen) < 0.05] = -0.0
    b = 12
    xs = torch.stack([x.roll(7 * i) for i in range(b)])
    u = torch.rand(xs.shape, device=cuda, generator=gen)
    xs = torch.where(u < 0.3, -xs, xs)
    xs[u < 0.08] = 0.0
    xs[u < 0.04] = -0.0
    xs[u < 0.01] = float("-inf")
    xs[u < 0.004] = float("nan")
    xs = xs.contiguous()

    def bits(t):
        return t.contiguous().view(torch.int32)

    ys = semiring_spmv_padded_batch(tiles, a.tile_cols, xs, sr=sr)
    single = torch.stack([semiring_spmv_padded(tiles, a.tile_cols, v, sr=sr) for v in xs])
    torch.cuda.synchronize()
    assert torch.equal(bits(ys), bits(single))
    keep = torch.rand(xs.shape, device=cuda, generator=gen) < 0.2
    meta = ops._spmspv_meta_batch(a, keep)
    ys = semiring_spmspv_padded_batch(tiles, meta, xs, sr=sr)
    single = torch.stack([semiring_spmspv_padded(tiles, m, v, sr=sr) for m, v in zip(meta, xs)])
    torch.cuda.synchronize()
    assert torch.equal(bits(ys), bits(single))


def test_multi_source_on_the_card_matches_the_host(cuda):
    from repro_torch.core import BOOL_OR_AND, MIN_PLUS
    from repro_torch.graphs import bfs_multi, build_engine, generate, sssp_multi, trained_stump
    from repro_torch.kernels.semiring_spmv import semiring_spmv_padded_batch
    from repro_torch.kernels.spmspv_tiles import semiring_spmspv_padded_batch

    g = generate("face", scale=0.15, seed=1)
    srcs = [int(s) for s in np.random.default_rng(42).integers(0, g.n, 8)]
    stump = trained_stump()

    def both(sr, **kw):
        return [build_engine(g, sr, stump, fmt_spmv="bsr", fmt_spmspv="bsr", device=d, **kw)
                for d in (cuda, "cpu")]

    before = semiring_spmv_padded_batch.launches + semiring_spmspv_padded_batch.launches
    on_card, on_host = (bfs_multi(e, srcs) for e in both(BOOL_OR_AND))
    assert torch.equal(on_card.levels.cpu(), on_host.levels)
    assert torch.equal(on_card.kernel_used.cpu(), on_host.kernel_used)
    on_card, on_host = (sssp_multi(e, srcs) for e in both(MIN_PLUS, weighted=True, seed=5))
    assert torch.equal(on_card.dist.cpu(), on_host.dist)
    assert semiring_spmv_padded_batch.launches + semiring_spmspv_padded_batch.launches > before


def test_wrapper_rejects_operands_on_two_devices(cuda):
    sr = SEMIRINGS["plus_times"]
    tiles = torch.zeros((2, 1, 4, 4), device=cuda)
    with pytest.raises(ValueError, match="operands on"):
        semiring_spmv_padded(tiles, torch.zeros((2, 1), dtype=torch.int32), torch.zeros(4, device=cuda),
                             sr=sr)


def spgemm_problem(sr, block, device, masked):
    """A skewed 300 × 260 A (ragged block rows, so pad slots), B [k_pad, 250]
    and a mask of density 0.4, in the semiring's safe domain as
    tests/test_spgemm.py makes them."""
    rng = np.random.default_rng(3)
    n, k, m, nnz = 300, 260, 250, 3000
    rows = (n * rng.random(nnz) ** 3).astype(np.int32)
    cols = rng.integers(0, k, nnz).astype(np.int32)
    if sr.collective == "pmin":
        vals = rng.integers(1, 9, nnz).astype(np.float32)
        b = rng.integers(1, 9, (k, m)).astype(np.float32)
        mask = np.where(rng.random((n, m)) < 0.4, 1.0, np.inf).astype(np.float32)
    elif sr.dtype == torch.int32:
        vals = np.ones(nnz, np.int32)
        b = (rng.random((k, m)) < 0.4).astype(np.int32)
        mask = (rng.random((n, m)) < 0.4).astype(np.int32)
    else:
        vals = rng.random(nnz).astype(np.float32)
        b = rng.random((k, m)).astype(np.float32)
        mask = (rng.random((n, m)) < 0.4).astype(np.float32)
    a = build_bsr_padded(rows, cols, vals, (n, k), sr, block=block, device=device)
    bp = torch.full((a.shape[1], m), sr.one, dtype=sr.dtype, device=device)
    bp[:k] = torch.from_numpy(b).to(device)
    if not masked:
        return a, bp, None
    mp = torch.full((a.shape[0], m), sr.zero, dtype=sr.dtype, device=device)
    mp[:n] = torch.from_numpy(mask).to(device)
    return a, bp, mp


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("block", [(16, 16), (64, 64), (24, 40)])
@pytest.mark.parametrize("name", list(SEMIRINGS))
def test_spgemm_kernel_matches_plain_version(cuda, name, block, masked):
    """The front door launches the tensor-core variant for ⟨+,∧⟩ and
    ⟨∨,∧⟩ on 0/1 values at blocks that are multiples of 16, kernel 6
    otherwise (here the duplicate edges give A values above 1, so kernel 6
    in every case but those whose tiles came out 0/1); either equals kernel
    6's plain version."""
    sr = SEMIRINGS[name]
    a, b, mask = spgemm_problem(sr, block, cuda, masked)
    binary = (name in ("plus_and", "bool_or_and") and block[0] % 16 == 0
              and block[1] % 16 == 0 and int(a.tiles.max()) <= 1 and int(a.tiles.min()) >= 0)
    before = semiring_spgemm_padded.launches, semiring_spgemm_binary.launches
    y = ops.semiring_spgemm(a, b, sr, mask)
    moved = (semiring_spgemm_padded.launches - before[0],
             semiring_spgemm_binary.launches - before[1])
    assert moved == ((0, 1) if binary else (1, 0))
    assert_match(y, ops.semiring_spgemm_ref(a, b, sr, mask), sr)


def binary_problem(block, device, mask_mode, n=300, k=260, m=250):
    """spgemm_problem's skewed A with each edge once (0/1 tiles, ragged
    block rows, rows with no real tile), B 0/1 of density 0.4 and a mask of
    density 0.4, all ones, or None."""
    rng = np.random.default_rng(4)
    rows = (n * rng.random(3000) ** 3).astype(np.int32)
    cols = rng.integers(0, k, 3000).astype(np.int32)
    rc = np.unique(np.stack([rows, cols], 1), axis=0)
    a = build_bsr_padded(rc[:, 0].copy(), rc[:, 1].copy(), np.ones(rc.shape[0], np.int32),
                         (n, k), SEMIRINGS["plus_and"], block=block, device=device)
    b = torch.from_numpy((rng.random((a.shape[1], m)) < 0.4).astype(np.int32)).to(device)
    if mask_mode == "none":
        return a, b, None
    mask = torch.zeros((a.shape[0], m), dtype=torch.int32, device=device)
    mask[:n] = (torch.from_numpy((rng.random((n, m)) < 0.4).astype(np.int32)).to(device)
                if mask_mode == "masked" else 1)
    return a, b, mask


BINARY_BLOCKS = [(16, 16), (32, 32), (64, 64), (128, 128), (48, 48), (64, 32), (16, 128),
                 (32, 16), (64, 16), (128, 16), (96, 48)]


@pytest.mark.parametrize("mask_mode", ["masked", "ones", "none"])
@pytest.mark.parametrize("block", BINARY_BLOCKS, ids=[f"{m}x{k}" for m, k in BINARY_BLOCKS])
@pytest.mark.parametrize("name", ["plus_and", "bool_or_and"])
def test_spgemm_binary_matches_plain_version_and_kernel_6(cuda, name, block, mask_mode):
    """0/1 operands: the front door launches the variant and only it, and
    its output equals its plain version, kernel 6 and kernel 6's plain
    version (blocks with bk < 32 pad the mma's k with zeros)."""
    sr = SEMIRINGS[name]
    a, b, mask = binary_problem(block, cuda, mask_mode)
    before = semiring_spgemm_padded.launches, semiring_spgemm_binary.launches
    y = ops.semiring_spgemm(a, b, sr, mask)
    assert (semiring_spgemm_padded.launches - before[0],
            semiring_spgemm_binary.launches - before[1]) == (0, 1)
    bp, mk, meta, bn, n = ops._spgemm_operands(a, b, sr, mask)
    y_full = semiring_spgemm_binary(a.tiles, meta, bp, mk, sr=sr, bn=bn)
    torch.cuda.synchronize()
    assert torch.equal(y, y_full[:, :n])
    assert torch.equal(y_full, ref.spgemm_binary_ref(a.tiles, meta, bp, mk, sr, bn))
    assert torch.equal(y_full, semiring_spgemm_padded(a.tiles, meta, bp, mk, sr=sr, bn=bn))
    assert torch.equal(y, ops.semiring_spgemm_ref(a, b, sr, mask))


def test_spgemm_binary_past_2_31_elements(cuda):
    """Output, mask and B of 48,000² elements (past 2³¹): tiles near the
    far corner land at offsets that overflow 32 bits, and they equal the
    plain version, which computes only the active tiles."""
    sr = SEMIRINGS["plus_and"]
    n = 48_000
    rng = np.random.default_rng(9)
    rows = np.concatenate([rng.integers(n - 200, n, 400), rng.integers(0, 64, 50)])
    cols = np.concatenate([rng.integers(n - 300, n, 400), rng.integers(0, 64, 50)])
    rc = np.unique(np.stack([rows, cols], 1).astype(np.int32), axis=0)
    a = build_bsr_padded(rc[:, 0].copy(), rc[:, 1].copy(), np.ones(rc.shape[0], np.int32),
                         (n, n), sr, block=(64, 64), device=cuda)
    b = torch.zeros((a.shape[1], n), dtype=torch.int32, device=cuda)
    b[-300:, -300:] = (torch.rand((300, 300), device=cuda) < 0.5).int()
    b[:64, -300:] = 1
    mask = torch.zeros((a.shape[0], n), dtype=torch.int32, device=cuda)
    mask[n - 200:n, n - 300:] = 1
    mask[:64, :64] = 1
    bp, mk, meta, bn, _ = ops._spgemm_operands(a, b, sr, mask)
    assert mk.numel() > 2**31
    del b, mask
    before = semiring_spgemm_binary.launches
    y = semiring_spgemm_binary(a.tiles, meta, bp, mk, sr=sr, bn=bn)
    assert semiring_spgemm_binary.launches == before + 1
    want = ref.spgemm_binary_ref(a.tiles, meta, bp, mk, sr, bn)
    torch.cuda.synchronize()
    assert int(want[n - 200:].sum()) > 0
    assert torch.equal(y, want)


def kernel6_counts(meta, t):
    """(real, pad) pairs kernel 6 folds: over the active output tiles, the
    block row's ``ell_n_real`` real slots and its T − n_real pad slots."""
    n_real = ref.ell_n_real(meta[:, :t]).long()
    act = (meta[:, t:] > 0).sum(dim=1)
    real = int((n_real * act).sum())
    return real, int(act.sum()) * t - real


def kernel6(a, b, sr, mask):
    """Kernel 6 itself on the front door's operands, its path counts reset
    first: (output, operands, {path: pairs})."""
    bp, mk, meta, bn, n = ops._spgemm_operands(a, b, sr, mask)
    semiring_spgemm_padded.paths = dict.fromkeys(spgemm_tiles.PATHS, 0)
    before = semiring_spgemm_padded.launches
    y = semiring_spgemm_padded(a.tiles, meta, bp, mk, sr=sr, bn=bn)
    assert semiring_spgemm_padded.launches == before + 1
    torch.cuda.synchronize()
    paths = {k: int(v) for k, v in semiring_spgemm_padded.paths.items()}
    return y, (bp, mk, meta, bn), paths


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("bm", [16, 24, 64, 128])
@pytest.mark.parametrize("name", list(SEMIRINGS))
def test_spgemm_kernel6_every_semiring_and_block(cuda, name, bm, masked):
    """Kernel 6 on spgemm_problem's ragged A (pad slots) against its plain
    version; it folds each active tile's real slots and one pad row per
    pad slot, as its path counts report."""
    sr = SEMIRINGS[name]
    a, b, mask = spgemm_problem(sr, (bm, bm), cuda, masked)
    y, (bp, mk, meta, bn), paths = kernel6(a, b, sr, mask)
    assert_match(y, ref.spgemm_padded_ref(a.tiles, meta, bp, mk, sr, bn), sr)
    real, pad = kernel6_counts(meta, a.tiles.shape[1])
    assert paths == {"real": real, "pad": pad}


@pytest.mark.parametrize("bm", [16, 64])
@pytest.mark.parametrize("name,fill", [("plus_times", float("inf")), ("min_times", 0.0),
                                       ("plus_and", -1)], ids=["pad-nan-plus_times",
                                                               "pad-nan-min_times", "neg-row"])
def test_spgemm_kernel6_pad_nan_and_neg_row(cuda, name, fill, bm):
    """B's row 3, under tile-column 0, holds inf (⟨+,×⟩: a pad's 0·inf is
    NaN), 0 (⟨min,×⟩: inf·0) or -1 (⟨+,∧⟩: a pad adds min(0, -1)) in
    every 7th column: kernel 6 equals its plain version, NaN where NaN,
    with one pad row per pad slot."""
    sr = SEMIRINGS[name]
    a, b, mask = spgemm_problem(sr, (bm, bm), cuda, True)
    if name == "plus_and":
        b = torch.randint(0, 9, b.shape, dtype=torch.int32, device=cuda,
                          generator=torch.Generator(device=cuda).manual_seed(1))
    b[3, ::7] = fill
    y, (bp, mk, meta, bn), paths = kernel6(a, b, sr, mask)
    want = ref.spgemm_padded_ref(a.tiles, meta, bp, mk, sr, bn)
    assert_match(y, want, sr)
    if name != "plus_and":
        assert bool(torch.isnan(want).any())
    assert paths == dict(zip(("real", "pad"), kernel6_counts(meta, a.tiles.shape[1])))


def test_spgemm_kernel6_one_non_finite_b_block(cuda):
    """⟨+,×⟩ at 64×64 with one inf in B block (k-block 1, tile-column 2):
    the output equals the plain version, inf or NaN where a real slot's
    product meets it."""
    sr = SEMIRINGS["plus_times"]
    a, b, mask = spgemm_problem(sr, (64, 64), cuda, True)
    b[64 + 5, 2 * 64 + 9] = float("inf")
    y, (bp, mk, meta, bn), paths = kernel6(a, b, sr, mask)
    assert_match(y, ref.spgemm_padded_ref(a.tiles, meta, bp, mk, sr, bn), sr)
    t = a.tiles.shape[1]
    n_real = ref.ell_n_real(meta[:, :t]).long()
    cols = meta[:, :t].long()
    meets = torch.stack([(cols[i, :n_real[i]] == 1).any() for i in range(cols.shape[0])])
    assert int((meets & (meta[:, t + 2] > 0)).sum()) > 0
    assert not bool(torch.isfinite(y[:, 2 * 64 + 9]).all())
    assert paths == dict(zip(("real", "pad"), kernel6_counts(meta, t)))


@pytest.mark.parametrize("bm", [16, 64])
def test_spgemm_kernel6_integer_valued_plus_times_is_exact(cuda, bm):
    """Integer values (A 1..9, B 0..9, sums below 2²⁴) come out of the
    fp32 fold exact: torch.equal to the plain version and to the integer
    product."""
    sr = SEMIRINGS["plus_times"]
    rng = np.random.default_rng(6)
    n, k, m = 300, 260, 250
    rows = (n * rng.random(3000) ** 3).astype(np.int32)
    cols = rng.integers(0, k, 3000).astype(np.int32)
    rc, first = np.unique(np.stack([rows, cols], 1), axis=0, return_index=True)
    vals = rng.integers(1, 10, rc.shape[0]).astype(np.float32)
    a = build_bsr_padded(rc[:, 0].copy(), rc[:, 1].copy(), vals, (n, k), sr, block=(bm, bm),
                         device=cuda)
    b = torch.zeros((a.shape[1], m), device=cuda)
    b[:k] = torch.from_numpy(rng.integers(0, 10, (k, m)).astype(np.float32)).to(cuda)
    y, (bp, mk, meta, bn), paths = kernel6(a, b, sr, None)
    assert paths["real"] > 0
    assert torch.equal(y, ref.spgemm_padded_ref(a.tiles, meta, bp, mk, sr, bn))
    dense = torch.zeros((n, k), dtype=torch.float64)
    dense[torch.from_numpy(rc[:, 0]).long(), torch.from_numpy(rc[:, 1]).long()] = (
        torch.from_numpy(vals).double())
    want = dense @ b[:k].cpu().double()
    assert torch.equal(y[:n, :m].cpu().double(), want)


def tolerance_ratio(y, want) -> float:
    """Worst |y − want| / (atol + rtol·|want|) under ⟨+,×⟩'s tolerance
    (rtol 1e-5, atol 1e-6): above 1 the comparison fails."""
    y, want = y.double(), want.double()
    return float(((y - want).abs() / (1e-6 + 1e-5 * want.abs())).max())


def test_spgemm_kernel6_plus_times_high_degree_margin(cuda):
    """⟨+,×⟩ f32 at 64×64 on a 2048² A of density 1/2 (~1,000 nonzero
    products an output entry, every tile of a block row real; values and
    B in [0, 1)): kernel 6's worst tolerance ratio is at most 0.5 against
    the plain version and against the product in float64."""
    sr = SEMIRINGS["plus_times"]
    n = 2048
    rng = np.random.default_rng(8)
    dense = np.where(rng.random((n, n)) < 0.5, rng.random((n, n)), 0.0).astype(np.float32)
    rows, cols = np.nonzero(dense)
    a = build_bsr_padded(rows.astype(np.int32), cols.astype(np.int32), dense[rows, cols],
                         (n, n), sr, block=(64, 64), device=cuda)
    b = torch.from_numpy(rng.random((n, n)).astype(np.float32)).to(cuda)
    y, (bp, mk, meta, bn), paths = kernel6(a, b, sr, None)
    assert paths == {"real": (n // 64) ** 3, "pad": 0}
    want64 = torch.from_numpy(dense).to(cuda).double() @ b.double()
    assert tolerance_ratio(y, ref.spgemm_padded_ref(a.tiles, meta, bp, mk, sr, bn)) <= 0.5
    assert tolerance_ratio(y, want64) <= 0.5


def test_spgemm_kernel6_wrapper_never_syncs(cuda):
    """The kernel finds its groups and real slots and computes the pad row
    itself, so the wrapper never waits on the card: with CUDA's sync debug
    mode set to error, a call raises nothing."""
    sr = SEMIRINGS["plus_times"]
    a, b, mask = spgemm_problem(sr, (64, 64), cuda, True)
    bp, mk, meta, bn, _ = ops._spgemm_operands(a, b, sr, mask)
    semiring_spgemm_padded(a.tiles, meta, bp, mk, sr=sr, bn=bn)   # built and loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = semiring_spgemm_padded(a.tiles, meta, bp, mk, sr=sr, bn=bn)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert_match(y, ref.spgemm_padded_ref(a.tiles, meta, bp, mk, sr, bn), sr)


@pytest.mark.parametrize("bm", [16, 32, 64])
def test_spgemm_kernel6_groups_cut_at_block_row_end(cuda, bm):
    """Mask tiles set so that every block row's active tiles run past a
    whole number of groups (G + 1, 2G − 1, 1, ...): each group stops at its
    block row's end, and kernel 6 equals its plain version."""
    sr = SEMIRINGS["min_plus"]
    g = spgemm_tiles.group_size(bm)
    a, b, _ = spgemm_problem(sr, (bm, bm), cuda, False)
    mb, nb = a.shape[0] // bm, -(-b.shape[1] // bm)
    mask = torch.full((a.shape[0], b.shape[1]), float("inf"), device=cuda)
    for i in range(mb):
        count = [g + 1, 2 * g - 1, 1, g - 1][i % 4] % nb or 1
        for j in range(count):
            mask[i * bm, j * bm] = 1.0
    y, (bp, mk, meta, bn), paths = kernel6(a, b, sr, mask)
    assert_match(y, ref.spgemm_padded_ref(a.tiles, meta, bp, mk, sr, bn), sr)
    active = (meta[:, a.tiles.shape[1]:] > 0).sum(dim=1)
    assert bool((active % g != 0).any())


@pytest.mark.parametrize("name", ["plus_times", "min_plus"])
def test_spgemm_kernel6_past_2_31_elements(cuda, name):
    """Output, mask and B of 48,000² elements (past 2³¹): tiles near the
    far corner land at offsets that overflow 32 bits, and kernel 6 equals
    its plain version there."""
    sr = SEMIRINGS[name]
    n = 48_000
    rng = np.random.default_rng(9)
    rows = np.concatenate([rng.integers(n - 200, n, 400), rng.integers(0, 64, 50)])
    cols = np.concatenate([rng.integers(n - 300, n, 400), rng.integers(0, 64, 50)])
    rc = np.unique(np.stack([rows, cols], 1).astype(np.int32), axis=0)
    vals = rng.integers(1, 9, rc.shape[0]).astype(np.float32)
    a = build_bsr_padded(rc[:, 0].copy(), rc[:, 1].copy(), vals, (n, n), sr, block=(64, 64),
                         device=cuda)
    b = torch.full((a.shape[1], n), sr.one, device=cuda)
    b[-300:, -300:] = torch.randint(1, 9, (300, 300), device=cuda).float()
    mask = torch.full((a.shape[0], n), sr.zero, device=cuda)
    mask[n - 200:n, n - 300:] = 1.0
    mask[:64, :64] = 1.0
    bp, mk, meta, bn, _ = ops._spgemm_operands(a, b, sr, mask)
    assert mk.numel() > 2**31
    del b, mask
    before = semiring_spgemm_padded.launches
    y = semiring_spgemm_padded(a.tiles, meta, bp, mk, sr=sr, bn=bn)
    assert semiring_spgemm_padded.launches == before + 1
    want = ref.spgemm_padded_ref(a.tiles, meta, bp, mk, sr, bn)
    torch.cuda.synchronize()
    assert bool((want[n - 200:] != sr.zero).any())
    assert_match(y, want, sr)


@pytest.mark.parametrize("block", [(16, 16), (64, 64)])
@pytest.mark.parametrize("name", ["plus_times", "min_times"])
def test_spgemm_pad_products_on_the_card(cuda, name, block):
    """Where pad ⊗ b is NaN (0·inf, inf·0) the kernel folds the pads as the
    TPU kernel does: block rows with no real tile come out NaN in that
    column (tests/test_torch_spgemm.py holds the same case to the JAX
    package on the host)."""
    sr = SEMIRINGS[name]
    bm = block[0]
    rows = np.array([0, 1, bm + 1], np.int32)
    cols = np.array([1, bm + 2, 2 * bm + 3], np.int32)
    a = build_bsr_padded(rows, cols, np.full(3, 2.0, np.float32), (3 * bm, 3 * bm), sr,
                         block=block, device=cuda)
    b = torch.ones((a.shape[1], 40), device=cuda)
    b[3, 5] = float("inf") if name == "plus_times" else 0.0
    y = ops.semiring_spgemm(a, b, sr)
    assert_match(y, ops.semiring_spgemm_ref(a, b, sr), sr)
    nan = torch.isnan(y)
    assert nan[:, 5].all() and int(nan.sum()) == a.shape[0]


def test_triangle_count_on_the_card_matches_the_host(cuda):
    from repro_torch.graphs import generate, triangle_count, triangle_reference

    g = generate("face", scale=0.15, seed=1)
    before = semiring_spgemm_padded.launches, semiring_spgemm_binary.launches
    on_card = triangle_count(g, impl="bsr", device=cuda)
    assert (semiring_spgemm_padded.launches - before[0],
            semiring_spgemm_binary.launches - before[1]) == (0, 1)
    on_host = triangle_count(g, impl="bsr", device="cpu")
    assert torch.equal(on_card.per_edge.cpu(), on_host.per_edge)
    assert int(on_card.total) == int(on_host.total) == triangle_reference(g.rows, g.cols, g.n)


def test_spgemm_wrapper_rejects_operands_on_two_devices(cuda):
    sr = SEMIRINGS["plus_and"]
    tiles = torch.zeros((2, 1, 16, 16), dtype=torch.int32, device=cuda)
    b = torch.zeros((16, 32), dtype=torch.int32, device=cuda)
    mask = torch.zeros((32, 32), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="operands on"):
        semiring_spgemm_padded(tiles, torch.zeros((2, 3), dtype=torch.int32), b, mask, sr=sr,
                               bn=16)


# ------------------------------------------------- kernel 7, MoE dispatch gather


def _gather_case(device, dtype, t, s, d, pads, offset=0):
    """x [t, d] of ``dtype`` starting ``offset`` elements into its storage
    (so offset > 0 misaligns the pointer), and a slot_tok [s] with a
    ``pads`` share of pad slots (== t)."""
    gen = torch.Generator(device=device).manual_seed(t * 7 + s + d)
    base = torch.randn(t * d + offset, generator=gen, device=device).to(dtype)
    x = base[offset:].view(t, d)
    tok = torch.randint(0, t, (s,), generator=gen, device=device, dtype=torch.int32)
    pad = torch.rand(s, generator=gen, device=device) < pads
    return x, torch.where(pad, t, tok).to(torch.int32)


@pytest.mark.parametrize("d", [128, 2048, 100, 3])
@pytest.mark.parametrize("s", [1, 7, 2048, 16384])
@pytest.mark.parametrize("pads", [0.0, 0.5, 1.0], ids=["no-pads", "half-pads", "all-pads"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_moe_dispatch_gather_matches_plain_version(cuda, dtype, pads, s, d):
    from repro_torch.kernels.moe_dispatch import moe_dispatch_gather

    x, tok = _gather_case(cuda, dtype, 512, s, d, pads)
    before = moe_dispatch_gather.launches
    got = moe_dispatch_gather(x, tok)
    assert moe_dispatch_gather.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, ref.moe_dispatch_gather_ref(x, tok))
    if pads == 1.0:
        assert not got.any()


@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_moe_dispatch_gather_misaligned_pointer(cuda, dtype, offset):
    """A row of 2048 elements whose base pointer is off 16 bytes takes the
    element-wise path and gives the same rows."""
    from repro_torch.kernels.moe_dispatch import moe_dispatch_gather

    x, tok = _gather_case(cuda, dtype, 64, 300, 2048, 0.3, offset=offset)
    assert x.data_ptr() % 16
    got = moe_dispatch_gather(x, tok)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.moe_dispatch_gather_ref(x, tok))


def test_moe_dispatch_gather_rejects_bad_operands(cuda):
    from repro_torch.kernels.moe_dispatch import moe_dispatch_gather

    x = torch.zeros((4, 128), device=cuda)
    tok = torch.zeros(3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="operands on"):
        moe_dispatch_gather(x, tok.cpu())
    with pytest.raises(ValueError, match="int32"):
        moe_dispatch_gather(x, tok.long())
    with pytest.raises(TypeError):
        moe_dispatch_gather(x.int(), tok)
    with pytest.raises(ValueError, match="contiguous"):
        moe_dispatch_gather(x.T, tok)


def _hinted_plan(device, b, t, e, k, cf, gen, skew=False):
    """slot_tok of ``dispatch_plan`` for [b, t] tokens routed to distinct
    random top-k of e experts at capacity factor cf (``skew``: every token
    to experts 0..k-1, so groups overflow and drop), with its hint."""
    from repro_torch.models.config import MoEConfig
    from repro_torch.models.moe import capacity, dispatch_plan

    cfg = MoEConfig(n_experts=e, top_k=k, d_ff_expert=8, capacity_factor=cf)
    ids = torch.argsort(torch.rand((b, t, e), generator=gen, device=device), dim=-1)[..., :k]
    if skew:
        ids = torch.arange(k, device=device).expand(b, t, k)
    c = capacity(t, cfg)
    return dispatch_plan(ids.to(torch.int32).contiguous(), e, c).slot_tok, c


# (batch rows, tokens a row, experts, top-k, capacity factor, D, x offset,
# plan change, the path the hinted call takes, by dtype where they
# differ). The window path runs where x holds at least 40% of L2 (2,400
# tokens of D = 6144: 29.5 MB in bf16, 59 MB in f32, on an H100's 50 MB);
# smaller x, unaligned rows and decode take the other paths. A row of
# D = 100 is 16-byte aligned in f32 (400 bytes), not in bf16.
HINTED = {
    "window": (2, 1200, 8, 2, 1.25, 6144, 0, None, "window"),
    "straddle": (3, 803, 5, 3, 1.0, 6144, 0, None, "window"),   # partial last run and window
    "drops": (4, 600, 16, 6, 0.5, 6144, 0, "skew", "window"),   # groups overflow
    "unsorted": (2, 1200, 8, 2, 1.25, 6144, 0, "shuffle", "window"),  # the order broken
    "out-of-range": (3, 800, 16, 6, 1.0, 6144, 0, "out-of-range", "window"),
    "small-s": (1, 2400, 1, 1, 0.01, 6144, 0, None, "window"),  # 24 slots, < a CTA's run
    "long-tail": (1, 2400, 2, 1, 4.0, 6144, 0, None, "window"),  # 3,600 pads a group
    "flat": (2, 300, 8, 2, 1.25, 2048, 0, None, "flat"),         # x fits L2
    "tiny": (1, 16, 1, 1, 0.5, 128, 0, None, "flat"),            # S·D < one CTA's run
    "decode": (4, 1, 64, 6, 1.0, 2048, 0, None, "flat"),
    "d-unaligned": (2, 100, 8, 2, 1.0, 100, 0, None,
                    {torch.bfloat16: "elementwise", torch.float32: "flat"}),
    "d-3": (1, 40, 4, 2, 2.0, 3, 0, None, "elementwise"),
    "pointer-misaligned": (2, 64, 8, 2, 1.0, 2048, 1, None, "elementwise"),
}


@pytest.mark.parametrize("case", list(HINTED))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_moe_dispatch_gather_hinted_and_unhinted(cuda, dtype, case):
    """The kernel with and without ``dispatch_plan``'s layout hint on plans
    built by it: every slot ``torch.equal`` to the plain version on the
    window, flat and element-wise paths, each call on the path the case
    names (the wrapper's per-path counts); a run and a window cut short at
    the end of a batch row (803 tokens), groups that overflow and drop, a
    plan whose order the hint does not describe (shuffled), tokens
    outside [0, T), fewer slots than a CTA's run and a tail of pads longer
    than a round still gathered exactly."""
    from repro_torch.kernels.moe_dispatch import moe_dispatch_gather

    b, t, e, k, cf, d, offset, change, path = HINTED[case]
    path = path[dtype] if isinstance(path, dict) else path
    gen = torch.Generator(device=cuda).manual_seed(b * 1000 + t + d)
    tok, c = _hinted_plan(cuda, b, t, e, k, cf, gen, skew=change == "skew")
    if change == "shuffle":
        tok = tok[torch.randperm(tok.shape[0], generator=gen, device=cuda)].contiguous()
    if change == "out-of-range":
        tok[::7] = -3
        tok[3::11] = b * t + 5
    base = torch.randn(b * t * d + offset, generator=gen, device=cuda).to(dtype)
    x = base[offset:].view(b * t, d)
    want = ref.moe_dispatch_gather_ref(x, tok)
    before = moe_dispatch_gather.launches
    paths = dict(moe_dispatch_gather.paths)
    hinted = moe_dispatch_gather(x, tok, group=c, experts=e)
    assert moe_dispatch_gather.paths[path] == paths[path] + 1
    unhinted = "elementwise" if path == "elementwise" else "flat"
    paths = dict(moe_dispatch_gather.paths)
    plain = moe_dispatch_gather(x, tok)
    assert moe_dispatch_gather.paths[unhinted] == paths[unhinted] + 1
    assert moe_dispatch_gather.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(hinted, want) and torch.equal(plain, want)
    assert want.any()


def test_moe_dispatch_gather_rejects_bad_hints_on_the_card(cuda):
    from repro_torch.kernels.moe_dispatch import moe_dispatch_gather

    x = torch.zeros((6, 128), device=cuda)
    tok = torch.zeros(48, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="slots"):
        moe_dispatch_gather(x, tok, group=5, experts=2)
    with pytest.raises(ValueError, match="batch rows"):
        moe_dispatch_gather(x, tok, group=2, experts=6)
    with pytest.raises(ValueError, match="neither"):
        moe_dispatch_gather(x, tok, group=8)


def test_moe_layer_on_the_card_matches_the_host(cuda):
    """One sparse MoE layer in f32 (TF32 off) through kernel 7 on the card
    against the same layer's plain path on the host."""
    from repro_torch.models.config import MoEConfig
    from repro_torch.models.moe import moe_ffn
    from repro_torch.kernels.moe_dispatch import moe_dispatch_gather

    cfg = MoEConfig(n_experts=16, top_k=2, d_ff_expert=64, capacity_factor=1.0)
    rng = np.random.default_rng(0)
    d = 128
    p = {"router": rng.standard_normal((d, 16)), "w1": rng.standard_normal((16, d, 64)) / 11,
         "w3": rng.standard_normal((16, d, 64)) / 11, "w2": rng.standard_normal((16, 64, d)) / 8}
    x = rng.standard_normal((3, 40, d))
    host = {k: torch.from_numpy(v.astype(np.float32)) for k, v in p.items()}
    card = {k: v.to(cuda) for k, v in host.items()}
    xt = torch.from_numpy(x.astype(np.float32))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        before = moe_dispatch_gather.launches
        y = moe_ffn(xt.to(cuda), card, cfg)
        assert moe_dispatch_gather.launches == before + 1
        torch.testing.assert_close(y.cpu(), moe_ffn(xt, host, cfg), rtol=1e-4, atol=1e-5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("plan", [(2, 256, 64, 6, 1.25, 2048), (2, 256, 64, 6, 0.5, 2048),
                                  (2, 100, 8, 2, 1.25, 6144), (1, 33, 8, 2, 1.0, 100)],
                         ids=["deepseek", "deepseek-drops", "mixtral", "misaligned-d"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_moe_dispatch_backward_matches_plain_version(cuda, dtype, plan):
    """Kernel 7ᵀ on a ``dispatch_plan``'s tok_slots (drops where the
    capacity factor is cut), bit for bit its plain version, launched once;
    and x's gradient through the dispatch Function (kernels 7 and 7ᵀ)
    equal to the one through the plain gather under autograd."""
    from repro_torch.kernels.moe_dispatch import moe_dispatch_gather_backward
    from repro_torch.models.config import MoEConfig
    from repro_torch.models.moe import capacity, dispatch_plan

    b, t, e, k, cf, d = plan
    gen = torch.Generator(device=cuda).manual_seed(t + e + d)
    ids = torch.argsort(torch.rand((b, t, e), generator=gen, device=cuda), dim=-1)[..., :k]
    c = capacity(t, MoEConfig(n_experts=e, top_k=k, d_ff_expert=8, capacity_factor=cf))
    p = dispatch_plan(ids.to(torch.int32).contiguous(), e, c)
    if cf < 1.0:
        assert not bool(p.keep.all())
    grad = torch.randn((b * e * c, d), generator=gen, device=cuda).to(dtype)
    before = moe_dispatch_gather_backward.launches
    got = moe_dispatch_gather_backward(grad, p.tok_slots)
    assert moe_dispatch_gather_backward.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, ref.moe_dispatch_gather_backward_ref(grad, p.tok_slots))
    x = torch.randn((b * t, d), generator=gen, device=cuda).to(dtype)
    xk = x.clone().requires_grad_(True)
    ops.moe_dispatch(xk, p.slot_tok, p.tok_slots, group=c, experts=e).backward(grad)
    xp = x.clone().requires_grad_(True)
    ref.moe_dispatch_gather_ref(xp, p.slot_tok).float().backward(grad.float())
    torch.cuda.synchronize()
    assert torch.equal(xk.grad, ref.moe_dispatch_gather_backward_ref(grad, p.tok_slots))
    if dtype == torch.float32:
        assert torch.equal(xk.grad, xp.grad)


def test_moe_dispatch_backward_rejects_bad_operands(cuda):
    from repro_torch.kernels.moe_dispatch import moe_dispatch_gather_backward

    g = torch.zeros((6, 128), device=cuda)
    slots = torch.zeros((3, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="operands on"):
        moe_dispatch_gather_backward(g, slots.cpu())
    with pytest.raises(ValueError, match="int32"):
        moe_dispatch_gather_backward(g, slots.long())
    with pytest.raises(ValueError, match="contiguous"):
        moe_dispatch_gather_backward(g, slots.T)
    with pytest.raises(TypeError):
        moe_dispatch_gather_backward(g.int(), slots)


# ---------------------------------------------------------------------------
# The mesh layer on the card: D virtual devices on one card
# ---------------------------------------------------------------------------

MESH_STRATEGIES = {"row": (8, 1), "col": (1, 8), "2d": (2, 4)}


def mesh_problem(sr, device, n=700, seed=3, n_pad=768):
    """A skewed n-node edge list in the semiring's domain (integer values,
    so every ⊕ order is exact) and its partitions at the padded square
    shape (n_pad, n_pad), whose input and output chunks coincide, on
    ``device``; x has n_pad entries."""
    from repro_torch.core.partition import partition

    rng = np.random.default_rng(seed)
    rows = (n * rng.random(6000) ** 2).astype(np.int64)
    cols = rng.integers(0, n, 6000).astype(np.int64)
    keys = np.unique(rows * n + cols)
    rows, cols = keys // n, keys % n
    vals = (np.ones(rows.shape[0], np.int32) if sr.dtype == torch.int32
            else rng.integers(1, 9, rows.shape[0]).astype(np.float32))
    parts = {s: partition(rows, cols, vals, (n_pad, n_pad), g, "bsr", sr, block=(16, 16),
                          device=device) for s, g in MESH_STRATEGIES.items()}
    xv = (rng.integers(0, 2, n_pad) if sr.dtype == torch.int32 else rng.integers(0, 5, n_pad))
    x = torch.from_numpy(xv.astype(np.int32 if sr.dtype == torch.int32 else np.float32))
    return parts, x


@pytest.mark.parametrize("name", ["plus_times", "min_plus", "bool_or_and"])
def test_mesh_on_the_card_matches_the_host(cuda, name):
    """Every strategy, topology and kernel (1, 2, fused 3, 5) on 8 virtual
    devices of the card equals the same code on the host bit for bit
    (integer-valued data), and each Kernel phase launches once per device."""
    from repro_torch.core.distributed import make_distributed_matvec
    from repro_torch.core.mesh import Mesh
    from repro_torch.core.partition import shard_tensor, unshard_tensor

    sr = SEMIRINGS[name]
    parts = {d: mesh_problem(sr, d) for d in (cuda, "cpu")}
    meshes = {cuda: Mesh((2, 4), device=cuda), "cpu": Mesh((2, 4), device="cpu")}
    for strategy in MESH_STRATEGIES:
        for kernel, fused, launched in (("spmv", False, semiring_spmv_padded),
                                        ("spmspv", False, semiring_spmspv_padded),
                                        ("spmv", True, semiring_spmv_fused_padded),
                                        ("spmspv", True, semiring_spmspv_fused_padded)):
            for topology in ("flat", "ring", "tree", "staged2d"):
                ys = []
                for dev in (cuda, "cpu"):
                    pms, x = parts[dev]
                    pm = pms[strategy]
                    xs = shard_tensor(pm.plan, x.to(dev), sr.zero)
                    fn = make_distributed_matvec(meshes[dev], pm, sr, strategy, kernel=kernel,
                                                 fused=fused, topology=topology)
                    before = launched.launches
                    ys.append(unshard_tensor(pm.plan, fn(pm.parts, xs)).cpu())
                    if dev == cuda:
                        assert launched.launches - before == 8
                torch.cuda.synchronize()
                assert torch.equal(ys[0], ys[1]), f"{strategy}/{kernel}/{fused}/{topology}"


def test_mesh_batched_spgemm_and_pipeline_on_the_card(cuda):
    """Kernels 1b/2b through the batched closures, kernel 6b through the
    distributed SpGEMM and the pipelined phase loop at depths 0 and 2 on
    the card equal the host bit for bit."""
    from repro_torch.core.distributed import (
        build_phase_fns, make_distributed_batched_matvec, make_distributed_spgemm,
    )
    from repro_torch.core.mesh import Mesh
    from repro_torch.core.partition import shard_tensor, unshard_tensor
    from repro_torch.core.pipeline import iterate_phases
    from repro_torch.kernels.semiring_spmv import semiring_spmv_padded_batch
    from repro_torch.kernels.spmspv_tiles import semiring_spmspv_padded_batch

    sr = SEMIRINGS["plus_and"]
    out = {}
    for dev in (cuda, "cpu"):
        mesh = Mesh((2, 4), device=dev)
        pms, x = mesh_problem(sr, dev)
        pm = pms["2d"]
        xb = torch.stack([x, x.roll(3), torch.zeros_like(x)]).to(dev)
        res = []
        for kernel in ("spmv", "spmspv"):
            fb = make_distributed_batched_matvec(mesh, pm, sr, "2d", kernel=kernel)
            res.append(unshard_tensor(pm.plan, fb(pm.parts, shard_tensor(pm.plan, xb, 0, dim=1)),
                                      dim=1))
        b = (torch.rand(768, 40, generator=torch.Generator().manual_seed(1)) < 0.3).int()
        fg = make_distributed_spgemm(mesh, pm, sr, "2d")
        res.append(unshard_tensor(pm.plan, fg(pm.parts, shard_tensor(pm.plan, b.to(dev), 1))))
        fns = build_phase_fns(mesh, pm, sr, "2d", "spmv")
        xs = shard_tensor(pm.plan, x.to(dev), 0)
        res += [iterate_phases(fns, pm.parts, xs, 3, depth=d) for d in (0, 2)]
        out[dev] = [r.cpu() for r in res]
    torch.cuda.synchronize()
    for a, h in zip(out[cuda], out["cpu"]):
        assert torch.equal(a, h)
    assert semiring_spmv_padded_batch.launches > 0 and semiring_spmspv_padded_batch.launches > 0
    assert semiring_spgemm_binary.launches > 0


@pytest.mark.parametrize("topology", ["flat", "ring", "tree", "staged2d"])
def test_mesh_warm_calls_never_synchronise(cuda, topology):
    """After its first call (which builds the mesh's index tables), a
    distributed SpMV or SpMSpV on the card, fused or not, with the dense or
    the compressed Load, and one step
    through the phase closures make no synchronising CUDA call: under
    ``torch.cuda.set_sync_debug_mode("error")`` a blocking copy, a read or
    a synchronize raises. So the depth-2 pipeline never waits inside a
    phase, whatever the Merge topology."""
    from repro_torch.core.distributed import build_phase_fns, make_distributed_matvec
    from repro_torch.core.mesh import Mesh
    from repro_torch.core.partition import shard_tensor
    from repro_torch.core.pipeline import run_phases_once

    sr = SEMIRINGS["min_plus"]
    mesh = Mesh((2, 4), device=cuda)
    pms, x = mesh_problem(sr, cuda)
    calls = []
    for strategy, pm in pms.items():
        xs = shard_tensor(pm.plan, x.to(cuda), sr.zero)
        topo = "flat" if strategy == "row" else topology
        forms = [(k, f, None) for k in ("spmv", "spmspv") for f in (False, True)]
        if strategy != "col":
            forms.append(("spmspv", False, pm.plan.in_per))     # the compressed Load
        for kernel, fused, f_local in forms:
            fn = make_distributed_matvec(mesh, pm, sr, strategy, kernel=kernel, fused=fused,
                                         topology=topo, f_local=f_local)
            calls.append(lambda fn=fn, pm=pm, xs=xs: fn(pm.parts, xs))
        fns = build_phase_fns(mesh, pm, sr, strategy, "spmv", topology=topo)
        calls.append(lambda fns=fns, pm=pm, xs=xs: run_phases_once(fns, pm.parts, xs))
    warm = [call() for call in calls]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = [call() for call in calls]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for a, b in zip(warm, again):
        assert torch.equal(a, b)
