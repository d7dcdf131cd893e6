"""The CUDA tile kernels on the card, held to their plain versions and the
fused kernels also to the unfused ones (``torch.equal`` where pad ⊗ x is
the ⊕-identity, as the inputs here make it). Needs
an NVIDIA GPU with nvcc; elsewhere every test here skips. On the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Exact for the integer and min semirings; ⟨+,×⟩ within rtol 1e-5,
atol 1e-6 (the kernel and the plain version sum in other orders)."""
import numpy as np
import pytest
import torch

from repro_torch.core import SEMIRINGS, build_bsr_padded, build_sell, frontier_from_dense
from repro_torch.kernels import ops, ref
from repro_torch.kernels.semiring_spmv import (
    semiring_spmv_fused_padded, semiring_spmv_padded, semiring_spmv_sell,
)
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


def test_wrapper_rejects_operands_on_two_devices(cuda):
    sr = SEMIRINGS["plus_times"]
    tiles = torch.zeros((2, 1, 4, 4), device=cuda)
    with pytest.raises(ValueError, match="operands on"):
        semiring_spmv_padded(tiles, torch.zeros((2, 1), dtype=torch.int32), torch.zeros(4, device=cuda),
                             sr=sr)
