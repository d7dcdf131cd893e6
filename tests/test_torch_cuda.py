"""The CUDA tile kernels on the card, held to their plain versions. Needs
an NVIDIA GPU with nvcc; elsewhere every test here skips. On the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Exact for the integer and min semirings; ⟨+,×⟩ within rtol 1e-5,
atol 1e-6 (the kernel and the plain version sum in other orders)."""
import numpy as np
import pytest
import torch

from repro_torch.core import SEMIRINGS, build_bsr_padded, frontier_from_dense
from repro_torch.kernels import ops, ref
from repro_torch.kernels.semiring_spmv import semiring_spmv_padded
from repro_torch.kernels.spmspv_tiles import semiring_spmspv_padded

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
        assert torch.equal(y, y_plain)


@pytest.mark.parametrize("block", [(128, 128), (16, 16), (20, 12), (16, 10), (8, 130)])
@pytest.mark.parametrize("name", list(SEMIRINGS))
def test_kernels_match_plain_versions(cuda, name, block):
    sr = SEMIRINGS[name]
    rng = np.random.default_rng(0)
    n, nnz = 700, 6000
    rows = rng.integers(0, n, nnz).astype(np.int32)
    cols = rng.integers(0, n, nnz).astype(np.int32)
    if sr.dtype == torch.int32:
        vals = rng.integers(0, 2, nnz).astype(np.int32)
    else:
        vals = rng.uniform(1.0, 5.0, nnz).astype(np.float32)
    a = build_bsr_padded(rows, cols, vals, (n, n), sr, block=block, device=cuda)
    xv = (rng.integers(0, 2, a.shape[1]) if sr.dtype == torch.int32
          else rng.uniform(1.0, 3.0, a.shape[1]))
    x = torch.from_numpy(xv).to(cuda).to(sr.dtype)
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
