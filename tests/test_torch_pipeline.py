"""The port's phase pipeline (``repro_torch.core.pipeline.iterate_phases``
and ``run_phases_once``) over ``core.distributed.build_phase_fns`` on the
CPU: every depth gives the same bits (``torch.equal``), and n_iters
distributed steps equal n_iters steps of the JAX package's dense semiring
oracle (``sr.matvec``) on the unpartitioned matrix, exactly: the data are
0/1 (or small integers under ⟨min,+⟩), so every ⊕ order gives the same
result. The JAX package's pipelined mesh test does not run under the
installed jax; its single-device oracle does."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import semiring as jsemiring
from repro_torch.core import distributed as dist
from repro_torch.core import semiring as tsemiring
from repro_torch.core.mesh import Mesh
from repro_torch.core.pipeline import iterate_phases, run_phases_once
from repro_torch.obs import trace

tpart = importlib.import_module("repro_torch.core.partition")

N = 128
N_ITERS = 4
STRATEGIES = {"row": (8, 1), "col": (1, 8), "2d": (2, 4)}


def problem(sr_name: str, seed: int = 3):
    """0/1 adjacency (⟨min,+⟩: weights 1..3) and a 0/1 start vector: four
    ⟨+,×⟩ steps stay below 2^24, so every ⊕ order is exact."""
    rng = np.random.default_rng(seed)
    dense = rng.random((N, N)) < 0.08
    rows, cols = np.nonzero(dense)
    sr = tsemiring.SEMIRINGS[sr_name]
    if sr_name == "min_plus":
        vals = rng.integers(1, 4, rows.shape[0]).astype(np.float32)
        x = np.where(rng.random(N) < 0.2, 0.0, np.inf).astype(np.float32)
    elif sr.dtype == torch.int32:
        vals = np.ones(rows.shape[0], np.int32)
        x = (rng.random(N) < 0.2).astype(np.int32)
    else:
        vals = np.ones(rows.shape[0], np.float32)
        x = (rng.random(N) < 0.2).astype(np.float32)
    return sr, rows, cols, vals, x


def oracle_steps(sr_name, rows, cols, vals, x, n_iters):
    """n_iters steps x <- A ⊕.⊗ x of the JAX package's dense oracle."""
    jsr = jsemiring.SEMIRINGS[sr_name]
    dense = np.full((N, N), jsr.zero, dtype=vals.dtype)
    dense[rows, cols] = vals
    a, y = jnp.asarray(dense, jsr.dtype), jnp.asarray(x, jsr.dtype)
    for _ in range(n_iters):
        y = jsr.matvec(a, y)
    return torch.from_numpy(np.array(y))


@pytest.fixture(scope="module")
def mesh():
    return Mesh((2, 4), device="cpu")


@pytest.mark.parametrize("fmt", ["csr", "bsr"])
@pytest.mark.parametrize("strategy", list(STRATEGIES))
@pytest.mark.parametrize("sr_name", ["plus_times", "min_plus", "bool_or_and"])
def test_every_depth_same_bits_and_single_device(mesh, sr_name, strategy, fmt):
    sr, rows, cols, vals, x = problem(sr_name)
    want = oracle_steps(sr_name, rows, cols, vals, x, N_ITERS)
    for kernel in ("spmv", "spmspv"):
        pm = tpart.partition(rows, cols, vals, (N, N), STRATEGIES[strategy], fmt, sr,
                             block=(16, 16), device="cpu")
        assert pm.plan.in_per == pm.plan.out_per        # rows balance, square: chainable
        xs = tpart.shard_tensor(pm.plan, torch.from_numpy(x), sr.zero)
        fns = dist.build_phase_fns(mesh, pm, sr, strategy, kernel)
        y0 = iterate_phases(fns, pm.parts, xs, N_ITERS, depth=0)
        for depth in (1, 2):
            assert torch.equal(iterate_phases(fns, pm.parts, xs, N_ITERS, depth=depth), y0)
        assert torch.equal(tpart.unshard_tensor(pm.plan, y0), want), f"{strategy}/{kernel}"
        if fmt == "bsr":
            fused = dist.build_phase_fns(mesh, pm, sr, strategy, kernel, fused=True)
            assert torch.equal(iterate_phases(fused, pm.parts, xs, N_ITERS, depth=2), y0)


def test_compressed_load_and_donate_iterate(mesh):
    """A compressed-Load dict (kernel folded into e2e) and donate=True run
    through the pipeline with the dense-Load bits."""
    sr, rows, cols, vals, x = problem("bool_or_and")
    for strategy in ("row", "2d"):
        pm = tpart.partition(rows, cols, vals, (N, N), STRATEGIES[strategy], "csc", sr,
                             device="cpu")
        xs = tpart.shard_tensor(pm.plan, torch.from_numpy(x), 0)
        dense = iterate_phases(dist.build_phase_fns(mesh, pm, sr, strategy, "spmspv"),
                               pm.parts, xs, N_ITERS, depth=0)
        comp = dist.build_phase_fns(mesh, pm, sr, strategy, "spmspv", f_local=pm.plan.in_per)
        assert comp["kernel"] is None
        assert torch.equal(iterate_phases(comp, pm.parts, xs, N_ITERS, depth=2), dense)
        don = dist.build_phase_fns(mesh, pm, sr, strategy, "spmspv", donate=True)
        assert torch.equal(iterate_phases(don, pm.parts, xs, N_ITERS, depth=1), dense)


def test_pipeline_spans_and_edge_cases(mesh):
    """With a tracer the phases trace themselves and the pipeline adds its
    backpressure waits (depth 1: one per iteration after the first, plus
    the final one); n_iters = 0 returns x0, a negative count raises."""
    sr, rows, cols, vals, x = problem("plus_times")
    pm = tpart.partition(rows, cols, vals, (N, N), (2, 4), "csr", sr, device="cpu")
    xs = tpart.shard_tensor(pm.plan, torch.from_numpy(x), 0.0)
    fns = dist.build_phase_fns(mesh, pm, sr, "2d", "spmv")
    with trace.tracing() as t:
        y = iterate_phases(fns, pm.parts, xs, 3, depth=1)
    names = [s.name for s in t.spans]
    assert names.count("pipeline/drain") == 3
    assert names.count("phase/load") == names.count("phase/kernel") == 3
    assert names.count("phase/retrieve_merge") == 3
    assert [s.attrs.get("final") for s in t.spans if s.name == "pipeline/drain"][-1] is True
    assert torch.equal(y, iterate_phases(fns, pm.parts, xs, 3, depth=0))
    assert iterate_phases(fns, pm.parts, xs, 0) is xs
    with pytest.raises(ValueError):
        iterate_phases(fns, pm.parts, xs, -1)
    once = run_phases_once(fns, pm.parts, xs)
    assert torch.equal(once, iterate_phases(fns, pm.parts, xs, 1, depth=0))
