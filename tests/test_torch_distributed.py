"""The port's distributed layer (``repro_torch.core.distributed`` on the
virtual devices of ``core.mesh.Mesh``) on the CPU.

* Every strategy × format × kernel × balance equals the dense semiring
  oracle (the JAX package's ``sr.matvec``): ⟨+,×⟩ within rtol 1e-5 (the
  ⊕ order differs), ⟨min,+⟩, ⟨∨,∧⟩ and ⟨+,∧⟩ exactly.
* The JAX mesh closures that run under the installed jax (row/col/2d,
  flat merge: the cases of ``test_distributed.py::
  test_distributed_strategies_8dev``) run once, in a module-scoped
  subprocess with 8 forced host devices, and the port equals their outputs
  on the same inputs (⟨+,×⟩ within rtol 1e-5: XLA's ``psum_scatter``
  order is its own).
* Where the JAX mesh cannot run (ring, tree, staged2d, fused, the batched
  closures, SpGEMM): every topology equals flat bit for bit on
  integer-valued data at 8 and 12 devices; ``fused=True`` equals
  ``fused=False``; the batched closures equal the unbatched ones row by
  row; the compressed Load equals the dense Load while ``f_local`` covers
  the largest shard's nonzeros; the distributed SpGEMM equals the JAX
  package's single-device ``spgemm_masked`` (exactly, on integer-valued
  data).
* The Kernel phase launches once per device on views of the stacked
  partition; after its first call no matvec copies from the host or reads
  from the device.
"""
import importlib
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import semiring as jsemiring
from repro.core.spgemm import spgemm_masked as jspgemm_masked
from repro.graphs import cost_model as jcost
from repro.graphs import datasets as jdata
from repro_torch.core import distributed as dist
from repro_torch.core import semiring as tsemiring
from repro_torch.core.mesh import Mesh
from repro_torch.core.pipeline import iterate_phases, run_phases_once
from repro_torch.core.spmspv import frontier_from_dense
from repro_torch.graphs import datasets as tdata
from repro_torch.graphs.multi import partitioned_matvec
from repro_torch.kernels import ops
from repro_torch.obs import trace

tpart = importlib.import_module("repro_torch.core.partition")

REPO_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
STRATEGIES = {"row": (8, 1), "col": (1, 8), "2d": (2, 4)}
FMTS = ["coo", "csr", "csc", "bsr"]
SR_NAMES = ["plus_times", "min_plus", "bool_or_and", "plus_and"]
BLOCK = (16, 16)


def kernels_of(fmt: str) -> tuple:
    """The kernels a format has (CSC has no dense-input SpMV, in either
    package)."""
    return ("spmspv",) if fmt == "csc" else ("spmv", "spmspv")


def problem(sr_name: str, seed: int = 1, n: int = 128, integer_x: bool = False):
    """(rows, cols, vals, x, fill, dense) of a random n×n matrix in the
    semiring's domain, as the JAX package's distributed tests draw them."""
    rng = np.random.default_rng(seed)
    dense_np = (rng.random((n, n)) < 0.08).astype(np.float32) * rng.integers(1, 9, (n, n))
    rows, cols = np.nonzero(dense_np)
    vals = dense_np[rows, cols].astype(np.float32)
    if sr_name == "min_plus":
        dense = np.where(dense_np != 0, dense_np, np.inf).astype(np.float32)
        xv = rng.integers(0, 9, n) if integer_x else rng.random(n)
        x = np.where(rng.random(n) < 0.3, xv, np.inf).astype(np.float32)
        return rows, cols, vals, x, np.inf, dense
    if sr_name in ("bool_or_and", "plus_and"):
        dense = (dense_np != 0).astype(np.int32)
        x = (rng.random(n) < 0.3).astype(np.int32)
        return rows, cols, np.ones_like(vals, dtype=np.int32), x, 0, dense
    if integer_x:
        x = rng.integers(0, 9, n).astype(np.float32)
    else:
        x = np.where(rng.random(n) < 0.3, rng.random(n), 0).astype(np.float32)
    return rows, cols, vals, x, 0.0, dense_np


def oracle(sr_name: str, dense: np.ndarray, x: np.ndarray) -> np.ndarray:
    jsr = jsemiring.SEMIRINGS[sr_name]
    return np.asarray(jsr.matvec(jnp.asarray(dense, jsr.dtype), jnp.asarray(x, jsr.dtype)))


def check(sr_name: str, got: np.ndarray, want: np.ndarray, tag: str) -> None:
    if sr_name == "plus_times":
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=tag)
    else:
        np.testing.assert_array_equal(got, want, err_msg=tag)


def run(mesh, pm, sr, strategy, x, fill, **kw) -> np.ndarray:
    xs = tpart.shard_tensor(pm.plan, torch.from_numpy(x), fill)
    fn = dist.make_distributed_matvec(mesh, pm, sr, strategy, **kw)
    return tpart.unshard_tensor(pm.plan, fn(pm.parts, xs)).numpy()


@pytest.fixture(scope="module")
def mesh():
    return Mesh((2, 4), device="cpu")


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("strategy", list(STRATEGIES))
@pytest.mark.parametrize("sr_name", SR_NAMES)
def test_strategies_equal_dense_oracle(mesh, sr_name, strategy, fmt):
    sr = tsemiring.SEMIRINGS[sr_name]
    rows, cols, vals, x, fill, dense = problem(sr_name)
    want = oracle(sr_name, dense, x)
    for balance in ("rows", "nnz"):
        pm = tpart.partition(rows, cols, vals, (128, 128), STRATEGIES[strategy], fmt, sr,
                             block=BLOCK, balance=balance, device="cpu")
        for kernel in kernels_of(fmt):
            check(sr_name, run(mesh, pm, sr, strategy, x, fill, kernel=kernel), want,
                  f"{sr_name}/{strategy}/{fmt}/{kernel}/{balance}")


JAX_WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax, jax.numpy as jnp
from repro.core import *
from repro.core.distributed import make_distributed_matvec

rng = np.random.default_rng(1)
n = 128
dense_np = (rng.random((n, n)) < 0.08).astype(np.float32) * rng.integers(1, 9, (n, n))
rows, cols = np.nonzero(dense_np)
vals = dense_np[rows, cols].astype(np.float32)
if hasattr(jax.sharding, "AxisType"):
    mesh = jax.make_mesh((2, 4), ("dr", "dc"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
else:
    mesh = jax.make_mesh((2, 4), ("dr", "dc"))
out = {"rows": rows, "cols": cols}
for sr in (PLUS_TIMES, MIN_PLUS, BOOL_OR_AND):
    if sr.name == "min_plus":
        x = np.where(rng.random(n) < 0.3, rng.random(n), np.inf).astype(np.float32)
        v = vals; fill = np.inf
    elif sr.name == "bool_or_and":
        x = (rng.random(n) < 0.3).astype(np.int32)
        v = np.ones_like(vals, dtype=np.int32); fill = 0
    else:
        x = np.where(rng.random(n) < 0.3, rng.random(n), 0).astype(np.float32)
        v = vals; fill = 0.0
    out[f"{sr.name}/x"] = x
    out[f"{sr.name}/vals"] = v
    cases = [("row", (8, 1), "csr", "spmv"), ("row", (8, 1), "coo", "spmv"),
             ("col", (1, 8), "csc", "spmspv"), ("2d", (2, 4), "csc", "spmspv"),
             ("2d", (2, 4), "coo", "spmv"), ("row", (8, 1), "bsr", "spmv"),
             ("2d", (2, 4), "bsr", "spmspv")]
    for strategy, grid, fmt, kern in cases:
        for balance in ("rows", "nnz"):
            pm = partition(rows, cols, v, (n, n), grid, fmt, sr,
                           block=(16, 16), balance=balance)
            xs = jnp.asarray(pm.plan.shard_input_vector(x, fill), sr.dtype)
            fn = make_distributed_matvec(mesh, pm, sr, strategy, kernel=kern)
            out[f"{sr.name}/{strategy}/{fmt}/{kern}/{balance}"] = (
                pm.plan.unshard_output_vector(np.asarray(jax.jit(fn)(pm.parts, xs))))
np.savez(sys.argv[1], **out)
print("JAX_MESH_OK", len(out))
"""


@pytest.fixture(scope="module")
def jax_mesh_outputs(tmp_path_factory):
    """The JAX mesh closures' outputs on 8 forced host devices, computed once."""
    path = tmp_path_factory.mktemp("jax_mesh") / "outputs.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable, "-c", JAX_WORKER, str(path)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, f"stdout:\n{res.stdout}\nstderr:\n{res.stderr}"
    return dict(np.load(path))


@pytest.mark.parametrize("sr_name", ["plus_times", "min_plus", "bool_or_and"])
def test_port_equals_the_jax_mesh_closures(mesh, jax_mesh_outputs, sr_name):
    """The cases the JAX mesh runs under the installed jax, on the inputs
    the JAX run drew: the port's outputs equal JAX's."""
    out = jax_mesh_outputs
    sr = tsemiring.SEMIRINGS[sr_name]
    rows, cols = out["rows"], out["cols"]
    x, vals = out[f"{sr_name}/x"], out[f"{sr_name}/vals"]
    fill = np.inf if sr_name == "min_plus" else 0
    keys = [k for k in out if k.startswith(f"{sr_name}/") and k.count("/") == 4]
    assert len(keys) == 14
    for key in keys:
        _, strategy, fmt, kern, balance = key.split("/")
        pm = tpart.partition(rows, cols, vals, (128, 128), STRATEGIES[strategy], fmt, sr,
                             block=BLOCK, balance=balance, device="cpu")
        check(sr_name, run(mesh, pm, sr, strategy, x, fill, kernel=kern), out[key], key)


@pytest.mark.parametrize("grid", [(2, 4), (4, 3)])
@pytest.mark.parametrize("sr_name", ["plus_times", "min_plus", "plus_and"])
def test_every_topology_bit_equal_to_flat(grid, sr_name):
    """Integer-valued data makes every ⊕ order exact: ring, tree and
    staged2d (both orders on col) equal flat and the oracle bit for bit,
    for every strategy and balance; 12 devices give the tree a radix-3
    stage and the 2d merge an odd axis."""
    mesh = Mesh(grid, device="cpu")
    d = grid[0] * grid[1]
    n = 192 if d == 12 else 128
    sr = tsemiring.SEMIRINGS[sr_name]
    rows, cols, vals, x, fill, dense = problem(sr_name, seed=6, n=n, integer_x=True)
    want = oracle(sr_name, dense, x)
    for strategy, sgrid in (("row", (d, 1)), ("col", (1, d)), ("2d", grid)):
        for balance in ("rows", "nnz"):
            pm = tpart.partition(rows, cols, vals, (n, n), sgrid, "csr", sr, balance=balance,
                                 device="cpu")
            flat = run(mesh, pm, sr, strategy, x, fill)
            np.testing.assert_array_equal(flat, want)
            topos = [("ring", "rc"), ("tree", "rc"), ("staged2d", "rc")]
            if strategy == "col":
                topos.append(("staged2d", "cr"))
            for topology, order in topos:
                y = run(mesh, pm, sr, strategy, x, fill, topology=topology, merge_order=order)
                np.testing.assert_array_equal(y, flat, err_msg=f"{strategy}/{balance}/{topology}")


@pytest.mark.parametrize("sr_name", ["plus_times", "min_plus", "bool_or_and"])
def test_fused_equals_unfused(mesh, sr_name):
    """fused=True (kernels 3 and 5, chunk-major partials into merge_chunks
    where the block rows divide) equals fused=False bit for bit, through
    make_distributed_matvec and through build_phase_fns, whose fused dicts
    fold retrieve_merge into the kernel."""
    sr = tsemiring.SEMIRINGS[sr_name]
    rows, cols, vals, x, fill, _ = problem(sr_name, seed=5, integer_x=True)
    for strategy, grid in STRATEGIES.items():
        pm = tpart.partition(rows, cols, vals, (128, 128), grid, "bsr", sr, block=BLOCK,
                             device="cpu")
        for kernel in ("spmv", "spmspv"):
            for topology in ("flat", "ring", "tree"):
                y_u = run(mesh, pm, sr, strategy, x, fill, kernel=kernel, topology=topology)
                y_f = run(mesh, pm, sr, strategy, x, fill, kernel=kernel, topology=topology,
                          fused=True)
                np.testing.assert_array_equal(y_f, y_u, err_msg=f"{strategy}/{kernel}/{topology}")
        xs = tpart.shard_tensor(pm.plan, torch.from_numpy(x), fill)
        fns_u = dist.build_phase_fns(mesh, pm, sr, strategy, "spmv")
        fns_f = dist.build_phase_fns(mesh, pm, sr, strategy, "spmv", fused=True)
        if strategy != "row":
            assert fns_f["retrieve_merge"] is None
        assert torch.equal(run_phases_once(fns_f, pm.parts, xs),
                           run_phases_once(fns_u, pm.parts, xs))
    pm = tpart.partition(rows, cols, vals, (128, 128), (1, 8), "csc", sr, device="cpu")
    with pytest.raises(ValueError):
        dist.make_distributed_matvec(mesh, pm, sr, "col", fused=True)


def test_fused_takes_the_chunk_major_path(mesh, monkeypatch):
    """With the block rows divisible by the merge's chunk count the fused
    kernels write chunk-major partials and the Merge starts from them."""
    from repro_torch.core import collectives

    sr = tsemiring.PLUS_TIMES
    rows, cols, vals, x, fill, dense = problem("plus_times", seed=5)
    seen = []
    real = collectives.merge_chunks
    monkeypatch.setattr(dist, "merge_chunks",
                        lambda *a, **k: seen.append(a[1].shape) or real(*a, **k))
    for strategy in ("col", "2d"):
        pm = tpart.partition(rows, cols, vals, (128, 128), STRATEGIES[strategy], "bsr", sr,
                             block=BLOCK, device="cpu")
        y = run(mesh, pm, sr, strategy, x, fill, fused=True)
        check("plus_times", y, oracle("plus_times", dense, x), strategy)
    assert seen == [(8, 8, 16), (8, 4, 16)]


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("sr_name", ["plus_times", "min_plus", "bool_or_and"])
def test_batched_closures_equal_unbatched_rows(mesh, sr_name, fmt):
    """make_distributed_batched_matvec (kernels 1 and 2 over the block on
    BSR parts) equals make_distributed_matvec row by row, bit for bit."""
    sr = tsemiring.SEMIRINGS[sr_name]
    rows, cols, vals, x, fill, _ = problem(sr_name, seed=2)
    rng = np.random.default_rng(3)
    xs_np = np.stack([x, np.roll(x, 7), rng.permutation(x), np.full_like(x, fill), x])
    for strategy, grid in STRATEGIES.items():
        for balance in ("rows", "nnz"):
            pm = tpart.partition(rows, cols, vals, (128, 128), grid, fmt, sr, block=BLOCK,
                                 balance=balance, device="cpu")
            for kernel in kernels_of(fmt):
                xb = tpart.shard_tensor(pm.plan, torch.from_numpy(xs_np), fill, dim=1)
                fb = dist.make_distributed_batched_matvec(mesh, pm, sr, strategy,
                                                          kernel=kernel)
                got = tpart.unshard_tensor(pm.plan, fb(pm.parts, xb), dim=1).numpy()
                for b in range(xs_np.shape[0]):
                    np.testing.assert_array_equal(
                        got[b], run(mesh, pm, sr, strategy, xs_np[b], fill, kernel=kernel),
                        err_msg=f"{strategy}/{balance}/{kernel}/row {b}")


@pytest.mark.parametrize("fmt", ["csc", "bsr"])
def test_compressed_load_equals_dense_load(mesh, fmt):
    """f_local >= the largest shard's nonzeros: the compressed Load (a
    frontier per device crosses the fabric) gives the dense Load's bits,
    through make_distributed_matvec and build_phase_fns (whose kernel is
    then folded into e2e)."""
    for sr_name in ("plus_times", "min_plus", "bool_or_and"):
        sr = tsemiring.SEMIRINGS[sr_name]
        rows, cols, vals, x, fill, dense = problem(sr_name, seed=4)
        for strategy in ("row", "2d"):
            for balance in ("rows", "nnz"):
                pm = tpart.partition(rows, cols, vals, (128, 128), STRATEGIES[strategy], fmt,
                                     sr, block=BLOCK, balance=balance, device="cpu")
                xs = tpart.shard_tensor(pm.plan, torch.from_numpy(x), fill)
                f_local = int((xs != sr.zero).sum(dim=1).max())
                dense_load = run(mesh, pm, sr, strategy, x, fill, kernel="spmspv")
                y = run(mesh, pm, sr, strategy, x, fill, kernel="spmspv", f_local=f_local)
                np.testing.assert_array_equal(y, dense_load, err_msg=f"{sr_name}/{strategy}")
                fns = dist.build_phase_fns(mesh, pm, sr, strategy, "spmspv", f_local=f_local)
                assert fns["kernel"] is None
                idx, val = fns["load"](pm.parts, xs)
                assert idx.shape == val.shape
                np.testing.assert_array_equal(
                    tpart.unshard_tensor(pm.plan, run_phases_once(fns, pm.parts, xs)).numpy(),
                    dense_load)


def test_gather_frontier_is_the_per_device_frontier(mesh):
    """Device g's gathered frontier holds the compressed slices of its
    group in position order, offset into the gathered vector."""
    sr = tsemiring.MIN_PLUS
    x = torch.full((8, 16), float("inf"))
    x[torch.rand(8, 16, generator=torch.Generator().manual_seed(0)) < 0.3] = 2.0
    f = dist.gather_frontier(mesh, x, sr, 5, "dr")
    for g in range(8):
        fg = dist.frontier_of(f, g)
        c = g % 4
        want = torch.cat([x[c], x[4 + c]])
        parts = [frontier_from_dense(x[r * 4 + c], sr, f_max=5) for r in (0, 1)]
        assert int(fg.count) == sum(int(p.count) for p in parts)
        dense = fg.to_dense(sr)
        kept = torch.cat([p.to_dense(sr) for p in parts])
        assert torch.equal(dense, kept) and fg.n == want.shape[0]


@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_distributed_spgemm_equals_single_device(mesh, strategy):
    """C = (A ⊕.⊗ B) ⊙ M over the mesh equals the JAX package's
    single-device spgemm_masked on the dense matrix: 0/1 ⟨+,∧⟩ and
    integer-valued ⟨+,×⟩ and ⟨min,+⟩ exactly, on BSR (the front door of
    kernels 6/6b) and CSR parts, with and without a mask."""
    rng = np.random.default_rng(7)
    n, width = 128, 24
    for sr_name in ("plus_and", "plus_times", "min_plus"):
        sr = tsemiring.SEMIRINGS[sr_name]
        rows, cols, vals, _, fill, dense = problem(sr_name, seed=8)
        if sr_name == "plus_and":
            b = (rng.random((n, width)) < 0.3).astype(np.int32)
        else:
            b = rng.integers(0, 5, (n, width)).astype(np.float32)
        mask = (rng.random((n, width)) < 0.5).astype(np.float32)
        mask = np.where(mask > 0, sr.one, sr.zero).astype(b.dtype)
        jsr = jsemiring.SEMIRINGS[sr_name]
        a1 = jnp.asarray(dense, jsr.dtype)
        for masked in (False, True):
            mk = torch.from_numpy(mask) if masked else None
            want = torch.from_numpy(np.array(jspgemm_masked(
                a1, jnp.asarray(b, jsr.dtype), jsr,
                mask=jnp.asarray(mask, jsr.dtype) if masked else None)))
            for fmt in ("bsr", "csr"):
                for balance in ("rows", "nnz"):
                    pm = tpart.partition(rows, cols, vals, (n, n), STRATEGIES[strategy], fmt,
                                         sr, block=BLOCK, balance=balance, device="cpu")
                    bs = tpart.shard_tensor(pm.plan, torch.from_numpy(b), sr.one)
                    ms = (tpart.shard_tensor(pm.plan, mk, sr.zero, side="output")
                          if masked else None)
                    fn = dist.make_distributed_spgemm(mesh, pm, sr, strategy)
                    got = tpart.unshard_tensor(pm.plan, fn(pm.parts, bs, ms))
                    assert torch.equal(got, want), f"{sr_name}/{fmt}/{balance}/{masked}"


def test_kernel_phase_runs_once_per_device_on_views(mesh, monkeypatch):
    """One Kernel phase is D front-door calls, device order, each on a
    contiguous view of the stacked tiles (no copy)."""
    sr = tsemiring.PLUS_TIMES
    rows, cols, vals, x, fill, _ = problem("plus_times")
    pm = tpart.partition(rows, cols, vals, (128, 128), (2, 4), "bsr", sr, block=BLOCK,
                         device="cpu")
    base = pm.parts.tiles.data_ptr()
    per = pm.parts.tiles[0].numel() * pm.parts.tiles.element_size()
    seen = []
    real = ops.semiring_spmv

    def spy(a, xx, s):
        assert a.tiles.is_contiguous() and xx.is_contiguous()
        seen.append((a.tiles.data_ptr() - base) // per)
        return real(a, xx, s)

    monkeypatch.setattr(ops, "semiring_spmv", spy)
    fns = dist.build_phase_fns(mesh, pm, sr, "2d", "spmv")
    xs = tpart.shard_tensor(pm.plan, torch.from_numpy(x), fill)
    xf = fns["load"](pm.parts, xs)
    fns["kernel"](pm.parts, xs, xf)
    assert seen == list(range(8))


@pytest.mark.parametrize("topology", ["flat", "ring", "tree", "staged2d"])
def test_no_host_copies_after_the_first_call(mesh, monkeypatch, topology):
    """After its first call, a distributed SpMV or SpMSpV on BSR parts
    under every Merge topology (and staged2d's cr order on col), fused or
    not, with the dense or the compressed Load, and a pipelined iteration
    through its phase closures make no tensor from host data, and no call,
    the first included, reads back (the profiler counts no
    ``aten::_local_scalar_dense``): the front doors build their metadata on
    the device and the mesh keeps its index tables there. On the card a host-to-device copy without
    ``non_blocking`` ends in a stream synchronise, so one such copy per
    ring or tree step would turn the depth-2 pipeline into the blocking
    schedule. The tile-kernel wrappers are stubbed with a zero output of
    their shape: their plain CPU versions read n_active to size their
    loops (the CUDA kernels do not), so what is checked is the code that
    runs around the kernels on the card."""
    from torch.profiler import ProfilerActivity, profile

    def stub(tiles, index, x, *, sr, chunks=None):
        y = torch.zeros(tiles.shape[0] * tiles.shape[2], dtype=sr.dtype)
        return y if chunks is None else y.view(chunks, -1)

    for name in ("semiring_spmv_padded", "semiring_spmspv_padded",
                 "semiring_spmv_fused_padded", "semiring_spmspv_fused_padded"):
        monkeypatch.setattr(ops, name, stub)
    sr = tsemiring.MIN_PLUS
    rows, cols, vals, x, fill, _ = problem("min_plus")
    made = []

    def spy_on_host_tensors():
        for name in ("from_numpy", "tensor", "as_tensor"):
            real = getattr(torch, name)
            monkeypatch.setattr(torch, name, lambda *a, _r=real, _n=name, **k:
                                made.append(_n) or _r(*a, **k))

    calls = []
    for strategy, grid in STRATEGIES.items():
        pm = tpart.partition(rows, cols, vals, (128, 128), grid, "bsr", sr, block=BLOCK,
                             device="cpu")
        xs = tpart.shard_tensor(pm.plan, torch.from_numpy(x), fill)
        orders = ("rc", "cr") if strategy == "col" and topology == "staged2d" else ("rc",)
        for order in orders:
            kw = {"topology": topology, "merge_order": order}
            forms = [(k, f, None) for k in ("spmv", "spmspv") for f in (False, True)]
            if strategy != "col":
                forms.append(("spmspv", False, 32))          # the compressed Load
            for kernel, fused, f_local in forms:
                fn = dist.make_distributed_matvec(mesh, pm, sr, strategy, kernel=kernel,
                                                  fused=fused, f_local=f_local, **kw)
                calls.append((f"{strategy}/{order}/{kernel}/{fused}/{f_local}",
                              lambda fn=fn, pm=pm, xs=xs: fn(pm.parts, xs)))
            if strategy != "col" or order == "rc":
                fns = dist.build_phase_fns(mesh, pm, sr, strategy, "spmv", **kw)
                calls.append((f"{strategy}/{order}/iterate",
                              lambda fns=fns, pm=pm, xs=xs: iterate_phases(fns, pm.parts, xs, 3,
                                                                           depth=2)))

    def reads(call) -> int:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            call()
        return sum(e.count for e in prof.key_averages() if e.key == "aten::_local_scalar_dense")

    for tag, call in calls:
        assert reads(call) == 0, tag                # the first call builds the tables
    spy_on_host_tensors()
    for tag, call in calls:
        assert (reads(call), made) == (0, []), tag


def test_phase_closures_equal_e2e_and_trace(mesh):
    """run_phases_once through every strategy's closures equals e2e;
    donate=True is inert; with a tracer each phase is one span carrying
    its bytes (Load elements, Merge wire) and steps."""
    sr = tsemiring.PLUS_TIMES
    rows, cols, vals, x, fill, _ = problem("plus_times")
    for strategy, grid in STRATEGIES.items():
        pm = tpart.partition(rows, cols, vals, (128, 128), grid, "bsr", sr, block=BLOCK,
                             device="cpu")
        xs = tpart.shard_tensor(pm.plan, torch.from_numpy(x), fill)
        for kernel in ("spmv", "spmspv"):
            fns = dist.build_phase_fns(mesh, pm, sr, strategy, kernel, donate=True,
                                       topology="ring")
            y = run_phases_once(fns, pm.parts, xs)
            assert torch.equal(y, fns["e2e"](pm.parts, xs))
            assert torch.equal(y, run_phases_once(fns, pm.parts, xs))
        with trace.tracing() as t:
            run_phases_once(fns, pm.parts, xs)
        names = [s.name for s in t.spans]
        want = {"row": ["phase/load", "phase/kernel"], "col": ["phase/kernel",
                "phase/retrieve_merge"], "2d": ["phase/load", "phase/kernel",
                                                "phase/retrieve_merge"]}[strategy]
        assert names == want
        rm = [s for s in t.spans if s.name == "phase/retrieve_merge"]
        if rm:
            assert rm[0].attrs["steps"] == (7 if strategy == "col" else 3)
            assert rm[0].attrs["bytes"] > 0


def test_partitioned_matvec_auto_and_fixed(mesh):
    """graphs.multi.partitioned_matvec: the planner's auto pick and fixed
    strategy:balance specs run on the mesh and equal the dense oracle; the
    choice equals the JAX planner's on the same graph."""
    tg, jg = tdata.generate("ca-Q", 0.05, 0), jdata.generate("ca-Q", 0.05, 0)
    sr = tsemiring.BOOL_OR_AND
    n = tg.n
    rng = np.random.default_rng(0)
    x = (rng.random(n) < 0.2).astype(np.int32)
    dense = np.zeros((n, n), np.int32)
    dense[tg.cols, tg.rows] = 1
    want = oracle("bool_or_and", dense, x)
    for spec, topo, kernel, fmt in (("auto", "auto", "spmv", None), ("row:nnz", "flat",
                                    "spmspv", None), ("2d", "ring", "spmspv", "bsr"),
                                    ("col", "auto", "spmv", "bsr")):
        pm, fn, choice = partitioned_matvec(tg, sr, mesh, strategy=spec, topology=topo,
                                            kernel=kernel, fmt=fmt)
        s, b = jcost.parse_strategy(spec)
        strategies, balances = jcost.candidate_space(s, b)
        jchoice = jcost.plan_for_graph(jg, n_devices=8, grid2d=(2, 4), kernel=kernel,
                                       strategies=strategies, balances=balances)
        assert (choice.strategy, choice.balance, choice.merge, choice.merge_order) == \
            (jchoice.strategy, jchoice.balance, jchoice.merge, jchoice.merge_order)
        xp = np.zeros(pm.plan.shape[1], np.int32)
        xp[:n] = x
        xs = tpart.shard_tensor(pm.plan, torch.from_numpy(xp), 0)
        y = tpart.unshard_tensor(pm.plan, fn(pm.parts, xs)).numpy()[:n]
        np.testing.assert_array_equal(y, want, err_msg=spec)
    pm, fb, _ = partitioned_matvec(tg, sr, mesh, strategy="2d", batched=True)
    xb = tpart.shard_tensor(pm.plan, torch.from_numpy(np.stack([xp, xp])), 0, dim=1)
    yb = tpart.unshard_tensor(pm.plan, fb(pm.parts, xb), dim=1).numpy()
    np.testing.assert_array_equal(yb[1, :n], want)


def test_strategy_and_mesh_mismatches_raise(mesh):
    sr = tsemiring.PLUS_TIMES
    rows, cols, vals, *_ = problem("plus_times")
    pm = tpart.partition(rows, cols, vals, (128, 128), (8, 1), "csr", sr, device="cpu")
    for bad in (lambda: dist.make_distributed_matvec(mesh, pm, sr, "col"),
                lambda: dist.make_distributed_matvec(mesh, pm, sr, "diag"),
                lambda: dist.make_distributed_matvec(Mesh((2, 2), device="cpu"), pm, sr, "row")):
        with pytest.raises(ValueError):
            bad()
    pm = tpart.partition(rows, cols, vals, (128, 128), (4, 2), "csr", sr, device="cpu")
    with pytest.raises(ValueError):
        dist.make_distributed_matvec(mesh, pm, sr, "2d")
