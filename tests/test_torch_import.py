"""The port stands alone: it imports neither ``jax`` nor ``repro``, and its
entry points refuse to run on the host unless asked to."""
import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch

PKG = pathlib.Path(repro_torch.__file__).parent
ROOT = PKG.parents[1]
MODULES = sorted(
    ".".join(p.relative_to(PKG.parent).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py"))


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_every_module_imports_with_jax_and_repro_blocked():
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            f"for m in {MODULES!r}:\n"
            "    __import__(m)\n"
            "print('imported', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


def test_entry_points_raise_without_a_gpu(monkeypatch):
    from repro_torch.convert import bsr_from_numpy, padded_bsr_from_numpy, sliced_ell_from_numpy
    from repro_torch.core import (
        PLUS_TIMES, autotune_sell, build_bsr, build_bsr_padded, build_csr, build_sell,
    )
    from repro_torch.graphs import build_engine, generate, triangle_count
    from repro_torch.graphs.analytics import triangle_problem

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = generate("face", scale=0.02, seed=0)
    rows, cols = g.rows.astype(np.int32), g.cols.astype(np.int32)
    vals = np.ones(g.nnz, np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine(g, PLUS_TIMES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine(g, PLUS_TIMES, fmt_spmv="bsr", fmt_spmspv="bsr")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_bsr_padded(rows, cols, vals, (g.n, g.n), PLUS_TIMES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_csr(rows, cols, vals, (g.n, g.n), PLUS_TIMES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        padded_bsr_from_numpy(np.zeros((1, 1, 2, 2), np.float32), np.zeros((1, 1), np.int32),
                              (2, 2), (2, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_sell(rows, cols, vals, (g.n, g.n), PLUS_TIMES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune_sell(rows, cols, vals, (g.n, g.n), PLUS_TIMES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_bsr(rows, cols, vals, (g.n, g.n), PLUS_TIMES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sliced_ell_from_numpy(np.zeros((1, 2, 2), np.float32), np.zeros(1, np.int32),
                              np.zeros((1, 3), np.int32), (2, 2), (2, 2), 1, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bsr_from_numpy(np.zeros((1, 2, 2), np.float32), np.zeros(1, np.int32),
                       np.zeros(2, np.int32), (2, 2), (2, 2))
    for impl in ("csr", "bsr", "dense"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            triangle_problem(g, impl)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            triangle_count(g, impl)
    eng = build_engine(g, PLUS_TIMES, device="cpu")
    assert eng.device.type == "cpu"


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    from repro_torch.core import BOOL_OR_AND, build_bsr_padded
    from repro_torch.kernels.semiring_spmv import semiring_spmv_padded
    from repro_torch.kernels.spmspv_tiles import semiring_spmspv_padded
    from repro_torch.kernels import ops
    from repro_torch.core import frontier_from_dense

    before = (semiring_spmv_padded.launches, semiring_spmspv_padded.launches)
    rows = np.array([0, 1, 5], np.int32)
    cols = np.array([3, 0, 2], np.int32)
    a = build_bsr_padded(rows, cols, np.ones(3, np.int32), (8, 8), BOOL_OR_AND,
                         block=(4, 4), device="cpu")
    x = torch.tensor([1, 0, 0, 1, 0, 0, 0, 0], dtype=torch.int32)
    assert ops.semiring_spmv(a, x, BOOL_OR_AND).tolist() == [1, 1, 0, 0, 0, 0, 0, 0]
    f = frontier_from_dense(x, BOOL_OR_AND)
    assert ops.semiring_spmspv(a, f, BOOL_OR_AND).tolist() == [1, 1, 0, 0, 0, 0, 0, 0]
    assert (semiring_spmv_padded.launches, semiring_spmspv_padded.launches) == before


def test_wrapper_rejects_bad_operands():
    from repro_torch.core import MIN_PLUS
    from repro_torch.kernels.semiring_spmv import semiring_spmv_padded

    tiles = torch.zeros((2, 3, 4, 4))
    cols = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        semiring_spmv_padded(tiles.int(), cols, torch.zeros(8, dtype=torch.int32), sr=MIN_PLUS)
    with pytest.raises(ValueError, match="index"):
        semiring_spmv_padded(tiles, cols.long(), torch.zeros(8), sr=MIN_PLUS)
    with pytest.raises(ValueError, match="multiple of bn"):
        semiring_spmv_padded(tiles, cols, torch.zeros(6), sr=MIN_PLUS)
    with pytest.raises(ValueError, match="contiguous"):
        semiring_spmv_padded(tiles.transpose(2, 3), cols, torch.zeros(8), sr=MIN_PLUS)


def test_chip_smoke_refuses_to_run_without_cuda():
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_lm_entry_points_raise_without_a_gpu(monkeypatch):
    from repro_torch.convert import (
        gqa_cache_from_numpy, mla_cache_from_numpy, model_params_from_numpy,
    )
    from repro_torch.models.transformer import Model, build_model
    from repro_torch.models.zoo import ARCH_IDS, get_config, get_model, reduced_config
    from repro_torch.serve.engine import ServingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config("deepseek-v2-lite-16b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(get_config("deepseek-v2-lite-16b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_params_from_numpy(cfg, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mla_cache_from_numpy(np.zeros((1, 1, 2, 4)), np.zeros((1, 1, 2, 2)), np.zeros(1),
                             torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gqa_cache_from_numpy(np.zeros((1, 1, 2, 1, 4)), np.zeros((1, 1, 2, 1, 4)), np.zeros(1),
                             torch.float32)
    for arch in ARCH_IDS:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(reduced_config(arch))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model("hubert-xlarge")
    model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(model)
    assert ServingEngine(model, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="unknown model family"):
        build_model(dataclasses.replace(cfg, family="no-such-family"), device="cpu")


def test_train_launcher_raises_without_a_gpu(monkeypatch, tmp_path):
    from repro_torch.launch.train import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())


def _top_level_names(path: pathlib.Path) -> set[str]:
    return {n.name for n in ast.parse(path.read_text()).body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}


@pytest.mark.parametrize("module,scope", [("core/delta.py", "all"), ("obs/trace.py", "all"),
                                          ("train/data.py", "all"),
                                          ("launch/dryrun.py", "all"),
                                          ("launch/mesh.py", "all"),
                                          ("core/pipeline.py", "subset"),
                                          ("graphs/multi.py", "subset"),
                                          ("graphs/dynamic.py", "subset"),
                                          ("train/optimizer.py", "subset"),
                                          ("train/checkpoint.py", "subset"),
                                          ("distributed/fault_tolerance.py", "subset")])
def test_ported_modules_keep_the_reference_names(module, scope):
    """The port's own copies of the JAX package's pure-Python modules
    (delta, trace, the data pipeline) and its dry run and meshes define
    every function and class the reference does; the ported multi-source, pipeline, dynamic, optimizer,
    checkpoint and fault-tolerance modules define only names the reference
    has (``_np``/``_block``/``_synchronize``/``_check_semiring``/``_traces``,
    the optimizer's ``_clip_scale`` and the checkpoint's ``_is_namedtuple``/
    ``_to_host``/``_load``/``_rebuild`` are the port's helpers). The meshes
    add one name of the port's own, ``rank_mesh`` (one rank per device,
    ``core/rank_mesh.py``). Read from the source text, so nothing of the
    reference is imported."""
    ported = _top_level_names(PKG / module)
    reference = _top_level_names(ROOT / "src" / "repro" / module)
    helpers = {"_np", "_block", "_synchronize", "_check_semiring", "_traces",
               "_clip_scale", "_is_namedtuple", "_to_host", "_load", "_rebuild"}
    if scope == "all":
        assert ported - {"launch/mesh.py": {"rank_mesh"}}.get(module, set()) == reference
    else:
        assert ported - helpers <= reference, ported - helpers - reference


def test_multi_source_runs_where_its_engine_lives():
    from repro_torch.core import BOOL_OR_AND
    from repro_torch.graphs import bfs_multi, build_engine, generate

    g = generate("face", scale=0.02, seed=0)
    eng = build_engine(g, BOOL_OR_AND, device="cpu")
    res = bfs_multi(eng, [0, 1])
    assert res.levels.device.type == "cpu" and tuple(res.levels.shape) == (2, g.n)
