"""The port's mesh train steps held to the JAX package's.

The reference's ``make_train_step`` and ``make_compressed_train_step`` run
in a subprocess on 8 forced host devices, on a (pod 2, data 2, model 2)
mesh of ``AxisType.Auto`` axes (jax 0.9's default Explicit axes make
``with_sharding_constraint`` refuse the reference's specs), for 3 steps
of ``SyntheticLM`` (8 × 16 tokens, 2 microbatches) from the same numpy
weights. The port runs ``make_train_step`` and
``make_compressed_train_step`` on ``small_mesh(2, 2, 2)`` of virtual CPU
devices. Each step is held from the reference's state before it (loaded
through ``shard_state``), so no earlier step's last bits carry over:

* the plain step at ``tests/test_torch_train.py``'s one-step tolerances:
  the loss within rtol 1e-5, the grad norm 1e-4, mu and nu rtol 1e-3 and
  atol 1e-5·max|leaf|, master rtol 1e-5 and atol 1e-6·max|leaf| where
  |mu| clears 1e-2·max|mu| (the first AdamW update's sign near g = 0);
* the compressed step, whose int8 codes may move by one where a
  gradient's last bits differ: the loss within rtol 1e-5 and the grad
  norm 1e-4 (a code move is a few ulps of the norm); each pod's
  error-feedback buffer equal to the reference pod's within 1e-3 of the
  quantization step except at ≤ 0.5% of entries, where it differs by one
  step; master, mu and nu at the plain tolerances except at ≤ 2% of
  entries (the entries a moved code reaches).

Then the free-running 3-step trajectories' losses within rtol 1e-5
(plain) and 1e-4 (compressed). In the reference each pod keeps its own
error-feedback buffer (its devices' shards differ between pods) and the
host reads pod 0's: ``make_compressed_train_step`` keeps one per pod in
its devices' ZeRO-1 blocks, and its gather reads pod 0's. This file runs
minitron (2 layers); ``test_torch_mesh_train_moe.py`` runs DeepSeek at
top-2 (the sparse dispatch, kernel 7's plain version, the EP regime).

Also: on a 1×1 mesh the mesh step is ``torch.equal`` to ``train_step_fn``
(loss, grad norm, every parameter and state leaf); the reference's
elastic rescale (a checkpoint written on (2, 2) restored onto (4, 1) and
(1, 8), bit for bit, blocks of ``param_shardings``' shard shapes); the
launcher with mesh flags, its loss falling.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from repro.distributed import sharding as jsharding
from repro.models import zoo as jzoo
from repro.models.transformer import build_model as jbuild_model

from repro_torch.distributed.sharding import (
    Sharded, param_shardings, set_activation_mesh, shard_state, tree_map, unshard_state,
    zero1_shardings,
)
from repro_torch.launch.mesh import small_mesh
from repro_torch.launch.train import main
from repro_torch.models import zoo
from repro_torch.models.transformer import build_model, model_specs
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.optimizer import OptConfig, OptState
from repro_torch.train.train_loop import (
    TrainConfig, device_batch, init_mesh_state, init_train_state, make_compressed_train_step,
    make_train_step, train_step_fn,
)

REPO_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
STEPS = 3
OPT = OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
TCFG = TrainConfig(opt=OPT, microbatches=2)

# arch, top-k (0: the config's), layers (0: the reduced config's), seed,
# steps, step kinds, output path
REF_WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from repro.models import zoo
from repro.models.transformer import build_model
from repro.train.data import DataConfig, SyntheticLM
from repro.train.grad_compress import ef_init
from repro.train.optimizer import OptConfig, adamw_init
from repro.train.train_loop import TrainConfig, make_compressed_train_step, make_train_step
from repro.distributed.sharding import set_activation_mesh

def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

arch, top_k, layers, seed, steps = sys.argv[1], *map(int, sys.argv[2:6])
kinds, path = sys.argv[6].split(","), sys.argv[7]
cfg = zoo.reduced_config(arch, 0.05)
if layers:
    cfg = dataclasses.replace(cfg, n_layers=layers)
if top_k:
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, top_k=top_k))
model = build_model(cfg)
rng = np.random.default_rng(seed)
params_np = jax.tree.map(
    lambda s: (rng.standard_normal(s.shape) / np.sqrt(s.shape[-1])).astype(np.float32)
    if s.init != "ones" else np.ones(s.shape, np.float32),
    model.specs(), is_leaf=lambda s: hasattr(s, "init"))
out = {f"init{k}": v for k, v in flat(params_np).items()}
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
pods = [{d.id for d in mesh.devices[p].reshape(-1)} for p in range(2)]
tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2, total_steps=10), microbatches=2)
src = SyntheticLM(DataConfig(global_batch=8, seq_len=16, vocab=cfg.vocab))
for kind in kinds:
    params = jax.tree.map(lambda a: jnp.asarray(a, cfg.dtype), params_np)
    opt, ef = adamw_init(params), ef_init(params)
    step = (make_train_step(model, mesh, tcfg, donate=False) if kind == "plain"
            else make_compressed_train_step(model, mesh, tcfg))
    for i in range(steps):
        b = {k: jnp.asarray(v) for k, v in src.batch(i, 0, 1).items()}
        if kind == "plain":
            params, opt, m = step(params, opt, b)
        else:
            params, opt, ef, m = step(params, opt, ef, b)
        pre = f"{kind}/s{i}/"
        out[pre + "loss"] = np.float32(m["loss"])
        out[pre + "grad_norm"] = np.float32(m["grad_norm"])
        for f in ("master", "mu", "nu"):
            out.update({f"{pre}{f}{k}": v for k, v in flat(getattr(opt, f)).items()})
        if kind == "compressed":
            for pth, leaf in jax.tree_util.tree_flatten_with_path(ef)[0]:
                k = jax.tree_util.keystr(pth)
                out[f"{pre}ef_host{k}"] = np.asarray(leaf)
                for p in range(2):       # the blocks of pod p's devices, assembled
                    full = np.full(leaf.shape, np.nan, np.float32)
                    for sh in leaf.addressable_shards:
                        if sh.device.id in pods[p]:
                            full[sh.index] = np.asarray(sh.data)
                    out[f"{pre}ef{p}{k}"] = full
    set_activation_mesh(None)
np.savez(path, **out)
print("MESH_TRAIN_OK", len(out))
"""


def run_reference(tmp_path, arch: str, top_k: int, layers: int, kinds: str) -> dict:
    """The reference's mesh steps' outputs (a dict of numpy arrays)."""
    out = tmp_path / "ref.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_SRC + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", REF_WORKER, arch, str(top_k), str(layers), "7",
                          str(STEPS), kinds, str(out)],
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0 and "MESH_TRAIN_OK" in res.stdout, res.stdout + res.stderr[-4000:]
    return dict(np.load(out))


def port_config(arch: str, top_k: int, layers: int):
    cfg = zoo.reduced_config(arch, 0.05)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if top_k:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, top_k=top_k))
    return cfg


def _tree(ref: dict, prefix: str) -> dict:
    """The JAX tree under ``prefix`` (keys as ``jax.tree_util.keystr``)."""
    tree: dict = {}
    for key, v in ref.items():
        if key.startswith(prefix) and key[len(prefix):].startswith("["):
            path = key[len(prefix) + 2:-2].split("']['")
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = v
    return tree


def _flat(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}['{k}']")
        else:
            yield f"{prefix}['{k}']", v


def _zeros(tree: dict) -> dict:
    return {k: _zeros(v) if isinstance(v, dict) else np.zeros_like(v) for k, v in tree.items()}


def mesh_state_from_reference(model, mesh, ref: dict, prefix: str, step: int):
    """(params, OptState, per-pod error feedback) on ``mesh`` from the
    reference's state under ``prefix`` ("init": before the first step)."""
    specs = model_specs(model.cfg)
    p_sh, z_sh = param_shardings(mesh, specs), zero1_shardings(mesh, specs)
    if prefix == "init":
        master = _tree(ref, "init")
        mu = nu = _zeros(master)
        efs = [_zeros(master)] * 2
    else:
        master, mu, nu = (_tree(ref, prefix + f) for f in ("master", "mu", "nu"))
        efs = [_tree(ref, prefix + f"ef{p}") for p in range(2)]
    params = shard_state(master, p_sh, model.cfg.dtype)
    opt = OptState(torch.tensor(step, dtype=torch.int32),
                   *(shard_state(t, z_sh, torch.float32) for t in (master, mu, nu)))

    def pods(e0, e1, sh):          # each pod's buffer into its devices' blocks
        both = torch.stack([torch.from_numpy(e0), torch.from_numpy(e1)])
        return Sharded(mesh.scatter_full(both, sh.spec, keep="pod"), sh, e0.shape)
    return params, opt, tree_map(pods, efs[0], efs[1], z_sh)


def _ok(got, want, rtol, atol, where):
    return (np.abs(got - want) <= atol + rtol * np.abs(want)) | ~where


def check_state(opt, ref: dict, prefix: str, share: float = 0.0):
    """master, mu and nu against the reference's at the one-step
    tolerances; at most ``share`` of the entries may lie outside them."""
    mus = dict(_flat(_tree(ref, prefix + "mu")))
    bad = total = 0
    for f in ("master", "mu", "nu"):
        got = dict(_flat(unshard_state(getattr(opt, f))))
        for k, want in _flat(_tree(ref, prefix + f)):
            g = got[k].float().numpy()
            scale = float(np.abs(want).max())
            if f == "master":
                where = np.abs(mus[k]) > 1e-2 * np.abs(mus[k]).max()
                ok = _ok(g, want, 1e-5, 1e-6 * scale, where)
            else:
                ok = _ok(g, want, 1e-3, 1e-5 * scale, np.ones(want.shape, bool))
            if share == 0.0:
                assert ok.all(), (f, k, np.abs(g - want)[~ok][:5])
            bad += int((~ok).sum())
            total += ok.size
    assert bad <= share * total, (bad, total)


def check_ef(ef, ref: dict, prefix: str, mesh):
    """Each pod's error-feedback buffer against the reference pod's."""
    bad = total = 0
    for p in range(2):
        for k, want in _flat(_tree(ref, f"{prefix}ef{p}")):
            e = dict(_flat(ef))[k]
            got = mesh.gather_full(e.blocks, e.sharding.spec, keep="pod")[p].numpy()
            step = 2 * float(np.abs(want).max()) + 1e-30     # ≥ the quantization step
            diff = np.abs(got - want)
            assert diff.max() <= 1.01 * step, (p, k, diff.max(), step)
            bad += int((diff > 1e-3 * step).sum())
            total += diff.size
    assert bad <= 0.005 * total, (bad, total)


def hold_steps(tmp_path, arch: str, top_k: int, layers: int, kinds: str):
    """Every step of ``kinds`` from the reference's state before it, then
    the free-running trajectory, against the reference."""
    ref = run_reference(tmp_path, arch, top_k, layers, kinds)
    cfg = port_config(arch, top_k, layers)
    src = SyntheticLM(DataConfig(global_batch=8, seq_len=16, vocab=cfg.vocab))
    batches = [device_batch(src.batch(i, 0, 1), "cpu") for i in range(STEPS)]
    mesh = small_mesh(2, 2, 2, device="cpu")
    try:
        for kind in kinds.split(","):
            model = build_model(cfg, device="cpu")
            compressed = kind == "compressed"
            step = (make_compressed_train_step if compressed else make_train_step)(
                model, mesh, TCFG)
            losses = []
            for i in range(STEPS):            # each step from the reference's state
                params, opt, ef = mesh_state_from_reference(
                    model, mesh, ref, "init" if i == 0 else f"{kind}/s{i - 1}/", i)
                if compressed:
                    params, opt, ef, m = step(params, opt, ef, batches[i])
                else:
                    params, opt, m = step(params, opt, batches[i])
                pre = f"{kind}/s{i}/"
                np.testing.assert_allclose(float(m["loss"]), ref[pre + "loss"], rtol=1e-5)
                np.testing.assert_allclose(float(m["grad_norm"]), ref[pre + "grad_norm"],
                                           rtol=1e-4)
                check_state(opt, ref, pre, share=0.02 if compressed else 0.0)
                if compressed:
                    check_ef(ef, ref, pre, mesh)
            params, opt, ef = mesh_state_from_reference(model, mesh, ref, "init", 0)
            for i in range(STEPS):            # free-running
                if compressed:
                    params, opt, ef, m = step(params, opt, ef, batches[i])
                else:
                    params, opt, m = step(params, opt, batches[i])
                losses.append(float(m["loss"]))
            want = [ref[f"{kind}/s{i}/loss"] for i in range(STEPS)]
            np.testing.assert_allclose(losses, want, rtol=1e-4 if compressed else 1e-5)
    finally:
        set_activation_mesh(None)
    return ref


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's tests, restored after (see
    ``tests/test_torch_lm_train.py``): small models make many small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_activation_mesh():
    """The step builders set the process-global activation mesh, as the
    reference's do; a later single-device MoE test must not run under it."""
    yield
    set_activation_mesh(None)


def test_minitron_mesh_steps_match_the_reference(tmp_path):
    ref = hold_steps(tmp_path, "minitron-4b", 0, 2, "plain,compressed")
    # the reference's pods keep their own buffers; the host reads pod 0's
    for k, e0 in _flat(_tree(ref, "compressed/s2/ef0")):
        assert np.array_equal(e0, ref[f"compressed/s2/ef_host{k}"])
        assert not np.array_equal(e0, ref[f"compressed/s2/ef1{k}"])


@pytest.mark.parametrize("arch,top_k", [("minitron-4b", 0), ("deepseek-v2-lite-16b", 2)])
def test_one_by_one_mesh_step_equals_the_single_device_step(arch, top_k):
    cfg = port_config(arch, top_k, 2)
    tcfg = TrainConfig(opt=OPT, microbatches=2)
    src = SyntheticLM(DataConfig(global_batch=4, seq_len=16, vocab=cfg.vocab))
    m1 = build_model(cfg, device="cpu")
    p1, o1 = init_train_state(m1, seed=3)
    one = train_step_fn(m1, tcfg)
    m2 = build_model(cfg, device="cpu").init(seed=3)
    mesh = small_mesh(1, 1, device="cpu")
    p2, o2 = init_mesh_state(m2, mesh)
    step = make_train_step(m2, mesh, tcfg)
    for i in range(2):
        b = device_batch(src.batch(i, 0, 1), "cpu")
        set_activation_mesh(None)
        p1, o1, a = one(p1, o1, b)
        set_activation_mesh(mesh)
        p2, o2, c = step(p2, o2, b)
        assert torch.equal(a["loss"], c["loss"]) and torch.equal(a["grad_norm"], c["grad_norm"])
    from repro_torch.convert import stack_model_params
    want = stack_model_params(cfg, p1)
    for f, tree in (("params", p2), ("master", o2.master), ("mu", o2.mu), ("nu", o2.nu)):
        ref_tree = want if f == "params" else stack_model_params(cfg, getattr(o1, f))
        for k, v in _flat(unshard_state(tree)):
            assert torch.equal(v, dict(_flat(ref_tree))[k]), (f, k)
    assert int(o2.step) == int(o1.step) == 2


def test_elastic_restore_across_meshes(tmp_path):
    """The reference's ``test_elastic_rescale_subprocess``: a checkpoint of
    the parameters written on a (2, 2) mesh restores onto (4, 1) and
    (1, 8), every leaf bit for bit, in the reference's shard shapes."""
    cfg = port_config("minitron-4b", 0, 2)
    model = build_model(cfg, device="cpu").init(seed=0)
    a = small_mesh(2, 2, device="cpu")
    params, _ = init_mesh_state(model, a)
    ckpt.save(str(tmp_path), 1, {"params": params})
    saved = dict(_flat(unshard_state(params)))
    jspecs = jbuild_model(dataclasses.replace(jzoo.reduced_config("minitron-4b", 0.05),
                                              n_layers=2)).specs()
    for shape in [(4, 1), (1, 8)]:
        mesh_b = small_mesh(*shape, device="cpu")
        sh_b = param_shardings(mesh_b, model_specs(cfg))
        got, _ = ckpt.restore(str(tmp_path), 1, {"params": params}, {"params": sh_b})
        jsh = jsharding.param_shardings(AbstractMesh(shape, ("data", "model")), jspecs)
        jflat = dict(_flat(jsh))
        for k, leaf in _flat(got["params"]):
            assert isinstance(leaf, Sharded) and leaf.sharding.mesh is mesh_b
            assert leaf.blocks.shape[0] == shape[0] * shape[1]
            assert leaf.block_shape == jflat[k].shard_shape(leaf.shape), k
            assert torch.equal(leaf.full(), saved[k]), k
        # the live blocks restore in place too
        back, _ = ckpt.restore(str(tmp_path), 1, {"params": got["params"]})
        assert back["params"] is not None


def test_launcher_trains_on_a_mesh(tmp_path, capsys):
    for flags in (["--data", "2", "--model", "2"],
                  ["--data", "2", "--model", "2", "--pod", "2", "--compress-pod"]):
        out = main(["--device", "cpu", "--steps", "8", "--seq", "32", "--global-batch", "8",
                    "--lr", "3e-3", "--ckpt-dir", str(tmp_path / str(len(flags))), *flags])
        h = out["history"]
        assert out["final_step"] == 8 and h[-1]["loss"] < h[0]["loss"], h
        assert "mesh={" in capsys.readouterr().out
        assert isinstance(out["params"]["embed"], Sharded)
