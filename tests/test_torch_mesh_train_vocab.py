"""The reference's own measure of the compressed step (``tests/test_launch.py``:
the mean of |Δp| / (|p| + 1e-3) against the uncompressed step, leaf by
leaf) at DeepSeek-V2-Lite's vocabulary of 102,400, the rest of the model
reduced: the reference's steps and the port's, the first 4 steps of phase
23c's schedule from the same parameters, on (pod 2, data 2, model 2).

At this vocabulary almost every lm_head column is a target of no token in
a batch. Its gradient entries then lie far below half an int8 step of the
leaf's absmax, so their codes are 0 on every pod, while the uncompressed
AdamW step moves them by about lr. The entries no step carried keep nu = 0
and move by the weight decay alone. The port must give the reference's
readings: the share of such entries and each leaf's mean, over the whole
leaf and over the carried entries.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import torch

from repro_torch.distributed.sharding import set_activation_mesh, unshard_state
from repro_torch.launch.mesh import small_mesh
from repro_torch.models.transformer import build_model
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.optimizer import OptConfig, cosine_lr
from repro_torch.train.train_loop import (
    TrainConfig, device_batch, init_mesh_ef, make_compressed_train_step, make_train_step,
)
from test_torch_mesh_train import REPO_SRC, _flat, mesh_state_from_reference, port_config

VOCAB = 102400
STEPS = 4
OPT = OptConfig(lr=3e-4, warmup_steps=2, total_steps=8)

WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from repro.models import zoo
from repro.models.transformer import build_model
from repro.train.data import DataConfig, SyntheticLM
from repro.train.grad_compress import ef_init
from repro.train.optimizer import OptConfig, adamw_init, cosine_lr
from repro.train.train_loop import TrainConfig, make_compressed_train_step, make_train_step
from repro.distributed.sharding import param_shardings, set_activation_mesh, zero1_shardings
from repro.train.optimizer import OptState
from jax.sharding import NamedSharding, PartitionSpec as P

def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

vocab, steps, total, path = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
cfg = zoo.reduced_config("deepseek-v2-lite-16b", 0.05)
cfg = dataclasses.replace(cfg, vocab=vocab, moe=dataclasses.replace(cfg.moe, top_k=2))
model = build_model(cfg)
init = model.init(jax.random.PRNGKey(0))
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
ocfg = OptConfig(lr=3e-4, warmup_steps=2, total_steps=total)
tcfg = TrainConfig(opt=ocfg, microbatches=1)
src = SyntheticLM(DataConfig(global_batch=8, seq_len=16, vocab=vocab))
out = {f"init{k}": v for k, v in flat(init).items()}
z = zero1_shardings(mesh, model.specs())
for kind in ("compressed", "plain"):
    # the state placed as the steps place it, so that the first step's
    # compile serves every step
    params = jax.device_put(init, param_shardings(mesh, model.specs()))
    opt = jax.device_put(adamw_init(init), OptState(NamedSharding(mesh, P()), z, z, z))
    ef = jax.device_put(ef_init(init), z)
    step = (make_train_step(model, mesh, tcfg, donate=False) if kind == "plain"
            else make_compressed_train_step(model, mesh, tcfg))
    for i in range(steps):
        b = {k: jnp.asarray(v) for k, v in src.batch(i, 0, 1).items()}
        if kind == "plain":
            params, opt, m = step(params, opt, b)
        else:
            params, opt, ef, m = step(params, opt, ef, b)
        out[f"{kind}/loss{i}"] = np.float32(m["loss"])
    out.update({f"{kind}/params{k}": v for k, v in flat(params).items()})
    if kind == "compressed":
        out.update({f"{kind}/master{k}": v for k, v in flat(opt.master).items()})
        out.update({f"{kind}/nu{k}": v for k, v in flat(opt.nu).items()})
    set_activation_mesh(None)
out["lr"] = np.asarray([cosine_lr(jnp.int32(i + 1), ocfg) for i in range(steps)], np.float32)
np.savez(path, **out)
print("VOCAB_OK")
"""


def readings(c: np.ndarray, p: np.ndarray, nu: np.ndarray) -> dict:
    """The reference's measure of leaf ``c`` against ``p``: over the whole
    leaf, over the entries the wire carried (nu > 0), and their share."""
    r = np.abs(c - p) / (np.abs(p) + 1e-3)
    never = nu == 0
    return {"whole": float(r.mean()), "never_share": float(never.mean()),
            "carried": float(r[~never].mean()) if (~never).any() else 0.0}


def decay_only(master: np.ndarray, init: np.ndarray, nu: np.ndarray, lrs) -> float:
    """The largest gap, relative to the leaf's largest |init|, between the
    entries no step carried and AdamW's zero-gradient path."""
    m = init.astype(np.float32)
    for lr in lrs:
        m = m - (m * np.float32(OPT.weight_decay)) * np.float32(lr)
    never = nu == 0
    if not never.any():
        return 0.0
    return float(np.abs(master[never] - m[never]).max() / np.abs(init).max())


def test_per_leaf_reading_at_the_full_vocabulary_matches_the_reference(tmp_path):
    out = tmp_path / "vocab.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_SRC + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", WORKER, str(VOCAB), str(STEPS),
                          str(OPT.total_steps), str(out)],
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0 and "VOCAB_OK" in res.stdout, res.stdout + res.stderr[-4000:]
    ref = dict(np.load(out))

    cfg = port_config("deepseek-v2-lite-16b", 2, 0)
    cfg = dataclasses.replace(cfg, vocab=VOCAB)
    src = SyntheticLM(DataConfig(global_batch=8, seq_len=16, vocab=VOCAB))
    batches = [device_batch(src.batch(i, 0, 1), "cpu") for i in range(STEPS)]
    mesh = small_mesh(2, 2, 2, device="cpu")
    tcfg = TrainConfig(opt=OPT, microbatches=1)
    got = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(2)         # the 102,400-column head's products dominate
    try:
        for kind in ("compressed", "plain"):
            model = build_model(cfg, device="cpu")
            params, opt, _ = mesh_state_from_reference(model, mesh, ref, "init", 0)
            if kind == "compressed":
                ef = init_mesh_ef(model, mesh)
                step = make_compressed_train_step(model, mesh, tcfg)
                for b in batches:
                    params, opt, ef, m = step(params, opt, ef, b)
                got["nu"] = {k: v.numpy() for k, v in _flat(unshard_state(opt.nu))}
                got["master"] = {k: v.numpy() for k, v in _flat(unshard_state(opt.master))}
            else:
                step = make_train_step(model, mesh, tcfg)
                for b in batches:
                    params, opt, m = step(params, opt, b)
            got[kind] = {k: v.float().numpy() for k, v in _flat(unshard_state(params))}
    finally:
        set_activation_mesh(None)
        torch.set_num_threads(threads)

    lrs = [float(cosine_lr(torch.tensor(i + 1, dtype=torch.int32), OPT)) for i in range(STEPS)]
    np.testing.assert_allclose(lrs, ref["lr"], rtol=1e-6)
    for k, init in ((k[4:], v) for k, v in ref.items() if k.startswith("init")):
        want = readings(ref[f"compressed/params{k}"], ref[f"plain/params{k}"],
                        ref[f"compressed/nu{k}"])
        have = readings(got["compressed"][k], got["plain"][k], got["nu"][k])
        assert abs(have["never_share"] - want["never_share"]) <= 1e-3, (k, have, want)
        for r in ("whole", "carried"):
            np.testing.assert_allclose(have[r], want[r], rtol=0.02, atol=1e-5,
                                       err_msg=f"{k} {r}: {have} against {want}")
        assert decay_only(ref[f"compressed/master{k}"], init, ref[f"compressed/nu{k}"],
                          lrs) <= 1e-6, k
        assert decay_only(got["master"][k], init, got["nu"][k], lrs) <= 1e-6, k
    head = readings(got["compressed"]["['lm_head']"], got["plain"]["['lm_head']"],
                    got["nu"]["['lm_head']"])
    # almost all of lm_head is never carried, and its reading is the largest of any leaf
    assert head["never_share"] > 0.9, head
    others = [readings(got["compressed"][k], got["plain"][k], got["nu"][k])["whole"]
              for k in got["plain"] if k != "['lm_head']"]
    assert head["whole"] > max(others), (head, max(others))
