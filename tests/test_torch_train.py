"""The port's train subsystem held to the JAX package and to the cases of
``tests/test_train.py`` and ``tests/test_fault_tolerance.py``: AdamW
against the numpy formula and against the reference's ``adamw_apply``
(rtol 1e-6), the cosine schedule, clipping, one train step against the
reference's, microbatch ≡ full batch, the loss falling, the data sources
equal to the reference's, the checkpoint format (a bf16 leaf bit for bit,
found by the reference's ``latest_step``), a restarted run equal to an
uninterrupted one bit for bit, the straggler policy, ``scaled_config``
field by field, and the launcher. The int8 error-feedback compression,
the mesh steps and the elastic rescale are held in
``test_torch_grad_compress.py`` and ``test_torch_mesh_train*.py``."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.train import scaled_config as jscaled_config
from repro.models import zoo as jzoo
from repro.models.transformer import build_model as jbuild_model
from repro.train import checkpoint as jckpt
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train import train_loop as jtrain
from repro_torch.convert import (
    model_params_from_numpy, model_params_to_numpy, opt_state_from_numpy, opt_state_to_numpy,
)
from repro_torch.distributed.fault_tolerance import FTConfig, StragglerMonitor, TrainDriver
from repro_torch.launch.train import main, scaled_config
from repro_torch.models import zoo
from repro_torch.models.transformer import build_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import DataConfig, SyntheticLM, make_source
from repro_torch.train.optimizer import (
    OptConfig, OptState, adamw_apply, adamw_init, clip_by_global_norm, cosine_lr, global_norm,
)
from repro_torch.train.train_loop import (
    TrainConfig, _grads_and_loss, device_batch, init_train_state, train_params, train_step_fn,
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's tests, restored after. Their
    small models make many small ops, and with the suite's other workers
    on the same cores torch's pool spends most of a step waiting: under
    load ``test_train_loss_decreases`` took 122 s on 8 threads, 18 s on 1."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(n_layers=2):
    return dataclasses.replace(zoo.reduced_config("minitron-4b", 0.05), n_layers=n_layers)


def tiny_model(seed=0):
    model = build_model(tiny(), device="cpu")
    params, opt = init_train_state(model, seed=seed)
    return model, params, opt


# --------------------------------------------------------------- AdamW


def test_adamw_matches_reference_formula():
    rng = np.random.default_rng(0)
    p = {"w": torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))}
    g = {"w": torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))}
    w0 = p["w"].numpy().copy()
    cfg = OptConfig(lr=1e-2, warmup_steps=0, total_steps=100, clip_norm=1e9,
                    weight_decay=0.1)
    state = adamw_init(p)
    new_p, new_state, m = adamw_apply(p, g, state, cfg)
    lr = float(cosine_lr(torch.tensor(1), cfg))
    gw = g["w"].numpy()
    mhat = 0.1 * gw / (1 - 0.9)
    nhat = 0.05 * gw ** 2 / (1 - 0.95)
    want = w0 - lr * (mhat / (np.sqrt(nhat) + cfg.eps) + 0.1 * w0)
    np.testing.assert_allclose(new_p["w"].numpy(), want, rtol=1e-5)
    assert new_p["w"] is p["w"] and int(new_state.step) == 1
    assert new_state.master["w"].data_ptr() != p["w"].data_ptr()


def test_adamw_matches_the_reference_over_steps():
    """Three steps on the same leaves, clipping active, one bf16 leaf: the
    parameters, master, mu and nu within rtol 1e-6 of the reference's, and
    atol 1e-6·max|leaf|: the clip scale comes from a norm summed in another
    order, and an ulp of it grows where b1·mu and (1 − b1)·g cancel."""
    rng = np.random.default_rng(1)
    shapes = {"a": (6, 5), "b": (7,), "c": (3, 2, 4)}
    p_np = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    cfg = OptConfig(lr=5e-2, warmup_steps=2, total_steps=10, clip_norm=0.5)
    jcfg = jopt.OptConfig(**dataclasses.asdict(cfg))
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    jp["c"] = jp["c"].astype(jnp.bfloat16)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
    tp["c"] = tp["c"].to(torch.bfloat16)
    jstate, tstate = jopt.adamw_init(jp), adamw_init(tp)
    for i in range(3):
        g_np = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        jp, jstate, jm = jopt.adamw_apply(jp, {k: jnp.asarray(v) for k, v in g_np.items()},
                                          jstate, jcfg)
        tp, tstate, tm = adamw_apply(tp, {k: torch.from_numpy(v) for k, v in g_np.items()},
                                     tstate, cfg)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        for f in ("master", "mu", "nu"):
            for k in shapes:
                want = np.asarray(getattr(jstate, f)[k])
                np.testing.assert_allclose(getattr(tstate, f)[k].numpy(), want, rtol=1e-6,
                                           atol=1e-6 * np.abs(want).max(),
                                           err_msg=f"{f} {k} step {i}")
        for k in shapes:
            assert tp[k].dtype == (torch.bfloat16 if k == "c" else torch.float32)
            np.testing.assert_allclose(tp[k].float().numpy(), np.asarray(jp[k], np.float32),
                                       rtol=1e-6 if k != "c" else 1e-2)
        assert int(tstate.step) == int(jstate.step) == i + 1


def test_cosine_schedule_shape_and_reference():
    cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    jcfg = jopt.OptConfig(**dataclasses.asdict(cfg))
    lrs = [float(cosine_lr(torch.tensor(s, dtype=torch.int32), cfg)) for s in range(0, 101, 10)]
    assert lrs[0] == 0.0
    assert abs(lrs[1] - 1.0) < 1e-6          # end of warmup
    assert lrs[-1] == pytest.approx(0.1, rel=1e-3)   # floor
    assert all(a >= b - 1e-9 for a, b in zip(lrs[1:], lrs[2:]))  # decays
    for s in range(0, 101, 7):
        np.testing.assert_allclose(float(cosine_lr(torch.tensor(s), cfg)),
                                   float(jopt.cosine_lr(jnp.int32(s), jcfg)), rtol=1e-6)


def test_clip_by_global_norm():
    g = {"a": torch.full((10,), 3.0), "b": torch.full((5,), 4.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    assert float(norm) == pytest.approx(np.sqrt(10 * 9 + 5 * 16), rel=1e-6)
    same, _ = clip_by_global_norm(g, 100.0)
    assert all(torch.equal(same[k], g[k]) for k in g)


# --------------------------------------------------------------- the step


def test_train_step_matches_the_reference():
    """One step at 2 microbatches from the same weights and batch: the loss
    (the total objective), the grad norm, and every parameter and
    optimizer leaf after AdamW, through the converters."""
    pc = tiny()
    jc = dataclasses.replace(jzoo.reduced_config("minitron-4b", 0.05), n_layers=2)
    jm = jbuild_model(jc)
    rng = np.random.default_rng(4)
    params_np = jax.tree.map(
        lambda s: (rng.standard_normal(s.shape) / np.sqrt(s.shape[-1])).astype(np.float32)
        if s.init != "ones" else np.ones(s.shape, np.float32),
        jm.specs(), is_leaf=lambda s: hasattr(s, "init"))
    batch = SyntheticLM(DataConfig(global_batch=4, seq_len=16, vocab=pc.vocab)).batch(3, 0, 1)
    ocfg = OptConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    jparams = jax.tree.map(jnp.asarray, params_np)
    jstep = jax.jit(jtrain.train_step_fn(jm, jtrain.TrainConfig(
        opt=jopt.OptConfig(**dataclasses.asdict(ocfg)), microbatches=2, remat=True)))
    jp, jo, jmet = jstep(jparams, jopt.adamw_init(jparams),
                         {k: jnp.asarray(v) for k, v in batch.items()})
    model = build_model(pc, device="cpu")
    model.load_state_dict(model_params_from_numpy(pc, params_np, device="cpu"))
    params = train_params(model)
    step = train_step_fn(model, TrainConfig(opt=ocfg, microbatches=2, remat=True))
    params, opt, met = step(params, adamw_init(params), device_batch(batch, "cpu"))
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-4)
    got = opt_state_to_numpy(pc, opt)
    assert got["step"] == int(jo.step) == 1
    flat = {f: (jax.tree_util.tree_flatten_with_path(getattr(jo, f))[0],
                jax.tree.leaves(got[f])) for f in ("master", "mu", "nu")}
    for f in ("mu", "nu"):
        for (path, want), g in zip(*flat[f]):
            np.testing.assert_allclose(g, want, rtol=1e-3, atol=1e-5 * float(np.abs(want).max()),
                                       err_msg=f"{f} {jax.tree_util.keystr(path)}")
    # the first update is lr·g/(|g| + eps): held where |g| is clear of the
    # gradients' own tolerance, since near g = 0 its sign is not defined
    for ((path, want), g), (_, mu) in zip(zip(*flat["master"]), flat["mu"][0]):
        ok = np.abs(mu) > 1e-2 * np.abs(mu).max()
        np.testing.assert_allclose(g[ok], want[ok], rtol=1e-5, atol=1e-6 * np.abs(want).max(),
                                   err_msg=f"master {jax.tree_util.keystr(path)}")
    now = model_params_to_numpy(pc, dict(model.named_parameters()))
    for a, b in zip(jax.tree.leaves(now), jax.tree.leaves(got["master"])):
        np.testing.assert_array_equal(a, b)                  # f32 params are their master
    back = opt_state_from_numpy(pc, jo.step, *(jax.tree.map(np.asarray, getattr(jo, f))
                                               for f in ("master", "mu", "nu")), device="cpu")
    assert isinstance(back, OptState) and set(back.master) == set(opt.master)
    assert all(v.dtype == torch.float32 for v in back.nu.values())


def test_microbatch_grads_match_full_batch():
    model, params, _ = tiny_model()
    g = torch.Generator().manual_seed(0)
    vocab = model.cfg.vocab
    batch = {"tokens": torch.randint(0, vocab, (8, 16), generator=g),
             "labels": torch.randint(0, vocab, (8, 16), generator=g)}
    g1, l1, _ = _grads_and_loss(model, params, batch, TrainConfig(microbatches=1, remat=False))
    g4, l4, _ = _grads_and_loss(model, params, batch, TrainConfig(microbatches=4, remat=True))
    assert float(l1) == pytest.approx(float(l4), rel=1e-5)
    assert all(v.dtype == torch.float32 for v in g4.values())
    for k in g1:
        np.testing.assert_allclose(g1[k].float().numpy(), g4[k].numpy(), rtol=2e-3, atol=2e-5)


def test_train_loss_decreases():
    model, params, opt = tiny_model()
    step = train_step_fn(model, TrainConfig(opt=OptConfig(lr=1e-2, warmup_steps=5,
                                                          total_steps=80),
                                            microbatches=1, remat=False))
    src = SyntheticLM(DataConfig(global_batch=8, seq_len=32, vocab=model.cfg.vocab))
    ptrs = {k: p.data_ptr() for k, p in params.items()}
    losses = []
    for i in range(80):
        params, opt, m = step(params, opt, device_batch(src.batch(i, 0, 1), "cpu"))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-8:]) < np.mean(losses[:8]) - 0.5, losses[::10]
    assert {k: p.data_ptr() for k, p in params.items()} == ptrs
    assert all(p is q for p, q in zip(params.values(), model.parameters()))


# --------------------------------------------------------------- data


@pytest.mark.parametrize("seed,step,shard,n_shards,frontend",
                         [(0, 0, 0, 1, "tokens"), (7, 12, 1, 2, "tokens"),
                          (3, 5, 3, 4, "tokens"), (1, 9, 0, 2, "frames")])
def test_synthetic_batches_equal_the_reference(seed, step, shard, n_shards, frontend):
    kw = dict(global_batch=8, seq_len=16, vocab=101, seed=seed, frontend=frontend,
              frontend_dim=6 if frontend == "frames" else 0)
    got = SyntheticLM(DataConfig(**kw)).batch(step, shard, n_shards)
    want = jdata.SyntheticLM(jdata.DataConfig(**kw)).batch(step, shard, n_shards)
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_data_determinism_and_tokenfile(tmp_path):
    cfg = DataConfig(global_batch=4, seq_len=16, vocab=101, seed=7)
    src = SyntheticLM(cfg)
    b1 = src.batch(12, 1, 2)
    np.testing.assert_array_equal(b1["tokens"], src.batch(12, 1, 2)["tokens"])
    assert not np.array_equal(src.batch(13, 1, 2)["tokens"], b1["tokens"])
    assert b1["tokens"].shape == (2, 16)
    path = tmp_path / "tokens.bin"
    np.arange(10000, dtype=np.uint16).tofile(path)
    tf = make_source(dataclasses.replace(cfg, path=str(path)))
    tb = tf.batch(3, 1, 2)
    np.testing.assert_array_equal(tb["labels"], tb["tokens"] + 1)
    jtb = jdata.make_source(jdata.DataConfig(global_batch=4, seq_len=16, vocab=101, seed=7,
                                             path=str(path))).batch(3, 1, 2)
    for k in tb:
        np.testing.assert_array_equal(tb[k], jtb[k])


# --------------------------------------------------------------- checkpoints


def test_checkpoint_roundtrip_in_the_reference_format(tmp_path):
    bf = torch.randn(3, 5).to(torch.bfloat16)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.tensor([1, 2], dtype=torch.int32), "bf": bf},
            "opt": OptState(torch.tensor(4, dtype=torch.int32), {"w": torch.ones(2)},
                            {"w": torch.zeros(2)}, {"w": torch.full((2,), 0.5)})}
    saved = {k: v.clone() for k, v in ckpt._flatten(tree).items()}
    ckpt.save(str(tmp_path), 5, tree, metadata={"note": "x"})
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert jckpt.latest_step(str(tmp_path)) == 5            # the reference finds it
    manifest = json.loads((tmp_path / "step_5" / "manifest.json").read_text())
    assert manifest["step"] == 5 and manifest["metadata"] == {"note": "x"}
    assert manifest["arrays"]["b/bf"] == {"file": "b__bf.npy", "shape": [3, 5],
                                          "dtype": "bfloat16"}
    assert manifest["arrays"]["opt/step"]["dtype"] == "int32"
    assert np.load(tmp_path / "step_5" / "b__bf.npy").dtype == np.uint16
    assert sorted(os.listdir(tmp_path)) == ["step_5"]
    for leaf in ckpt._flatten(tree).values():
        leaf.zero_()
    got, meta = ckpt.restore(str(tmp_path), 5, tree)
    assert meta == {"note": "x"}
    assert got["b"]["bf"] is tree["b"]["bf"] and isinstance(got["opt"], OptState)
    for k, v in ckpt._flatten(got).items():
        assert v.dtype == saved[k].dtype
        assert torch.equal(v.view(torch.int16) if v.dtype == torch.bfloat16 else v,
                           saved[k].view(torch.int16) if v.dtype == torch.bfloat16 else saved[k])
    with pytest.raises(ValueError, match="b/bf"):
        ckpt.restore(str(tmp_path), 5, {**tree, "b": {"c": tree["b"]["c"],
                                                      "bf": torch.zeros(3, 5)}})


def _driver(tmp_path, async_save):
    model, params, opt = tiny_model()
    step = train_step_fn(model, TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2,
                                                          total_steps=20)))
    src = SyntheticLM(DataConfig(global_batch=4, seq_len=16, vocab=model.cfg.vocab))
    driver = TrainDriver(step, lambda i: device_batch(src.batch(i, 0, 1), "cpu"),
                         FTConfig(ckpt_dir=str(tmp_path), ckpt_every=4, async_save=async_save))
    return params, opt, driver


@pytest.mark.parametrize("async_save", [False, True])
def test_restart_reproduces_uninterrupted_run(tmp_path, async_save):
    """Injected failures and restores give the uninterrupted run's loss
    history, parameters and optimizer state bit for bit."""
    p1, o1, d_clean = _driver(tmp_path / "clean", async_save)
    clean = d_clean.run(p1, o1, 12)
    p2, o2, d_fail = _driver(tmp_path / "faulty", async_save)
    faulty = d_fail.run(p2, o2, 12, failure_at=[5, 9])
    assert faulty["restarts"] == 2 and clean["restarts"] == 0
    c = {h["step"]: h["loss"] for h in clean["history"]}
    f = {h["step"]: h["loss"] for h in faulty["history"]}
    assert set(c) == set(f) == set(range(12))
    for s in range(12):
        assert c[s] == f[s], (s, c[s], f[s])
    for a, b in ((clean["params"], faulty["params"]),
                 (clean["opt_state"], faulty["opt_state"])):
        fa, fb = ckpt._flatten(a), ckpt._flatten(b)
        assert fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k]) for k in fa)
    assert ckpt.latest_step(str(tmp_path / "faulty")) == 12


def test_straggler_monitor_flags_and_paces():
    m = StragglerMonitor(factor=2.0, max_lag=2)
    for step in range(8):
        m.record(0, step, 0.10)
        m.record(1, step, 0.11)
        m.record(2, step, 0.55)     # straggler
    assert m.stragglers() == [2]
    assert not m.must_resync()
    m.progress[2] = 2               # falls 6 steps behind
    m.progress[0] = m.progress[1] = 8
    assert m.must_resync()


# --------------------------------------------------------------- launcher


@pytest.mark.parametrize("scale", [0.02, 0.05])
def test_scaled_config_equals_the_reference(scale):
    for arch in zoo.ARCH_IDS:
        got = dataclasses.asdict(scaled_config(zoo.get_config(arch), scale))
        want = dataclasses.asdict(jscaled_config(jzoo.get_config(arch), scale))
        got.pop("dtype"), want.pop("dtype")
        assert got == want, arch


def test_launcher_trains_on_the_named_device(tmp_path, capsys):
    out = main(["--device", "cpu", "--steps", "6", "--seq", "16", "--global-batch", "4",
                "--ckpt-dir", str(tmp_path), "--ckpt-every", "3", "--microbatches", "2"])
    assert out["final_step"] == 6 and len(out["history"]) == 6
    assert ckpt.latest_step(str(tmp_path)) == 6
    assert "loss[0]=" in capsys.readouterr().out
    # the mesh flags train on virtual devices of the named device
    for flags in (["--data", "2"], ["--model", "2"], ["--pod", "2"], ["--compress-pod"]):
        out = main(["--device", "cpu", "--steps", "2", "--seq", "16", "--global-batch", "4",
                    "--ckpt-dir", str(tmp_path / flags[0][2:]), *flags])
        assert out["final_step"] == 2 and all(np.isfinite(h["loss"]) for h in out["history"])
        assert "mesh=" in capsys.readouterr().out
