"""The rank bodies of ``tests/test_torch_rank_ckpt.py``, importable by the
ranks' processes (no ``jax``, no ``repro``): one checkpoint for a whole
``core.rank_mesh.RankMesh``, written by rank 0 and restored onto meshes of
other shapes, ``TrainDriver`` on ranks and the launcher relaunched on
another shape. Every body has a twin on the virtual mesh (``virtual_*``),
which the tests hold each rank to.
"""
import dataclasses
import os

import numpy as np
import torch

#: the config of phase 21d: ``scaled_config(deepseek-v2-lite-16b, 0.05)``
#: at top-2
ARCH = "deepseek-v2-lite-16b"
SEQ = 16
BATCH = 4
FT_STEPS = 12
FAILURES = (5, 9)
LAUNCH = ["--device", "cpu", "--steps", "4", "--seq", str(SEQ), "--global-batch", str(BATCH),
          "--scale", "0.05"]
RESTORE_SHAPES = {4: [(4, 1), (1, 4)], 2: [(2, 1)]}


def small_config():
    from repro_torch.launch.train import scaled_config
    from repro_torch.models.zoo import get_config
    cfg = scaled_config(get_config(ARCH), 0.05)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, top_k=2))


def tcfg():
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_loop import TrainConfig
    return TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2, total_steps=20))


def batch(i: int, vocab: int) -> dict:
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.train_loop import device_batch
    src = SyntheticLM(DataConfig(global_batch=BATCH, seq_len=SEQ, vocab=vocab, seed=0))
    return device_batch(src.batch(i, 0, 1), "cpu")


def trained_state(mesh, steps: int = 1):
    """The scaled config's mesh state from seed 0 after ``steps`` steps
    (nonzero moments), with its model."""
    from repro_torch.models.transformer import build_model
    from repro_torch.train.train_loop import init_mesh_state, make_train_step
    cfg = small_config()
    model = build_model(cfg, device="cpu").init(seed=0)
    params, opt = init_mesh_state(model, mesh)
    step = make_train_step(model, mesh, tcfg())
    for i in range(steps):
        params, opt, _ = step(params, opt, batch(i, cfg.vocab))
    return model, params, opt


def blocks_of(tree) -> dict:
    """{checkpoint key: a copy of the blocks} of every ``Sharded`` leaf,
    and {"plain:" key: a copy} of every plain tensor leaf."""
    from repro_torch.distributed.sharding import Sharded
    from repro_torch.train import checkpoint as ckpt
    out = {}
    for k, v in ckpt._flatten(tree).items():
        if isinstance(v, Sharded):
            out[k] = v.blocks.clone()
        elif isinstance(v, torch.Tensor):
            out["plain:" + k] = v.clone()
    return out


def shardings_on(mesh):
    from repro_torch.distributed.sharding import param_shardings, zero1_shardings
    from repro_torch.models.transformer import model_specs
    from repro_torch.train.optimizer import OptState
    specs = model_specs(small_config())
    z = zero1_shardings(mesh, specs)
    return {"params": param_shardings(mesh, specs), "opt": OptState(None, z, z, z)}


def restore_onto(ckpt_dir: str, like: dict, mesh) -> dict:
    from repro_torch.train import checkpoint as ckpt
    got, _ = ckpt.restore(ckpt_dir, 1, like, shardings_on(mesh))
    return blocks_of(got)


def drive(mesh, ckpt_dir: str, failure_at):
    """``TrainDriver`` on ``mesh``, ``FT_STEPS`` steps, a checkpoint every 4:
    the losses, the restarts and the final blocks."""
    from repro_torch.distributed.fault_tolerance import FTConfig, TrainDriver
    from repro_torch.distributed.sharding import set_activation_mesh
    from repro_torch.models.transformer import build_model
    from repro_torch.train.train_loop import init_mesh_state, make_train_step
    cfg = small_config()
    model = build_model(cfg, device="cpu").init(seed=0)
    params, opt = init_mesh_state(model, mesh)
    driver = TrainDriver(make_train_step(model, mesh, tcfg()), lambda i: batch(i, cfg.vocab),
                         FTConfig(ckpt_dir=ckpt_dir, ckpt_every=4, async_save=True))
    out = driver.run(params, opt, FT_STEPS, failure_at=failure_at)
    set_activation_mesh(None)
    return {"losses": [h["loss"] for h in out["history"]],
            "steps": [h["step"] for h in out["history"]], "restarts": out["restarts"],
            "blocks": blocks_of({"params": out["params"], "opt": out["opt_state"]})}


def launch(extra: list, ckpt_dir: str, steps: int) -> dict:
    """The launcher's losses and final blocks."""
    from repro_torch.launch.train import main
    args = list(LAUNCH)
    args[args.index("--steps") + 1] = str(steps)
    out = main(args + ["--ckpt-dir", ckpt_dir] + extra)
    return {"losses": [h["loss"] for h in out["history"]],
            "blocks": blocks_of({"params": out["params"], "opt": out["opt_state"]})}


def relaunch(first: list, second: list, ckpt_dir: str, rejoin=None) -> list:
    """4 launcher steps on the mesh of ``first``, then a relaunch to step 8
    on the mesh of ``second`` from the same directory; ``rejoin()`` joins
    a new process group between them (the launcher leaves its own)."""
    a = launch(first, ckpt_dir, 4)
    if rejoin is not None:
        rejoin()
    return [a, launch(second, ckpt_dir, 8)]


def _join(init: str, rank: int, world: int) -> None:
    import torch.distributed as tdist
    tdist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)


def run_ckpt(rank: int, world: int, init: str, workdir: str) -> dict:
    """A rank of 4: the (2, 2) state saved into ``workdir/save`` (rank 0
    alone writing: ``np.save`` is counted), restored onto (4, 1) and
    (1, 4); ``TrainDriver`` uninterrupted and with failures; the launcher
    on (2, 2), then relaunched on (4, 1)."""
    import torch.distributed as tdist

    from repro_torch.distributed.sharding import set_activation_mesh
    from repro_torch.launch.mesh import rank_mesh
    from repro_torch.train import checkpoint as ckpt
    torch.set_num_threads(1)
    mesh = rank_mesh(2, 2, 0, "gloo", device="cpu", init_method=init, rank=rank,
                     world_size=world)
    _, params, opt = trained_state(mesh)
    set_activation_mesh(None)
    writes = []
    save = np.save
    np.save = lambda path, arr: writes.append(os.path.basename(path)) or save(path, arr)
    calls, wire = dict(mesh.calls), dict(mesh.wire_bytes)
    try:
        ret = ckpt.save(os.path.join(workdir, "save"), 1, {"params": params, "opt": opt})
    finally:
        np.save = save
    out = {"save": {"returned": ret, "writes": writes,
                    "calls": {k: v - calls.get(k, 0) for k, v in mesh.calls.items()},
                    "wire": {k: v - wire.get(k, 0) for k, v in mesh.wire_bytes.items()},
                    "blocks": blocks_of({"params": params, "opt": opt})}}
    mesh.share(b"")                 # rank 0's files are written before anyone reads
    out["restore"] = {shape: restore_onto(os.path.join(workdir, "save"),
                                          {"params": params, "opt": opt},
                                          rank_mesh(*shape, 0, "gloo", device="cpu"))
                      for shape in RESTORE_SHAPES[4]}
    out["driver"] = {name: drive(mesh, os.path.join(workdir, name), failure_at)
                     for name, failure_at in (("clean", None), ("faulty", list(FAILURES)))}
    out["driver_dirs"] = sorted(os.listdir(os.path.join(workdir, "faulty")))
    out["launcher"] = relaunch(["--backend", "gloo", "--data", "2", "--model", "2"],
                               ["--backend", "gloo", "--data", "4", "--model", "1"],
                               os.path.join(workdir, "launch"),
                               lambda: _join(init + "_relaunch", rank, world))
    assert not tdist.is_initialized()
    return out


def run_restore(rank: int, world: int, init: str, ckpt_dir: str) -> dict:
    """A rank of 2: ``run_ckpt``'s checkpoint restored onto (2, 1), no
    collective issued."""
    from repro_torch.launch.mesh import rank_mesh
    from repro_torch.models.transformer import build_model
    from repro_torch.train.train_loop import init_mesh_state
    torch.set_num_threads(1)
    mesh = rank_mesh(2, 1, 0, "gloo", device="cpu", init_method=init, rank=rank,
                     world_size=world)
    params, opt = init_mesh_state(build_model(small_config(), device="cpu").init(seed=1), mesh)
    calls = dict(mesh.calls)
    got = restore_onto(ckpt_dir, {"params": params, "opt": opt}, mesh)
    return {"blocks": got, "calls": dict(mesh.calls) == calls}
