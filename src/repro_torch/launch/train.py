"""Training launcher (``repro.launch.train``).

Example:
    PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-4b \
        --scale 0.05 --steps 50 --data 2 --model 2

trains a width/depth-scaled variant of the arch config through the port's
train step, checkpoints and fault-tolerance driver, on the CUDA card
unless ``--device`` names another. With ``--data``, ``--model`` or
``--pod`` above 1 it runs the mesh step (``make_train_step``) on a mesh of
that many virtual devices of the one device; ``--compress-pod`` with a pod
axis runs the int8 error-feedback step (``make_compressed_train_step``).

With ``--backend gloo|nccl``, under ``torchrun --nproc-per-node N`` (N =
pod · data · model), the same mesh has one rank per device
(``launch.mesh.rank_mesh``, from torchrun's environment): each rank holds
its own blocks on ``cuda:LOCAL_RANK`` (or ``--device``), every mesh
primitive is a collective, and only rank 0 prints. The ranks checkpoint
into the one ``--ckpt-dir`` (rank 0 writes the whole mesh's checkpoint),
so a relaunch on a mesh of another shape resumes from its last committed
step:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --backend nccl --data 2 --model 2 --steps 50 --ckpt-dir <dir>
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --backend nccl --data 4 --model 1 --steps 100 --ckpt-dir <dir>
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile


def scaled_config(cfg, scale: float):
    """Geometry-scaled variant of an arch config (same family/topology)."""
    def r8(x):
        return max(8, int(x * scale) // 8 * 8)

    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(
            moe, d_ff_expert=r8(moe.d_ff_expert),
            d_ff_dense=r8(moe.d_ff_dense) if moe.d_ff_dense else 0,
            n_experts=min(moe.n_experts, 8),
            top_k=min(moe.top_k, min(moe.n_experts, 8)))
    mla = cfg.mla
    if mla is not None:
        mla = dataclasses.replace(
            mla, kv_lora_rank=r8(mla.kv_lora_rank),
            rope_head_dim=max(8, r8(mla.rope_head_dim)),
            nope_head_dim=max(8, r8(mla.nope_head_dim)),
            v_head_dim=max(8, r8(mla.v_head_dim)))
    n_heads = max(2, int(cfg.n_heads * scale) or 2)
    d_model = r8(cfg.d_model)
    # keep head structure consistent
    while d_model % n_heads:
        n_heads -= 1
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    return dataclasses.replace(
        cfg,
        n_layers=max(2, int(cfg.n_layers * scale)),
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_ff=r8(cfg.d_ff) if cfg.d_ff else 0,
        vocab=min(cfg.vocab, 8192),
        head_dim=r8(cfg.head_dim) if cfg.head_dim else 0,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        moe=moe, mla=mla,
    )


def main(argv=None) -> dict:
    """Parse ``argv`` (the command line when None), train, print the first
    and last losses; returns the driver's result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-4b")
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--pod", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--compress-pod", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the CUDA card; with "
                         "--backend, cuda:LOCAL_RANK)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="one rank per device over this process-group backend "
                         "(run under torchrun); without it, virtual devices of one card")
    args = ap.parse_args(argv)

    from repro_torch.core.device import resolve_device
    from repro_torch.distributed.fault_tolerance import FTConfig, TrainDriver
    from repro_torch.launch.mesh import rank_mesh, small_mesh
    from repro_torch.models.transformer import build_model
    from repro_torch.models.zoo import count_params, get_config
    from repro_torch.train.data import DataConfig, make_source
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_loop import (
        TrainConfig, device_batch, init_mesh_ef, init_mesh_state, init_train_state,
        make_compressed_train_step, make_train_step, train_step_fn,
    )

    cfg = scaled_config(get_config(args.arch), args.scale)
    if args.backend:
        mesh = rank_mesh(args.data, args.model, args.pod, args.backend, device=args.device)
        device = mesh.device
    else:
        device = resolve_device(args.device)
        on_mesh = args.data > 1 or args.model > 1 or args.pod > 1 or args.compress_pod
        mesh = small_mesh(args.data, args.model, args.pod, device=device) if on_mesh else None
    model = build_model(cfg, device)
    say = print if getattr(mesh, "rank", 0) == 0 else (lambda *a, **k: None)
    say(f"arch={args.arch} scaled params={count_params(cfg) / 1e6:.1f}M device={device}"
        + (f" mesh={mesh.shape}" if mesh else "")
        + (f" ranks={mesh.n_devices} backend={args.backend}" if args.backend else ""))

    tcfg = TrainConfig(
        opt=OptConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps),
        microbatches=args.microbatches, remat=True, grad_compress_pod=args.compress_pod)
    params, opt_state = init_train_state(model, seed=0)

    dcfg = DataConfig(global_batch=args.global_batch, seq_len=args.seq,
                      vocab=cfg.vocab,
                      frontend=cfg.frontend, frontend_dim=cfg.frontend_dim)
    source = make_source(dcfg)
    if mesh is None:
        step_fn = train_step_fn(model, tcfg)
    elif args.compress_pod and args.pod:
        params, opt_state = init_mesh_state(model, mesh)
        step = make_compressed_train_step(model, mesh, tcfg)
        ef = init_mesh_ef(model, mesh)

        def step_fn(p, o, batch):
            nonlocal ef
            p, o, ef, m = step(p, o, ef, batch)
            return p, o, m
    else:
        params, opt_state = init_mesh_state(model, mesh)
        step_fn = make_train_step(model, mesh, tcfg)

    def batch_fn(step_idx):
        return device_batch(source.batch(step_idx, 0, 1), device)

    driver = TrainDriver(step_fn, batch_fn,
                         FTConfig(ckpt_dir=args.ckpt_dir,
                                  ckpt_every=args.ckpt_every))
    out = driver.run(params, opt_state, args.steps)
    h = out["history"]
    say(f"steps={out['final_step']} restarts={out['restarts']} "
        f"loss[0]={h[0]['loss']:.3f} loss[-1]={h[-1]['loss']:.3f}")
    if args.backend:
        import torch.distributed as dist
        dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
