"""The ranks of a ``core/rank_mesh.py`` mesh on one host, without
``torchrun``: ``run_ranks(fn, world, *args)`` runs ``fn(rank, world,
init_method, *args)`` in one new process per rank, with a ``file://``
rendezvous in a fresh directory, joins every process and fails if one
fails. The tests run their ranks on the CPU through it, and
``chip_smoke.py`` its ranks that share one card.

The ranks fork from one ``forkserver`` process that imports ``PRELOAD``
once and initialises no CUDA context, so a rank starts with torch and the
mesh layer imported (each import costs a rank seconds, eight at once
more). The server serves every later call of this process and exits with
it. ``torchrun`` is the launcher of a job with one rank per card
(``launch/train.py --backend``).
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time
import traceback
from typing import Callable

import torch
import torch.distributed as dist

#: what the ranks' fork server imports: ``torch._dynamo`` is what the first
#: ``torch.utils.checkpoint`` call (the train steps' remat) would import
PRELOAD = ("torch", "torch._dynamo", "numpy", "repro_torch.core.distributed",
           "repro_torch.kernels.ops", "repro_torch.train.train_loop", "repro_torch.launch.mesh")


def _server():
    """The forkserver context, with its preload set."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(list(PRELOAD))
    return ctx


def start_rank_server() -> None:
    """Start the fork server of ``run_ranks`` now: it imports ``PRELOAD``
    while the caller goes on, so the first ``run_ranks`` does not wait
    for it."""
    import multiprocessing.forkserver as mp_forkserver

    _server()
    mp_forkserver.ensure_running()


def _rank_main(fn: Callable, rank: int, world: int, workdir: str, args: tuple) -> None:
    path = os.path.join(workdir, f"rank{rank}")
    try:
        out = fn(rank, world, "file://" + os.path.join(workdir, "rendezvous"), *args)
        torch.save(out, path + ".pt")
    except BaseException:
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, *args, timeout: float = 600.0) -> list:
    """Run ``fn(rank, world, init_method, *args)`` in ``world`` new
    processes, one per rank, with a ``file://`` rendezvous in a fresh
    directory (so concurrent runs never share a port), and return their
    results in rank order. ``fn`` must be importable by name. Every
    process is joined; if one fails or the run outlasts ``timeout``
    seconds, the others are terminated and the first failure's traceback
    is raised."""
    ctx = _server()
    workdir = tempfile.mkdtemp(prefix="rank_mesh_")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, workdir, args))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while any(p.exitcode is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if bad or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
        if failed or any(p.exitcode is None for p in procs):
            for p in procs:
                if p.exitcode is None:
                    p.terminate()
            for p in procs:
                p.join()
            msgs = []
            for r in failed:
                err = os.path.join(workdir, f"rank{r}.err")
                text = open(err).read() if os.path.exists(err) else "(no traceback)"
                msgs.append(f"rank {r} exited with {procs[r].exitcode}:\n{text}")
            if not msgs:
                msgs.append(f"the ranks outlasted {timeout} s")
            raise RuntimeError("\n".join(msgs))
        for p in procs:
            p.join()
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(workdir, ignore_errors=True)
