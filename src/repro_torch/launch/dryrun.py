"""Dry run (``repro.launch.dryrun``) on the meta device: one card, or one
device of the reference's 256- and 512-device meshes.

For every (architecture × input shape) cell, the reference lowers and
compiles its step on the 16x16 or 2x16x16 mesh of fake host devices and
reads XLA's per-device memory and cost analyses and the HLO's
collectives. The port runs the same step once on meta tensors, whose
shapes and dtypes are real and whose storage is none, under
``launch/op_analysis.py``'s counter. It needs no card: it runs on any
host, and ``chip_smoke.py`` phase 22 holds the one-card run to the card's
own steps. One JSON record per cell and mesh goes under ``--out``, with
every key of the reference's record:

* ``devices`` and ``mesh``: 1 and ``{"card": 1}``, or 256 / 512 and the
  axis dict;
* ``compile_s`` holds the seconds of the meta pass (there is no compile);
* ``memory``, per device: ``argument_bytes`` (its parameter and
  optimizer-state blocks, its rows of the inputs, its cache blocks),
  ``output_bytes`` (the storages the step's outputs hold), ``temp_bytes``
  (the peak of live bytes less the arguments) and
  ``generated_code_bytes`` null;
* ``cost_raw`` equals ``cost``: eager runs every loop trip, so nothing is
  counted once per loop body;
* ``collectives``: one card has none; on a mesh, each mesh primitive of
  the device's step is the collective it stands for
  (``launch/device_view.py``'s ``DeviceView``), with the reference's wire-bytes
  formulas, split into ``ici_bytes`` (inside an 8-card NVLink node) and
  ``dcn_bytes`` (between nodes); ``unknown_trip_loops`` is 0;
* ``roofline``, ``model_flops_*``, ``useful_flops_ratio`` and ``params_*``
  as the reference's, with the H100's constants of ``op_analysis``;

and beside them ``fits_one_card`` (the device's arguments plus temps
within one card's memory: the card's own where one is present, else the
data sheet's 80 GB, named in ``card_memory``), the FLOPs by dtype, the op
count, the bytes each hand-written kernel reported, and on a mesh
``placement``, the port's placement in words.

Shapes: train_4k runs the train step (AdamW state on meta, the
reference's microbatch clamp: each microbatch keeps at least one row per
(pod, data) group), prefill_32k ``Model.prefill`` through
``make_prefill_step``, decode_32k and long_500k ``make_serve_step`` (one
token, a cache of seq_len capacity).

On a mesh the record counts device 0's step, as one rank of a mesh of
one rank per card would run it (every device's counts are the same):

* train cells run ``train_loop.make_train_step`` on the ``DeviceView``
  (``launch/device_view.py``):
  parameters in ``param_shardings`` blocks, master/mu/nu in
  ``zero1_shardings`` blocks, and the rows of the device's (pod, data)
  group (the batch sharding), cut into the clamped microbatches;
* prefill and decode run the serve steps as the mesh train step runs its
  forward: every leaf gathered from its ``param_shardings`` blocks (an
  all-gather each), the cache in ``cache_shardings`` blocks, gathered
  over its other axes for the device's rows before the step and cut back
  to its block after it, and the batch by the reference's rule (over the
  (pod, data) axes when they divide it, else whole on every device).

Where the port's FSDP-style placement differs from XLA's, the record
counts the port's step and does not scale it to imitate XLA's: each
device computes its group's rows on a whole working copy of the weights
(a temp of every parameter, the devices of the model axis repeating the
same work), the gradient of its rows is reduced over the batch axes into
its ZeRO-1 blocks, and the serve steps gather the cache as they gather
the weights; XLA instead splits the model axis's work by tensor
parallelism and gathers weights one layer at a time.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch xlstm-1.3b \\
        --shape decode_32k --mesh single --out /tmp/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

``--mesh card`` (the default) is the one-card run; ``single`` and
``multi`` are the reference's 16x16 and 2x16x16 meshes; ``both`` runs
every cell on the two.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import time
import traceback

import torch

from repro_torch.core.mesh import Mesh
from repro_torch.distributed.sharding import batch_axes
from repro_torch.launch import op_analysis
from repro_torch.launch.device_view import DeviceView, blocks_of, device_step
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.models.transformer import Model
from repro_torch.models.zoo import (
    ARCH_IDS, active_params, arch_shapes, count_params, get_config, input_specs,
)
from repro_torch.serve.engine import make_prefill_step, make_serve_step
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_loop import TrainConfig, train_params, train_step_fn

PLACEMENT = ("port FSDP-style: each device runs its (pod, data) group's rows on a whole "
             "working copy of the weights gathered from its blocks (the model axis repeats "
             "the work); gradients reduced over the batch axes into the ZeRO-1 blocks; "
             "serve caches gathered for the rows like the weights. Counts are this "
             "placement's, not scaled to XLA's tensor-parallel one")


def model_flops(cfg, shape) -> float:
    """Analytic useful FLOPs: 6·N_active·tokens (train), 2·N_active·tokens
    (prefill/decode). Attention score FLOPs excluded by convention."""
    n_act = active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n_act * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n_act * shape.tokens
    return 2.0 * n_act * shape.global_batch        # one token per request


# Per-arch microbatch overrides (the reference's, for its FSDP mesh; the
# clamp in lower_cell keeps at least one row per (pod, data) group).
MB_OVERRIDES = {"mixtral-8x22b": 8}


def serving_config(cfg, shape):
    """Serving overrides: (1) hybrid archs window their shared attention
    sites at 500k (full shared attention would carry an O(S) cache per
    site); (2) MoE inference uses capacity factor 1.0 (the training
    headroom only buys dispatch-buffer bytes at prefill scale)."""
    if shape.name == "long_500k" and cfg.hybrid is not None \
            and not cfg.hybrid.attn_window:
        cfg = dataclasses.replace(
            cfg, hybrid=dataclasses.replace(cfg.hybrid, attn_window=4096))
    if shape.kind != "train" and cfg.moe is not None \
            and cfg.moe.capacity_factor > 1.0:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.0))
    return cfg


def lower_cell(arch_id: str, shape_name, mesh=None, tcfg: TrainConfig | None = None,
               cfg=None):
    """Run one cell's step once on meta tensors under the counter. Returns
    (record, ``op_analysis.Analysis``). ``shape_name``: a name of
    ``SHAPES`` or a ``ShapeConfig``; ``mesh``: one card (None or
    ``{"card": 1}``), or a ``core.mesh.Mesh`` (``launch/mesh
    .make_production_mesh``) or an axis dict, whose device 0's step is
    counted; ``cfg``: a config to run as it is (a cut of the arch's, or
    the one a model on the card runs), in place of the arch's config with
    ``serving_config``'s overrides."""
    if isinstance(mesh, dict) and set(mesh) != {"card"}:
        mesh = Mesh(tuple(mesh.values()), tuple(mesh), device="meta")
    view = DeviceView(mesh) if isinstance(mesh, Mesh) else None
    mesh_dict = dict(view.shape) if view else dict(mesh or {"card": 1})
    n_dev = view.n_devices if view else 1
    shape = shape_name if isinstance(shape_name, ShapeConfig) else SHAPES[shape_name]
    cfg_obj = cfg or get_config(arch_id)
    cfg = cfg or serving_config(cfg_obj, shape)
    tcfg = tcfg or TrainConfig(remat=True)
    model = Model(cfg, device="meta")
    ins = input_specs(cfg, shape)
    t0 = time.monotonic()
    held = ()
    if shape.kind == "train":
        # the reference's clamp: each microbatch keeps at least one row per
        # (pod, data) group
        dsize = math.prod(view.shape[a] for a in batch_axes(view)) if view else 1
        mb = max(1, min(MB_OVERRIDES.get(arch_id, tcfg.microbatches),
                        shape.global_batch // dsize))
        tcfg = dataclasses.replace(tcfg, microbatches=mb)
    if view is not None:
        step, state = device_step(model, view, cfg, shape, tcfg, ins)
        # the working copy of the weights is a temp of the step, not an argument
        held = dict(model.named_parameters())
        resident = blocks_of(state)
    elif shape.kind == "train":
        params = train_params(model)
        state = (params, adamw_init(params), ins["batch"])
        step = train_step_fn(model, tcfg)
    elif shape.kind == "prefill":
        batch = ins["batch"]
        state = (batch.get("tokens"), model.init_cache(shape.global_batch, shape.seq_len),
                 batch.get("image_embeds"), batch.get("frames"))
        step = make_prefill_step(model)
    else:
        state = (ins["token"], model.init_cache(shape.global_batch, shape.seq_len),
                 ins.get("vision_kv"))
        step = make_serve_step(model)
    if view is None:
        resident = (dict(model.named_parameters()), state)
    out, ana = op_analysis.analyze(step, *state, resident=resident, held=held)
    compile_s = time.monotonic() - t0
    terms = op_analysis.roofline_terms(ana)
    out_storages = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                    for t in op_analysis.tree_tensors(blocks_of(out))}
    temp = ana.peak_bytes - ana.argument_bytes
    if torch.cuda.is_available():
        card_mem = {"bytes": torch.cuda.get_device_properties(0).total_memory,
                    "source": torch.cuda.get_device_name(0)}
    else:
        card_mem = {"bytes": op_analysis.HBM_BYTES, "source": "H100 SXM data sheet"}
    kernels = {}
    for r in ana.ops:
        if not r.op.startswith(("aten.", "prim.")):
            k = kernels.setdefault(r.op, {"launches": 0, "bytes": 0})
            k["launches"] += 1
            k["bytes"] += r.bytes
    mf = model_flops(cfg_obj, shape)
    cost = {"flops_per_device": ana.flops, "hbm_bytes_per_device": ana.hbm_bytes}
    record = {
        "arch": arch_id,
        "shape": shape.name,
        "mesh": mesh_dict,
        "devices": n_dev,
        "compile_s": compile_s,     # the meta pass, in seconds
        "memory": {
            "argument_bytes": ana.argument_bytes,
            "output_bytes": sum(out_storages.values()),
            "temp_bytes": temp,
            "generated_code_bytes": None,
        },
        "cost_raw": {"flops_per_device": ana.flops, "bytes_per_device": ana.hbm_bytes},
        "cost": cost,
        "collectives": {
            "wire_bytes_per_device": ana.wire_bytes,
            "ici_bytes": ana.ici_bytes,
            "dcn_bytes": ana.dcn_bytes,
            "by_kind": ana.by_kind,
            "n_ops": ana.n_collectives,
            "unknown_trip_loops": ana.unknown_trip_loops,
        },
        "roofline": terms,
        "model_flops_total": mf,
        "model_flops_per_device": mf / n_dev,
        "useful_flops_ratio": (mf / n_dev) / ana.flops if ana.flops else None,
        "params_total": count_params(cfg_obj),
        "params_active": active_params(cfg_obj),
        "flops_by_dtype": ana.flops_by_dtype,
        "n_ops": len(ana.ops),
        "kernels": kernels,
        "microbatches": tcfg.microbatches if shape.kind == "train" else None,
        "fits_one_card": ana.argument_bytes + temp <= card_mem["bytes"],
        "card_memory": card_mem,
    }
    if view is not None:
        record["placement"] = PLACEMENT
    return record, ana


def run_cell(arch_id: str, shape_name: str, mesh_kind: str, out_dir: str,
             tcfg: TrainConfig) -> dict:
    """One cell on ``mesh_kind`` ("card", "single" or "multi"), its record
    written under ``out_dir``."""
    mesh = ({"card": 1} if mesh_kind == "card" else
            make_production_mesh(multi_pod=mesh_kind == "multi", device="meta"))
    record, ana = lower_cell(arch_id, shape_name, mesh, tcfg)
    os.makedirs(out_dir, exist_ok=True)
    fname = f"{arch_id}__{shape_name}__{mesh_kind}.json".replace("/", "_")
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(record, f, indent=1)
    del ana
    gc.collect()
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="card", choices=["card", "single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--microbatches", type=int, default=16)
    args = ap.parse_args(argv)

    tcfg = TrainConfig(microbatches=args.microbatches, remat=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    cells = []
    if args.all:
        for aid in ARCH_IDS:
            for sname in arch_shapes(get_config(aid)):
                cells.append((aid, sname))
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    failures = []
    t_all = time.monotonic()
    for aid, sname in cells:
        for mk in meshes:
            tag = f"{aid} x {sname} x {mk}"
            try:
                t0 = time.monotonic()
                rec = run_cell(aid, sname, mk, args.out, tcfg)
                r = rec["roofline"]
                print(f"[ok] {tag}: meta pass={rec['compile_s']:.1f}s "
                      f"compute={r['compute_s']*1e3:.2f}ms "
                      f"memory={r['memory_s']*1e3:.2f}ms "
                      f"coll={r['collective_s']*1e3:.2f}ms "
                      f"dominant={r['dominant']} "
                      f"fits={rec['fits_one_card']} "
                      f"(wall {time.monotonic()-t0:.0f}s)", flush=True)
            except Exception as e:      # one cell's failure is reported; the rest still run
                failures.append((tag, repr(e)))
                print(f"[FAIL] {tag}: {e}", flush=True)
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e)
        raise SystemExit(1)
    print(f"\nall {len(cells) * len(meshes)} cells passed in {time.monotonic() - t_all:.1f}s")


if __name__ == "__main__":
    main()
