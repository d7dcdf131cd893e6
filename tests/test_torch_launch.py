"""The port's launch tools (``repro_torch.launch``): the op counter against
known answers and ``FlopCounterMode``, each family's counted forward
FLOPs against the reference's HLO analyzer, the dry run's cell tables and
record against the reference's, kernel 7's meta path and traffic report,
and the meshes."""
import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.launch import hlo_analysis
from repro.models import zoo as jzoo
from repro.models.params import shape_struct
from repro.models.transformer import build_model as jbuild_model
from repro_torch.kernels import ops, ref
from repro_torch.kernels.moe_dispatch import moe_dispatch_gather, moe_dispatch_gather_backward
from repro_torch.launch import dryrun, mesh as lmesh, op_analysis, op_profile
from repro_torch.launch.op_analysis import OpCounter, analyze, roofline_terms
from repro_torch.models import zoo
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.models.moe import capacity, dispatch_plan, uses_dense
from repro_torch.models.transformer import Model
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_loop import TrainConfig, train_params, train_step_fn

REPO = os.path.join(os.path.dirname(__file__), "..")
META = torch.device("meta")


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


# ------------------------------------------------------------- known answers


def test_a_loop_of_products_counts_its_flops_and_bytes_exactly():
    layers, b, d = 5, 24, 96
    ws = [meta(d, d, dtype=torch.bfloat16) for _ in range(layers)]
    x = meta(b, d, dtype=torch.bfloat16)
    ys, ana = analyze(lambda: [x @ w for w in ws], resident=(ws, x))
    assert ana.flops == 2 * layers * b * d * d
    assert ana.flops_by_dtype == {"bfloat16": 2 * layers * b * d * d}
    assert ana.hbm_bytes == layers * 2 * (b * d + d * d + b * d)
    assert [r.op for r in ana.ops] == ["aten.mm"] * layers
    assert ana.argument_bytes == 2 * (layers * d * d + b * d)
    assert ana.peak_bytes == ana.argument_bytes + layers * 2 * b * d
    terms = roofline_terms(ana)
    assert terms["compute_s"] == ana.flops / 989e12
    assert terms["memory_s"] == ana.hbm_bytes / 3.35e12
    assert terms["dominant"] == "memory" and terms["bound_s"] == terms["memory_s"]
    assert terms["collective_s"] == terms["ici_bytes"] == terms["dcn_bytes"] == 0


def test_views_in_place_ops_factories_and_broadcasts():
    x = meta(64, 32)

    def step():
        v = x.view(-1)
        y = x.clone()
        y.add_(x)
        z = torch.zeros(10, device=META)
        e = torch.empty(100, device=META)
        w = x + meta(32)[None].expand(64, 32)
        z.copy_(meta(10))
        return v, y, z, e, w

    _, ana = analyze(step, resident=(x,))
    by_op = {r.op: r.bytes for r in ana.ops}
    n = 64 * 32 * 4
    assert by_op["aten.view"] == 0 and by_op["aten.expand"] == 0
    assert by_op["aten.clone"] == 2 * n
    assert by_op["aten.add_"] == 3 * n            # self read, x read, self written
    assert by_op["aten.zeros"] == 40
    assert "aten.empty" not in by_op              # no fill: no op, no bytes
    assert by_op["aten.add"] == n + 32 * 4 + n    # the broadcast row counts once
    assert by_op["aten.copy_"] == 40 + 40          # the source read, the destination written
    assert ana.flops == 0 and ana.flops_by_dtype == {}


def test_live_and_peak_bytes_follow_allocations_and_frees():
    x = meta(1000)                                  # 4,000 bytes resident

    def step():
        a = torch.ones(2000, device=META)           # +8,000
        b = a * 2                                   # +8,000: 20,000 live
        del a                                       # -8,000
        c = torch.ones(500, device=META)            # +2,000: 14,000
        return b + c[:1]                            # +8,000: 22,000, the peak

    counter = OpCounter(resident=(x,))
    with counter:
        out = step()
    ana = counter.analysis()
    assert ana.argument_bytes == 4000
    assert ana.peak_bytes == 22000
    del out
    assert counter.live_bytes == 4000          # b, c and the sum freed; x stays


def test_counter_flops_equal_flop_counter_mode_on_a_reduced_forward():
    cfg = zoo.reduced_config("mistral-nemo-12b")
    model = Model(cfg, device=META)
    tokens = meta(2, 64, dtype=torch.int32)
    _, ana = analyze(lambda: model.forward(tokens))
    with FlopCounterMode(display=False) as fc:
        model.forward(tokens)
    assert ana.flops == fc.get_total_flops() > 0
    assert set(ana.flops_by_dtype) == {"float32"}


def test_callers_name_the_port_and_the_autograd_nodes():
    cfg = dataclasses.replace(zoo.reduced_config("minitron-4b"), n_layers=2)
    model = Model(cfg, device=META)
    params = train_params(model)
    batch = {"tokens": meta(2, 16, dtype=torch.int32), "labels": meta(2, 16, dtype=torch.int32)}
    step = train_step_fn(model, TrainConfig(microbatches=2, remat=True))
    _, ana = analyze(step, params, adamw_init(params), batch)
    callers = {r.caller for r in ana.ops}
    assert "models/layers.py:flash_attention" in callers
    assert "train/optimizer.py:adamw_apply" in callers
    assert any(c.startswith("autograd:") for c in callers)
    assert not any("op_analysis" in c for c in callers)
    shown = op_profile.contributors(ana, top=5)
    assert len(shown["bytes"]) == 5 and shown["bytes"][0][1] >= shown["bytes"][-1][1]


# --------------------------------------------- forward FLOPs against the reference


def _batch(cfg, b, s, meta_device):
    shapes = ({"frames": ((b, s, cfg.frontend_dim), "f")} if cfg.frontend == "frames"
              else {"tokens": ((b, s), "i")})
    if cfg.family == "vlm":
        shapes["image_embeds"] = ((b, cfg.vlm.vision_tokens, cfg.vlm.vision_dim), "f")
    if meta_device:
        return {k: meta(*sh, dtype=torch.int32 if t == "i" else torch.float32)
                for k, (sh, t) in shapes.items()}
    return {k: jax.ShapeDtypeStruct(sh, jnp.int32 if t == "i" else jnp.float32)
            for k, (sh, t) in shapes.items()}


# the port's MLA attends over v at its own width (16); the reference pads v
# to q's head dim (24) for its shared attention kernel and slices the pad
# off: 2·B·H·T·T·8 = 524,288 FLOPs a layer more, 0.36% of the forward
MLA_V_PAD = {"deepseek-v2-lite-16b": 2 * 2 * 4 * 64 * 64 * 8 * 2}


@pytest.mark.parametrize("arch,top_k", [(a, None) for a in zoo.ARCH_IDS]
                         + [("deepseek-v2-lite-16b", 2)])
def test_forward_flops_match_the_reference_analyzer(arch, top_k):
    """Each family's reduced config at batch 2 × 64: the counter's FLOPs on
    meta against ``hlo_analysis.analyze`` of the compiled JAX forward. At
    top-2 deepseek takes the sparse dispatch, kernel 7's meta path."""
    jc, pc = jzoo.reduced_config(arch), zoo.reduced_config(arch)
    if top_k:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, top_k=top_k))
        pc = dataclasses.replace(pc, moe=dataclasses.replace(pc.moe, top_k=top_k))
    jm = jbuild_model(jc)
    hlo = jax.jit(lambda p, b: jm.forward(p, b)).lower(
        shape_struct(jm.specs()), _batch(jc, 2, 64, False)).compile().as_text()
    want = hlo_analysis.analyze(hlo, 1).flops
    model = Model(pc, device=META)
    b = _batch(pc, 2, 64, True)
    before = moe_dispatch_gather.launches
    _, ana = analyze(lambda: model.forward(b.get("tokens"), frames=b.get("frames"),
                                           image_embeds=b.get("image_embeds")))
    assert moe_dispatch_gather.launches == before
    notes = sum(r.op == "moe_dispatch_gather" for r in ana.ops)
    sparse = pc.moe is not None and not uses_dense(pc.moe)
    assert notes == (pc.n_layers - pc.moe.first_dense_layers if sparse else 0)
    assert sparse == (arch == "mixtral-8x22b" or top_k == 2)
    assert ana.flops == want - MLA_V_PAD.get(arch, 0)
    assert abs(ana.flops - want) <= 0.01 * want


# ------------------------------------------------------ the cell tables and records

REFERENCE_TABLES = r"""
import dataclasses, json
import jax.numpy as jnp
from repro.launch import dryrun
from repro.models.config import SHAPES
from repro.models.zoo import ARCH_IDS, arch_shapes, get_config

def plain(cfg):
    d = dataclasses.asdict(cfg)
    d["dtype"] = str(jnp.dtype(d["dtype"]))
    return d

out = {"mb": dryrun.MB_OVERRIDES, "cells": {}}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    out["cells"][arch] = {s: {"model_flops": dryrun.model_flops(cfg, SHAPES[s]),
                              "serving_config": plain(dryrun.serving_config(cfg, SHAPES[s]))}
                          for s in arch_shapes(cfg)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_tables():
    """The reference's tables, from a subprocess: ``repro.launch.dryrun``
    sets XLA_FLAGS to 512 host devices when imported."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", REFERENCE_TABLES], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", zoo.ARCH_IDS)
def test_cells_model_flops_and_serving_configs_match_the_reference(arch, reference_tables):
    assert dryrun.MB_OVERRIDES == reference_tables["mb"]
    cfg = zoo.get_config(arch)
    want = reference_tables["cells"][arch]
    assert zoo.arch_shapes(cfg) == list(want)
    for shape, row in want.items():
        assert dryrun.model_flops(cfg, SHAPES[shape]) == row["model_flops"]
        got = dataclasses.asdict(dryrun.serving_config(cfg, SHAPES[shape]))
        got["dtype"] = str(got["dtype"]).removeprefix("torch.")
        ref_cfg = row["serving_config"]
        assert {k: v for k, v in ref_cfg.items() if k in got} == json.loads(json.dumps(got))
        assert all(ref_cfg[k] in (None, 0, False) for k in set(ref_cfg) - set(got))


def test_dryrun_record_of_the_reference_test_cell(tmp_path):
    """xlstm-1.3b × decode_32k, the cell ``tests/test_launch.py`` dry-runs,
    through the CLI: the reference's keys and the port's additions."""
    dryrun.main(["--arch", "xlstm-1.3b", "--shape", "decode_32k", "--mesh", "card",
                 "--out", str(tmp_path)])
    rec = json.load(open(tmp_path / "xlstm-1.3b__decode_32k__card.json"))
    assert rec["devices"] == 1 and rec["mesh"] == {"card": 1}
    for key in ("compute_s", "memory_s", "collective_s", "dominant"):
        assert key in rec["roofline"]
    assert rec["cost"]["flops_per_device"] > 0
    assert rec["collectives"] == {"wire_bytes_per_device": 0.0, "ici_bytes": 0.0,
                                  "dcn_bytes": 0.0, "by_kind": {}, "n_ops": 0,
                                  "unknown_trip_loops": 0}
    assert rec["cost_raw"] == {"flops_per_device": rec["cost"]["flops_per_device"],
                               "bytes_per_device": rec["cost"]["hbm_bytes_per_device"]}
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                  "generated_code_bytes"}
    cfg = zoo.get_config("xlstm-1.3b")
    assert rec["model_flops_total"] == 2.0 * zoo.active_params(cfg) * SHAPES["decode_32k"].global_batch
    assert rec["useful_flops_ratio"] == rec["model_flops_total"] / rec["cost"]["flops_per_device"]
    assert rec["params_total"] == zoo.count_params(cfg)
    assert rec["fits_one_card"] == (rec["memory"]["argument_bytes"] + rec["memory"]["temp_bytes"]
                                    <= rec["card_memory"]["bytes"])
    assert sum(rec["flops_by_dtype"].values()) == rec["cost"]["flops_per_device"]
    assert rec["roofline"]["bound_s"] == max(rec["roofline"]["compute_s"],
                                             rec["roofline"]["memory_s"])


@pytest.mark.parametrize("arch,kind", [(a, k) for a in zoo.ARCH_IDS
                                       for k in ("train", "prefill", "decode")
                                       if k != "decode" or not zoo.get_config(a).encoder_only])
def test_every_family_runs_each_step_kind_on_meta(arch, kind):
    """Each family's reduced config through the dry run at 2 × 32: the
    train step, the prefill (an encoder's through ``frames``) and the
    decode (a VLM's with ``vision_kv``), as ``--all`` runs them at full
    size (an encoder has no decode cell); a prefill costs the forward's
    FLOPs but the head's over all but the last token."""
    cfg = zoo.reduced_config(arch)
    shape = dataclasses.replace(SHAPES[{"train": "train_4k", "prefill": "prefill_32k",
                                        "decode": "decode_32k"}[kind]], seq_len=32,
                                global_batch=2)
    rec, ana = dryrun.lower_cell(arch, shape, tcfg=TrainConfig(microbatches=2), cfg=cfg)
    assert rec["cost"]["flops_per_device"] > 0 and rec["n_ops"] == len(ana.ops) > 0
    assert rec["memory"]["argument_bytes"] > 0 and rec["memory"]["temp_bytes"] > 0
    if kind == "prefill":
        b = _batch(cfg, 2, 32, True)
        _, fwd = analyze(lambda: Model(cfg, device=META).forward(
            b.get("tokens"), frames=b.get("frames"), image_embeds=b.get("image_embeds")))
        head = 2 * 2 * 31 * cfg.d_model * cfg.vocab      # the prefill's head runs on the last token
        assert rec["cost"]["flops_per_device"] == fwd.flops - (0 if cfg.encoder_only else head)


def test_moe_train_cell_reports_kernels_7_and_7t_on_meta():
    """A reduced deepseek at top-2 trained on meta in 2 microbatches:
    kernel 7 reports its traffic in the forward and the recompute, 7ᵀ in
    the backward, and neither launches."""
    cfg = zoo.reduced_config("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, top_k=2))
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=32, global_batch=4)
    before = (moe_dispatch_gather.launches, moe_dispatch_gather_backward.launches)
    rec, ana = dryrun.lower_cell(cfg.arch_id, shape, tcfg=TrainConfig(microbatches=2), cfg=cfg)
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    assert rec["kernels"]["moe_dispatch_gather"]["launches"] == 2 * 2 * n_moe
    assert rec["kernels"]["moe_dispatch_gather_backward"]["launches"] == 2 * n_moe
    assert (moe_dispatch_gather.launches, moe_dispatch_gather_backward.launches) == before
    assert rec["microbatches"] == 2 and rec["memory"]["temp_bytes"] > 0


def test_other_meshes_raise(tmp_path):
    """The dry run's meshes are card, single, multi and both; any other
    mesh (an unknown name, an axis of size 0) raises before a cell runs
    (single and multi write records: ``test_mesh_records``)."""
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "xlstm-1.3b", "--shape", "decode_32k", "--mesh", "pod",
                     "--out", str(tmp_path)])
    with pytest.raises(ValueError, match="positive sizes"):
        dryrun.lower_cell("xlstm-1.3b", "decode_32k", {"data": 2, "model": 0})
    assert not list(tmp_path.iterdir())


# the reference's record keys (``repro.launch.dryrun.lower_cell``)
REFERENCE_KEYS = {
    "arch", "shape", "mesh", "devices", "compile_s", "memory", "cost_raw", "cost",
    "collectives", "roofline", "model_flops_total", "model_flops_per_device",
    "useful_flops_ratio", "params_total", "params_active"}
REFERENCE_SUBKEYS = {
    "memory": {"argument_bytes", "output_bytes", "temp_bytes", "generated_code_bytes"},
    "cost_raw": {"flops_per_device", "bytes_per_device"},
    "cost": {"flops_per_device", "hbm_bytes_per_device"},
    "collectives": {"wire_bytes_per_device", "ici_bytes", "dcn_bytes", "by_kind", "n_ops",
                    "unknown_trip_loops"},
    "roofline": {"compute_s", "memory_s", "collective_s", "ici_bytes", "dcn_bytes",
                 "dominant", "bound_s"}}


@pytest.mark.parametrize("kind,devices", [("single", 256), ("multi", 512)])
def test_mesh_records(tmp_path, kind, devices):
    """``--mesh single`` and ``multi`` on the reference's test cell: device
    0's step on the 16x16 and 2x16x16 meshes, with every key of the
    reference's record and non-zero collective fields."""
    dryrun.main(["--arch", "xlstm-1.3b", "--shape", "decode_32k", "--mesh", kind,
                 "--out", str(tmp_path)])
    rec = json.load(open(tmp_path / f"xlstm-1.3b__decode_32k__{kind}.json"))
    assert REFERENCE_KEYS <= set(rec)
    for key, sub in REFERENCE_SUBKEYS.items():
        assert sub <= set(rec[key]), key
    axes = {"data": 16, "model": 16} if kind == "single" else {"pod": 2, "data": 16, "model": 16}
    assert rec["devices"] == devices and rec["mesh"] == axes
    coll = rec["collectives"]
    assert coll["wire_bytes_per_device"] > 0 and coll["n_ops"] > 0
    assert coll["wire_bytes_per_device"] == coll["ici_bytes"] + coll["dcn_bytes"]
    assert coll["wire_bytes_per_device"] == pytest.approx(sum(coll["by_kind"].values()))
    assert coll["unknown_trip_loops"] == 0 and rec["cost_raw"]["flops_per_device"] == \
        rec["cost"]["flops_per_device"]
    assert rec["roofline"]["collective_s"] == pytest.approx(
        coll["ici_bytes"] / op_analysis.NVLINK_BW + coll["dcn_bytes"] / op_analysis.IB_BW)
    assert rec["model_flops_per_device"] == rec["model_flops_total"] / devices
    assert rec["fits_one_card"] == (rec["memory"]["argument_bytes"] + rec["memory"]["temp_bytes"]
                                    <= rec["card_memory"]["bytes"])
    assert "placement" in rec


def test_multi_train_cell_crosses_pods():
    """A cut train cell on the 2x16x16 mesh: gradients reduced across the
    pods go between nodes (``dcn_bytes``); every kind the step issues."""
    cfg = zoo.reduced_config("minitron-4b")
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=16, global_batch=64)
    mesh = lmesh.make_production_mesh(multi_pod=True, device="meta")
    rec, ana = dryrun.lower_cell(cfg.arch_id, shape, mesh, TrainConfig(microbatches=16), cfg=cfg)
    assert rec["devices"] == 512 and rec["microbatches"] == 2    # 64 rows over 32 groups
    assert rec["collectives"]["dcn_bytes"] > 0
    assert set(rec["collectives"]["by_kind"]) == {"all-gather", "reduce-scatter", "all-reduce"}
    pods = [c for c in ana.collectives if c.kind == "all-reduce" and c.group == 2]
    assert pods and all(c.crosses_node for c in pods)


def _block_bytes(specs, shardings, dtype=None):
    from repro_torch.distributed.sharding import tree_map

    total = []
    is_leaf = lambda x: hasattr(x, "shape") and hasattr(x, "dtype") and not isinstance(  # noqa: E731
        x, (dict, torch.Tensor))
    tree_map(lambda sp, sh: total.append(
        math.prod(sh.shard_shape(sp.shape)) * torch.empty((), dtype=dtype or sp.dtype)
        .element_size()), specs, shardings, is_leaf=is_leaf)
    return sum(total)


def test_mesh_argument_bytes_are_the_devices_own_blocks():
    """Device 0's arguments on a (pod 2, data 2, model 2) mesh: its
    parameter blocks, its ZeRO-1 master/mu/nu blocks and the step, its
    rows of the batch; for a decode its cache blocks and its token rows."""
    from repro_torch.distributed.sharding import param_shardings, zero1_shardings
    from repro_torch.launch.device_view import DeviceView
    from repro_torch.models.transformer import cache_specs, model_specs
    from repro_torch.serve.kv_cache import cache_shardings

    cfg = zoo.reduced_config("deepseek-v2-lite-16b")
    axes = {"pod": 2, "data": 2, "model": 2}
    view = DeviceView(lmesh.make_mesh(tuple(axes.values()), tuple(axes), device="meta"))
    specs = model_specs(cfg)
    p = _block_bytes(specs, param_shardings(view, specs))
    z = _block_bytes(specs, zero1_shardings(view, specs), torch.float32)
    train = dataclasses.replace(SHAPES["train_4k"], seq_len=16, global_batch=8)
    rec, _ = dryrun.lower_cell(cfg.arch_id, train, axes, TrainConfig(microbatches=2), cfg=cfg)
    rows = 8 // 4
    assert rec["memory"]["argument_bytes"] == p + 3 * z + 4 + 2 * rows * 16 * 4
    dec = dataclasses.replace(SHAPES["decode_32k"], seq_len=16, global_batch=8)
    rec, _ = dryrun.lower_cell(cfg.arch_id, dec, axes, cfg=cfg)
    c = _block_bytes(cache_specs(cfg, 8, 16), cache_shardings(view, cfg, 8, 16))
    assert rec["memory"]["argument_bytes"] == p + c + rows * 4


def test_collective_wire_bytes_by_hand():
    """One device's primitives on a (pod 2, data 4, model 2) view, counted
    by the reference's formulas: flat id = 8·pod + 2·data + model, so the
    data and model groups of device 0 stay in its 8-card node and the pod
    group crosses to the next."""
    from repro_torch.launch.device_view import DeviceView

    view = DeviceView(lmesh.make_mesh((2, 4, 2), ("pod", "data", "model"), device="meta"))
    assert view.group(("data",)) == [0, 2, 4, 6] and view.group(("pod",)) == [0, 8]

    def step():
        full = view.gather_full(meta(1, 4, 8, dtype=torch.bfloat16), ("data", "model"))
        assert full.shape == (16, 16)                       # 512 bytes over 8: 448
        blk = view.scatter_full(meta(16, 16), ("data",))    # 256-byte block: RS over data
        assert blk.shape == (1, 4, 16)                      # 768, AR over pod 256
        g = view.all_gather(meta(1, 4, 8), "model", dim=1)  # 256 bytes over 2: 128
        assert g.shape == (1, 8, 8)
        view.ppermute(meta(1, 10), "pod", [(0, 1), (1, 0)])                 # 40
        view.all_to_all(meta(1, 4, 3, dtype=torch.int32), "data")          # 48·3/4 = 36
        view.fold_blocks(lambda b: b.sum(), meta(1, 5), [0, 8])            # 2·4·1/2 = 4

    _, ana = analyze(step)
    assert ana.by_kind == {"all-gather": 448 + 128, "reduce-scatter": 768,
                           "all-reduce": 256 + 4, "collective-permute": 40, "all-to-all": 36}
    assert ana.n_collectives == 7
    assert ana.ici_bytes == 448 + 768 + 128 + 36 and ana.dcn_bytes == 256 + 40 + 4
    assert ana.wire_bytes == ana.ici_bytes + ana.dcn_bytes
    terms = roofline_terms(ana)
    assert terms["collective_s"] == 1380 / 450e9 + 300 / 50e9
    assert op_analysis.wire_bytes("all-reduce", 100, 4) == 150.0


REFERENCE_MESH_CELLS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
jax.devices()                     # 8 host devices, before the dry run's module sets 512
from repro.launch import dryrun
from repro.models import zoo
from repro.models.config import ShapeConfig

mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
out = {}
for arch, kinds in json.loads(sys.argv[1]):
    cfg = zoo.reduced_config(arch)
    dryrun.get_config = lambda a, cfg=cfg: cfg
    for kind in kinds:
        dryrun.SHAPES["cut_" + kind] = ShapeConfig("cut_" + kind, 64, 16, kind)
        rec, _, _ = dryrun.lower_cell(arch, "cut_" + kind, mesh,
                                      dryrun.TrainConfig(microbatches=2, remat=True))
        out[arch + "/" + kind] = {"arg": rec["memory"]["argument_bytes"],
                                  "flops": rec["cost"]["flops_per_device"],
                                  "keys": {k: sorted(v) if isinstance(v, dict) else None
                                           for k, v in rec.items()}}
print(json.dumps(out))
"""
MESH_CELLS = [("minitron-4b", ["train", "prefill", "decode"]),
              ("deepseek-v2-lite-16b", ["decode"]), ("xlstm-1.3b", ["decode"])]


@pytest.fixture(scope="module")
def reference_mesh_cells():
    """The reference's ``lower_cell`` on an Auto-axis (2, 2, 2) mesh of 8
    host devices, each arch's reduced config patched in, at 16 × 64."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", REFERENCE_MESH_CELLS, json.dumps(MESH_CELLS)],
                         env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,kind", [(a, k) for a, ks in MESH_CELLS for k in ks])
def test_mesh_argument_bytes_match_the_reference(arch, kind, reference_mesh_cells):
    """Per-device argument bytes against XLA's
    ``memory_analysis().argument_size_in_bytes`` for the same cut cell:
    equal (tolerance 0). The FLOPs differ by the placement (the port's
    model axis repeats its group's work), so their ratio is printed."""
    want = reference_mesh_cells[f"{arch}/{kind}"]
    cfg = zoo.reduced_config(arch)
    shape = ShapeConfig(f"cut_{kind}", 64, 16, kind)
    rec, _ = dryrun.lower_cell(arch, shape, {"pod": 2, "data": 2, "model": 2},
                               TrainConfig(microbatches=2, remat=True), cfg=cfg)
    assert rec["memory"]["argument_bytes"] == want["arg"]
    assert set(want["keys"]) <= set(rec)
    for key, sub in want["keys"].items():
        if sub is not None and key != "mesh":
            assert set(sub) <= set(rec[key]), key
    print(f"{arch} {kind}: port/reference FLOPs per device "
          f"{rec['cost']['flops_per_device'] / want['flops']:.3f}")


# ------------------------------------------------------ kernel 7 on meta


def _plan(b=2, t=16, experts=8, k=2, seed=0):
    from repro_torch.models.config import MoEConfig

    g = torch.Generator().manual_seed(seed)
    m = MoEConfig(n_experts=experts, top_k=k, d_ff_expert=8)
    ids = torch.argsort(torch.rand((b, t, experts), generator=g), dim=-1)[..., :k]
    c = capacity(t, m)
    return dispatch_plan(ids.to(torch.int32).contiguous(), experts, c), c


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_7_on_meta_shapes_without_launching(dtype):
    plan, c = _plan()
    s, t, d = plan.slot_tok.shape[0], 32, 24
    before = (moe_dispatch_gather.launches, dict(moe_dispatch_gather.paths),
              moe_dispatch_gather_backward.launches)
    with OpCounter() as counter:
        out = moe_dispatch_gather(meta(t, d, dtype=dtype), plan.slot_tok.to(META),
                                  group=c, experts=8)
        grad = moe_dispatch_gather_backward(meta(s, d, dtype=dtype), plan.tok_slots.to(META))
    assert out.device == META and out.shape == (s, d) and out.dtype == dtype
    assert grad.device == META and grad.shape == (t, d) and grad.dtype == dtype
    assert before == (moe_dispatch_gather.launches, dict(moe_dispatch_gather.paths),
                      moe_dispatch_gather_backward.launches)
    e = torch.empty((), dtype=dtype).element_size()
    notes = {r.op: r.bytes for r in counter.analysis().ops if not r.op.startswith("aten.")}
    assert notes == {"moe_dispatch_gather": (t + s) * d * e + 4 * s,
                     "moe_dispatch_gather_backward": (t * 2 + t) * d * e + 4 * t * 2}


def test_kernel_7_on_meta_still_checks_its_operands():
    plan, c = _plan()
    x, tok = meta(32, 24), plan.slot_tok.to(META)
    with pytest.raises(TypeError):
        moe_dispatch_gather(meta(32, 24, dtype=torch.float16), tok)
    with pytest.raises(ValueError, match="int32"):
        moe_dispatch_gather(x, tok.long())
    with pytest.raises(ValueError, match="contiguous"):
        moe_dispatch_gather(meta(24, 32).t(), tok)
    with pytest.raises(ValueError, match="operands on"):
        moe_dispatch_gather(x, plan.slot_tok)
    with pytest.raises(ValueError, match="experts"):
        moe_dispatch_gather(x, tok, group=c, experts=7)
    with pytest.raises(ValueError, match="tok_slots"):
        moe_dispatch_gather_backward(meta(tok.shape[0], 24), plan.tok_slots.to(META).view(-1))


def test_kernel_7_on_the_cpu_still_runs_the_plain_version():
    plan, c = _plan(seed=3)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((32, 24), generator=g)
    grad = torch.randn((plan.slot_tok.shape[0], 24), generator=g)
    with OpCounter() as counter:
        out = moe_dispatch_gather(x, plan.slot_tok, group=c, experts=8)
        gx = moe_dispatch_gather_backward(grad, plan.tok_slots)
    assert torch.equal(out, ref.moe_dispatch_gather_ref(x, plan.slot_tok))
    assert torch.equal(gx, ref.moe_dispatch_gather_backward_ref(grad, plan.tok_slots))
    # the plain versions are aten ops the counter sees; no kernel reports
    assert all(r.op.startswith("aten.") for r in counter.analysis().ops)
    y = ops.moe_dispatch(x.requires_grad_(True), plan.slot_tok, plan.tok_slots, group=c,
                         experts=8)
    y.backward(grad)
    assert torch.equal(x.grad, gx)


# ------------------------------------------------------------------ meshes


def test_meshes_of_virtual_devices():
    m = lmesh.make_mesh((2, 4), ("data", "model"), device="cpu")
    assert m.shape == {"data": 2, "model": 4} and m.axis_names == ("data", "model")
    assert m.n_devices == 8 and m.device.type == "cpu"
    s = lmesh.small_mesh(device="cpu")
    assert s.shape == {"data": 2, "model": 2}
    assert lmesh.small_mesh(data=1, model=3, device="cpu").shape == {"data": 1, "model": 3}


def test_pod_and_production_meshes_raise():
    """The pod and production meshes build as virtual meshes; a dry run
    over a production mesh's axes counts device 0's step on it (the name
    is kept from when a dry run on these meshes raised)."""
    s = lmesh.small_mesh(data=2, model=2, pod=2, device="cpu")
    assert s.shape == {"pod": 2, "data": 2, "model": 2} and s.n_devices == 8
    m = lmesh.make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    assert m.axis_names == ("pod", "data", "model")
    for multi, shape in ((False, {"data": 16, "model": 16}),
                         (True, {"pod": 2, "data": 16, "model": 16})):
        big = lmesh.make_production_mesh(multi_pod=multi, device="cpu")
        assert big.shape == shape and big.n_devices == (512 if multi else 256)
        rec, _ = dryrun.lower_cell("xlstm-1.3b", "decode_32k", big.shape)
        assert rec["devices"] == big.n_devices and rec["mesh"] == shape


def test_the_card_constants_are_the_h100s():
    assert op_analysis.PEAK_FLOPS == {"bfloat16": 989e12, "float16": 989e12,
                                      "float32": 67e12}
    assert op_analysis.HBM_BW == 3.35e12 and op_analysis.HBM_BYTES == 80e9
    assert op_analysis.NVLINK_BW == 450e9 and op_analysis.IB_BW == 50e9
    assert op_analysis.NODE_SIZE == 8
