"""The cases the rank-mesh tests run, importable by the ranks' processes (no
``jax``, no ``repro``): each case is a function of a mesh that runs the
same calls on ``core.mesh.Mesh`` (every block, [D, ...]) and on a rank of
``core.rank_mesh.RankMesh`` (its own block, [1, ...]) from the same
seeded inputs. The tests hold each rank's result to block ``rank`` of the
virtual mesh's.
"""
import importlib
import itertools

import numpy as np
import torch

from repro_torch.core import distributed as dist_mv
from repro_torch.core import semiring as tsemiring
from repro_torch.core.mesh import Mesh
from repro_torch.core.pipeline import iterate_phases

tpart = importlib.import_module("repro_torch.core.partition")

#: world size -> the meshes built on one process group of that size
MESHES = {4: [((4,), ("x",)), ((2, 2), ("dr", "dc"))],
          8: [((2, 2, 2), ("pod", "data", "model")), ((2, 4), ("dr", "dc"))]}
#: (spec entries, kept axes) per axis names, over a full tensor [8, 8]
SPECS = {
    ("x",): [(("x",), ()), ((None, "x"), ()), ((), ()), ((), "x")],
    ("dr", "dc"): [(("dr", "dc"), ()), ((("dr", "dc"),), ()), ((("dc", "dr"), None), ()),
                   (("dc",), ()), ((None, "dr"), ()), ((), ()), (("dc",), "dr"),
                   ((None, "dr"), "dc")],
    ("pod", "data", "model"): [((("pod", "data"), "model"), ()), (("model",), ()),
                               ((None, ("data", "model")), ()), ((("model", "pod"),), ()),
                               (("data", "model"), "pod"), ((None, "data"), "pod"),
                               ((), "pod"), ((None, "model"), ("pod", "data"))],
}
PRIMITIVES = ("all_gather", "ppermute", "all_to_all", "axis_index", "take", "gather_full",
              "scatter_full", "fold_blocks", "fold_scatter", "gather_positions", "split_rows")
SEMIRINGS = ("plus_times", "min_plus", "bool_or_and")
GRAPH_N = 128
BLOCK = (16, 16)
STRATEGIES = {"row": (8, 1), "col": (1, 8), "2d": (2, 4)}


def axis_tuples(names):
    """Every axis and ordered tuple of two or more axes."""
    out = []
    for k in range(1, len(names) + 1):
        out += [c if k > 1 else c[0] for c in itertools.permutations(names, k)]
    return out


def position(mesh: Mesh, axis, flat_id: int) -> int:
    """Device ``flat_id``'s position along ``axis``."""
    for row in mesh._members(axis):
        if flat_id in row:
            return list(row).index(flat_id)
    raise ValueError(flat_id)


def primitive_cases(mesh: Mesh) -> dict:
    """{(primitive, label): fn(mesh) -> what this mesh holds after it}:
    every primitive over every axis and axis tuple of ``mesh``."""
    d = mesh.n_devices
    gen = torch.Generator().manual_seed(d + len(mesh.grid))
    x = torch.randn((d, 3, 5), generator=gen)
    cases = {}
    for ax in axis_tuples(mesh.axis_names):
        s = mesh.axis_size(ax)
        y = torch.randn((d, s, 4), generator=gen)
        cases[("all_gather", f"{ax}/dim1")] = lambda m, ax=ax: m.all_gather(m.local(x), ax, 1)
        cases[("all_gather", f"{ax}/dim2")] = lambda m, ax=ax: m.all_gather(m.local(x), ax, 2)
        cases[("ppermute", f"{ax}/shift")] = lambda m, ax=ax, s=s: m.ppermute(
            m.local(x), ax, [(j, (j + 1) % s) for j in range(s)])
        cases[("ppermute", f"{ax}/one")] = lambda m, ax=ax, s=s: m.ppermute(
            m.local(x), ax, [(0, s - 1)])
        cases[("ppermute", f"{ax}/reverse")] = lambda m, ax=ax, s=s: m.ppermute(
            m.local(x), ax, [(j, s - 1 - j) for j in range(s)])
        cases[("all_to_all", str(ax))] = lambda m, ax=ax, y=y: m.all_to_all(m.local(y), ax)
        cases[("axis_index", str(ax))] = lambda m, ax=ax: m.axis_index(ax)
        cases[("take", str(ax))] = lambda m, ax=ax, y=y, s=s: m.take(
            m.local(y), (m.axis_index(ax) + 1) % s)
    for i, (entries, keep) in enumerate(SPECS[mesh.axis_names]):
        lead = [mesh.axis_size(keep)] if keep else []
        full = torch.randn(lead + [8, 8], generator=gen)
        # blocks as a sharding holds them: the copies along unnamed axes agree
        blocks = mesh.scatter_full(full, entries, keep)
        held = (lambda m, keep=keep, full=full:
                full[m.positions(keep)] if keep else full)
        cases[("gather_full", f"{entries}/keep{keep!r}")] = (
            lambda m, e=entries, k=keep, b=blocks: m.gather_full(m.local(b), e, k))
        cases[("scatter_full", f"{entries}/keep{keep!r}")] = (
            lambda m, e=entries, k=keep, h=held: m.scatter_full(h(m), e, k))
    # the train step's exchanges: one tensor a position along ``over``
    overs = list(mesh.axis_names) + [mesh.axis_names, mesh.axis_names[::-1]]
    for over in overs:
        s = mesh.axis_size(over)
        per_pos = torch.randn((s, 8, 8), generator=gen).to(torch.bfloat16)
        vals = torch.randn((s, 5), generator=gen)
        rows = torch.randn((4 * s, 3), generator=gen)
        for entries, keep in SPECS[mesh.axis_names]:
            if not keep:
                cases[("fold_scatter", f"{over}/{entries}")] = (
                    lambda m, e=entries, over=over, t=per_pos:
                    m.fold_scatter([t[q] for q in m.positions(over)], e, over))
        cases[("gather_positions", str(over))] = lambda m, over=over, v=vals: torch.stack(
            m.gather_positions([v[q] for q in m.positions(over)], over))
        cases[("split_rows", str(over))] = lambda m, over=over, x=rows: torch.stack(
            m.split_rows(x, over))
    for devs in ([0], list(range(d)), [d - 1] + list(range(d - 1))):
        cases[("fold_blocks", str(devs))] = lambda m, devs=devs: m.fold_blocks(
            lambda b: torch.sum(b * b, dim=-1), m.local(x), devs)
    return cases


def rank_view(mesh: Mesh, key, out: torch.Tensor, rank: int) -> torch.Tensor:
    """What rank ``rank`` holds of the virtual mesh's result ``out``."""
    kind, label = key
    if kind in ("fold_blocks", "gather_positions"):
        return out
    if kind == "split_rows":                # the rows of the rank's position
        over = label if label in mesh.axis_names else eval(label)  # noqa: S307 (our labels)
        return out[position(mesh, over, rank)][None]
    if kind == "gather_full":
        keep = eval(label.split("/keep")[1])            # noqa: S307 (our own labels)
        if not keep:
            return out
        return out[position(mesh, keep, rank)][None]
    return out[rank:rank + 1]


def run_primitives(rank: int, world: int, init: str) -> dict:
    """A rank's results of every primitive case on the meshes of ``world``."""
    from repro_torch.core.rank_mesh import init_rank_mesh
    torch.set_num_threads(1)
    out = {}
    for shape, names in MESHES[world]:
        m = init_rank_mesh(shape, names, "gloo", device="cpu", init_method=init, rank=rank,
                           world_size=world)
        for key, fn in primitive_cases(Mesh(shape, names, device="cpu")).items():
            out[(shape,) + key] = fn(m)
        out[(shape, "wire")] = dict(m.wire_bytes)
    return out


# ------------------------------------------------------------- graph layer


def graph_problem(sr_name: str, seed: int = 3, n: int = GRAPH_N):
    """(rows, cols, vals, x dense, x sparse, fill) of a random n×n matrix
    in the semiring's domain, float values where the semiring has them."""
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < 0.08
    rows, cols = np.nonzero(mask)
    if sr_name == "bool_or_and":
        vals = np.ones(rows.shape[0], np.int32)
        x = (rng.random(n) < 0.4).astype(np.int32)
        return rows, cols, vals, x, np.where(rng.random(n) < 0.3, x, 0).astype(np.int32), 0
    vals = rng.uniform(0.5, 4.0, rows.shape[0]).astype(np.float32)
    x = rng.uniform(0.5, 4.0, n).astype(np.float32)
    fill = np.inf if sr_name == "min_plus" else 0.0
    return rows, cols, vals, x, np.where(rng.random(n) < 0.3, x, fill).astype(np.float32), fill


def graph_cases(mesh: Mesh, sr_name: str) -> dict:
    """{(sr, label): fn() -> what this mesh holds}: every strategy, both
    kernels, the fused form, every topology, the compressed Load, the
    batched calls, SpGEMM and ``iterate_phases`` at depth 0 and 2, on a
    (2, 4) mesh; each partition is the rank's own part on a rank."""
    sr = tsemiring.SEMIRINGS[sr_name]
    rows, cols, vals, x, x_sp, fill = graph_problem(sr_name)
    n = GRAPH_N
    own = getattr(mesh, "rank", None)
    rng = np.random.default_rng(11)
    cases = {}

    def pm_of(grid, fmt="bsr", shape=(n, n)):
        return tpart.partition(rows, cols, vals, shape, grid, fmt, sr, block=BLOCK,
                               device="cpu", part=own)

    def shard(pm, v, dim=0):
        return mesh.local(tpart.shard_tensor(pm.plan, torch.from_numpy(v), fill, dim=dim))

    for strategy, grid in STRATEGIES.items():
        pm = pm_of(grid)
        xs, xsp = shard(pm, x), shard(pm, x_sp)

        def mv(pm=pm, strategy=strategy, xin=xs, **kw):
            return lambda: dist_mv.make_distributed_matvec(mesh, pm, sr, strategy, **kw)(
                pm.parts, xin)
        cases[(strategy, "spmv")] = mv()
        cases[(strategy, "spmspv")] = mv(xin=xsp, kernel="spmspv")
        cases[(strategy, "spmv/fused")] = mv(fused=True)
        cases[(strategy, "spmspv/fused")] = mv(xin=xsp, kernel="spmspv", fused=True)
        if strategy != "row":
            for topology, order in (("ring", "rc"), ("tree", "rc"), ("staged2d", "rc"),
                                    ("staged2d", "cr")):
                cases[(strategy, f"spmv/{topology}:{order}")] = mv(topology=topology,
                                                                  merge_order=order)
                cases[(strategy, f"spmspv/fused/{topology}:{order}")] = mv(
                    xin=xsp, kernel="spmspv", fused=True, topology=topology, merge_order=order)
        else:
            cases[(strategy, "spmspv/compressed")] = mv(xin=xsp, kernel="spmspv",
                                                        f_local=pm.plan.in_per)
        if strategy == "2d":
            cases[(strategy, "spmspv/compressed")] = mv(xin=xsp, kernel="spmspv",
                                                        f_local=pm.plan.in_per)
        xb = np.stack([x, x_sp, x[::-1].copy()])
        for kernel in ("spmv", "spmspv"):
            cases[(strategy, f"batched/{kernel}")] = (
                lambda pm=pm, strategy=strategy, kernel=kernel, xb=xb:
                dist_mv.make_distributed_batched_matvec(mesh, pm, sr, strategy, kernel=kernel)(
                    pm.parts, shard(pm, xb, dim=1)))
        # the element formats: each rank's part built on its own
        fmt, kernel = {"row": ("csr", "spmv"), "col": ("csc", "spmspv"),
                       "2d": ("coo", "spmv")}[strategy]
        pe = pm_of(grid, fmt)
        cases[(strategy, f"{fmt}/{kernel}")] = mv(pm=pe, xin=shard(pe, x_sp), kernel=kernel)
        # SpGEMM: B [n, 8], an output mask
        bmat = (rng.random((n, 8)) < 0.5).astype(np.int32) if sr.dtype == torch.int32 else \
            rng.uniform(0.5, 2.0, (n, 8)).astype(np.float32)
        mask = (rng.random((n, 8)) < 0.5).astype(np.float32 if sr.dtype != torch.int32
                                                 else np.int32)
        bs = mesh.local(tpart.shard_tensor(pm.plan, torch.from_numpy(bmat), sr.one))
        ms = mesh.local(tpart.shard_tensor(pm.plan, torch.from_numpy(mask), sr.zero,
                                           side="output"))
        for masked in (False, True):
            cases[(strategy, f"spgemm/{'masked' if masked else 'plain'}")] = (
                lambda pm=pm, strategy=strategy, bs=bs, ms=ms, masked=masked:
                dist_mv.make_distributed_spgemm(mesh, pm, sr, strategy)(
                    pm.parts, bs, ms if masked else None))
    # the pipeline: 4 steps of x <- A x on 2d, square chunks
    pm = pm_of(STRATEGIES["2d"])
    xs = shard(pm, x)
    for depth in (0, 2):
        cases[("2d", f"iterate/depth{depth}")] = (
            lambda depth=depth: iterate_phases(
                dist_mv.build_phase_fns(mesh, pm, sr, "2d", "spmv"), pm.parts, xs, 4, depth))
    return {(sr_name,) + k: v for k, v in cases.items()}


def run_graph(rank: int, world: int, init: str, jax_inputs: dict) -> dict:
    """A rank's output block of every graph case, and of each JAX mesh
    case (``jax_inputs``: the JAX run's rows, cols, values and x)."""
    from repro_torch.core.rank_mesh import init_rank_mesh
    torch.set_num_threads(1)
    m = init_rank_mesh((2, 4), ("dr", "dc"), "gloo", device="cpu", init_method=init,
                       rank=rank, world_size=world)
    out = {}
    for sr_name in SEMIRINGS:
        for key, fn in graph_cases(m, sr_name).items():
            out[key] = fn()
    for key, (rows, cols, vals, x, fill, fmt, strategy, kernel, balance) in jax_inputs.items():
        sr = tsemiring.SEMIRINGS[key.split("/")[0]]
        pm = tpart.partition(rows, cols, vals, (GRAPH_N, GRAPH_N), STRATEGIES[strategy], fmt,
                             sr, block=BLOCK, balance=balance, device="cpu", part=rank)
        xs = m.local(tpart.shard_tensor(pm.plan, torch.from_numpy(x), fill))
        out[("jax", key)] = dist_mv.make_distributed_matvec(m, pm, sr, strategy,
                                                            kernel=kernel)(pm.parts, xs)
    out["wire"] = dict(m.wire_bytes)
    return out


# ------------------------------------------------------------- mesh train


def port_config(arch: str = "deepseek-v2-lite-16b", top_k: int = 2):
    """``test_torch_mesh_train.port_config`` (the reduced config, top-k set)."""
    import dataclasses

    from repro_torch.models import zoo
    cfg = zoo.reduced_config(arch, 0.05)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, top_k=top_k))


def init_tree(ref: dict) -> dict:
    """The reference's initial parameters as a nested dict of numpy arrays
    (its keys are ``jax.tree_util.keystr`` paths under ``init``)."""
    tree: dict = {}
    for key, v in ref.items():
        if key.startswith("init["):
            path = key[len("init") + 2:-2].split("']['")
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = v
    return tree


def blocks_of(tree, prefix: str = "") -> dict:
    """{key path: the blocks} of a tree of ``Sharded`` leaves (a copy)."""
    from repro_torch.distributed.sharding import Sharded
    if isinstance(tree, Sharded):
        return {prefix: tree.blocks.clone()}
    items = tree._asdict().items() if hasattr(tree, "_fields") else tree.items()
    out = {}
    for k, v in items:
        if isinstance(v, (dict, Sharded)) or hasattr(v, "_fields"):
            out.update(blocks_of(v, f"{prefix}/{k}"))
    return out


def train_steps(mesh, kind: str, ref: dict, steps: int) -> list:
    """``steps`` mesh steps of ``kind`` ("plain", "compressed") on the
    reduced DeepSeek from the reference's initial weights: per step, the
    loss, the grad norm, every block of the state and, under ``rows``,
    the rows of each forward the step ran."""
    from repro_torch.distributed.sharding import (
        param_shardings, set_activation_mesh, shard_state, zero1_shardings,
    )
    from repro_torch.models.transformer import build_model, model_specs
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import OptConfig, OptState
    from repro_torch.train.train_loop import (
        TrainConfig, device_batch, init_mesh_ef, make_compressed_train_step, make_train_step,
    )
    cfg = port_config()
    model = build_model(cfg, device="cpu")
    rows, loss_parts = [], model.loss_parts

    def noted(batch, remat=False):
        rows.append(int(batch["labels"].shape[0]))
        return loss_parts(batch, remat)
    model.loss_parts = noted
    specs = model_specs(cfg)
    tree = init_tree(ref)
    params = shard_state(tree, param_shardings(mesh, specs), cfg.dtype)
    zs = zero1_shardings(mesh, specs)
    master = shard_state(tree, zs, torch.float32)
    mu, nu = (shard_state(_zeros_like(tree), zs, torch.float32) for _ in range(2))
    opt = OptState(torch.tensor(0, dtype=torch.int32), master, mu, nu)
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2, total_steps=10), microbatches=2)
    src = SyntheticLM(DataConfig(global_batch=8, seq_len=16, vocab=cfg.vocab))
    if kind == "plain":
        step = make_train_step(model, mesh, tcfg)
    else:
        ef = init_mesh_ef(model, mesh)
        step = make_compressed_train_step(model, mesh, tcfg)
    out = []
    for i in range(steps):
        batch = device_batch(src.batch(i, 0, 1), "cpu")
        if kind == "plain":
            params, opt, m = step(params, opt, batch)
        else:
            params, opt, ef, m = step(params, opt, ef, batch)
        rec = {"rows": list(rows), "loss": m["loss"].clone(), "grad_norm": m["grad_norm"].clone(),
               **{f"params{k}": v for k, v in blocks_of(params).items()},
               **{f"{f}{k}": v for f in ("master", "mu", "nu")
                  for k, v in blocks_of(getattr(opt, f)).items()}}
        if kind == "compressed":
            rec.update({f"ef{k}": v for k, v in blocks_of(ef).items()})
        out.append(rec)
        rows.clear()
    set_activation_mesh(None)
    return out


def _zeros_like(tree: dict) -> dict:
    return {k: _zeros_like(v) if isinstance(v, dict) else np.zeros_like(v)
            for k, v in tree.items()}


def launcher_losses(extra: list, ckpt_dir: str) -> list:
    """The launcher's per-step losses at a small size on the CPU."""
    from repro_torch.launch.train import main
    out = main(["--device", "cpu", "--steps", "4", "--seq", "16", "--global-batch", "4",
                "--data", "2", "--model", "2", "--ckpt-dir", ckpt_dir, *extra])
    return [h["loss"] for h in out["history"]]


def run_train(rank: int, world: int, init: str, ref_path: str, kind: str, steps: int,
              ckpt_dir: str) -> dict:
    """A rank's ``train_steps`` on the rank mesh ((data 2, model 2) for
    "plain", (pod 2, data 2, model 2) for "compressed"); after the plain
    steps, the launcher with ``--backend gloo`` on the same process group."""
    import os

    import torch.distributed as tdist

    from repro_torch.launch.mesh import rank_mesh
    torch.set_num_threads(1)
    mesh = rank_mesh(2, 2, 2 if kind == "compressed" else 0, "gloo", device="cpu",
                     init_method=init, rank=rank, world_size=world)
    out = {"steps": train_steps(mesh, kind, dict(np.load(ref_path)), steps)}
    if kind == "plain":
        out["launcher"] = launcher_losses(["--backend", "gloo"], ckpt_dir)
        out["launcher_ckpt"] = sorted(os.listdir(ckpt_dir))
        assert not tdist.is_initialized()
    return out
