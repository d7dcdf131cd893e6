"""The train steps (``repro.train.train_loop``): the single-device step
body, and the mesh steps on ``core/mesh.py``'s virtual devices.

``train_step_fn`` is the step body: the loss and its gradients with remat
and microbatches, then AdamW. Microbatches: the global batch is split into
``microbatches`` slices run one after another; their gradients accumulate
in f32 and are divided by the count, and the loss reported is the mean of
the slices' total objectives (NLL + 0.01·aux), as the reference reports it.

``make_train_step`` and ``make_compressed_train_step`` are the reference's
pjit and pod-manual steps on a mesh. The state is the reference's layout
in real per-device blocks (``distributed.sharding.Sharded``): parameters
by ``param_shardings``; master, mu, nu and the error-feedback tree by
``zero1_shardings``; ``step`` replicated. Where XLA decides the reference's
placement, the port decides it FSDP-style:
  * each step gathers every leaf from its blocks (``Mesh.gather_full``)
    into the model's parameters, the one working copy that the devices
    of every (pod, data) group share on one card (and that every rank
    holds whole);
  * each microbatch is cut into the rows of each position along the
    batch axes, as the reference shards it over (pod, data). Each
    position runs the forward of its rows; the positions' sums of the
    objective (``Model.loss_parts``: the NLL, the token count, each MoE
    layer's top-1 counts and mean router probability) are exchanged
    (``Mesh.gather_positions``), so that the objective is the whole
    microbatch's, as the reference's is; each position then takes the
    backward of its share (``loss_from_parts`` with the others' sums
    detached). The positions' gradients are folded into the ZeRO-1
    blocks in position order (``Mesh.fold_scatter``: a reduce-scatter
    over the batch axes a block's spec names, an all-reduce over the
    others), microbatch by microbatch;
  * AdamW runs on every device's own blocks, with the gradient norm
    counting each element once (one holder of every set of copies) and
    folding the per-block partials in a fixed order; each parameter's bf16
    blocks are then rewritten from its master blocks, gathered over the
    data axis (``Mesh.all_gather``) where ZeRO-1 split them finer.
The compressed step runs the pod axis manually
(``partial_shard_map``): each pod's gradient comes from its contiguous
share of the global batch, cut into microbatches inside the pod and each
microbatch over the pod's data positions as above, the positions'
gradients folded whole over the data axis; the pods' gradients are
averaged by ``compressed_tree_psum_mean`` over the pod axis, each pod
keeping its own error-feedback buffer.

On ``core/rank_mesh.py``'s ``RankMesh`` (one rank per device) the same
steps run on each rank's own blocks, every gather, exchange and fold a
collective across the ranks, in the same order on every rank: a rank
runs the rows of its own (pod, data) position, so the data axis is real
data parallelism, and its blocks equal the virtual mesh's bit for bit.
The model axis is not tensor parallelism: the ranks of one (pod, data)
position run the same rows on the same working copy, and every rank
holds the full working copy and its rows' full gradient before the
fold, so a model larger than one card's memory waits for the weights
to be gathered layer by layer.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch.convert import leaf_at, param_layout, stack_model_params
from repro_torch.core.mesh import Mesh
from repro_torch.distributed.sharding import (
    NamedSharding, Sharded, batch_axes, entry_axes, param_shardings, set_activation_mesh,
    shard_state, tree_map, zero1_shardings,
)
from repro_torch.models.params import P_
from repro_torch.models.transformer import LossParts, Model, loss_from_parts, model_specs
from repro_torch.train.grad_compress import compressed_psum_mean
from repro_torch.train.optimizer import OptConfig, OptState, adamw_apply, adamw_init

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    microbatches: int = 1
    remat: bool = True
    grad_compress_pod: bool = False   # int8 EF compression on the pod axis


def device_batch(host: Dict[str, np.ndarray], device) -> Dict[str, Tensor]:
    """A host batch (``train.data``'s numpy arrays) as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in host.items()}


def _split_micro(batch: Dict[str, Tensor], k: int) -> Dict[str, Tensor]:
    """[GB, ...] -> [k, GB/k, ...] per leaf."""
    return {key: x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:])) for key, x in batch.items()}


def _backward(model: Model, params: Dict[str, Tensor], batch: Dict[str, Tensor],
              cfg: TrainConfig):
    """The loss of one (micro)batch and its gradients, in each parameter's
    dtype (zeros for a parameter the loss does not reach)."""
    for p in params.values():
        p.grad = None
    total, aux = model.loss(batch, remat=cfg.remat)
    total.backward()
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in params.items()}
    for p in params.values():
        p.grad = None
    return grads, total.detach(), {k: v.detach() for k, v in aux.items()}


def _grads_and_loss(model: Model, params: Dict[str, Tensor], batch: Dict[str, Tensor],
                    cfg: TrainConfig):
    """(grads, loss, aux): one backward, or the f32 mean over microbatches."""
    if cfg.microbatches <= 1:
        return _backward(model, params, batch, cfg)
    micro = _split_micro(batch, cfg.microbatches)
    acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for k, p in params.items()}
    loss_sum = 0.0
    for i in range(cfg.microbatches):
        grads, loss, _ = _backward(model, params, {k: v[i] for k, v in micro.items()}, cfg)
        for k, g in grads.items():
            acc[k].add_(g.float())
        del grads
        loss_sum = loss_sum + loss
    k = cfg.microbatches
    for g in acc.values():
        g.div_(k)
    loss = loss_sum / k
    return acc, loss, {"loss": loss}


def train_step_fn(model: Model, cfg: TrainConfig):
    """The step body: ``(params, opt_state, batch) -> (params, opt_state,
    metrics)``. ``params`` are the model's own parameters by name
    (``train_params``), updated in place; ``batch`` holds tensors on the
    model's device. metrics: ``loss`` (the total objective), ``lr``,
    ``grad_norm``, all 0-d tensors on the device."""

    def step(params: Dict[str, Tensor], opt_state: OptState, batch: Dict[str, Tensor]):
        grads, loss, _ = _grads_and_loss(model, params, batch, cfg)
        params, opt_state, om = adamw_apply(params, grads, opt_state, cfg.opt)
        return params, opt_state, {"loss": loss, **om}

    return step


def train_params(model: Model) -> Dict[str, Tensor]:
    """The model's parameters by name, with ``requires_grad`` turned on."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return params


def init_train_state(model: Model, generator: torch.Generator | None = None, *,
                     seed: int = 0) -> tuple:
    """Initialise the model (``Model.init``) and return (params, the AdamW
    state): the parameters by name with grad on, f32 master copies and
    zero moments on their device."""
    model.init(generator, seed=seed)
    params = train_params(model)
    return params, adamw_init(params)


# ------------------------------------------------------------- mesh steps


def batch_sharding(mesh: Mesh, batch_specs) -> Dict[str, NamedSharding]:
    """Every batch leaf's leading (global-batch) dim over (pod, data)."""
    axes = batch_axes(mesh)
    return {k: NamedSharding(mesh, (axes or None,) + (None,) * (len(v.shape) - 1))
            for k, v in batch_specs.items()}


def partial_shard_map(body: Callable, mesh: Mesh, manual_axes, in_specs, out_specs):
    """``shard_map`` manual over ``manual_axes`` only. The result runs
    ``body(position, *args)`` once per position along those axes (row-major
    in mesh order), an argument whose spec names them on its leading dim
    cut into its contiguous chunk for that position (every leaf of a dict),
    any other argument whole. An output whose spec names the manual axes
    comes back as the list of every position's value (of the positions
    the mesh holds: a rank's own alone); any other output is the same at
    every position, and the first one's is returned."""
    axes = tuple(a for a in mesh.axis_names if a in set(manual_axes))
    n = mesh.axis_size(axes)
    held = mesh.positions(axes)         # every position, or a rank's own

    def manual(spec) -> bool:
        return bool(spec) and bool(set(entry_axes(spec[0])) & set(axes))

    def cut(arg, spec, i):
        if not manual(spec):
            return arg
        one = lambda x: x[i * (x.shape[0] // n):(i + 1) * (x.shape[0] // n)]
        return {k: one(v) for k, v in arg.items()} if isinstance(arg, dict) else one(arg)

    def run(*args):
        outs = [body(i, *(cut(a, sp, i) for a, sp in zip(args, in_specs))) for i in held]
        return tuple([o[j] for o in outs] if manual(sp) else outs[0][j]
                     for j, sp in enumerate(out_specs))
    return run


def _fold(values: List[torch.Tensor]) -> torch.Tensor:
    """The ⊕ of per-position values, left to right in position order."""
    total = values[0]
    for v in values[1:]:
        total = total + v
    return total


class _MeshPlan:
    """A model on a mesh: per leaf of the JAX params tree, its port
    parameters, its parameter and ZeRO-1 shardings."""

    def __init__(self, model: Model, mesh: Mesh):
        self.mesh = mesh
        specs = model_specs(model.cfg)
        self.layout = param_layout(model.cfg)
        p_sh, z_sh = param_shardings(mesh, specs), zero1_shardings(mesh, specs)
        self.p_sh = {name: leaf_at(p_sh, name) for name, _, _ in self.layout}
        self.z_sh = {name: leaf_at(z_sh, name) for name, _, _ in self.layout}
        self.params = train_params(model)
        # the gradient norm's partial sums in the single-device step's order
        index = {p: (name, idx) for name, _, parts in self.layout for p, idx in parts}
        self.norm_order = [index[p] for p in self.params]

    def load_weights(self, params: dict) -> None:
        """Gather every leaf from its blocks into the model's parameters."""
        with torch.no_grad():
            for name, _, parts in self.layout:
                full = leaf_at(params, name).full()
                for p, idx in parts:
                    self.params[p].copy_(full[idx] if idx else full)
                del full

    @staticmethod
    def stacked(grads: Dict[str, torch.Tensor], spec, parts) -> torch.Tensor:
        """One leaf of the JAX tree from the port's per-parameter tensors."""
        if not parts[0][1]:
            return grads[parts[0][0]]
        return torch.stack([grads[p] for p, _ in parts]).reshape(spec.shape)

    def zero1_zeros(self) -> Dict[str, torch.Tensor]:
        n = self.mesh.stack_size
        return {name: torch.zeros((n,) + self.z_sh[name].shard_shape(spec.shape),
                                  dtype=torch.float32, device=self.mesh.device)
                for name, spec, _ in self.layout}

    def grad_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """√Σ g² over the ZeRO-1 gradient blocks, each element once: per
        port parameter (per leaf where ZeRO-1 split the layers), the
        partial of each distinct block folded in device order, then the
        partials summed as the single-device ``global_norm`` sums its
        leaves."""
        terms: dict = {}
        fold = self.mesh.fold_blocks
        for name, spec, parts in self.layout:
            sh, blocks = self.z_sh[name], grads[name]
            lead = len(parts[0][1])
            devs = sh.primary_devices()
            if any(entry_axes(e) for e in sh.spec[:lead]):
                terms[(name, parts[0][1])] = fold(
                    lambda b: torch.sum(torch.square(b.float())), blocks, devs)
                continue
            for _, idx in parts:
                terms[(name, idx)] = fold(
                    lambda b, idx=idx: torch.sum(torch.square(b[idx].float())), blocks, devs)
        return torch.sqrt(torch.sum(torch.stack([terms[k] for k in self.norm_order
                                                 if k in terms])))

    def write_params(self, params: dict) -> Callable:
        """``adamw_apply``'s ``write``: a parameter's blocks from its master
        blocks, gathered over the data axis on the dim ZeRO-1 added it to."""
        def write(name: str, master: torch.Tensor) -> None:
            pspec, zspec = self.p_sh[name].spec, self.z_sh[name].spec
            target = leaf_at(params, name).blocks
            for j, e in enumerate(zspec):
                if e is not None and (j >= len(pspec) or pspec[j] is None):
                    master = self.mesh.all_gather(master, e, dim=1 + j)
            target.copy_(master)
        return write

    def adamw(self, params: dict, opt_state: OptState, grads: Dict[str, torch.Tensor],
              cfg: OptConfig):
        flat = {f: {name: leaf_at(getattr(opt_state, f), name).blocks
                    for name, _, _ in self.layout} for f in ("master", "mu", "nu")}
        state = OptState(opt_state.step, flat["master"], flat["mu"], flat["nu"])
        _, new, om = adamw_apply({name: None for name, _, _ in self.layout}, grads, state, cfg,
                                 norm=self.grad_norm(grads), write=self.write_params(params))
        return OptState(new.step, opt_state.master, opt_state.mu, opt_state.nu), om


def _pack(p: LossParts) -> torch.Tensor:
    """A position's objective sums as one f32 vector, for the exchange."""
    return torch.cat([p.nll_sum.reshape(1), p.tokens.reshape(1), *p.counts, *p.p_mean]).detach()


def _unpack(v: torch.Tensor, like: LossParts) -> LossParts:
    """``_pack``'s vector as ``LossParts`` shaped as ``like`` (every
    position routes as many tokens: the rows split evenly)."""
    n, e = len(like.counts), (like.counts[0].numel() if like.counts else 0)
    layers = [v[2 + j * e:2 + (j + 1) * e] for j in range(2 * n)]
    return LossParts(v[0], v[1], like.routed, tuple(layers[:n]), tuple(layers[n:]))


def _position_grads(model: Model, plan: _MeshPlan, rows: List[Dict[str, torch.Tensor]],
                    axes, cfg: TrainConfig):
    """The forward of each held position's ``rows`` on the one working
    copy, every position's objective sums exchanged over ``axes``, then
    each held position's backward of its share: (per held position, the
    full gradient by leaf; the objective's value, the same at every
    position)."""
    mesh, params = plan.mesh, plan.params
    for p in params.values():
        p.grad = None
    parts = [model.loss_parts(r, remat=cfg.remat) for r in rows]
    every = mesh.gather_positions([_pack(p) for p in parts], axes)
    grads, total = [], None
    for j, q in enumerate(mesh.positions(axes)):
        mix = [_unpack(v, parts[j]) for v in every]
        mix[q] = parts[j]
        total, _ = loss_from_parts(mix, model.cfg)
        total.backward()
        g = {k: p.grad if p.grad is not None else torch.zeros_like(p) for k, p in params.items()}
        for p in params.values():
            p.grad = None
        grads.append({name: plan.stacked(g, spec, prts) for name, spec, prts in plan.layout})
        del g
    return grads, total.detach()


def _grads_into(model: Model, plan: _MeshPlan, batch: Dict[str, torch.Tensor], cfg: TrainConfig,
                acc: Dict[str, torch.Tensor], axes, fold: Callable) -> torch.Tensor:
    """The microbatches of ``batch``, each cut into the rows of the
    positions along ``axes`` (``_position_grads``), the positions'
    gradients folded into ``acc`` (f32, leaf name → ``fold(per-position
    full gradients, name)``) and divided by the count, as
    ``_grads_and_loss`` does; returns the loss."""
    k = cfg.microbatches
    micro = ([batch] if k <= 1 else
             [{key: v[i] for key, v in _split_micro(batch, k).items()} for i in range(k)])
    losses = []
    for mb in micro:
        split = {key: plan.mesh.split_rows(v, axes) for key, v in mb.items()}
        rows = [{key: v[j] for key, v in split.items()}
                for j in range(len(plan.mesh.positions(axes)))]
        grads, loss = _position_grads(model, plan, rows, axes, cfg)
        for name, _, _ in plan.layout:
            acc[name].add_(fold([g.pop(name) for g in grads], name))
        del grads
        losses.append(loss)
    if k <= 1:
        return losses[0]
    for g in acc.values():
        g.div_(k)
    return _fold(losses) / k


def init_mesh_state(model: Model, mesh: Mesh):
    """(params, AdamW state) on ``mesh`` from the model's parameters: the
    JAX-layout tree (``convert.stack_model_params``) cut into parameter
    blocks by ``param_shardings`` and into f32 master blocks by
    ``zero1_shardings``, zero moments beside them, step 0 on the mesh's
    device."""
    specs = model_specs(model.cfg)
    tree = stack_model_params(model.cfg, dict(model.named_parameters()))
    params = shard_state(tree, param_shardings(mesh, specs))
    master = shard_state(tree, zero1_shardings(mesh, specs), torch.float32)
    del tree

    def zeros(s: Sharded) -> Sharded:
        return Sharded(torch.zeros_like(s.blocks), s.sharding, s.shape)

    mu, nu = (tree_map(zeros, master, is_leaf=_is_sharded) for _ in range(2))
    step = torch.zeros((), dtype=torch.int32, device=mesh.device)
    return params, OptState(step, master, mu, nu)


def init_mesh_ef(model: Model, mesh: Mesh) -> dict:
    """Zero f32 error-feedback buffers in the ZeRO-1 blocks."""
    specs = model_specs(model.cfg)

    def zeros(spec, sh: NamedSharding) -> Sharded:
        return Sharded(torch.zeros((mesh.stack_size,) + sh.shard_shape(spec.shape),
                                   dtype=torch.float32, device=mesh.device), sh, spec.shape)

    return tree_map(zeros, specs, zero1_shardings(mesh, specs), is_leaf=lambda x: isinstance(x, P_))


def _is_sharded(x) -> bool:
    return isinstance(x, Sharded)


def make_train_step(model: Model, mesh: Mesh, cfg: TrainConfig):
    """The mesh step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)`` on ``init_mesh_state``'s blocks, updated in place (the
    reference's ``donate``). ``batch`` holds the global batch's tensors,
    cut into microbatches as the reference cuts them, and each microbatch
    into the rows of the positions along (pod, data) that the mesh holds.
    Sets the activation mesh, which stays set after the call, as in the
    reference."""
    set_activation_mesh(mesh)
    plan = _MeshPlan(model, mesh)
    axes = batch_axes(mesh)

    def step(params: dict, opt_state: OptState, batch: Dict[str, torch.Tensor]):
        plan.load_weights(params)
        acc = plan.zero1_zeros()
        loss = _grads_into(model, plan, batch, cfg, acc, axes,
                           lambda fulls, name: mesh.fold_scatter(fulls, plan.z_sh[name].spec, axes))
        opt_state, om = plan.adamw(params, opt_state, acc, cfg.opt)
        return params, opt_state, {"loss": loss, **om}

    return step


def make_compressed_train_step(model: Model, mesh: Mesh, cfg: TrainConfig):
    """The pod-manual mesh step ``(params, opt_state, ef, batch) -> (params,
    opt_state, ef, metrics)``: pod p computes the gradient of rows
    [p·GB/P, (p+1)·GB/P), cut into microbatches inside the pod and each
    over its data positions; the pods'
    gradients are averaged in int8 with error feedback
    (``compressed_psum_mean`` over the pod axis; each pod keeps its own
    buffer, in the ZeRO-1 blocks of its devices), and every pod takes the
    same AdamW step. The loss is the pods' mean."""
    if "pod" not in mesh.axis_names:
        raise ValueError("the compressed step needs a mesh with a pod axis")
    set_activation_mesh(mesh)
    plan = _MeshPlan(model, mesh)
    n_pod = mesh.shape["pod"]
    # the pods' tensors stacked [P, ...] on one card, or a rank's own [1, ...]
    # averaged over the rank mesh's pod axis
    pod_mesh = (Mesh((n_pod,), ("pod",), device=mesh.device)
                if mesh.stack_size == mesh.n_devices else mesh)

    data = tuple(a for a in batch_axes(mesh) if a != "pod")

    def whole(fulls, name):
        """The pod's gradient: its data positions' folded in f32."""
        every = mesh.gather_positions(fulls, data)
        return _fold([every[0].float()] + every[1:])

    def pod_body(pod: int, batch: Dict[str, torch.Tensor]):
        acc = {name: torch.zeros(spec.shape, dtype=torch.float32, device=mesh.device)
               for name, spec, _ in plan.layout}
        loss = _grads_into(model, plan, batch, cfg, acc, data, whole)
        return acc, loss

    per_pod = partial_shard_map(pod_body, mesh, {"pod"}, in_specs=(("pod",),),
                                out_specs=(("pod",), ("pod",)))

    def step(params: dict, opt_state: OptState, ef: dict, batch: Dict[str, torch.Tensor]):
        plan.load_weights(params)
        accs, losses = per_pod(batch)
        grads = {}
        for name, _, _ in plan.layout:
            zspec, e = plan.z_sh[name].spec, leaf_at(ef, name)
            x = torch.stack([a.pop(name) for a in accs])                 # [P, *leaf]
            mean, new_ef = compressed_psum_mean(
                x, mesh.gather_full(e.blocks, zspec, keep="pod"), "pod", pod_mesh)
            del x
            e.blocks.copy_(mesh.scatter_full(new_ef, zspec, keep="pod"))
            grads[name] = mesh.scatter_full(mean, zspec, keep="pod")
        if len(losses) < n_pod:             # a rank's own pod: gather the others'
            got = mesh.all_gather(losses[0].reshape(1, 1), "pod", dim=1)[0]
            losses = [got[i] for i in range(n_pod)]
        loss = _fold(losses) / n_pod
        opt_state, om = plan.adamw(params, opt_state, grads, cfg.opt)
        return params, opt_state, ef, {"loss": loss, **om}

    return step
