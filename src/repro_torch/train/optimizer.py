"""AdamW with f32 master weights, global-norm clipping and a cosine
schedule (``repro.train.optimizer``), on one device.

``OptState`` keys its f32 ``master``, ``mu`` and ``nu`` by parameter
name (``Model.named_parameters()``), on the parameters' device; ``step``
is a 0-d int32 tensor there, and the schedule's scalars are computed from
it in f32 on the device, as the reference computes them, so a step needs
no host sync. ``adamw_apply`` updates master, mu and nu in place and
writes ``master`` rounded to each parameter's dtype into the parameter's
own storage, one leaf at a time, so no temporary covers more than one
leaf: at full width the state is 12 bytes a parameter beside the weights
and their gradients.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple

import torch

Tensor = torch.Tensor


class OptState(NamedTuple):
    step: Tensor                 # 0-d int32
    master: Dict[str, Tensor]    # f32 master copy of each parameter
    mu: Dict[str, Tensor]        # first moment, f32
    nu: Dict[str, Tensor]        # second moment, f32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def adamw_init(params: Dict[str, Tensor]) -> OptState:
    """f32 master copies (new storage, also for f32 parameters) and zero
    moments on each parameter's device; step 0."""
    with torch.no_grad():
        master = {k: p.detach().to(torch.float32, copy=True) for k, p in params.items()}
    dev = next(iter(params.values())).device if params else torch.device("cpu")
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        master=master,
        mu={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()},
        nu={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()},
    )


def cosine_lr(step: Tensor, cfg: OptConfig) -> Tensor:
    """Linear warmup to ``lr``, then a cosine down to ``min_lr_frac``·lr
    at ``total_steps``; f32, on step's device."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def global_norm(tree: Dict[str, Tensor]) -> Tensor:
    """√(Σ over leaves of Σ g²), each leaf summed in f32."""
    leaves = [torch.sum(torch.square(g.float())) for g in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(norm: Tensor, max_norm: float) -> Tensor:
    return torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)


def clip_by_global_norm(tree: Dict[str, Tensor], max_norm: float):
    """(the leaves scaled to a global norm of at most ``max_norm``, in f32;
    the norm before clipping)."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return {k: g.float() * scale for k, g in tree.items()}, norm


def adamw_apply(params: Dict[str, Tensor], grads: Dict[str, Tensor], state: OptState,
                cfg: OptConfig, *, norm: Tensor | None = None, write=None):
    """One AdamW step on clipped gradients. master, mu and nu are updated in
    place and each parameter takes ``master`` in its own dtype, in its own
    storage. Returns (params, the new state, {"lr", "grad_norm"}). Each
    leaf is clipped as it is updated, so no f32 copy of every gradient
    exists at once. The update is elementwise, so a mesh step runs it on
    its per-device blocks: it passes the gradient's ``norm`` (each element
    counted once) and ``write(name, master)``, which rewrites the
    parameter ``name`` from its updated master blocks."""
    norm = global_norm(grads) if norm is None else norm
    scale = _clip_scale(norm, cfg.clip_norm)
    step = state.step + 1
    lr = cosine_lr(step, cfg)
    s = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=s.device), s)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=s.device), s)
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k].float() * scale
            m, mu, nu = state.master[k], state.mu[k], state.nu[k]
            mu.mul_(cfg.b1).add_(g * (1 - cfg.b1))
            nu.mul_(cfg.b2).add_(torch.square(g).mul_(1 - cfg.b2))
            upd = (mu / b1c).div_(torch.sqrt(nu / b2c).add_(cfg.eps)).add_(m * cfg.weight_decay)
            m.sub_(upd.mul_(lr))
            if write is None:
                p.copy_(m)
            else:
                write(k, m)
    return params, OptState(step, state.master, state.mu, state.nu), {"lr": lr, "grad_norm": norm}
