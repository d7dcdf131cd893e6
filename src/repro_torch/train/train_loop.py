"""The single-device train step (``repro.train.train_loop``): the loss and
its gradients with remat and microbatches, then AdamW.

The reference also builds pjit and shard_map steps over a mesh; those wait
for the port's process-group mesh (ROADMAP.md §1 item 3). ``TrainConfig``
keeps ``grad_compress_pod`` for them, and ``train_step_fn`` is the step
body both wrap.

Microbatches: the global batch is split into ``microbatches`` slices run
one after another; their gradients accumulate in f32 and are divided by
the count, and the loss reported is the mean of the slices' total
objectives (NLL + 0.01·aux), as the reference reports it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.models.transformer import Model
from repro_torch.train.optimizer import OptConfig, OptState, adamw_apply, adamw_init

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    microbatches: int = 1
    remat: bool = True
    grad_compress_pod: bool = False   # int8 EF compression on the pod axis (a mesh step's)


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
