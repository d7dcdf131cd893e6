"""int8 error-feedback gradient compression for the pod axis
(``repro.train.grad_compress``).

Multi-pod training reduces gradients over two fabrics, the fast one
inside a pod and a slower one between pods, so the pod-axis reduction
dominates a multi-pod step; sending it as int8 instead of bf16 halves the
dominant collective's bytes.

Scheme (1-bit-Adam-style error feedback, at 8 bits):
  x      = g + e          (carry quantization error across steps)
  q, s   = quantize(x)    (per-tensor symmetric int8, scale s = absmax/127)
  e'     = x - dequant(q) (error feedback)
  wire   = all_gather(q: int8) + all_gather(s)   over the pod axis
  result = mean_i dequant(q_i)

``compressed_psum_mean`` runs over an axis of ``core/mesh.py``'s mesh:
x and e are [D, ...] stacks, each device quantises its own tensor, the
codes cross the axis as an int8 ``Mesh.all_gather`` and the scales as
f32, and each device sums the dequantised terms in position order before
dividing by n, as the reference's ``jnp.sum(deq, axis=0) / n``. On a
``core/rank_mesh.py`` mesh the stacks are a rank's own, [1, ...], and
the codes and scales cross the axis between ranks: int8 and f32 bytes on
the wire. The
``stacked`` pair is the reference's fallback for old jax: a [P, ...] stack
against one shared error-feedback buffer, with no mesh.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

Tensor = torch.Tensor


def quantize_int8(x: Tensor) -> Tuple[Tensor, Tensor]:
    """(int8 codes, the f32 0-d scale): symmetric, scale = max|x| / 127
    (at least 1e-12), codes round half to even and clip to ±127."""
    xf = x.float()
    scale = torch.clamp_min(torch.max(torch.abs(xf)) / 127.0, 1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: Tensor, scale: Tensor) -> Tensor:
    return q.float() * scale


def _quantize_rows(x: Tensor) -> Tuple[Tensor, Tensor]:
    """``quantize_int8`` of each x[i] of a stack: codes [n, ...], scales [n]."""
    flat = x.reshape(x.shape[0], -1)
    scale = torch.clamp_min(torch.amax(torch.abs(flat), dim=1) / 127.0, 1e-12)
    s = scale.view((-1,) + (1,) * (x.dim() - 1))
    q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_rows(q: Tensor, scale: Tensor) -> Tensor:
    return q.float() * scale.view((-1,) + (1,) * (q.dim() - 1))


def ef_init(params) -> Any:
    """Zero error-feedback buffers shaped like the parameters (f32): a
    dict of tensors, nested as ``params``."""
    if isinstance(params, dict):
        return {k: ef_init(v) for k, v in params.items()}
    return torch.zeros(tuple(params.shape), dtype=torch.float32, device=params.device)


def compressed_psum_mean(x: Tensor, ef: Tensor, axis_name, mesh) -> Tuple[Tensor, Tensor]:
    """Error-feedback int8 mean over ``axis_name`` of ``mesh``. x, ef:
    [D, ...] stacks (each device's tensor). Returns (the mean, f32, [D, ...];
    each device's new error-feedback buffer)."""
    carry = x.float() + ef
    q, scale = _quantize_rows(carry)
    new_ef = carry - _dequantize_rows(q, scale)
    n = mesh.axis_size(axis_name)
    qg = mesh.all_gather(q[:, None], axis_name, dim=1)            # [D, n, ...] int8 on the wire
    sg = mesh.all_gather(scale[:, None], axis_name, dim=1)        # [D, n]
    bshape = (x.shape[0],) + (1,) * (x.dim() - 1)
    total = qg[:, 0].float() * sg[:, 0].view(bshape)
    for j in range(1, n):
        total = total + qg[:, j].float() * sg[:, j].view(bshape)
    return total / n, new_ef


def compressed_tree_psum_mean(grads: dict, ef_tree: dict, axis_name, mesh):
    """Leaf-wise ``compressed_psum_mean`` of a dict of stacks: (means, new
    error-feedback buffers), each nested as ``grads``."""
    means, efs = {}, {}
    for k, g in grads.items():
        if isinstance(g, dict):
            means[k], efs[k] = compressed_tree_psum_mean(g, ef_tree[k], axis_name, mesh)
        else:
            means[k], efs[k] = compressed_psum_mean(g, ef_tree[k], axis_name, mesh)
    return means, efs


def compressed_stacked_mean(g_stack: Tensor, ef: Tensor) -> Tuple[Tensor, Tensor]:
    """Pod-stacked ([P, ...]) counterpart of ``compressed_psum_mean``:
    per-pod int8 quantization against one shared error-feedback buffer,
    the mean over the leading pod axis; (mean, new shared buffer)."""
    carry = g_stack.float() + ef[None]
    q, scale = _quantize_rows(carry)
    deq = _dequantize_rows(q, scale)
    return torch.mean(deq, dim=0), torch.mean(carry - deq, dim=0)


def compressed_tree_stacked_mean(grads_stack: dict, ef_tree: dict):
    """Leaf-wise ``compressed_stacked_mean`` over a dict of pod stacks."""
    means, efs = {}, {}
    for k, g in grads_stack.items():
        if isinstance(g, dict):
            means[k], efs[k] = compressed_tree_stacked_mean(g, ef_tree[k])
        else:
            means[k], efs[k] = compressed_stacked_mean(g, ef_tree[k])
    return means, efs
