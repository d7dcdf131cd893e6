"""Mixture-of-Experts with adaptive sparse/dense dispatch
(``repro.models.moe``).

* ``moe_sparse`` — sort-based dispatch, the SpMSpV analogue: each batch
  row's (token, expert) assignments are sorted by expert, cut to the
  expert capacity, and the expert buffer [B, E, C, D] is filled by the
  MoE dispatch gather (kernel 7, ``kernels/ops.moe_dispatch_gather``)
  from the slot→token plan. Only k/E of the expert compute is routed;
  overflow tokens drop.
* ``moe_dense`` — every expert on every token, weighted by the top-k
  router probabilities: the SpMV analogue.

``moe_ffn`` picks between them statically from the routing density
top_k / n_experts against ``DENSE_DISPATCH_THRESHOLD``; with ``with_aux``
it also returns ``load_balance_parts``, the statistics of the Switch-style
auxiliary of the train objective (``load_balance_loss``).

The buffer is filled under autograd (``ops.moe_dispatch``): its gradient
flows back to x through the gather's transpose (kernel 7ᵀ), which sums
each token's kept slots in the plan's ``tok_slots`` order.

Where the reference scatter-adds, the port writes by a fixed order with
no atomics: the buffer by the gather's plan, the combine by summing each
token's k contributions in ascending expert order, the order of the
reference's serial scatter. Top-k takes a stable descending sort, so
among equal router probabilities the lower expert id comes first, as
``lax.top_k`` puts it.

On a mesh the reference picks its routing form from the activation mesh
(``_ep_regime``): row by row when the experts divide the model axis
(expert parallelism), natively batched otherwise. Both give each batch
row its own capacity, so the numbers are the same and ``moe_ffn`` runs
the one form on the virtual mesh, where every device shares one card.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import activation_mesh
from repro_torch.kernels import ops
from repro_torch.models.config import MoEConfig
from repro_torch.models.layers import swiglu

Tensor = torch.Tensor

# the paper's scale-free switch point: density above it → dense kernel
DENSE_DISPATCH_THRESHOLD = 0.5


def router_topk(x: Tensor, w_router: Tensor, cfg: MoEConfig) -> Tuple[Tensor, Tensor]:
    """Softmax-then-topk router. x [..., T, D] → (probs [..., T, k] fp32,
    ids int32)."""
    logits = (x @ w_router).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_ids = top_p[..., :cfg.top_k], top_ids[..., :cfg.top_k]
    top_p = top_p / torch.clamp_min(top_p.sum(dim=-1, keepdim=True), 1e-9)
    return top_p, top_ids.to(torch.int32)


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


class DispatchPlan(NamedTuple):
    """The sort stage of ``moe_sparse`` for [B, T] tokens routed top-k
    over E experts with capacity C; every [B, T·k] field is in expert
    order (stable, so token order within an expert)."""
    order: Tensor      # [B, T·k] int64: assignment index (tok·k + rank) in sorted position
    s_ids: Tensor      # [B, T·k] int32: expert
    s_tok: Tensor      # [B, T·k] int64: token within the row
    pos_in_grp: Tensor  # [B, T·k] int64: place within the expert's group
    keep: Tensor       # [B, T·k] bool: pos_in_grp < C (capacity drop)
    slot_tok: Tensor   # [B·E·C] int32: b·T + tok for each buffer slot, the pad B·T;
    #                    ascending within each group of C slots, pads at its tail
    tok_pos: Tensor    # [B, T·k] int64: each token's k sorted positions, ascending
    #                    (ascending expert id), token-major
    tok_slots: Tensor  # [B·T, k] int32: the buffer slot of each of them, the pad B·E·C
    #                    for a dropped assignment


def load_balance_parts(x: Tensor, w_router: Tensor, cfg: MoEConfig) -> Tuple[Tensor, Tensor]:
    """The two statistics of ``load_balance_loss`` over x's tokens, f32 [E]
    each: the count of tokens whose top-1 expert (the first of equal
    maxima) is each expert, which carries no gradient (the reference's
    ``bincount``, taken as a sum of one-hot rows so that its size does not
    depend on the data: no host sync, and it runs on the meta device), and
    the mean router probability. Rows split over devices exchange these
    (``balance_loss`` of the folded counts and the token-weighted means)."""
    logits = (x @ w_router).float()
    probs = torch.softmax(logits, dim=-1)
    p_mean = probs.reshape(-1, cfg.n_experts).mean(dim=0)
    top1 = probs.argmax(dim=-1).reshape(-1)
    experts = torch.arange(cfg.n_experts, device=top1.device)
    counts = (top1[:, None] == experts).sum(dim=0).float()
    return counts, p_mean


def balance_loss(counts: Tensor, p_mean: Tensor, n_experts: int) -> Tensor:
    """E·⟨f, p⟩ with f the top-1 fraction from ``counts`` and p ``p_mean``."""
    f = counts / torch.clamp_min(counts.sum(), 1.0)
    return n_experts * torch.sum(f * p_mean)


def load_balance_loss(x: Tensor, w_router: Tensor, cfg: MoEConfig) -> Tensor:
    """Switch-style auxiliary loss, f32: E·⟨f, p⟩ with f the fraction of
    tokens whose top-1 expert is each expert and p the mean router
    probability (``load_balance_parts``); 1 at uniform routing."""
    return balance_loss(*load_balance_parts(x, w_router, cfg), cfg.n_experts)


def dispatch_plan(top_ids: Tensor, n_experts: int, c: int) -> DispatchPlan:
    """Stable per-row sort by expert id, ``searchsorted`` group starts,
    the capacity cut, the slot→token map of the flat buffer [B·E·C] (slot
    (b, e, p) is b·E·C + e·C + p) and its transpose, each token's slots in
    ascending expert order; no host sync."""
    b, t, k = top_ids.shape
    dev = top_ids.device
    flat_ids = top_ids.reshape(b, t * k)
    order = torch.argsort(flat_ids, dim=1, stable=True)
    s_ids = torch.gather(flat_ids, 1, order)
    s_tok = order // k
    experts = torch.arange(n_experts, dtype=s_ids.dtype, device=dev).expand(b, n_experts)
    grp_start = torch.searchsorted(s_ids.contiguous(), experts.contiguous(), side="left")
    pos_in_grp = (torch.arange(t * k, device=dev)[None]
                  - torch.gather(grp_start, 1, s_ids.long()))
    keep = pos_in_grp < c
    rows = torch.arange(b, device=dev)[:, None]
    n_slots = b * n_experts * c
    # a dropped assignment writes to one spare slot past the end, so the
    # plan is built without a host sync on the number kept
    slot = torch.where(keep, rows * (n_experts * c) + s_ids.long() * c + pos_in_grp, n_slots)
    slot_tok = torch.full((n_slots + 1,), b * t, dtype=torch.int32, device=dev)
    slot_tok.scatter_(0, slot.reshape(-1), (rows * t + s_tok).reshape(-1).to(torch.int32))
    # each token's k sorted positions, ascending = ascending expert id
    inv = torch.argsort(order, dim=1)
    tok_pos = inv.view(b, t, k).sort(dim=2).values.reshape(b, t * k)
    tok_slots = torch.gather(slot, 1, tok_pos).reshape(b * t, k).to(torch.int32)
    return DispatchPlan(order, s_ids, s_tok, pos_in_grp, keep, slot_tok[:n_slots], tok_pos,
                        tok_slots)


def moe_sparse(x: Tensor, w_router: Tensor, w1: Tensor, w3: Tensor, w2: Tensor,
               cfg: MoEConfig) -> Tensor:
    """Sort-based dispatch. x [T, D] or [B, T, D] (each batch row routed
    with its own capacity(T)); w1/w3 [E, D, F], w2 [E, F, D]."""
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = capacity(t, cfg)
    top_p, top_ids = router_topk(x, w_router, cfg)                    # [B, T, k]
    plan = dispatch_plan(top_ids, e, c)

    # kernel 7: buf[b, e, p] = x[b, tok] for each kept assignment, else 0;
    # the hint tells it the plan's layout, so it reads each token row once;
    # its gradient is kernel 7ᵀ over tok_slots
    buf = ops.moe_dispatch(x.reshape(b * t, d), plan.slot_tok, plan.tok_slots, group=c,
                           experts=e).view(b, e, c, d)

    # expert FFN on the compact buffer (SwiGLU)
    h = F.silu(torch.einsum("becd,edf->becf", buf, w1))
    g = torch.einsum("becd,edf->becf", buf, w3)
    out = torch.einsum("becf,efd->becd", h * g, w2)

    # combine: each assignment's output row, weighted by its router prob
    rows = torch.arange(b, device=x.device)[:, None]
    safe_e = torch.where(plan.keep, plan.s_ids.long(), 0)
    safe_c = torch.where(plan.keep, plan.pos_in_grp, 0)
    s_p = torch.gather(top_p.reshape(b, t * k), 1, plan.order)
    contrib = out[rows, safe_e, safe_c] * s_p[..., None].to(out.dtype)
    contrib = torch.where(plan.keep[..., None], contrib, torch.zeros((), dtype=out.dtype,
                                                                     device=x.device))
    # each token's k contributions in ascending expert order
    per_tok = torch.gather(contrib, 1, plan.tok_pos[..., None].expand(b, t * k, d)).view(b, t, k, d)
    y = per_tok[:, :, 0]
    for j in range(1, k):
        y = y + per_tok[:, :, j]
    y = y.to(x.dtype)
    return y[0] if squeeze else y


def moe_dense(x: Tensor, w_router: Tensor, w1: Tensor, w3: Tensor, w2: Tensor,
              cfg: MoEConfig) -> Tensor:
    """All-experts dispatch: every expert on every token, weighted by the
    (top-k masked) router probabilities. x [..., T, D]."""
    top_p, top_ids = router_topk(x, w_router, cfg)
    w_tok = torch.zeros(x.shape[:-1] + (cfg.n_experts,), dtype=top_p.dtype, device=x.device)
    w_tok.scatter_(-1, top_ids.long(), top_p)
    h = F.silu(torch.einsum("...td,edf->...tef", x, w1))
    g = torch.einsum("...td,edf->...tef", x, w3)
    out = torch.einsum("...tef,efd->...ted", h * g, w2)
    return torch.einsum("...ted,...te->...td", out, w_tok.to(out.dtype)).to(x.dtype)


def uses_dense(cfg: MoEConfig) -> bool:
    density = cfg.top_k / cfg.n_experts
    return cfg.dispatch == "dense" or (cfg.dispatch == "adaptive"
                                       and density > DENSE_DISPATCH_THRESHOLD)


def _ep_regime(cfg: MoEConfig) -> bool:
    """True when the activation mesh's model axis divides the experts: the
    reference's expert-parallel regime, where each model-axis device holds
    and runs its own E / model experts."""
    mesh = activation_mesh()
    if mesh is None or "model" not in mesh.axis_names:
        return False
    return cfg.n_experts % mesh.shape["model"] == 0


def moe_ffn(x: Tensor, moe_params, cfg: MoEConfig, with_aux: bool = False):
    """Routed experts (+ shared experts, deepseek-style). x [..., D]; a 3-D
    [B, T, D] input is routed per batch row: natively batched on the
    sparse path (the reference's single-device regime), row by row on the
    dense one. ``with_aux`` returns (y, ``load_balance_parts``)."""
    fn = moe_dense if uses_dense(cfg) else moe_sparse

    def routed(xt: Tensor) -> Tensor:
        return fn(xt, moe_params["router"], moe_params["w1"], moe_params["w3"],
                  moe_params["w2"], cfg)

    if x.dim() == 3:
        y = routed(x)
    else:
        y = routed(x.reshape(-1, x.shape[-1])).reshape(x.shape)
    if cfg.n_shared:
        y = y + swiglu(x, moe_params["shared_w1"], moe_params["shared_w3"],
                       moe_params["shared_w2"])
    if with_aux:
        return y, load_balance_parts(x, moe_params["router"], cfg)
    return y
