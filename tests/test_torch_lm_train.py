"""The port's train mode held to the JAX package: ``Model.loss`` (total,
NLL, load-balance aux) and the gradient of every parameter leaf against
``jax.value_and_grad(model.loss)``, one reduced config of each family on
the same numpy weights and batch, in f32.

The weights are drawn over the reference's spec tree with every
zero-initialised leaf at random, so its path carries a gradient: dense,
audio, moe and vlm leaves as ``test_torch_lm_families.py`` draws them,
xLSTM and zamba2 with ``test_torch_lm_ssm.py``'s draws. DeepSeek runs
top-2 of its 8 experts, so ``moe_sparse`` and the dispatch gather's
autograd node run, once at the reduced capacity factor 4.0 and once at
0.5, where tokens drop. The port's gradients are stacked back into the
JAX tree by ``model_params_to_numpy``. The loss agrees within rtol 1e-5;
each gradient leaf within rtol 1e-3 and atol 1e-5·max|g| of the leaf
(the f32 backward sums in another order than XLA's). Remat changes no
bit. Kernel 7ᵀ's plain version is held to a numpy loop.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models import zoo as jzoo
from repro.models.config import MoEConfig as JMoEConfig
from repro.models.transformer import BODY_REGISTRY, build_model as jbuild_model
from repro_torch.convert import model_params_from_numpy, model_params_to_numpy
from repro_torch.kernels import ops, ref
from repro_torch.models import moe, zoo
from repro_torch.models.config import MoEConfig
from repro_torch.models.transformer import build_model
from repro_torch.train.train_loop import train_params
from test_torch_lm_ssm import _draw as _draw_ssm, _edit

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-5      # atol relative to the leaf's max |g|
B, T = 2, 32

CASES = {
    "deepseek-top2": ("deepseek-v2-lite-16b", {"moe": {"top_k": 2}}),
    "deepseek-top2-drop": ("deepseek-v2-lite-16b", {"moe": {"top_k": 2, "capacity_factor": 0.5}}),
    "minitron": ("minitron-4b", {}),
    "hubert": ("hubert-xlarge", {}),
    "llama-vision": ("llama-3.2-vision-11b", {}),
    "xlstm": ("xlstm-1.3b", {}),
    "zamba2": ("zamba2-1.2b", {}),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's tests, restored after: small
    models make many small ops, and with the suite's other workers on the
    same cores torch's pool spends most of its time waiting (see
    ``tests/test_torch_train.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw_general(rng, encoder_only: bool):
    """Matrices at std 1/√(input width), token embeddings at std 1 (an
    encoder's, its output head, as a matrix of width d_model), norms ones,
    the zero-initialised leaves (qkv biases, the cross-attention gate) at
    0.3·N so their gradients are not trivially zero."""
    def draw(path, spec):
        if spec.init == "ones":
            return np.ones(spec.shape, np.float32)
        if spec.init == "zeros":
            return (rng.standard_normal(spec.shape) * 0.3).astype(np.float32)
        if spec.init == "embed":
            std = 1 / np.sqrt(spec.shape[-1]) if encoder_only else 1.0
        else:
            std = 1 / np.sqrt(spec.shape[-2])
        return (rng.standard_normal(spec.shape) * std).astype(np.float32)
    return draw


def _batch(cfg, rng):
    out = {"labels": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)}
    if cfg.frontend == "frames":
        out["frames"] = rng.standard_normal((B, T, cfg.frontend_dim)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    if cfg.family == "vlm":
        out["image_embeds"] = rng.standard_normal(
            (B, cfg.vlm.vision_tokens, cfg.vlm.vision_dim)).astype(np.float32)
    return out


def _make(name):
    arch, edits = CASES[name]
    jc = _edit(jzoo.reduced_config(arch), edits)
    pc = _edit(zoo.reduced_config(arch), edits)
    BODY_REGISTRY.pop("mla_mlp_dense", None)     # the reference registers it once per width
    jm = jbuild_model(jc)
    rng = np.random.default_rng(0)
    draw = (_draw_ssm(rng, pc.n_layers) if pc.family in ("ssm", "hybrid")
            else _draw_general(rng, pc.encoder_only))
    params_np = jax.tree_util.tree_map_with_path(draw, jm.specs(),
                                                 is_leaf=lambda s: hasattr(s, "init"))
    pm = build_model(pc, device="cpu")
    pm.load_state_dict(model_params_from_numpy(pc, params_np, device="cpu"))
    return jm, params_np, pm, _batch(pc, np.random.default_rng(1))


def _port_loss_and_grads(pm, batch_np, remat=False):
    params = train_params(pm)
    for p in params.values():
        p.grad = None
    total, aux = pm.loss({k: torch.from_numpy(v) for k, v in batch_np.items()}, remat=remat)
    total.backward()
    grads = {k: p.grad for k, p in params.items()}
    for p in params.values():
        p.grad = None
    return total.detach(), {k: v.detach() for k, v in aux.items()}, grads


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """Both packages on the same weights and batch; the reference's loss,
    aux and gradients (jitted once), the port's without remat."""
    jm, params_np, pm, batch_np = _make(request.param)
    vg = jax.jit(jax.value_and_grad(lambda p, b: jm.loss(p, b), has_aux=True))
    (jtotal, jaux), jgrads = vg(jax.tree.map(jnp.asarray, params_np),
                                {k: jnp.asarray(v) for k, v in batch_np.items()})
    plans = []
    real_plan = moe.dispatch_plan

    def record(*a, **kw):
        plans.append(real_plan(*a, **kw))
        return plans[-1]

    moe.dispatch_plan = record
    try:
        total, aux, grads = _port_loss_and_grads(pm, batch_np)
    finally:
        moe.dispatch_plan = real_plan
    return dict(name=request.param, pm=pm, batch=batch_np, plans=plans,
                want=(float(jtotal), {k: float(v) for k, v in jaux.items()},
                      jax.tree.map(np.asarray, jgrads)),
                got=(total, aux, grads))


def test_loss_matches_the_reference(case):
    jtotal, jaux, _ = case["want"]
    total, aux, _ = case["got"]
    np.testing.assert_allclose(float(total), jtotal, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux["loss"]), jaux["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux["moe_aux"]), jaux["moe_aux"], rtol=LOSS_RTOL)
    assert float(aux["tokens"]) == jaux["tokens"] == B * T
    is_moe = case["pm"].cfg.family == "moe"
    assert (jaux["moe_aux"] > 0) == is_moe
    if is_moe:      # the sparse dispatch ran, with drops exactly where the capacity is cut
        assert case["plans"] and not moe.uses_dense(case["pm"].cfg.moe)
        dropped = any(not bool(p.keep.all()) for p in case["plans"])
        assert dropped == case["name"].endswith("drop")


def test_every_gradient_leaf_matches_the_reference(case):
    pm = case["pm"]
    _, _, jgrads = case["want"]
    got = model_params_to_numpy(pm.cfg, case["got"][2])
    flat_want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_want) == len(flat_got)
    for path, want in flat_want:
        g = flat_got[path]
        scale = float(np.abs(want).max())
        assert scale > 0, path                         # every leaf's path carries a gradient
        np.testing.assert_allclose(g, want, rtol=GRAD_RTOL, atol=GRAD_ATOL * scale,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", ["deepseek-top2-drop", "xlstm"])
def test_remat_changes_no_bit(name):
    _, _, pm, batch_np = _make(name)
    t0, a0, g0 = _port_loss_and_grads(pm, batch_np, remat=False)
    t1, a1, g1 = _port_loss_and_grads(pm, batch_np, remat=True)
    assert torch.equal(t0, t1) and all(torch.equal(a0[k], a1[k]) for k in a0)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)


def test_buffer_is_the_dispatch_node_and_its_gradient_is_the_transpose(monkeypatch):
    """``moe_sparse``'s expert buffer comes out of the dispatch Function
    (on the CPU too), and x's gradient through it equals the gradient of
    the plain gather under autograd."""
    cfg = MoEConfig(n_experts=8, top_k=2, d_ff_expert=16, capacity_factor=0.5)
    rng = np.random.default_rng(3)
    d = 24
    w = {k: torch.from_numpy((rng.standard_normal(s) * 0.3).astype(np.float32)) for k, s in
         (("router", (d, 8)), ("w1", (8, d, 16)), ("w3", (8, d, 16)), ("w2", (8, 16, d)))}
    x0 = torch.from_numpy(rng.standard_normal((3, 40, d)).astype(np.float32))
    bufs, real = [], ops.moe_dispatch

    def spy(*a, **kw):
        bufs.append(real(*a, **kw))
        return bufs[-1]

    monkeypatch.setattr(ops, "moe_dispatch", spy)
    x = x0.clone().requires_grad_(True)
    moe.moe_sparse(x, w["router"], w["w1"], w["w3"], w["w2"], cfg).square().sum().backward()
    assert len(bufs) == 1 and type(bufs[0].grad_fn).__name__ == "MoEDispatchBackward"

    def plain(xf, slot_tok, tok_slots, **hint):
        return ref.moe_dispatch_gather_ref(xf, slot_tok)     # differentiable by autograd

    monkeypatch.setattr(ops, "moe_dispatch", plain)
    x_plain = x0.clone().requires_grad_(True)
    moe.moe_sparse(x_plain, w["router"], w["w1"], w["w3"], w["w2"], cfg).square().sum().backward()
    assert torch.equal(x.grad, x_plain.grad)


def test_tok_slots_transpose_the_plan():
    """Each token's slots in ascending expert order, the pad S in the place
    of a dropped assignment: exactly the slots whose slot_tok names the
    token."""
    rng = np.random.default_rng(5)
    b, t, e, k, c = 3, 30, 8, 3, 8
    ids = np.argsort(rng.random((b, t, e)), axis=-1)[..., :k].astype(np.int32)
    plan = moe.dispatch_plan(torch.from_numpy(ids), e, c)
    s = b * e * c
    assert plan.tok_slots.dtype == torch.int32 and tuple(plan.tok_slots.shape) == (b * t, k)
    slot_tok = plan.slot_tok.numpy()
    dropped = 0
    for r, slots in enumerate(plan.tok_slots.numpy()):
        kept = slots[slots < s]
        dropped += int((slots == s).sum())
        assert np.all(np.diff(kept) > 0)
        assert sorted(kept.tolist()) == np.flatnonzero(slot_tok == r).tolist()
        assert set(((kept % (e * c)) // c).tolist()) <= set(ids[r // t, r % t].tolist())
        assert np.all(kept // (e * c) == r // t)
    assert dropped == int((~plan.keep).sum())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_plain_version_matches_a_numpy_loop(dtype):
    """Kernel 7ᵀ's plain version: per token, its kept slots' rows summed in
    f32 in ascending j and rounded once; pads (S) and a token with every
    assignment dropped give zeros."""
    rng = np.random.default_rng(11)
    t, k, s, d = 20, 3, 64, 16
    slots = np.full((t, k), s, np.int32)
    free = iter(rng.permutation(s).tolist())
    for r in range(t - 1):                        # the last token keeps nothing
        for j in range(k):
            if rng.random() < 0.7:                # else a pad in the place of a drop
                slots[r, j] = next(free)
    grad = torch.from_numpy(rng.standard_normal((s, d)).astype(np.float32)).to(dtype)
    got = ref.moe_dispatch_gather_backward_ref(grad, torch.from_numpy(slots))
    g32 = grad.float().numpy()
    want = np.zeros((t, d), np.float32)
    for r in range(t):
        for j in range(k):
            if slots[r, j] < s:
                want[r] = want[r] + g32[slots[r, j]]
    assert got.dtype == dtype
    assert torch.equal(got, torch.from_numpy(want).to(dtype))
    assert not got[-1].any()
    got_wrapper = ops.moe_dispatch_gather_backward(grad, torch.from_numpy(slots))
    assert torch.equal(got_wrapper, got)


def test_load_balance_loss_matches_the_reference_with_ties():
    """Equal router probabilities (a zero router): the top-1 is the first
    expert in both packages, so f = e₀ and the loss is E·(1/E) = 1."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 10, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 8)) * 0.5).astype(np.float32)
    pcfg = MoEConfig(n_experts=8, top_k=2, d_ff_expert=8)
    jcfg = JMoEConfig(n_experts=8, top_k=2, d_ff_expert=8)
    for wr in (w, np.zeros_like(w)):
        got = moe.load_balance_loss(torch.from_numpy(x), torch.from_numpy(wr), pcfg)
        want = jmoe.load_balance_loss(jnp.asarray(x), jnp.asarray(wr), jcfg)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(got) == pytest.approx(1.0)


def test_forward_with_aux_matches_forward_and_serving_stays_without_grad():
    _, _, pm, batch_np = _make("deepseek-top2")
    tokens = torch.from_numpy(batch_np["tokens"])
    train_params(pm)
    logits, aux = pm.forward_with_aux(tokens)
    assert logits.requires_grad and aux.requires_grad and aux.dtype == torch.float32
    served = pm.forward(tokens)
    assert not served.requires_grad
    assert torch.equal(served, logits.detach())
    cfg = dataclasses.replace(pm.cfg, n_layers=1)   # the dense layer alone: no aux
    pd = build_model(cfg, device="cpu").init(seed=0)
    assert float(pd.forward_with_aux(tokens)[1]) == 0.0
