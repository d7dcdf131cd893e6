"""The port's LM slice (DeepSeek-V2-Lite: MLA + routed MoE) held to the JAX
package on the same inputs, made with numpy from fixed seeds.

Modules are compared on the reduced deepseek config in f32, with ``moe``
replaced so that the sparse dispatch runs (the reduced config keeps 8
experts with top-6, density 0.75, which takes ``moe_dense``); one case
keeps ``moe_dense``. Outputs agree within rtol 1e-4, atol 1e-5, the
repo's own f32 tolerance (``tests/test_models.py``); routing ids, slot
plans, ``keep`` and generated tokens agree exactly. The whole slice runs
3 layers (the dense one + 2 MoE) through prefill, 4 decode steps and the
serving engine, at capacity factor 4.0 and at 1.0, where tokens drop.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn, layers as jlayers, moe as jmoe
from repro.models import zoo as jzoo
from repro.models.transformer import BODY_REGISTRY, build_model as jbuild_model
from repro.serve import engine as jengine, kv_cache as jkv
from repro_torch.convert import mla_cache_from_numpy, mla_cache_to_numpy, model_params_from_numpy
from repro_torch.kernels.moe_dispatch import moe_dispatch_gather
from repro_torch.models import attention, layers, moe, zoo
from repro_torch.models.transformer import build_model
from repro_torch.serve import engine, kv_cache

ARCH = "deepseek-v2-lite-16b"
RTOL, ATOL = 1e-4, 1e-5

# the JAX side jitted: one compile per function rather than one per op
J_FLASH = jax.jit(jlayers.flash_attention, static_argnames=("causal", "kv_chunk"))
J_MLA_PREFILL = jax.jit(jattn.mla_prefill, static_argnums=2)
J_MLA_DECODE = jax.jit(jattn.mla_decode, static_argnums=2)
J_ROUTER = jax.jit(jmoe.router_topk, static_argnums=2)
J_SPARSE = jax.jit(jmoe.moe_sparse, static_argnums=5)
J_DENSE = jax.jit(jmoe.moe_dense, static_argnums=5)
J_FFN = jax.jit(jmoe.moe_ffn, static_argnums=2)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                                          np.float32),
                               np.asarray(want, np.float32), rtol=rtol, atol=atol)


def t_(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def configs(n_layers=None, **moe_kw):
    """The reduced deepseek config in both packages, with the same edits."""
    jc, pc = jzoo.reduced_config(ARCH), zoo.reduced_config(ARCH)
    if moe_kw:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **moe_kw))
        pc = dataclasses.replace(pc, moe=dataclasses.replace(pc.moe, **moe_kw))
    if n_layers:
        jc, pc = dataclasses.replace(jc, n_layers=n_layers), dataclasses.replace(pc, n_layers=n_layers)
    return jc, pc


def fresh_dense_body():
    """The reference registers its dense-layer body (``mla_mlp_dense``)
    once per process, with the ``d_ff_dense`` of the first config it
    plans; a later config of another width reuses it. Drop it, so the
    next JAX call that builds specs registers this config's width."""
    BODY_REGISTRY.pop("mla_mlp_dense", None)


# --------------------------------------------------------------- configs


def test_configs_match_the_reference():
    for jc, pc in ((jzoo.get_config(ARCH), zoo.get_config(ARCH)), configs()):
        jd, pd = dataclasses.asdict(jc), dataclasses.asdict(pc)
        jdtype, pdtype = jd.pop("dtype"), pd.pop("dtype")
        assert str(jnp.dtype(jdtype)) == str(pdtype).removeprefix("torch.")
        assert {k: v for k, v in jd.items() if k in pd} == pd
        assert all(jd[k] in (None, 0, False) for k in set(jd) - set(pd)), set(jd) - set(pd)
    with pytest.raises(KeyError, match="unknown arch"):
        zoo.get_config("no-such-arch")


def test_full_config_counts_without_allocation():
    cfg, jcfg = zoo.get_config(ARCH), jzoo.get_config(ARCH)
    fresh_dense_body()
    assert zoo.count_params(cfg) == jzoo.count_params(jcfg) == 15_706_484_224
    assert zoo.active_params(cfg) == jzoo.active_params(jcfg) == 2_661_150_208
    assert kv_cache.cache_bytes(cfg, 4, 1024) == jkv.cache_bytes(jcfg, 4, 1024) == 127_402_092
    p = kv_cache.plan(cfg, 4, 1024)
    assert p["param_bytes"] == 2 * 15_706_484_224 and p["fits"]
    assert not moe.uses_dense(cfg.moe) and moe.uses_dense(zoo.reduced_config(ARCH).moe)


def test_bf16_params_cross_bit_for_bit():
    """The JAX init in bf16 (the full config's dtype) carried over by
    ``model_params_from_numpy``: every layer's slice, bit for bit."""
    jc, pc = configs(n_layers=3)
    jc = dataclasses.replace(jc, dtype=jnp.bfloat16)
    pc = dataclasses.replace(pc, dtype=torch.bfloat16)
    fresh_dense_body()
    params = jax.tree.map(np.asarray, jbuild_model(jc).init(jax.random.PRNGKey(1)))
    m = build_model(pc, device="cpu")
    m.load_state_dict(model_params_from_numpy(pc, params, device="cpu"))
    got = m.moe_layers[1].moe.w2
    want = params["moe_layers"]["moe"]["w2"][1]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    np.testing.assert_array_equal(m.embed.float().numpy(), params["embed"].astype(np.float32))
    with pytest.raises(ValueError, match="shape"):
        model_params_from_numpy(dataclasses.replace(pc, d_model=168), params, device="cpu")


def test_init_rule_uses_the_stacked_fan_in():
    """Stacked specs draw with std scale/√n_layers of their segment, the
    unstacked lm_head with 1/√d_model (the reference's rule as written)."""
    from repro_torch.models.params import init_std
    _, pc = configs(n_layers=3)
    m = build_model(pc, device="cpu").init(torch.Generator().manual_seed(0))
    spec = m.specs
    assert init_std(spec["moe_layers"]["moe"]["w1"]) == pytest.approx(1 / np.sqrt(2))
    assert init_std(spec["dense_layers"]["mlp"]["w1"]) == 1.0
    assert init_std(spec["lm_head"]) == pytest.approx(1 / np.sqrt(pc.d_model))
    assert init_std(spec["embed"]) == 1.0
    w = torch.cat([blk.moe.w1.flatten() for blk in m.moe_layers])
    assert abs(float(w.std()) - 1 / np.sqrt(2)) < 0.02
    assert abs(float(m.dense_layers[0].mlp.w1.std()) - 1.0) < 0.02
    assert torch.equal(m.moe_layers[0].norm1, torch.ones(pc.d_model))
    assert torch.equal(m.moe_layers[0].attn.kv_norm, torch.ones(pc.mla.kv_lora_rank))


# --------------------------------------------------------------- layers


def test_rms_norm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    gamma = rng.standard_normal(16).astype(np.float32)
    close(layers.rms_norm(t_(x), t_(gamma)), jlayers.rms_norm(jnp.asarray(x), jnp.asarray(gamma)))
    pos = (5 + np.arange(7))[None]
    close(layers.rope(t_(x), t_(pos), 10000.0),
          jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))


@pytest.mark.parametrize("case", [
    dict(tq=9, tk=9),                                  # causal prefill, one chunk
    dict(tq=40, tk=40, kv_chunk=16),                   # T > kv_chunk, a padded last chunk
    dict(tq=5, tk=21, q_offset=16, kv_chunk=8),        # q_offset: the tail of a sequence
    dict(tq=1, tk=32, q_offset=11, kv_len=12, kv_chunk=8),   # decode on a partly filled cache
    dict(tq=6, tk=30, q_offset=4, kv_len=10, causal=False),  # kv_len without causal: unmasked
    dict(tq=8, tk=8, heads=(4, 2)),                    # GQA
])
def test_flash_attention(case):
    rng = np.random.default_rng(1)
    h, kh = case.pop("heads", (3, 3))
    tq, tk = case.pop("tq"), case.pop("tk")
    q = rng.standard_normal((2, tq, h, 12)).astype(np.float32)
    k = rng.standard_normal((2, tk, kh, 12)).astype(np.float32)
    v = rng.standard_normal((2, tk, kh, 12)).astype(np.float32)
    close(layers.flash_attention(t_(q), t_(k), t_(v), **case),
          J_FLASH(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **case))


def test_flash_attention_default_chunk_longer_than_one_chunk():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((1, 1100, 1, 8)).astype(np.float32)
    k = rng.standard_normal((1, 1100, 1, 8)).astype(np.float32)
    close(layers.flash_attention(t_(q), t_(k), t_(q)),
          J_FLASH(jnp.asarray(q), jnp.asarray(k), jnp.asarray(q)))


# --------------------------------------------------------------- MLA


def _numpy_params(specs: dict, rng, scale=0.3) -> dict:
    return {k: _numpy_params(v, rng, scale) if isinstance(v, dict)
            else (rng.standard_normal(v.shape) * scale).astype(np.float32)
            for k, v in specs.items()}


def _tree(f, tree):
    return {k: _tree(f, v) if isinstance(v, dict) else f(v) for k, v in tree.items()}


def test_mla_prefill_then_decode():
    jc, pc = configs()
    rng = np.random.default_rng(4)
    p = _numpy_params(attention.mla_specs(pc), rng)
    b, s, t = 2, 16, 6
    x = rng.standard_normal((b, t, pc.d_model)).astype(np.float32)
    jcache = jattn.MLACache(jnp.zeros((b, s, pc.mla.kv_lora_rank)),
                            jnp.zeros((b, s, pc.mla.rope_head_dim)), jnp.int32(0))
    pcache = attention.MLACache(torch.zeros(b, s, pc.mla.kv_lora_rank),
                                torch.zeros(b, s, pc.mla.rope_head_dim), 0)
    jp, tp = _tree(jnp.asarray, p), _tree(t_, p)
    jo, jcache = J_MLA_PREFILL(jp, jnp.asarray(x), jc, jcache)
    po, pcache = attention.mla_prefill(tp, t_(x), pc, pcache)
    close(po, jo)
    close(pcache.c_kv, jcache.c_kv)
    close(pcache.k_rope, jcache.k_rope)
    assert pcache.pos == int(jcache.pos) == t
    for step in range(3):
        xd = rng.standard_normal((b, 1, pc.d_model)).astype(np.float32)
        jo, jcache = J_MLA_DECODE(jp, jnp.asarray(xd), jc, jcache)
        po, pcache = attention.mla_decode(tp, t_(xd), pc, pcache)
        close(po, jo)
        close(pcache.c_kv, jcache.c_kv)
        assert pcache.pos == int(jcache.pos) == t + step + 1
    with pytest.raises(ValueError, match="overflow"):
        attention.mla_prefill(tp, t_(np.zeros((b, s, pc.d_model), np.float32)), pc, pcache)


# --------------------------------------------------------------- MoE


def _moe_inputs(pc, rng, b, t):
    m = pc.moe
    d, f, e = pc.d_model, m.d_ff_expert, m.n_experts
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    w = [(rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)
         for s in ((d, e), (e, d, f), (e, d, f), (e, f, d))]
    return x, w


def test_router_topk():
    jc, pc = configs(top_k=2)
    rng = np.random.default_rng(5)
    x, (wr, *_) = _moe_inputs(pc, rng, 3, 20)
    p, ids = moe.router_topk(t_(x), t_(wr), pc.moe)
    jp, jids = J_ROUTER(jnp.asarray(x), jnp.asarray(wr), jc.moe)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert ids.dtype == torch.int32
    close(p, jp)
    # ties go to the lower expert id, as lax.top_k puts them
    tie_p, tie_ids = moe.router_topk(torch.zeros(1, 4), torch.zeros(4, 8), pc.moe)
    assert tie_ids.tolist() == [[0, 1]]
    np.testing.assert_array_equal(
        np.asarray(J_ROUTER(jnp.zeros((1, 4)), jnp.zeros((4, 8)), jc.moe)[1]), [[0, 1]])


@pytest.mark.parametrize("cf", [4.0, 1.0])
def test_moe_sparse(cf, monkeypatch):
    """Batched [B, T, D] sort dispatch through kernel 7's plain version; at
    capacity factor 1.0 (capacity 16 for 64 tokens × 2 of 8 experts) tokens
    drop, and the port drops the same ones."""
    jc, pc = configs(top_k=2, capacity_factor=cf)
    rng = np.random.default_rng(6)
    b, t = 2, 64
    x, w = _moe_inputs(pc, rng, b, t)
    plans = []
    real_plan = moe.dispatch_plan
    monkeypatch.setattr(moe, "dispatch_plan", lambda *a: plans.append(real_plan(*a)) or plans[-1])
    got = moe.moe_sparse(t_(x), *map(t_, w), pc.moe)
    close(got, J_SPARSE(jnp.asarray(x), *map(jnp.asarray, w), jc.moe))
    (plan,) = plans
    assert (not plan.keep.all()) if cf == 1.0 else plan.keep.all()
    # the plan is the reference's sort stage on the JAX router's ids
    _, jids = J_ROUTER(jnp.asarray(x), jnp.asarray(w[0]), jc.moe)
    c = jmoe.capacity(t, jc.moe)
    for r in range(b):
        flat = np.asarray(jids[r]).reshape(-1)
        order = np.argsort(flat, kind="stable")
        s_ids = flat[order]
        pos = np.arange(t * 2) - np.searchsorted(s_ids, np.arange(8), side="left")[s_ids]
        np.testing.assert_array_equal(plan.order[r].numpy(), order)
        np.testing.assert_array_equal(plan.keep[r].numpy(), pos < c)
        want_slots = np.full(8 * c, t, np.int64)
        want_slots[(s_ids * c + pos)[pos < c]] = (order // 2)[pos < c]
        np.testing.assert_array_equal(
            plan.slot_tok.view(b, 8 * c)[r].numpy() - r * t,
            np.where(want_slots == t, b * t - r * t, want_slots))
    # 2-D input routes as one row
    close(moe.moe_sparse(t_(x[0]), *map(t_, w), pc.moe),
          J_SPARSE(jnp.asarray(x[0]), *map(jnp.asarray, w), jc.moe))


def test_moe_ffn_dense_and_sparse_with_shared_experts():
    rng = np.random.default_rng(7)
    for kw in ({}, {"top_k": 2}):                       # reduced as is: moe_dense; top-2: sparse
        jc, pc = configs(**kw)
        assert moe.uses_dense(pc.moe) == (not kw)
        x, (wr, w1, w3, w2) = _moe_inputs(pc, rng, 2, 10)
        fs = pc.moe.n_shared * pc.moe.d_ff_expert
        shared = [(rng.standard_normal(s) * 0.1).astype(np.float32)
                  for s in ((pc.d_model, fs), (pc.d_model, fs), (fs, pc.d_model))]
        p = dict(zip(("router", "w1", "w3", "w2", "shared_w1", "shared_w3", "shared_w2"),
                     (wr, w1, w3, w2, *shared)))
        before = moe_dispatch_gather.launches
        close(moe.moe_ffn(t_(x), _tree(t_, p), pc.moe),
              J_FFN(jnp.asarray(x), _tree(jnp.asarray, p), jc.moe))
        close(moe.moe_ffn(t_(x[0]), _tree(t_, p), pc.moe),
              J_FFN(jnp.asarray(x[0]), _tree(jnp.asarray, p), jc.moe))
        assert moe_dispatch_gather.launches == before
    close(moe.moe_dense(t_(x[0]), t_(wr), t_(w1), t_(w3), t_(w2), pc.moe),
          J_DENSE(jnp.asarray(x[0]), *map(jnp.asarray, (wr, w1, w3, w2)), jc.moe))


# --------------------------------------------------------------- bf16


def test_bf16_modules_within_bf16_rounding():
    """One bf16 check per module kind. The two frameworks round the
    products and sums of a matmul to bf16 at their own places, so the
    outputs agree to about two bf16 ulps: rtol 1.6e-2 (2·2⁻⁷), and the
    same times the output's largest magnitude as atol, for entries that
    cancel towards zero. The MoE router takes small integers, so its bf16
    logits are exact in both and the routing is identical."""
    jc, pc = configs(top_k=2)
    jc, pc = dataclasses.replace(jc, dtype=jnp.bfloat16), dataclasses.replace(pc, dtype=torch.bfloat16)
    rng = np.random.default_rng(8)

    def pair(a):
        j = jnp.asarray(a, jnp.bfloat16)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)

    def bclose(got, want):
        want = np.asarray(want.astype(jnp.float32))
        close(got, want, rtol=1.6e-2, atol=1.6e-2 * float(np.abs(want).max()))

    (jx, tx), (jg, tg) = pair(rng.standard_normal((3, 40))), pair(rng.standard_normal(40))
    got = layers.rms_norm(tx, tg)
    assert got.dtype == torch.bfloat16
    bclose(got, jlayers.rms_norm(jx, jg))

    specs = attention.mla_specs(pc)
    pp = _tree(pair, _numpy_params(specs, rng, 0.1))
    jp, tp = _tree(lambda a: a[0], pp), _tree(lambda a: a[1], pp)
    b, s = 2, 8
    c_kv, k_rope = pair(rng.standard_normal((b, s, pc.mla.kv_lora_rank)))[1], \
        pair(rng.standard_normal((b, s, pc.mla.rope_head_dim)))[1]
    jcache = jattn.MLACache(jnp.asarray(c_kv.float().numpy(), jnp.bfloat16),
                            jnp.asarray(k_rope.float().numpy(), jnp.bfloat16), jnp.int32(5))
    jxd, txd = pair(rng.standard_normal((b, 1, pc.d_model)))
    jo, jcache = J_MLA_DECODE(jp, jxd, jc, jcache)
    po, pcache = attention.mla_decode(tp, txd, pc, attention.MLACache(c_kv, k_rope, 5))
    bclose(po, jo)
    bclose(pcache.c_kv, jcache.c_kv)

    d, e, f = pc.d_model, pc.moe.n_experts, pc.moe.d_ff_expert
    jx, tx = pair(rng.integers(-1, 2, (2, 24, d)))
    jr, tr = pair(rng.integers(-1, 2, (d, e)))
    ws = [pair(rng.standard_normal(sh) / np.sqrt(sh[-2])) for sh in ((e, d, f), (e, d, f), (e, f, d))]
    got = moe.moe_sparse(tx, tr, *(w[1] for w in ws), pc.moe)
    assert got.dtype == torch.bfloat16
    bclose(got, J_SPARSE(jx, jr, *(w[0] for w in ws), jc.moe))


# --------------------------------------------------------------- whole slice


@pytest.fixture(scope="module", params=[4.0, 1.0], ids=["cf4", "cf1"])
def slice_pair(request):
    """The 3-layer reduced deepseek (dense + 2 MoE, top-2 of 8: the sparse
    path) in both packages on the same weights, drawn with numpy over the
    reference's spec tree: std 1/√(input width), so the residual stream
    stays O(1). (The reference's own init draws the dense layer with
    std 1, which leaves f32 sums of 1e5-sized terms near the 1e-5 atol.)"""
    jc, pc = configs(n_layers=3, top_k=2, capacity_factor=request.param)
    jm = jbuild_model(jc)
    fresh_dense_body()
    rng = np.random.default_rng(0)

    def draw(spec):
        if spec.init == "ones":
            return np.ones(spec.shape, np.float32)
        std = 1.0 if spec.init == "embed" else 1 / np.sqrt(spec.shape[-2])
        return (rng.standard_normal(spec.shape) * std).astype(np.float32)

    params_np = jax.tree.map(draw, jm.specs(), is_leaf=lambda s: hasattr(s, "init"))
    pm = build_model(pc, device="cpu")
    pm.load_state_dict(model_params_from_numpy(pc, params_np, device="cpu"))
    return jm, jax.tree.map(jnp.asarray, params_np), pm, request.param


def test_prefill_and_decode_match_the_reference(slice_pair, monkeypatch):
    jm, params, pm, cf = slice_pair
    jdecode = jax.jit(jm.decode)
    rng = np.random.default_rng(9)
    b, s = 2, 64
    toks = rng.integers(0, pm.cfg.vocab, (b, s)).astype(np.int32)
    plans = []
    real_plan = moe.dispatch_plan
    monkeypatch.setattr(moe, "dispatch_plan", lambda *a: plans.append(real_plan(*a)) or plans[-1])
    jcache = jm.init_cache(b, s + 8)
    pcache = pm.init_cache(b, s + 8)
    jl, jcache = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks)}, jcache)
    before = moe_dispatch_gather.launches
    pl, pcache = pm.prefill(t_(toks), pcache)
    assert moe_dispatch_gather.launches == before          # CPU tensors: the plain version
    close(pl, jl)
    dropped = sum(int((~p.keep).sum()) for p in plans)
    assert (dropped > 0) if cf == 1.0 else dropped == 0
    for name in jcache:
        c = mla_cache_to_numpy(pcache[name])
        close(c["c_kv"], jcache[name].c_kv)
        close(c["k_rope"], jcache[name].k_rope)
        np.testing.assert_array_equal(c["pos"], np.asarray(jcache[name].pos))
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    assert np.array_equal(tok[:, 0], pl.argmax(-1).numpy())
    first = tok
    for _ in range(4):
        jl, jcache = jdecode(params, jnp.asarray(tok), jcache)
        pl, pcache = pm.decode(t_(tok), pcache)
        close(pl, jl)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        assert np.array_equal(tok[:, 0], pl.argmax(-1).numpy())

    # a cache carried across from JAX decodes as the port's own does
    ccache = {name: mla_cache_from_numpy(np.asarray(c.c_kv), np.asarray(c.k_rope),
                                         np.asarray(c.pos), torch.float32, device="cpu")
              for name, c in jcache.items()}
    jl, _ = jdecode(params, jnp.asarray(tok), jcache)
    close(pm.decode(t_(tok), ccache)[0], jl)

    # decode after prefill == forward at position S on the same stream
    if cf == 4.0:
        cache = pm.init_cache(b, s + 1)
        _, cache = pm.prefill(t_(toks), cache)
        dl, _ = pm.decode(t_(first), cache)
        full = pm.forward(t_(np.concatenate([toks, first], 1)))
        close(dl, full[:, s])
        close(full, jax.jit(jm.forward)(params, {"tokens": jnp.asarray(np.concatenate([toks, first], 1))}))


def test_serving_engine_generates_the_reference_tokens(slice_pair):
    jm, params, pm, cf = slice_pair
    rng = np.random.default_rng(10)
    lens, budgets = (5, 23, 40), (6, 3, 6)

    def requests(mod):
        return [mod.Request(prompt=rng2.integers(0, pm.cfg.vocab, n).tolist(), max_new_tokens=m)
                for n, m in zip(lens, budgets)]

    rng2 = np.random.default_rng(10)
    want = jengine.ServingEngine(jm, params, max_seq=64).run(requests(jengine))
    rng2 = np.random.default_rng(10)
    got = engine.ServingEngine(pm, max_seq=64, device="cpu").run(requests(engine))
    for g, w, m in zip(got, want, budgets):
        assert g.prompt == w.prompt
        assert g.generated == w.generated
        assert len(g.generated) == m
    # an EOS stops a request early, as in the reference
    eos = want[0].generated[1]
    rng2 = np.random.default_rng(10)
    want = jengine.ServingEngine(jm, params, max_seq=64, eos_id=eos).run(requests(jengine))
    rng2 = np.random.default_rng(10)
    got = engine.ServingEngine(pm, max_seq=64, eos_id=eos, device="cpu").run(requests(engine))
    assert [g.generated for g in got] == [w.generated for w in want]
    del rng
