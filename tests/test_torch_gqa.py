"""The port's GQA layer stack held to the JAX package on the same inputs,
made with numpy from fixed seeds: ``flash_attention`` with a window, key
offsets, ring positions and int8 scales; ``quantize_kv`` (codes exact);
both cache updates on a linear cache and on the ring at t < w, t = w,
t > w and across the wrap; ``ring_slot_positions``; ``decode_attention``;
the GQA prefill/decode on every cache with an explicit head_dim and with
a qkv bias; the gated cross-attention with a random gate.

Floats agree within rtol 1e-4, atol 1e-5 (the repo's f32 tolerance, as in
``test_torch_lm.py``); int8 codes, slot positions and ``pos`` exactly.
The configs are the reduced mixtral (window 32) and mistral-nemo, with the
edits the reduced config drops (an explicit head_dim, ``kv_quant``)
set back in both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn, layers as jlayers
from repro.models import zoo as jzoo
from repro_torch.convert import gqa_cache_from_numpy, gqa_cache_to_numpy
from repro_torch.models import attention, layers, zoo

RTOL, ATOL = 1e-4, 1e-5
W = 32                                            # the reduced mixtral's window

J_FLASH = jax.jit(jlayers.flash_attention,
                  static_argnames=("causal", "window", "kv_chunk"))
J_QUANT = jax.jit(jlayers.quantize_kv)
J_RING = jax.jit(jlayers.ring_slot_positions, static_argnums=1)
J_DECODE_ATTN = jax.jit(jlayers.decode_attention, static_argnames=("window",))
J_CACHE_UPDATE = jax.jit(jlayers.cache_update, static_argnames=("window",))
J_QUANT_UPDATE = jax.jit(jlayers.quant_cache_update, static_argnames=("window",))
J_GQA_FORWARD = jax.jit(jattn.gqa_forward, static_argnums=2, static_argnames=("causal",))
J_GQA_PREFILL = jax.jit(jattn.gqa_prefill, static_argnums=2)
J_GQA_DECODE = jax.jit(jattn.gqa_decode, static_argnums=2)
J_CROSS = jax.jit(jattn.cross_attn, static_argnums=3)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                                          np.float32),
                               np.asarray(want, np.float32), rtol=rtol, atol=atol)


def t_(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def configs(arch="mixtral-8x22b", **kw):
    """The reduced config of ``arch`` in both packages, with the same edits."""
    jc, pc = jzoo.reduced_config(arch), zoo.reduced_config(arch)
    return dataclasses.replace(jc, **kw), dataclasses.replace(pc, **kw)


def _tree(f, tree):
    return {k: _tree(f, v) if isinstance(v, dict) else f(v) for k, v in tree.items()}


def _numpy_params(specs: dict, rng) -> dict:
    """Every leaf drawn at random, matrices with std 1/√(input width), the
    zero-initialised biases and gate with std 0.3, so their paths are
    exercised."""
    return {k: _numpy_params(v, rng) if isinstance(v, dict)
            else (rng.standard_normal(v.shape)
                  * (v.shape[-2] ** -0.5 if len(v.shape) > 1 else 0.3)).astype(np.float32)
            for k, v in specs.items()}


# --------------------------------------------------------------- attention


@pytest.mark.parametrize("case", [
    dict(tq=40, tk=40, window=8, kv_chunk=16),               # causal SWA prefill, padded chunk
    dict(tq=5, tk=21, q_offset=16, window=6, kv_chunk=8),    # window on a sequence's tail
    dict(tq=6, tk=12, q_offset=10, k_offset=4, kv_chunk=8),  # keys that start at an offset
    dict(tq=7, tk=7, window=3, causal=False),                # a window without the causal mask
    dict(tq=12, tk=30, causal=False, kv_chunk=16),           # non-causal: the zero pad keys count
])
def test_flash_attention_window_and_offsets(case):
    rng = np.random.default_rng(1)
    tq, tk = case.pop("tq"), case.pop("tk")
    q = rng.standard_normal((2, tq, 4, 12)).astype(np.float32)
    k = rng.standard_normal((2, tk, 2, 12)).astype(np.float32)
    v = rng.standard_normal((2, tk, 2, 12)).astype(np.float32)
    close(layers.flash_attention(t_(q), t_(k), t_(v), **case),
          J_FLASH(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **case))


@pytest.mark.parametrize("pos", [5, 32, 45, 77])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_flash_attention_ring_positions_and_scales(pos, quant):
    """One query over a ring of W slots, the key positions those of
    ``ring_slot_positions`` (invalid slots 2**30), K/V int8 with per-token
    scales or float: the mask, the pads and the per-chunk dequantisation."""
    rng = np.random.default_rng(pos)
    q = rng.standard_normal((2, 1, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, W, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, W, 2, 8)).astype(np.float32)
    k_pos = np.asarray(J_RING(jnp.int32(pos), W))
    kw = dict(causal=True, window=W, q_offset=pos - 1, kv_chunk=12)
    jkw, pkw = dict(kw), dict(kw)
    if quant:
        kq, ks = J_QUANT(jnp.asarray(k))
        vq, vs = J_QUANT(jnp.asarray(v))
        k, v = np.asarray(kq), np.asarray(vq)
        jkw.update(k_scale=ks, v_scale=vs)
        pkw.update(k_scale=t_(ks), v_scale=t_(vs))
    got = layers.flash_attention(t_(q), t_(k), t_(v), k_positions=t_(k_pos), **pkw)
    want = J_FLASH(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   k_positions=jnp.asarray(k_pos), **jkw)
    close(got, want)


def test_quantize_kv_codes_exact():
    """Codes equal bit for bit, scales to the last bit, on gaussians, on
    values at the rounding edges (k + 0.5 times a scale) and on an all-zero
    token (scale 1e-12)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 17, 4, 16)).astype(np.float32) * 3
    edges = (np.arange(-127, 127) + 0.5).astype(np.float32)
    x[0, 0] = np.resize(edges / 127, (4, 16)) * 2.5
    x[0, 0, 0, 0] = 2.5
    x[1, 3] = 0.0
    q, s = layers.quantize_kv(t_(x))
    jq, js = J_QUANT(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and tuple(s.shape) == (3, 17)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert int(q.abs().max()) == 127


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_ring_slots_match_ring_slot_positions_through_a_wrap(quant):
    """Ring writes one token at a time from position 0 past two wraps:
    after every write the cache equals JAX's, and each slot holds the token
    ``ring_slot_positions`` names (the token's value is its position)."""
    b, kh, d = 1, 1, 2
    pcache = _port_cache(quant, b, W, kh, d)
    jcache = _jax_cache(quant, b, W, kh, d)
    upd, jupd = ((layers.quant_cache_update, J_QUANT_UPDATE) if quant
                 else (layers.cache_update, J_CACHE_UPDATE))
    for p in range(2 * W + 7):
        tok = np.full((b, 1, kh, d), p + 1, np.float32)
        pcache = upd(pcache, t_(tok), t_(tok), window=W)
        jcache = jupd(jcache, jnp.asarray(tok), jnp.asarray(tok), window=W)
        _same_cache(pcache, jcache)
        slots = layers.ring_slot_positions(pcache.pos, W)
        np.testing.assert_array_equal(slots.numpy(), np.asarray(J_RING(jnp.int32(pcache.pos), W)))
        held = _dequant(pcache)[0, :, 0, 0]
        valid = slots < 2**30
        np.testing.assert_allclose(held[valid].numpy(), slots[valid].numpy() + 1.0, rtol=1e-2)


@pytest.mark.parametrize("pos", [0, 1, 5, 31, 32, 33, 40, 64, 95, 1000])
def test_ring_slot_positions(pos):
    got = layers.ring_slot_positions(pos, W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(J_RING(jnp.int32(pos), W)))


def _port_cache(quant, b, s, kh, d):
    if quant:
        return layers.QuantKVCache(torch.zeros(b, s, kh, d, dtype=torch.int8),
                                   torch.zeros(b, s, kh, d, dtype=torch.int8),
                                   torch.zeros(b, s), torch.zeros(b, s), 0)
    return layers.KVCache(torch.zeros(b, s, kh, d), torch.zeros(b, s, kh, d), 0)


def _jax_cache(quant, b, s, kh, d):
    if quant:
        return jlayers.QuantKVCache(jnp.zeros((b, s, kh, d), jnp.int8),
                                    jnp.zeros((b, s, kh, d), jnp.int8),
                                    jnp.zeros((b, s)), jnp.zeros((b, s)), jnp.int32(0))
    return jlayers.KVCache(jnp.zeros((b, s, kh, d)), jnp.zeros((b, s, kh, d)), jnp.int32(0))


def _dequant(c):
    if isinstance(c, layers.QuantKVCache):
        return c.k.float() * c.k_scale[..., None, None]
    return c.k


def _same_cache(pcache, jcache, projected=False):
    """k/v, scales and pos of one layer's cache. On the same float inputs
    the int8 codes are equal exactly. When each package projected its own
    k/v (``projected``), the floats differ in their last bits, and a code
    whose value sits at a rounding edge may land one step away: codes then
    differ by at most 1, in at most 0.1% of the entries (that each package
    quantises its own input exactly as the other would is
    ``test_quantize_kv_codes_exact`` and the spy of ``_spy_quantize``)."""
    got = gqa_cache_to_numpy([pcache])
    assert int(got["pos"][0]) == int(jcache.pos)
    if isinstance(pcache, layers.QuantKVCache):
        for f in ("k", "v"):
            want = np.asarray(getattr(jcache, f))
            if projected:
                diff = np.abs(got[f][0].astype(np.int32) - want.astype(np.int32))
                assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).sum())
            else:
                np.testing.assert_array_equal(got[f][0], want)
        for f in ("k_scale", "v_scale"):
            close(got[f][0], getattr(jcache, f))
    else:
        close(got["k"][0], jcache.k)
        close(got["v"][0], jcache.v)


def _spy_quantize(monkeypatch):
    """Record every (input, codes, scale) of the port's ``quantize_kv``."""
    seen = []
    real = layers.quantize_kv

    def spy(x):
        q, sc = real(x)
        seen.append((x.numpy().copy(), q.numpy().copy(), sc.numpy().copy()))
        return q, sc

    monkeypatch.setattr(layers, "quantize_kv", spy)
    return seen


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("writes", [(5, 7), (W,), (40,), (20, 20), (33, 1, 1)],
                         ids=["t<w", "t=w", "t>w", "two-prompts", "wrap"])
def test_cache_updates_on_the_ring(quant, writes):
    """Prompt-sized writes through ``gqa_prefill``'s rule (the last w
    tokens of a longer prompt written from slot ``pos``, then pos += t) and
    single-token writes, on the ring: the caches equal JAX's after every
    write, the reference's misplacement at t > w included."""
    rng = np.random.default_rng(len(writes))
    b, kh, d = 2, 2, 8
    pcache, jcache = _port_cache(quant, b, W, kh, d), _jax_cache(quant, b, W, kh, d)
    upd, jupd = ((layers.quant_cache_update, J_QUANT_UPDATE) if quant
                 else (layers.cache_update, J_CACHE_UPDATE))
    for t in writes:
        k = rng.standard_normal((b, t, kh, d)).astype(np.float32)
        v = rng.standard_normal((b, t, kh, d)).astype(np.float32)
        pos0 = pcache.pos
        pcache = upd(pcache, t_(k[:, -W:]), t_(v[:, -W:]), window=W)._replace(pos=pos0 + t)
        jcache = jupd(jcache, jnp.asarray(k[:, -W:]), jnp.asarray(v[:, -W:]), window=W
                      )._replace(pos=jnp.int32(pos0 + t))
        _same_cache(pcache, jcache)
    if writes == (40,):
        # the caveat: slot 0 holds token 8, ring_slot_positions says 32
        assert int(layers.ring_slot_positions(40, W)[0]) == 32


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_linear_cache_update_and_overflow(quant):
    rng = np.random.default_rng(3)
    b, s, kh, d = 2, 16, 2, 8
    pcache, jcache = _port_cache(quant, b, s, kh, d), _jax_cache(quant, b, s, kh, d)
    upd, jupd = ((layers.quant_cache_update, J_QUANT_UPDATE) if quant
                 else (layers.cache_update, J_CACHE_UPDATE))
    for t in (6, 1, 4):
        k = rng.standard_normal((b, t, kh, d)).astype(np.float32)
        v = rng.standard_normal((b, t, kh, d)).astype(np.float32)
        pcache = upd(pcache, t_(k), t_(v))
        jcache = jupd(jcache, jnp.asarray(k), jnp.asarray(v))
        _same_cache(pcache, jcache)
    # an explicit start
    k = rng.standard_normal((b, 2, kh, d)).astype(np.float32)
    _same_cache(upd(pcache, t_(k), t_(k), start=3),
                jupd(jcache, jnp.asarray(k), jnp.asarray(k), start=jnp.int32(3)))
    with pytest.raises(ValueError, match="overflow"):
        upd(pcache, t_(np.zeros((b, s, kh, d), np.float32)), t_(np.zeros((b, s, kh, d), np.float32)))


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("ring", [False, True], ids=["linear", "ring"])
def test_decode_attention(quant, ring):
    rng = np.random.default_rng(4)
    b, kh, d = 2, 2, 8
    s = W if ring else 48
    window = W if ring else 0
    pcache, jcache = _port_cache(quant, b, s, kh, d), _jax_cache(quant, b, s, kh, d)
    upd, jupd = ((layers.quant_cache_update, J_QUANT_UPDATE) if quant
                 else (layers.cache_update, J_CACHE_UPDATE))
    for t in (20, 1, 1, 15, 1):
        if not ring and pcache.pos + t > s:
            break
        k = rng.standard_normal((b, t, kh, d)).astype(np.float32)
        v = rng.standard_normal((b, t, kh, d)).astype(np.float32)
        pcache = upd(pcache, t_(k), t_(v), window=window)
        jcache = jupd(jcache, jnp.asarray(k), jnp.asarray(v), window=window)
        q = rng.standard_normal((b, 1, 4, d)).astype(np.float32)
        close(layers.decode_attention(t_(q), pcache, window=window),
              J_DECODE_ATTN(jnp.asarray(q), jcache, window=window))


# --------------------------------------------------------------- GQA


def _gqa_caches(jc, pc, b, max_seq):
    """One layer's zero cache in each package, from its cache spec."""
    spec = attention.gqa_cache_spec(pc, b, max_seq, (1,))
    pcache = type(spec)(*(torch.zeros(f.shape[1:], dtype=f.dtype) for f in spec[:-1]), 0)
    jspec = jattn.gqa_cache_spec(jc, b, max_seq, ())
    return pcache, jax.tree.map(lambda sds: jnp.zeros(sds.shape, sds.dtype), jspec)


@pytest.mark.parametrize("case", [
    dict(arch="mistral-nemo-12b", head_dim=24, max_seq=64, prompt=17),          # explicit head_dim
    dict(arch="mistral-nemo-12b", head_dim=24, kv_quant=True, max_seq=64, prompt=17),
    dict(arch="qwen1.5-32b", qkv_bias=True, kv_quant=True, max_seq=64, prompt=17),
    dict(arch="qwen1.5-32b", qkv_bias=True, max_seq=64, prompt=17),
    dict(arch="mixtral-8x22b", max_seq=64, prompt=20),                          # ring, t < w
    dict(arch="mixtral-8x22b", max_seq=64, prompt=W),                           # ring, t = w
    dict(arch="mixtral-8x22b", max_seq=64, prompt=40),                          # ring, t > w
    dict(arch="mixtral-8x22b", kv_quant=True, max_seq=64, prompt=29),           # int8 ring
    dict(arch="mixtral-8x22b", max_seq=24, prompt=10),                          # window > max_seq
], ids=["nemo-hd24", "nemo-hd24-int8", "qwen-bias-int8", "qwen-bias", "ring-t<w", "ring-t=w",
        "ring-t>w", "ring-int8", "window-linear"])
def test_gqa_prefill_then_decode(case, monkeypatch):
    """Prefill then decode steps past the ring's wrap, on every cache
    kind; outputs and caches against JAX at each step. On the int8 caches
    every quantisation the port makes equals JAX's ``quantize_kv`` on the
    same input, bit for bit."""
    case = dict(case)
    arch, max_seq, t = case.pop("arch"), case.pop("max_seq"), case.pop("prompt")
    jc, pc = configs(arch, **case)
    rng = np.random.default_rng(5)
    p = _numpy_params(attention.gqa_specs(pc), rng)
    if pc.head_dim:
        assert pc.resolved_head_dim != pc.d_model // pc.n_heads
    assert ("bq" in p) == pc.qkv_bias
    b = 2
    pcache, jcache = _gqa_caches(jc, pc, b, max_seq)
    assert type(pcache).__name__ == type(jcache).__name__
    seen = _spy_quantize(monkeypatch)
    x = rng.standard_normal((b, t, pc.d_model)).astype(np.float32)
    jp, tp = _tree(jnp.asarray, p), _tree(t_, p)
    jo, jcache = J_GQA_PREFILL(jp, jnp.asarray(x), jc, jcache)
    po, pcache = attention.gqa_prefill(tp, t_(x), pc, pcache)
    close(po, jo)
    _same_cache(pcache, jcache, projected=True)
    steps = min(W + 3, max_seq - t)
    for _ in range(steps):
        xd = rng.standard_normal((b, 1, pc.d_model)).astype(np.float32)
        jo, jcache = J_GQA_DECODE(jp, jnp.asarray(xd), jc, jcache)
        po, pcache = attention.gqa_decode(tp, t_(xd), pc, pcache)
        # a code one step off (see _same_cache) moves an output by up to
        # one int8 step: 1/127 of its scale
        close(po, jo, atol=float(np.abs(jo).max()) / 127 if pc.kv_quant else ATOL)
    _same_cache(pcache, jcache, projected=True)
    assert pcache.pos == t + steps
    assert len(seen) == (2 * (1 + steps) if pc.kv_quant else 0)
    for x, q, sc in seen:
        jq, js = J_QUANT(jnp.asarray(x))
        np.testing.assert_array_equal(q, np.asarray(jq))
        np.testing.assert_array_equal(sc, np.asarray(js))


@pytest.mark.parametrize("causal", [True, False])
def test_gqa_forward(causal):
    jc, pc = configs("mixtral-8x22b", qkv_bias=True, head_dim=20)
    rng = np.random.default_rng(6)
    p = _numpy_params(attention.gqa_specs(pc), rng)
    x = rng.standard_normal((2, 45, pc.d_model)).astype(np.float32)
    close(attention.gqa_forward(_tree(t_, p), t_(x), pc, causal=causal),
          J_GQA_FORWARD(_tree(jnp.asarray, p), jnp.asarray(x), jc, causal=causal))


def test_cross_attn_with_a_random_gate():
    jc, pc = configs("llama-3.2-vision-11b")
    rng = np.random.default_rng(7)
    p = _numpy_params(attention.cross_attn_specs(pc), rng)
    p["gate"] = np.array([0.7], np.float32)
    x = rng.standard_normal((2, 9, pc.d_model)).astype(np.float32)
    kv = rng.standard_normal((2, pc.vlm.vision_tokens, pc.d_model)).astype(np.float32)
    got = attention.cross_attn(_tree(t_, p), t_(x), t_(kv), pc)
    close(got, J_CROSS(_tree(jnp.asarray, p), jnp.asarray(x), jnp.asarray(kv), jc))
    assert float(got.abs().max()) > 0
    # the zero init closes the gate
    p["gate"] = np.zeros(1, np.float32)
    assert float(attention.cross_attn(_tree(t_, p), t_(x), t_(kv), pc).abs().max()) == 0.0


def test_gqa_cache_spec_and_carry_across():
    """Cache specs (ring when max_seq ≥ window, int8 with scales) equal
    JAX's, and a JAX cache carried across by ``gqa_cache_from_numpy``
    decodes as the port's own does."""
    for kw, max_seq in (({}, 64), ({}, 16), ({"kv_quant": True}, 64)):
        jc, pc = configs("mixtral-8x22b", **kw)
        spec = attention.gqa_cache_spec(pc, 3, max_seq, (2,))
        jspec = jattn.gqa_cache_spec(jc, 3, max_seq, (2,))
        assert type(spec).__name__ == type(jspec).__name__
        for f in spec._fields:
            assert tuple(getattr(spec, f).shape) == tuple(getattr(jspec, f).shape), f
            assert str(getattr(spec, f).dtype).removeprefix("torch.") == \
                str(jnp.dtype(getattr(jspec, f).dtype))
    jc, pc = configs("mixtral-8x22b", kv_quant=True)
    rng = np.random.default_rng(8)
    p = _numpy_params(attention.gqa_specs(pc), rng)
    jp, tp = _tree(jnp.asarray, p), _tree(t_, p)
    _, jcache = _gqa_caches(jc, pc, 2, 64)
    _, jcache = J_GQA_PREFILL(jp, jnp.asarray(rng.standard_normal((2, 12, pc.d_model)),
                                              jnp.float32), jc, jcache)
    stacked = jax.tree.map(lambda a: np.asarray(a)[None], jcache)
    (carried,) = gqa_cache_from_numpy(stacked.k, stacked.v, stacked.pos, torch.float32,
                                      stacked.k_scale, stacked.v_scale, device="cpu")
    assert carried.k.dtype == torch.int8 and carried.pos == 12
    xd = rng.standard_normal((2, 1, pc.d_model)).astype(np.float32)
    jo, _ = J_GQA_DECODE(jp, jnp.asarray(xd), jc, jcache)
    close(attention.gqa_decode(tp, t_(xd), pc, carried)[0], jo)
