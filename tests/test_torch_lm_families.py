"""The GQA model families of the port held to the JAX package, arch by
arch: mistral-nemo-12b, deepseek-7b, minitron-4b, qwen1.5-32b (dense),
mixtral-8x22b (GQA + routed MoE, sliding window), hubert-xlarge (audio
encoder) and llama-3.2-vision-11b (VLM).

On the full configs, without allocation: parameter counts, the cache
bytes and serving plan, the configs and the input specs' shapes. On the
reduced configs in f32, from the same numpy weights: prefill, 4 greedy
decode steps and ``ServingEngine.run``, logits within rtol 1e-4, atol 1e-5
(the repo's f32 tolerance, as in ``test_torch_lm.py``), tokens and the
caches' ``pos`` exactly. The reduced mixtral (top-2 of 8, window 32)
takes ``moe_sparse``, so kernel 7's plain version, and its longest prompt
(40 tokens) is longer than the window; hubert encodes frames; the VLM
prefills with ``image_embeds`` and decodes with ``vision_kv``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import zoo as jzoo
from repro.models.config import SHAPES as JSHAPES
from repro.models.transformer import build_model as jbuild_model
from repro.serve import engine as jengine, kv_cache as jkv
from repro_torch.convert import gqa_cache_to_numpy, model_params_from_numpy
from repro_torch.kernels.moe_dispatch import moe_dispatch_gather
from repro_torch.models import moe, zoo
from repro_torch.models.config import SHAPES
from repro_torch.models.transformer import build_model
from repro_torch.serve import engine, kv_cache

RTOL, ATOL = 1e-4, 1e-5
ARCHS = ["mistral-nemo-12b", "deepseek-7b", "minitron-4b", "qwen1.5-32b", "mixtral-8x22b",
         "hubert-xlarge", "llama-3.2-vision-11b"]
FULL_PARAMS = {"mistral-nemo-12b": 12_247_782_400, "mixtral-8x22b": 140_630_071_296,
               "qwen1.5-32b": 35_197_096_960, "llama-3.2-vision-11b": 10_142_191_624}


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                                          np.float32),
                               np.asarray(want, np.float32), rtol=rtol, atol=atol)


def t_(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.") if isinstance(dtype, torch.dtype) \
        else str(jnp.dtype(dtype))


# --------------------------------------------------------------- full configs


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_counts_and_plans_match_the_reference(arch):
    """The config field by field, parameter counts, cache bytes and the
    serving plan at batch 4 × 1024, all without allocation."""
    jc, pc = jzoo.get_config(arch), zoo.get_config(arch)
    for a, b in ((jc, pc), (jzoo.reduced_config(arch), zoo.reduced_config(arch))):
        jd, pd = dataclasses.asdict(a), dataclasses.asdict(b)
        assert _dtype_name(jd.pop("dtype")) == _dtype_name(pd.pop("dtype"))
        assert {k: v for k, v in jd.items() if k in pd} == pd
        assert all(jd[k] in (None, 0, False) for k in set(jd) - set(pd)), set(jd) - set(pd)
    assert zoo.count_params(pc) == jzoo.count_params(jc) == FULL_PARAMS.get(arch, zoo.count_params(pc))
    assert zoo.active_params(pc) == jzoo.active_params(jc)
    assert pc.subquadratic == jc.subquadratic
    assert zoo.arch_shapes(pc) == jzoo.arch_shapes(jc)
    for batch, max_seq in ((4, 1024), (2, 4128)):
        assert kv_cache.cache_bytes(pc, batch, max_seq) == jkv.cache_bytes(jc, batch, max_seq)
        want = jkv.plan(jc, batch, max_seq, chips=1)
        got = kv_cache.plan(pc, batch, max_seq)
        assert {k: got[k] for k in ("param_bytes", "cache_bytes", "per_chip_bytes")} == \
            {k: want[k] for k in ("param_bytes", "cache_bytes", "per_chip_bytes")}


def _flat(tree, prefix=""):
    """(path, (shape, dtype name)) for every leaf of a spec tree of either
    package: dicts and the cache NamedTuples, leaves with .shape/.dtype."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}/")
    elif isinstance(tree, tuple):
        for k, v in zip(tree._fields, tree):
            yield from _flat(v, f"{prefix}{k}/")
    else:
        yield prefix, (tuple(tree.shape), _dtype_name(tree.dtype))


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_the_reference(arch):
    """For every shape the arch runs: the same inputs and cache leaves,
    shapes and dtypes, the port's on the ``meta`` device."""
    jc, pc = jzoo.get_config(arch), zoo.get_config(arch)
    assert set(SHAPES) == set(JSHAPES)
    for name in zoo.arch_shapes(pc):
        got, want = zoo.input_specs(pc, SHAPES[name]), jzoo.input_specs(jc, JSHAPES[name])
        assert dict(_flat(got)) == dict(_flat(want)), name
        assert all(t.device.type == "meta" for t in jax.tree.leaves(
            got, is_leaf=lambda x: isinstance(x, torch.Tensor)))


# --------------------------------------------------------------- reduced models


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """The reduced arch in both packages on the same weights, drawn with
    numpy over the reference's spec tree: matrices at std 1/√(input
    width), so the residual stream stays O(1), token embeddings at std 1
    (an encoder's embedding is only its output head, so it is drawn as a
    matrix of input width d_model), norms ones, and the zero-initialised
    qkv biases and cross-attention gate at random, so their paths run."""
    return _make_pair(request.param)


def _make_pair(arch, **edits):
    jc = dataclasses.replace(jzoo.reduced_config(arch), **edits)
    pc = dataclasses.replace(zoo.reduced_config(arch), **edits)
    jm = jbuild_model(jc)
    rng = np.random.default_rng(0)

    def draw(spec):
        if spec.init == "ones":
            return np.ones(spec.shape, np.float32)
        if spec.init == "zeros":
            return (rng.standard_normal(spec.shape) * 0.3).astype(np.float32)
        if spec.init == "embed":
            std = 1 / np.sqrt(spec.shape[-1]) if jc.encoder_only else 1.0
        else:
            std = 1 / np.sqrt(spec.shape[-2])
        return (rng.standard_normal(spec.shape) * std).astype(np.float32)

    params_np = jax.tree.map(draw, jm.specs(), is_leaf=lambda s: hasattr(s, "init"))
    pm = build_model(pc, device="cpu")
    pm.load_state_dict(model_params_from_numpy(pc, params_np, device="cpu"))
    return arch, jm, jax.tree.map(jnp.asarray, params_np), pm


def _inputs(pm, rng, b, s):
    cfg = pm.cfg
    if cfg.frontend == "frames":
        return {"frames": rng.standard_normal((b, s, cfg.frontend_dim)).astype(np.float32)}
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        out["image_embeds"] = rng.standard_normal(
            (b, cfg.vlm.vision_tokens, cfg.vlm.vision_dim)).astype(np.float32)
    return out


def test_prefill_and_decode_match_the_reference(pair, monkeypatch):
    arch, jm, params, pm = pair
    rng = np.random.default_rng(9)
    b, s = 2, 40
    inputs = _inputs(pm, rng, b, s)
    kw = {k: t_(v) for k, v in inputs.items() if k != "tokens"}
    tokens = t_(inputs["tokens"]) if "tokens" in inputs else None
    plans = []
    real_plan = moe.dispatch_plan
    monkeypatch.setattr(moe, "dispatch_plan", lambda *a: plans.append(real_plan(*a)) or plans[-1])
    before = moe_dispatch_gather.launches
    jbatch = {k: jnp.asarray(v) for k, v in inputs.items()}
    if pm.cfg.encoder_only:
        jl, jcache = jax.jit(jm.prefill)(params, jbatch, {})
        pl, pcache = pm.prefill(tokens, {}, **kw)
        assert pcache == {} and jcache == {}
        assert tuple(pl.shape) == (b, s, pm.cfg.vocab)
        close(pl, jl)
        close(pm.forward(frames=kw["frames"]), jl)
        return
    jcache = jm.init_cache(b, s + 8)
    pcache = pm.init_cache(b, s + 8)
    jl, jcache = jax.jit(jm.prefill)(params, jbatch, jcache)
    pl, pcache = pm.prefill(tokens, pcache, **kw)
    close(pl, jl)
    _same_caches(pcache, jcache)
    vision = None
    jvision = None
    if pm.cfg.family == "vlm":
        vision = pm.vision_kv(kw["image_embeds"])
        jvision = jm._vision_kv(params, jbatch)
        close(vision, jvision)
    jdecode = jax.jit(jm.decode)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    assert np.array_equal(tok[:, 0], pl.argmax(-1).numpy())
    for _ in range(4):
        jl, jcache = jdecode(params, jnp.asarray(tok), jcache, jvision)
        pl, pcache = pm.decode(t_(tok), pcache, vision_kv=vision)
        close(pl, jl)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        assert np.array_equal(tok[:, 0], pl.argmax(-1).numpy())
    _same_caches(pcache, jcache)
    assert moe_dispatch_gather.launches == before           # CPU tensors: the plain version
    assert (len(plans) > 0) == (arch == "mixtral-8x22b")
    if pm.cfg.family == "vlm":
        # the gate is open: the vision sequence moves the logits
        assert not torch.allclose(pm.decode(t_(tok), pm.prefill(tokens, pm.init_cache(b, s + 8),
                                                                **kw)[1])[0],
                                  pm.decode(t_(tok), pm.prefill(tokens, pm.init_cache(b, s + 8),
                                                                **kw)[1], vision_kv=vision)[0])


def _same_caches(pcache, jcache):
    assert set(pcache) == set(jcache)
    for name, jc in jcache.items():
        got = gqa_cache_to_numpy(pcache[name])
        np.testing.assert_array_equal(got["pos"], np.asarray(jc.pos))
        close(got["k"], jc.k)
        close(got["v"], jc.v)


def test_serving_engine_generates_the_reference_tokens(pair):
    """Each causal arch through both engines, prompts of 5, 23 and 40
    tokens (the reduced mixtral's window is 32). The encoder has no cache
    and no decode in either package: its frames attend both ways, so the
    last frame moves the first position's logits."""
    arch, jm, params, pm = pair
    if pm.cfg.encoder_only:
        assert pm.init_cache(2, 16) == {} == jm.init_cache(2, 16)
        frames = np.random.default_rng(11).standard_normal((1, 12, pm.cfg.frontend_dim))
        moved = frames.copy()
        moved[:, -1] += 1.0
        for f in (lambda x: pm.forward(frames=t_(x.astype(np.float32))),
                  lambda x: jax.jit(jm.forward)(params, {"frames": jnp.asarray(x, jnp.float32)})):
            assert float(np.abs(np.asarray(f(moved))[:, 0] - np.asarray(f(frames))[:, 0]).max()) > 1e-3
        return
    lens, budgets = (5, 23, 40), (6, 3, 6)

    def requests(mod):
        rng = np.random.default_rng(10)
        return [mod.Request(prompt=rng.integers(0, pm.cfg.vocab, n).tolist(), max_new_tokens=m)
                for n, m in zip(lens, budgets)]

    want = jengine.ServingEngine(jm, params, max_seq=64).run(requests(jengine))
    got = engine.ServingEngine(pm, max_seq=64, device="cpu").run(requests(engine))
    for g, w, m in zip(got, want, budgets):
        assert g.prompt == w.prompt
        assert g.generated == w.generated
        assert len(g.generated) == m


@pytest.mark.parametrize("arch", ["deepseek-7b", "qwen1.5-32b"])
def test_int8_cache_models_match_the_reference(arch):
    """The two int8-cache archs with ``kv_quant`` set back on in both
    packages (the reduced config turns it off): prefill and 4 greedy
    decode steps pick the same tokens. Each package quantises its own
    projected k/v, whose last bits differ, so a code at a rounding edge
    may land one step away (codes within 1, in at most 0.1% of the
    entries; ``test_torch_gqa.py`` holds the codes exact on the same
    input), and the logits agree within one int8 step of their scale."""
    _, jm, params, pm = _make_pair(arch, kv_quant=True)
    rng = np.random.default_rng(12)
    b, s = 2, 40
    toks = rng.integers(0, pm.cfg.vocab, (b, s)).astype(np.int32)
    jcache, pcache = jm.init_cache(b, s + 8), pm.init_cache(b, s + 8)
    assert pcache["layers"][0].k.dtype == torch.int8
    jl, jcache = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks)}, jcache)
    pl, pcache = pm.prefill(t_(toks), pcache)
    jdecode = jax.jit(jm.decode)
    for step in range(5):
        close(pl, jl, atol=float(np.abs(jl).max()) / 127)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        assert np.array_equal(tok[:, 0], pl.argmax(-1).numpy())
        if step < 4:
            jl, jcache = jdecode(params, jnp.asarray(tok), jcache)
            pl, pcache = pm.decode(t_(tok), pcache)
    for got_c, want_c in zip(pcache["layers"], [jax.tree.map(lambda a, i=i: a[i], jcache["layers"])
                                                for i in range(pm.cfg.n_layers)]):
        got = gqa_cache_to_numpy([got_c])
        assert int(got["pos"][0]) == int(want_c.pos) == s + 4
        for f in ("k", "v"):
            diff = np.abs(got[f][0].astype(np.int32) - np.asarray(getattr(want_c, f), np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        close(got["k_scale"][0], want_c.k_scale)
