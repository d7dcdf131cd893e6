"""The ssm and hybrid families of the port held to the JAX package:
xlstm-1.3b (groups of one sLSTM and ``slstm_every − 1`` mLSTM blocks) and
zamba2-1.2b (Mamba2 layers with one shared attention+MLP block at a site
before each group of ``attn_every`` and before the remainder).

On the full configs, without allocation: the configs field by field,
parameter counts (1,639,614,632 and 1,104,602,240), cache bytes and the
serving plan, and the input specs of every shape the arch runs. On small
configs in f32, from the same numpy weights with every leaf drawn at
random (the zero-initialised ``w_gate``, ``dt_bias`` and ``A_log``
included, so their paths run): the reduced configs, xLSTM at [g, per] =
[2, 2], zamba2 with a remainder site (5 layers) and without (4), and
zamba2 with a window of 8 whose decode wraps the ring. Forward, prefill
and 4 greedy decode steps within rtol 1e-4, atol 1e-5 (the repo's f32
tolerance), the recurrent states after prefill and after decode through
the converters, decode from the reference's own states, and
``ServingEngine.run``'s tokens. The JAX side of each case runs once, in a
module-scoped fixture.
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
from repro_torch.convert import (
    gqa_cache_to_numpy, model_params_from_numpy, ssm_cache_from_numpy, ssm_cache_to_numpy,
)
from repro_torch.models import zoo
from repro_torch.models.config import SHAPES
from repro_torch.models.transformer import (
    SLSTMState, SSMCache, build_model, xlstm_groups, zamba_groups,
)
from repro_torch.serve import engine, kv_cache

RTOL, ATOL = 1e-4, 1e-5
ARCHS = ["xlstm-1.3b", "zamba2-1.2b"]
FULL_PARAMS = {"xlstm-1.3b": 1_639_614_632, "zamba2-1.2b": 1_104_602_240}
CACHE_4x1024 = {"xlstm-1.3b": 2_825_846_784, "zamba2-1.2b": 400_490_524}


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
def test_configs_counts_and_cache_bytes_match_the_reference(arch):
    jc, pc = jzoo.get_config(arch), zoo.get_config(arch)
    for a, b in ((jc, pc), (jzoo.reduced_config(arch), zoo.reduced_config(arch))):
        jd, pd = dataclasses.asdict(a), dataclasses.asdict(b)
        assert _dtype_name(jd.pop("dtype")) == _dtype_name(pd.pop("dtype"))
        assert jd == pd
    assert zoo.count_params(pc) == jzoo.count_params(jc) == FULL_PARAMS[arch]
    assert zoo.active_params(pc) == jzoo.active_params(jc)
    assert pc.subquadratic and jc.subquadratic
    assert zoo.arch_shapes(pc) == jzoo.arch_shapes(jc)
    assert kv_cache.cache_bytes(pc, 4, 1024) == CACHE_4x1024[arch]
    for batch, max_seq in ((4, 1024), (2, 4224), (1, 524288)):
        assert kv_cache.cache_bytes(pc, batch, max_seq) == jkv.cache_bytes(jc, batch, max_seq)
        want = jkv.plan(jc, batch, max_seq, chips=1)
        got = kv_cache.plan(pc, batch, max_seq)
        assert {k: got[k] for k in ("param_bytes", "cache_bytes", "per_chip_bytes")} == \
            {k: want[k] for k in ("param_bytes", "cache_bytes", "per_chip_bytes")}
    # xLSTM's state does not grow with the sequence; zamba2's sites do
    grows = kv_cache.cache_bytes(pc, 2, 4224) != kv_cache.cache_bytes(pc, 2, 1024)
    assert grows == (arch == "zamba2-1.2b")


def _leaf_specs(tree):
    """(shape, dtype name) of every leaf in the tree order of either
    package's spec tree: dicts by sorted key, tuples in order."""
    is_leaf = lambda x: isinstance(x, torch.Tensor)             # noqa: E731
    return [(tuple(x.shape), _dtype_name(x.dtype)) for x in jax.tree.leaves(tree, is_leaf=is_leaf)]


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_the_reference(arch):
    """Every shape the arch runs, long_500k included: the same inputs and
    cache leaves, shapes and dtypes, the port's on the ``meta`` device."""
    jc, pc = jzoo.get_config(arch), zoo.get_config(arch)
    names = zoo.arch_shapes(pc)
    assert "long_500k" in names
    for name in names:
        got, want = zoo.input_specs(pc, SHAPES[name]), jzoo.input_specs(jc, JSHAPES[name])
        assert set(got) == set(want), name
        for key in got:
            if key == "cache":
                assert set(got[key]) == set(want[key])
            assert _leaf_specs(got[key]) == _leaf_specs(want[key]), (name, key)
        assert all(t.device.type == "meta" for t in jax.tree.leaves(
            got, is_leaf=lambda x: isinstance(x, torch.Tensor)))


# --------------------------------------------------------------- small models

CASES = {
    "xlstm-reduced": ("xlstm-1.3b", {}),
    "xlstm-2x2": ("xlstm-1.3b", {"n_layers": 6, "ssm": {"slstm_every": 3}}),
    "zamba2-reduced": ("zamba2-1.2b", {}),
    "zamba2-5": ("zamba2-1.2b", {"n_layers": 5}),
    "zamba2-4": ("zamba2-1.2b", {"n_layers": 4}),
    "zamba2-window8": ("zamba2-1.2b", {"hybrid": {"attn_window": 8}}),
}


def _edit(cfg, edits):
    kw = {k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict) else v
          for k, v in edits.items()}
    return dataclasses.replace(cfg, **kw)


# the projections each block adds to the residual stream
_RESIDUAL_OUT = ("w_down", "w_out", "wo", "w2")


def _draw(rng, n_layers: int):
    """Every leaf at random: matrices (and conv taps, per-head q/k
    projections) with std 1/√(input width); the embedding, which both
    archs tie as their output head, as a matrix of input width d_model
    (as ``test_torch_lm_families.py`` draws hubert's head), so the logits
    are O(1) as there; the vectors that start at ones (norms, f_bias, D)
    at 1 + 0.2·N, and the zero-initialised ones (dt_bias, A_log) at
    0.3·N; ``w_gate`` is a matrix.

    Two rules keep the f32 comparison above both packages' rounding.
    Mamba2's B and C projections are drawn at std 1/√(d_model · d_state),
    so their scores over d_state are O(1) as attention's scaled scores
    are: at 1/√d_model the reduced zamba2's logits from the reference's
    own jitted and eager forwards differ by 1.1e-4 beyond rtol 1e-4, ten
    times the atol. The projections a block adds to the residual stream
    are drawn at std 1/√(input width · layers), the usual init for a deep
    residual stack: without it, the 6-block xLSTM's jitted and eager
    reference forwards differ by up to 8.6e-6 beyond rtol (9 draws), at
    the atol itself; with it, by at most 5.2e-6."""
    def draw(path, spec):
        x = rng.standard_normal(spec.shape)
        name = path[-1].key
        per_layer = [d for d in spec.dims if d not in ("layers", "layers2")]
        if spec.init == "embed":
            return (x / np.sqrt(spec.shape[-1])).astype(np.float32)
        if spec.dims[-1] == "state":                   # Mamba2's w_B, w_C
            return (x / np.sqrt(spec.shape[-2] * spec.shape[-1])).astype(np.float32)
        if len(per_layer) >= 2:
            depth = n_layers if name in _RESIDUAL_OUT else 1
            return (x / np.sqrt(spec.shape[-2] * depth)).astype(np.float32)
        if spec.init == "ones":
            return (1.0 + 0.2 * x).astype(np.float32)
        return (0.3 * x).astype(np.float32)
    return draw


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """The case's config in both packages on the same weights, and the
    reference's results: forward logits, prefill logits and states,
    4 greedy decode steps, the served tokens."""
    arch, edits = CASES[request.param]
    jc = _edit(jzoo.reduced_config(arch), edits)
    pc = _edit(zoo.reduced_config(arch), edits)
    jm = jbuild_model(jc)
    params_np = jax.tree_util.tree_map_with_path(
        _draw(np.random.default_rng(0), pc.n_layers), jm.specs(),
        is_leaf=lambda s: hasattr(s, "init"))
    params = jax.tree.map(jnp.asarray, params_np)
    pm = build_model(pc, device="cpu")
    pm.load_state_dict(model_params_from_numpy(pc, params_np, device="cpu"))
    # prefill and decode run through the reference engine's own jitted
    # steps, at the shapes its run takes (3 prompts padded to 40 tokens, or
    # to 6 for the window case, max_seq 64), so each is compiled once
    window = request.param == "zamba2-window8"
    lens, budgets = ((3, 6, 5), (6, 3, 6)) if window else ((5, 23, 40), (6, 3, 6))
    b, s, max_seq = len(lens), max(lens), 64
    jeng = jengine.ServingEngine(jm, params, max_seq=max_seq)
    toks = np.random.default_rng(9).integers(0, pc.vocab, (b, s)).astype(np.int32)
    ref = {"forward": np.asarray(jax.jit(jm.forward)(params, {"tokens": jnp.asarray(toks)}))}
    jl, jcache = jeng._prefill(params, {"tokens": jnp.asarray(toks)}, jm.init_cache(b, max_seq))
    ref["prefill"], ref["prefill_cache"] = np.asarray(jl), jax.tree.map(np.asarray, jcache)
    steps, fed = [], []
    tok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    for _ in range(4):
        fed.append(np.asarray(tok))
        tok, jl, jcache = jeng._decode(params, tok, jcache)
        steps.append(np.asarray(jl))
    ref.update(decode=steps, fed=fed, decode_cache=jax.tree.map(np.asarray, jcache))
    prompts = [np.random.default_rng(10 + i).integers(0, pc.vocab, n).tolist()
               for i, n in enumerate(lens)]
    ref["served"] = [r.generated for r in jeng.run(
        [jengine.Request(prompt=p, max_new_tokens=m) for p, m in zip(prompts, budgets)])]
    return dict(name=request.param, pm=pm, toks=toks, max_seq=max_seq, ref=ref,
                prompts=prompts, budgets=budgets)


def _same_states(pm, pcache, jcache):
    """The port's caches against the reference's stacks, segment by
    segment: recurrent states through ``ssm_cache_to_numpy``, the shared
    sites' KV caches through ``gqa_cache_to_numpy``."""
    assert set(pcache) == set(jcache)
    cfg = pm.cfg
    if cfg.family == "ssm":
        g, per = xlstm_groups(cfg)
        got = ssm_cache_to_numpy(pcache["slstm"])
        assert isinstance(got, SLSTMState) and got.c.shape[0] == g
        close(got.c, jcache["slstm"][0])
        close(got.n, jcache["slstm"][1])
        got = ssm_cache_to_numpy(pcache["mlstm"], lead=(g, per))
        want = jcache["mlstm"]
    else:
        full, _, rem = zamba_groups(cfg)
        kv = gqa_cache_to_numpy(pcache["attn"])
        assert len(pcache["attn"]) == full + (1 if rem else 0)
        np.testing.assert_array_equal(kv["pos"], np.asarray(jcache["attn"].pos))
        close(kv["k"], jcache["attn"].k)
        close(kv["v"], jcache["attn"].v)
        got, want = ssm_cache_to_numpy(pcache["mamba"]), jcache["mamba"]
    close(got["conv"], want["conv"])
    close(got["gla"].s, want["gla"].s)
    close(got["gla"].n, want["gla"].n)


def test_forward_matches_the_reference(case):
    pm, ref = case["pm"], case["ref"]
    close(pm.forward(t_(case["toks"])), ref["forward"])


def test_prefill_decode_and_states_match_the_reference(case):
    """Prefill, the states it leaves, 4 greedy decode steps and the states
    after them; every cache tensor keeps its storage from ``init_cache``
    on (the decode state does not grow)."""
    pm, ref = case["pm"], case["ref"]
    b = case["toks"].shape[0]
    pcache = pm.init_cache(b, case["max_seq"])
    ptrs = [t.data_ptr() for t in _cache_tensors(pcache)]
    pl, pcache = pm.prefill(t_(case["toks"]), pcache)
    close(pl, ref["prefill"])
    _same_states(pm, pcache, ref["prefill_cache"])
    for fed, want in zip(ref["fed"], ref["decode"]):
        assert np.array_equal(fed[:, 0], pl.argmax(-1).numpy())
        pl, pcache = pm.decode(t_(fed), pcache)
        close(pl, want)
    _same_states(pm, pcache, ref["decode_cache"])
    assert [t.data_ptr() for t in _cache_tensors(pcache)] == ptrs
    if case["name"] == "zamba2-window8":
        ring = pcache["attn"][0]
        assert ring.k.shape[1] == 8 and ring.pos == case["toks"].shape[1] + 4 > 8


def _cache_tensors(cache):
    out = []
    for seg in cache.values():
        for c in seg:
            out += [t for t in jax.tree.leaves(c, is_leaf=lambda x: isinstance(x, torch.Tensor))
                    if isinstance(t, torch.Tensor)]
    return out


def test_decode_from_the_reference_states(case):
    """The reference's states after prefill carried into the port
    (``ssm_cache_from_numpy``; the KV sites as the port's caches), then
    the same 4 decode steps."""
    pm, ref = case["pm"], case["ref"]
    jc = ref["prefill_cache"]
    if pm.cfg.family == "ssm":
        pcache = {"slstm": ssm_cache_from_numpy(jc["slstm"], pm.cfg.dtype, device="cpu"),
                  "mlstm": ssm_cache_from_numpy(jc["mlstm"], pm.cfg.dtype, device="cpu")}
        assert all(isinstance(c, SLSTMState) for c in pcache["slstm"])
        assert len(pcache["mlstm"]) == np.prod(xlstm_groups(pm.cfg))
    else:
        from repro_torch.convert import gqa_cache_from_numpy
        a = jc["attn"]
        pcache = {"attn": gqa_cache_from_numpy(a.k, a.v, a.pos, pm.cfg.dtype, device="cpu"),
                  "mamba": ssm_cache_from_numpy(jc["mamba"], pm.cfg.dtype, device="cpu")}
    assert all(isinstance(c, SSMCache) for c in pcache.get("mlstm", pcache.get("mamba")))
    for fed, want in zip(ref["fed"], ref["decode"]):
        pl, pcache = pm.decode(t_(fed), pcache)
        close(pl, want)


def test_decode_equals_the_forward(case):
    """The port alone: each greedy step's logits against ``forward`` over
    the prompt and the tokens fed so far (stepwise against chunked
    recurrence, at the chunked-against-step tolerance rtol 2e-4,
    atol 2e-5)."""
    pm, ref = case["pm"], case["ref"]
    toks = case["toks"]
    seq = np.concatenate([toks] + ref["fed"], axis=1)
    full = pm.forward(t_(seq))
    pcache = pm.init_cache(toks.shape[0], case["max_seq"])
    pl, pcache = pm.prefill(t_(toks), pcache)
    close(pl, full[:, toks.shape[1] - 1], rtol=2e-4, atol=2e-5)
    for i, fed in enumerate(ref["fed"]):
        pl, pcache = pm.decode(t_(fed), pcache)
        close(pl, full[:, toks.shape[1] + i], rtol=2e-4, atol=2e-5)


def test_serving_engine_generates_the_reference_tokens(case):
    pm = case["pm"]
    got = engine.ServingEngine(pm, max_seq=case["max_seq"], device="cpu").run(
        [engine.Request(prompt=p, max_new_tokens=m)
         for p, m in zip(case["prompts"], case["budgets"])])
    assert [r.generated for r in got] == case["ref"]["served"]
    assert [len(r.generated) for r in got] == list(case["budgets"])
