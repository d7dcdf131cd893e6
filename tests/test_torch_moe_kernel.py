"""Kernel 7, the MoE dispatch gather: its plain version (what the wrapper
runs on CPU tensors) against the Pallas kernel in interpret mode, through
``repro.kernels.ops`` as ``tests/test_moe_kernel.py`` runs it, exactly,
in f32 and bf16 with pads; and the expert buffer the port's
``moe_sparse`` builds from its slot→token plan against a scatter buffer
built from the same plan, as the reference builds it."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models.config import MoEConfig as JMoEConfig
from repro.models.moe import capacity as jcapacity, router_topk as jrouter_topk
from repro_torch.kernels import ops, ref
from repro_torch.kernels.moe_dispatch import moe_dispatch_gather
from repro_torch.models.config import MoEConfig
from repro_torch.models.moe import capacity, dispatch_plan, router_topk

SWEEP = [(16, 128, 24, 128), (64, 256, 64, 128), (8, 384, 40, 128),
         (128, 512, 96, 256), (32, 128, 8, 128)]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(rng, shape, dtype):
    """The same values in both packages: drawn in f32, rounded by JAX, and
    carried to torch bit for bit."""
    jx = jnp.asarray(rng.standard_normal(shape), DTYPES[dtype][0])
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(DTYPES[dtype][1])
    return jx, tx


def _f32(a) -> np.ndarray:
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a.astype(jnp.float32))


@pytest.mark.parametrize("t,d,s,block_d", SWEEP)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_version_equals_pallas_kernel(t, d, s, block_d, dtype):
    rng = np.random.default_rng(hash((t, d, s)) % 2**31)
    jx, tx = _pair(rng, (t, d), dtype)
    tok = rng.integers(0, t + 1, s).astype(np.int32)
    tok[::5] = t                                              # pads included
    want = jops.moe_dispatch_gather(jx, jnp.asarray(tok), block_d=block_d)
    before, paths = moe_dispatch_gather.launches, dict(moe_dispatch_gather.paths)
    got = ops.moe_dispatch_gather(tx, torch.from_numpy(tok))
    assert moe_dispatch_gather.launches == before            # CPU: plain version, no launch
    assert moe_dispatch_gather.paths == paths
    assert set(paths) == {"elementwise", "flat", "window"}
    assert got.dtype == DTYPES[dtype][1] and got.shape == (s, d)
    np.testing.assert_array_equal(_f32(got), _f32(want))
    np.testing.assert_array_equal(_f32(ref.moe_dispatch_gather_ref(tx, torch.from_numpy(tok))),
                                  _f32(jops.moe_dispatch_gather_ref(jx, jnp.asarray(tok))))


@pytest.mark.parametrize("seed", range(6))
def test_plain_version_row_by_row(seed):
    rng = np.random.default_rng(seed)
    t, s = int(rng.integers(1, 40)), int(rng.integers(1, 64))
    x = torch.from_numpy(rng.standard_normal((t, 128)).astype(np.float32))
    tok = rng.integers(0, t + 1, s).astype(np.int32)
    got = moe_dispatch_gather(x, torch.from_numpy(tok))
    for i, tk in enumerate(tok):
        if tk < t:
            assert torch.equal(got[i], x[tk])
        else:
            assert not got[i].any()


def test_pads_outside_the_token_range_and_no_tokens():
    x = torch.arange(12, dtype=torch.float32).view(3, 4)
    tok = torch.tensor([2, -1, 3, 0, 7], dtype=torch.int32)
    got = moe_dispatch_gather(x, tok)
    assert torch.equal(got, torch.stack([x[2], torch.zeros(4), torch.zeros(4), x[0],
                                         torch.zeros(4)]))
    empty = moe_dispatch_gather(torch.zeros((0, 4)), tok)
    assert empty.shape == (5, 4) and not empty.any()
    assert moe_dispatch_gather(x, torch.zeros(0, dtype=torch.int32)).shape == (0, 4)


def test_wrapper_rejects_bad_operands():
    x = torch.zeros((4, 8))
    tok = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\[T, D\]"):
        moe_dispatch_gather(x[0], tok)
    with pytest.raises(TypeError):
        moe_dispatch_gather(x.int(), tok)
    with pytest.raises(ValueError, match="int32"):
        moe_dispatch_gather(x, tok.long())
    with pytest.raises(ValueError, match="int32"):
        moe_dispatch_gather(x, tok.view(3, 1))
    with pytest.raises(ValueError, match="contiguous"):
        moe_dispatch_gather(x.T, tok)
    # meta tensors take the dry run's shape inference: an empty output of
    # the right shape and dtype, no launch (tests/test_torch_launch.py)
    before = moe_dispatch_gather.launches
    out = moe_dispatch_gather(x.to("meta"), tok.to("meta"))
    assert out.device.type == "meta" and out.shape == (3, 8) and out.dtype == x.dtype
    assert moe_dispatch_gather.launches == before


@pytest.mark.parametrize("cf", [2.0, 1.0])
def test_routing_plan_buffer_equals_scatter_and_pallas(cf):
    """The port's plan, fed to kernel 7's plain version, gives the buffer
    the reference's scatter-add builds from the same plan; the Pallas
    kernel gives it too from the port's slot→token map; and the plan is
    the one the reference's sort stage makes from the JAX router."""
    rng = np.random.default_rng(3)
    b, t, d = 2, 32, 128
    jcfg = JMoEConfig(n_experts=4, top_k=2, d_ff_expert=64, capacity_factor=cf)
    cfg = MoEConfig(n_experts=4, top_k=2, d_ff_expert=64, capacity_factor=cf)
    xn = rng.standard_normal((b, t, d)).astype(np.float32)
    wn = (rng.standard_normal((d, cfg.n_experts)) * 0.1).astype(np.float32)
    c = capacity(t, cfg)
    assert c == jcapacity(t, jcfg)
    _, top_ids = router_topk(torch.from_numpy(xn), torch.from_numpy(wn), cfg)
    _, jtop_ids = jrouter_topk(jnp.asarray(xn), jnp.asarray(wn), jcfg)
    np.testing.assert_array_equal(top_ids.numpy(), np.asarray(jtop_ids))
    plan = dispatch_plan(top_ids, cfg.n_experts, c)

    # the reference's sort stage, per row, in numpy
    e_, k = cfg.n_experts, cfg.top_k
    for r in range(b):
        flat_ids = np.asarray(jtop_ids[r]).reshape(-1)
        order = np.argsort(flat_ids, kind="stable")
        s_ids = flat_ids[order]
        pos = np.arange(t * k) - np.searchsorted(s_ids, np.arange(e_), side="left")[s_ids]
        np.testing.assert_array_equal(plan.order[r].numpy(), order)
        np.testing.assert_array_equal(plan.s_ids[r].numpy(), s_ids)
        np.testing.assert_array_equal(plan.s_tok[r].numpy(), np.repeat(np.arange(t), k)[order])
        np.testing.assert_array_equal(plan.keep[r].numpy(), pos < c)
    if cf == 1.0:
        assert not plan.keep.all()                           # tokens drop at capacity 8
    else:
        assert plan.keep.all()

    x = torch.from_numpy(xn)
    buf = ops.moe_dispatch_gather(x.reshape(b * t, d), plan.slot_tok).view(b, e_, c, d)
    scatter = torch.zeros((b, e_, c, d))
    rows = torch.arange(b)[:, None].expand(b, t * k)
    safe_e = torch.where(plan.keep, plan.s_ids.long(), 0)
    safe_c = torch.where(plan.keep, plan.pos_in_grp, 0)
    gathered = torch.where(plan.keep[..., None], x[rows, plan.s_tok], 0.0)
    scatter.index_put_((rows, safe_e, safe_c), gathered, accumulate=True)
    assert torch.equal(buf, scatter)
    pallas = jops.moe_dispatch_gather(jnp.asarray(xn.reshape(b * t, d)),
                                      jnp.asarray(plan.slot_tok.numpy()))
    np.testing.assert_array_equal(buf.reshape(-1, d).numpy(), np.asarray(pallas))


def test_wrapper_validates_the_hint():
    """The layout hint must split S into B·E·C and T into B rows; a
    consistent hint leaves the result as it is."""
    x = torch.arange(6 * 4, dtype=torch.float32).view(6, 4)
    tok = torch.tensor([0, 2, 6, 6, 1, 6, 6, 6, 3, 4, 6, 6, 5, 6, 6, 6] * 3, dtype=torch.int32)
    want = ref.moe_dispatch_gather_ref(x, tok)
    for group, experts in ((4, 2), (2, 4), (8, 1), (1, 8), (4, 4), (2, 12)):
        assert torch.equal(moe_dispatch_gather(x, tok, group=group, experts=experts), want)
    with pytest.raises(ValueError, match="slots"):
        moe_dispatch_gather(x, tok, group=5, experts=2)              # 48 % 10
    with pytest.raises(ValueError, match="batch rows"):
        moe_dispatch_gather(x, tok, group=2, experts=6)              # B = 4, 6 % 4
    with pytest.raises(ValueError, match="batch rows"):
        moe_dispatch_gather(x, tok, group=3, experts=4)              # B = 4, 6 % 4
    with pytest.raises(ValueError, match="neither"):
        moe_dispatch_gather(x, tok, group=4)
    with pytest.raises(ValueError, match="neither"):
        moe_dispatch_gather(x, tok, experts=2)
    with pytest.raises(ValueError, match="positive"):
        moe_dispatch_gather(x, tok, group=0, experts=2)
    with pytest.raises(ValueError, match="positive"):
        moe_dispatch_gather(x, tok, group=-4, experts=-2)
    empty = torch.zeros(0, dtype=torch.int32)
    assert moe_dispatch_gather(torch.zeros((0, 4)), empty, group=8, experts=2).shape == (0, 4)
    with pytest.raises(ValueError, match="batch rows"):
        moe_dispatch_gather(x, empty, group=8, experts=2)            # no rows for 6 tokens


def test_front_door_passes_ready_operands_without_a_copy(monkeypatch):
    seen = []

    def spy(x, slot_tok, **hint):
        seen.append((x, slot_tok, hint))
        return ref.moe_dispatch_gather_ref(x, slot_tok)

    monkeypatch.setattr(ops, "_moe_dispatch_gather", spy)
    x = torch.randn(5, 8)
    tok = torch.tensor([4, 0, 5, 5], dtype=torch.int32)
    ops.moe_dispatch_gather(x, tok, group=2, experts=2)
    assert seen[-1][0] is x and seen[-1][1] is tok and seen[-1][2] == {"group": 2, "experts": 2}
    got = ops.moe_dispatch_gather(x.T.contiguous().T, tok.long())
    assert seen[-1][0].is_contiguous() and seen[-1][1].dtype == torch.int32
    assert seen[-1][2] == {"group": None, "experts": None}
    assert torch.equal(got, ref.moe_dispatch_gather_ref(x, tok))


@pytest.mark.parametrize("batched", [False, True])
def test_moe_sparse_passes_the_hint(monkeypatch, batched):
    """``moe_sparse`` hands kernel 7 its buffer's layout (C, E); the layer's
    output is identical with the hint dropped."""
    from repro_torch.models.moe import moe_sparse

    cfg = MoEConfig(n_experts=8, top_k=2, d_ff_expert=16, capacity_factor=1.0)
    rng = np.random.default_rng(7)
    d = 32
    w = {k: torch.from_numpy((rng.standard_normal(s) * 0.2).astype(np.float32)) for k, s in
         (("router", (d, 8)), ("w1", (8, d, 16)), ("w3", (8, d, 16)), ("w2", (8, 16, d)))}
    x = torch.from_numpy(rng.standard_normal((3, 40, d) if batched else (40, d)).astype(np.float32))
    real = ops.moe_dispatch_gather
    calls = []

    def spy(xf, slot_tok, **hint):
        calls.append((xf.shape, slot_tok.shape, hint))
        return real(xf, slot_tok, **hint)

    monkeypatch.setattr(ops, "moe_dispatch_gather", spy)
    y = moe_sparse(x, w["router"], w["w1"], w["w3"], w["w2"], cfg)
    b = 3 if batched else 1
    c = capacity(40, cfg)
    assert calls == [((b * 40, d), (b * 8 * c,), {"group": c, "experts": 8})]
    monkeypatch.setattr(ops, "moe_dispatch_gather", lambda xf, slot_tok, **hint: real(xf, slot_tok))
    assert torch.equal(moe_sparse(x, w["router"], w["w1"], w["w3"], w["w2"], cfg), y)


# (batch rows, tokens a row, experts, top-k, capacity factor): T = 1 and
# T > C, with drops where the factor is below 1
PLAN_CASES = [(1, 1, 4, 2, 1.0), (4, 1, 8, 2, 1.25), (3, 1, 16, 6, 1.0), (1, 40, 4, 2, 0.5),
              (2, 32, 4, 3, 0.25), (4, 24, 8, 2, 1.0), (3, 50, 8, 4, 0.5), (2, 64, 16, 6, 0.75),
              (1, 100, 2, 1, 0.25), (4, 17, 4, 4, 0.5)]


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_plan_is_ascending_in_each_group_with_pads_at_the_tail(case):
    """What the hint promises, over random routings with drops: within
    every group of C slots the kept tokens ascend and the pads (B·T) fill
    the tail. The plan stays the reference's sort stage, and the buffer
    the hinted gather fills equals the scatter the reference builds and
    the Pallas kernel's."""
    b, t, e, k, cf = case
    rng = np.random.default_rng(hash(case) % 2**31)
    cfg = MoEConfig(n_experts=e, top_k=k, d_ff_expert=8, capacity_factor=cf)
    c = capacity(t, cfg)
    assert c == jcapacity(t, JMoEConfig(n_experts=e, top_k=k, d_ff_expert=8,
                                        capacity_factor=cf))
    ids = np.argsort(rng.random((b, t, e)), axis=-1)[..., :k].astype(np.int32)
    plan = dispatch_plan(torch.from_numpy(ids), e, c)
    groups = plan.slot_tok.view(b, e, c).numpy()
    for r in range(b):
        for g in range(e):
            grp = groups[r, g]
            kept = grp[grp != b * t]
            assert np.all(np.diff(kept) > 0)                               # ascending
            assert np.all(grp[len(kept):] == b * t)                        # pads at the tail
            assert np.all((kept >= r * t) & (kept < (r + 1) * t))          # its own row's tokens
    # the reference's sort stage, per row, in numpy, gives the same slots
    want = np.full(b * e * c, b * t, np.int32)
    for r in range(b):
        flat = ids[r].reshape(-1)
        order = np.argsort(flat, kind="stable")
        s_ids = flat[order]
        pos = np.arange(t * k) - np.searchsorted(s_ids, np.arange(e), side="left")[s_ids]
        keep = pos < c
        want[(r * e + s_ids[keep]) * c + pos[keep]] = r * t + order[keep] // k
    np.testing.assert_array_equal(plan.slot_tok.numpy(), want)
    if cf < 1.0 and t > c:
        assert not plan.keep.all()
    d = 128
    xn = rng.standard_normal((b * t, d)).astype(np.float32)
    x = torch.from_numpy(xn)
    buf = moe_dispatch_gather(x, plan.slot_tok, group=c, experts=e)
    scatter = np.zeros((b * e * c, d), np.float32)
    hit = want < b * t
    scatter[hit] = xn[want[hit]]
    np.testing.assert_array_equal(buf.numpy(), scatter)
    pallas = jops.moe_dispatch_gather(jnp.asarray(xn), jnp.asarray(want))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(pallas))
