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
    before = moe_dispatch_gather.launches
    got = ops.moe_dispatch_gather(tx, torch.from_numpy(tok))
    assert moe_dispatch_gather.launches == before            # CPU: plain version, no launch
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
    with pytest.raises(ValueError, match="no kernel"):
        moe_dispatch_gather(x.to("meta"), tok.to("meta"))


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
