"""The port's sub-quadratic mixers (``repro_torch.models.ssm``) held to the
JAX package's (``repro.models.ssm``) on the same numpy inputs, in f32,
within rtol 1e-5, atol 1e-6: the chunked GLA in both ``normalize`` modes
with a padded last chunk and a carried state, its single step, the causal
conv with and without state, and the sLSTM scan (a Hillis–Steele scan in
the port, the reference's associative scan) with a carried state up to
T = 300, and its step. The port's own chunked GLA against its step run
token by token, at the reference's tolerance for that pair (rtol 2e-4,
atol 2e-5, ``tests/test_numerics.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models import ssm

RTOL, ATOL = 1e-5, 1e-6
J_GLA = jax.jit(jssm.gla_chunked, static_argnames=("chunk", "normalize"))
J_SLSTM = jax.jit(jssm.slstm_scan)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(got, torch.Tensor) else got),
                               np.asarray(want, np.float32), rtol=rtol, atol=atol)


def t_(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _gla_inputs(rng, b, t, h, dk, dv):
    """q, k at the scale of a projected head (std 1/√dk for k), v normal,
    g ≤ 0 a log-sigmoid decay."""
    q = rng.standard_normal((b, t, h, dk)).astype(np.float32)
    k = (rng.standard_normal((b, t, h, dk)) / np.sqrt(dk)).astype(np.float32)
    v = rng.standard_normal((b, t, h, dv)).astype(np.float32)
    g = -np.logaddexp(0.0, -(rng.standard_normal((b, t, h)) + 1.0)).astype(np.float32)
    return q, k, v, g


def _state(rng, b, h, dk, dv):
    return (rng.standard_normal((b, h, dk, dv)).astype(np.float32),
            np.abs(rng.standard_normal((b, h, dk))).astype(np.float32))


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("t,chunk,carried", [(37, 16, False), (37, 16, True), (9, 32, True),
                                              (64, 16, False)])
def test_gla_chunked_matches_the_reference(normalize, t, chunk, carried):
    rng = np.random.default_rng(t + chunk + carried)
    b, h, dk, dv = 2, 3, 8, 6
    q, k, v, g = _gla_inputs(rng, b, t, h, dk, dv)
    st = _state(rng, b, h, dk, dv) if carried else None
    want_y, want_st = J_GLA(*map(jnp.asarray, (q, k, v, g)), chunk=chunk, normalize=normalize,
                            state=None if st is None else jssm.GLAState(*map(jnp.asarray, st)))
    y, got_st = ssm.gla_chunked(t_(q), t_(k), t_(v), t_(g), chunk=chunk, normalize=normalize,
                                state=None if st is None else ssm.GLAState(*map(t_, st)))
    assert y.dtype == torch.float32 and tuple(y.shape) == (b, t, h, dv)
    close(y, want_y)
    close(got_st.s, want_st.s)
    close(got_st.n, want_st.n)
    assert got_st.s.dtype == got_st.n.dtype == torch.float32


def test_gla_chunked_returns_v_dtype_and_keeps_an_f32_state():
    """bf16 inputs: y comes back in v's dtype, the state in f32, both
    within bf16 rounding of the f32 run on the same (rounded) inputs."""
    rng = np.random.default_rng(5)
    q, k, v, g = (t_(a) for a in _gla_inputs(rng, 2, 20, 2, 8, 8))
    qb, kb, vb = (a.to(torch.bfloat16) for a in (q, k, v))
    y, st = ssm.gla_chunked(qb, kb, vb, g, chunk=8, normalize=True)
    y32, st32 = ssm.gla_chunked(qb.float(), kb.float(), vb.float(), g, chunk=8, normalize=True)
    assert y.dtype == torch.bfloat16 and st.s.dtype == st.n.dtype == torch.float32
    torch.testing.assert_close(y.float(), y32.to(torch.bfloat16).float(), rtol=0, atol=0)
    torch.testing.assert_close(st.s, st32.s, rtol=0, atol=0)


@pytest.mark.parametrize("normalize", [False, True])
def test_gla_step_matches_the_reference(normalize):
    rng = np.random.default_rng(2)
    b, h, dk, dv = 3, 4, 8, 5
    q, k, v, g = (a[:, 0] for a in _gla_inputs(rng, b, 1, h, dk, dv))
    st = _state(rng, b, h, dk, dv)
    want_y, want_st = jssm.gla_step(*map(jnp.asarray, (q, k, v, g)),
                                    jssm.GLAState(*map(jnp.asarray, st)), normalize=normalize)
    y, got_st = ssm.gla_step(t_(q), t_(k), t_(v), t_(g), ssm.GLAState(*map(t_, st)),
                             normalize=normalize)
    close(y, want_y)
    close(got_st.s, want_st.s)
    close(got_st.n, want_st.n)


@pytest.mark.parametrize("normalize", [False, True])
def test_gla_chunked_equals_its_step_recurrence(normalize):
    """The port's chunked form against its own step, token by token, from
    a carried state: outputs and final state."""
    rng = np.random.default_rng(3)
    b, t, h, dk, dv = 2, 23, 2, 6, 4
    q, k, v, g = (t_(a) for a in _gla_inputs(rng, b, t, h, dk, dv))
    st0 = ssm.GLAState(*map(t_, _state(rng, b, h, dk, dv)))
    y_par, st_par = ssm.gla_chunked(q, k, v, g, chunk=8, state=st0, normalize=normalize)
    st, ys = st0, []
    for i in range(t):
        y, st = ssm.gla_step(q[:, i], k[:, i], v[:, i], g[:, i], st, normalize=normalize)
        ys.append(y)
    close(y_par, torch.stack(ys, 1), rtol=2e-4, atol=2e-5)
    close(st_par.s, st.s, rtol=2e-4, atol=2e-5)
    close(st_par.n, st.n, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("t", [1, 11])
def test_causal_conv1d_matches_the_reference(with_state, t):
    rng = np.random.default_rng(4 + t)
    b, c, kw = 2, 10, 4
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    w = rng.standard_normal((kw, c)).astype(np.float32)
    st = rng.standard_normal((b, kw - 1, c)).astype(np.float32) if with_state else None
    want_y, want_st = jssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                         None if st is None else jnp.asarray(st))
    y, got_st = ssm.causal_conv1d(t_(x), t_(w), None if st is None else t_(st))
    close(y, want_y)
    assert tuple(got_st.shape) == (b, kw - 1, c)
    np.testing.assert_array_equal(got_st.numpy(), np.asarray(want_st))


def _slstm_inputs(rng, b, t, c):
    f = rng.uniform(0.1, 0.99, (b, t, c)).astype(np.float32)
    i = rng.uniform(0.05, 0.95, (b, t, c)).astype(np.float32)
    z = np.tanh(rng.standard_normal((b, t, c))).astype(np.float32)
    o = rng.uniform(0.1, 1.0, (b, t, c)).astype(np.float32)
    return f, i, z, o


@pytest.mark.parametrize("t", [1, 2, 5, 64, 300])
@pytest.mark.parametrize("carried", [False, True])
def test_slstm_scan_matches_the_reference(t, carried):
    rng = np.random.default_rng(t)
    b, c = 2, 12
    f, i, z, o = _slstm_inputs(rng, b, t, c)
    st = ((rng.standard_normal((b, c)).astype(np.float32),
           rng.uniform(0.5, 3.0, (b, c)).astype(np.float32)) if carried else None)
    want_y, (want_c, want_n) = J_SLSTM(*map(jnp.asarray, (f, i, z, o)),
                                       None if st is None else tuple(map(jnp.asarray, st)))
    y, (c_, n_) = ssm.slstm_scan(*map(t_, (f, i, z, o)), None if st is None else tuple(map(t_, st)))
    assert y.dtype == torch.float32 and c_.dtype == n_.dtype == torch.float32
    close(y, want_y)
    close(c_, want_c)
    close(n_, want_n)


def test_slstm_step_matches_the_reference():
    rng = np.random.default_rng(6)
    b, c = 3, 9
    f, i, z, o = (a[:, 0] for a in _slstm_inputs(rng, b, 1, c))
    st = (rng.standard_normal((b, c)).astype(np.float32),
          rng.uniform(0.5, 3.0, (b, c)).astype(np.float32))
    want_y, (want_c, want_n) = jssm.slstm_step(*map(jnp.asarray, (f, i, z, o)),
                                               tuple(map(jnp.asarray, st)))
    y, (c_, n_) = ssm.slstm_step(*map(t_, (f, i, z, o)), tuple(map(t_, st)))
    close(y, want_y)
    close(c_, want_c)
    close(n_, want_n)
