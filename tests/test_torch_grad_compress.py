"""The port's int8 error-feedback compression held to the JAX package's
``repro.train.grad_compress``.

``quantize_int8`` and ``dequantize_int8`` bit for bit, the all-zero
input (scale 1e-12) and round-half-to-even ties included; the
reference's two property tests (``tests/test_train.py``) as port tests;
``compressed_stacked_mean`` within rtol 1e-6; ``compressed_psum_mean``
over a pod axis of 2 and 4 devices against the reference's under a
fully manual ``jax.shard_map`` (a subprocess on 8 forced host devices):
the int8 codes that cross the axis (caught by a spy on the mesh's
``all_gather``, which must see int8) and the scales bit for bit, the mean
within rtol 1e-6, and every pod's own error-feedback buffer within rtol
1e-6 and atol 1e-6·max|carry| of the reference pod's (XLA contracts the
reference's carry − q·scale into one fused multiply-add, a last-bit
difference where the two nearly cancel).
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.train import grad_compress as jgc

from repro_torch.core.mesh import Mesh
from repro_torch.train import grad_compress as gc

hypothesis = pytest.importorskip("hypothesis")
given, settings, st = hypothesis.given, hypothesis.settings, hypothesis.strategies

REPO_SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _inputs():
    rng = np.random.default_rng(0)
    yield np.zeros(17, np.float32)
    yield np.array([127.0, 63.5, -63.5, 0.5, -0.5, 1.5, 2.5, -1.0], np.float32)   # ties
    yield np.array([1e-30, -3e-31, 0.0], np.float32)
    for e in (-3, 0, 3):
        yield (rng.standard_normal((8, 33)) * 10.0 ** e).astype(np.float32)


@pytest.mark.parametrize("i", range(6))
def test_quantize_bit_for_bit(i):
    x = list(_inputs())[i]
    q, s = gc.quantize_int8(torch.from_numpy(x))
    jq, js = jgc.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    d = gc.dequantize_int8(q, s).numpy()
    assert d.tobytes() == np.asarray(jgc.dequantize_int8(jq, js)).tobytes()


@given(st.integers(0, 2 ** 31 - 1))
@settings(max_examples=20, deadline=None)
def test_property_int8_quant_roundtrip_bounded(seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal(64) * 10 ** rng.uniform(-3, 3)).astype(np.float32))
    q, s = gc.quantize_int8(x)
    err = (gc.dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-9     # half a step of the int8 grid


def test_error_feedback_mean_converges():
    """The running sum of compressed outputs tracks the true running sum
    (error carried, never lost), the 1-bit-Adam lemma at 8 bits."""
    rng = np.random.default_rng(1)
    ef = torch.zeros(32)
    out_sum, true_sum = np.zeros(32), np.zeros(32)
    for _ in range(30):
        g = torch.from_numpy(rng.standard_normal(32).astype(np.float32))
        carry = g + ef
        q, s = gc.quantize_int8(carry)
        deq = gc.dequantize_int8(q, s)
        ef = carry - deq
        out_sum += deq.numpy()
        true_sum += g.numpy()
        assert np.abs(out_sum + ef.numpy() - true_sum).max() < 1e-4
    assert np.abs(out_sum - true_sum).max() <= float(s) + 1e-5


def test_stacked_mean_and_ef_init():
    rng = np.random.default_rng(2)
    g = rng.standard_normal((4, 6, 5)).astype(np.float32)
    e = (rng.standard_normal((6, 5)) * 1e-2).astype(np.float32)
    mean, ef = gc.compressed_stacked_mean(torch.from_numpy(g), torch.from_numpy(e))
    jmean, jef = jgc.compressed_stacked_mean(jnp.asarray(g), jnp.asarray(e))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ef.numpy(), np.asarray(jef), rtol=1e-6, atol=1e-9)
    tm, te = gc.compressed_tree_stacked_mean({"a": {"b": torch.from_numpy(g)}},
                                             {"a": {"b": torch.from_numpy(e)}})
    assert torch.equal(tm["a"]["b"], mean) and torch.equal(te["a"]["b"], ef)
    z = gc.ef_init({"w": torch.ones(3, 2, dtype=torch.bfloat16), "n": {"v": torch.ones(4)}})
    assert z["w"].dtype == torch.float32 and z["w"].shape == (3, 2) and not z["n"]["v"].any()


PSUM_WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.train.grad_compress import compressed_psum_mean, quantize_int8
out = {}
rng = np.random.default_rng(3)
for n in (2, 4):
    mesh = Mesh(np.array(jax.devices()[:n]), ("pod",))
    x = (rng.standard_normal((n, 7, 9)) * np.array([1, 1e-3, 30, 2][:n])[:, None, None]
         ).astype(np.float32)
    e = (rng.standard_normal((n, 7, 9)) * 1e-2).astype(np.float32)

    def body(xb, eb):
        mean, new_ef = compressed_psum_mean(xb[0], eb[0], "pod")
        q, s = quantize_int8(xb[0] + eb[0])
        return mean[None], new_ef[None], q[None], s[None]

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("pod"), P("pod")),
                              out_specs=(P("pod"),) * 4, check_vma=False))
    for k, v in zip(("x", "e", "mean", "ef", "q", "s"), (x, e, *f(x, e))):
        out[f"{n}/{k}"] = np.asarray(v)
np.savez(sys.argv[1], **out)
print("PSUM_OK", len(out))
"""


@pytest.fixture(scope="module")
def psum_reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("psum") / "psum.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_SRC + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", PSUM_WORKER, str(path)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "PSUM_OK" in res.stdout, res.stdout + res.stderr[-3000:]
    return dict(np.load(path))


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_psum_mean_matches_the_reference(psum_reference, n):
    ref = {k.split("/")[1]: v for k, v in psum_reference.items() if k.startswith(f"{n}/")}
    mesh = Mesh((n,), ("pod",), device="cpu")
    wire = []
    gather = mesh.all_gather

    def spy(x, axis, dim=1):
        wire.append(x)
        return gather(x, axis, dim)

    mesh.all_gather = spy
    mean, ef = gc.compressed_psum_mean(torch.from_numpy(ref["x"]), torch.from_numpy(ref["e"]),
                                       "pod", mesh)
    codes, scales = wire
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    np.testing.assert_array_equal(codes[:, 0].numpy(), ref["q"])
    assert scales[:, 0].numpy().tobytes() == ref["s"].tobytes()
    np.testing.assert_allclose(mean.numpy(), ref["mean"], rtol=1e-6, atol=1e-7)
    for p in range(n):   # each pod's own buffer, to ulps of its carry (XLA fuses x + e − q·s)
        carry = np.abs(ref["x"][p] + ref["e"][p]).max()
        np.testing.assert_allclose(ef[p].numpy(), ref["ef"][p], rtol=1e-6, atol=1e-6 * carry)
        assert torch.equal(mean[p], mean[0])
    means, efs = gc.compressed_tree_psum_mean({"a": {"b": torch.from_numpy(ref["x"])}},
                                              {"a": {"b": torch.from_numpy(ref["e"])}}, "pod",
                                              Mesh((n,), ("pod",), device="cpu"))
    assert torch.equal(means["a"]["b"], mean) and torch.equal(efs["a"]["b"], ef)
