"""The port's plain mesh step on DeepSeek (reduced, top-2 of 8 experts,
one dense and one MoE layer) held to the reference's on (pod 2, data 2,
model 2), as ``test_torch_mesh_train.py`` holds minitron: the sparse
dispatch (kernel 7's plain version and its transpose) under the expert-
parallel regime, and the load-balance loss of each whole microbatch.
Also the regime itself: ``_ep_regime`` equal to the reference's for every
config on every mesh, and the port's one routing form equal to both of
the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from repro.distributed import sharding as jsharding
from repro.models import moe as jmoe
from repro.models import zoo as jzoo

from repro_torch.core.mesh import Mesh
from repro_torch.distributed.sharding import set_activation_mesh
from repro_torch.models import moe, zoo
from test_torch_mesh_train import hold_steps, one_torch_thread, port_config  # noqa: F401
from test_torch_sharding import MESHES


@pytest.fixture(autouse=True)
def no_activation_mesh():
    yield
    set_activation_mesh(None)
    jsharding.set_activation_mesh(None)


def test_deepseek_plain_mesh_step_matches_the_reference(tmp_path):
    hold_steps(tmp_path, "deepseek-v2-lite-16b", 2, 0, "plain")


@pytest.mark.parametrize("arch", [a for a in jzoo.ARCH_IDS if jzoo.get_config(a).moe])
def test_ep_regime_equals_the_reference(arch):
    jcfg, cfg = jzoo.get_config(arch), zoo.get_config(arch)
    assert not moe._ep_regime(cfg.moe)
    for shape, names in MESHES + [((2, 3), ("data", "model"))]:
        jsharding.set_activation_mesh(AbstractMesh(shape, names))
        set_activation_mesh(Mesh(shape, names, device="cpu"))
        assert moe._ep_regime(cfg.moe) == jmoe._ep_regime(jcfg.moe), (arch, shape)


@pytest.mark.parametrize("shape,names", [(None, None), ((2, 2, 2), ("pod", "data", "model")),
                                         ((1, 3), ("data", "model"))])
def test_moe_ffn_equals_both_reference_forms(shape, names):
    """Under an EP mesh, a mesh whose model axis does not divide the
    experts, and no mesh, the port's one routing form equals both of the
    reference's: per-row ``vmap`` (the EP regime) and natively batched."""
    arch = "deepseek-v2-lite-16b"
    jcfg = dataclasses.replace(jzoo.reduced_config(arch, 0.05).moe, top_k=2, n_shared=0)
    full = port_config(arch, 2, 0)
    cfg = dataclasses.replace(full.moe, n_shared=0)
    d, e, f = full.d_model, cfg.n_experts, cfg.d_ff_expert
    rng = np.random.default_rng(0)
    shapes = {"router": (d, e), "w1": (e, d, f), "w3": (e, d, f), "w2": (e, f, d)}
    w = {k: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)
         for k, s in shapes.items()}
    x = rng.standard_normal((2, 16, d)).astype(np.float32)
    jw = [jnp.asarray(w[k]) for k in ("router", "w1", "w3", "w2")]

    def routed(xt):
        return jmoe.moe_sparse(xt, *jw, jcfg)

    forms = [np.asarray(jax.vmap(routed)(jnp.asarray(x))), np.asarray(routed(jnp.asarray(x)))]
    set_activation_mesh(None if shape is None else Mesh(shape, names, device="cpu"))
    got = moe.moe_ffn(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in w.items()},
                      cfg).numpy()
    for want in forms:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
