"""The port's sharding layer held to the JAX package's.

``spec_for``, ``param_shardings`` and ``zero1_shardings`` give every leaf
of every config's spec tree the reference's spec, entry for entry, and
the reference's ``NamedSharding.shard_shape``, on the production meshes
(16, 16) and (2, 16, 16) and the test meshes (2, 2, 2), (4, 1) and
(1, 8); so do ``cache_shardings`` and ``serve_shardings``. The reference
side builds its shardings over ``jax.sharding.AbstractMesh``, which needs
no devices. The three-axis ``Mesh`` primitives (``all_gather``,
``ppermute``, ``all_to_all``, ``axis_index`` over every ordered subset of
the axes) are held bit for bit to ``jax.lax``'s collectives under a fully
manual ``shard_map`` in a subprocess on 8 forced host devices. Then the
blocks themselves: ``Sharded`` round trips, copies on the axes a spec
leaves out, ``shard_state``/``unshard_state``, the ZeRO-1 leaves that
add the data axis, and the layout hints returning their inputs.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from repro.distributed import sharding as jsharding
from repro.models import zoo as jzoo
from repro.models.transformer import BODY_REGISTRY, Model as JModel
from repro.serve.engine import serve_shardings as jserve_shardings
from repro.serve.kv_cache import cache_shardings as jcache_shardings

from repro_torch.core.mesh import Mesh
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import (
    NamedSharding, Sharded, param_shardings, shard_state, spec_for, unshard_state,
    zero1_shardings,
)
from repro_torch.launch import mesh as lmesh
from repro_torch.models import zoo
from repro_torch.models.params import spec_leaves
from repro_torch.models.transformer import build_model, model_specs
from repro_torch.serve.engine import serve_shardings
from repro_torch.serve.kv_cache import cache_shardings

REPO_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2, 2), ("pod", "data", "model")), ((4, 1), ("data", "model")),
          ((1, 8), ("data", "model"))]


def _pairs(jtree, ptree, leaf_type):
    """(key path, reference leaf, port leaf) of two trees of one layout."""
    jl = {jax.tree_util.keystr(p): v for p, v in
          jax.tree_util.tree_flatten_with_path(jtree, is_leaf=lambda x: isinstance(x, leaf_type))[0]}
    pl = {_reference_key(k): v for k, v in _port_flat(ptree)}
    assert set(jl) == set(pl), (set(jl) ^ set(pl))
    return [(k, jl[k], pl[k]) for k in sorted(jl)]


def _reference_key(key: str) -> str:
    """A port cache key as the reference spells it: its recurrent caches
    are a dict {"conv", "gla"} and, for the sLSTM, a pair (c, n), where the
    port's are ``SSMCache`` and ``SLSTMState``."""
    key = key.replace(".conv", "['conv']").replace(".gla", "['gla']")
    if key.startswith("['slstm']"):
        key = key.replace(".c", "[0]").replace(".n", "[1]")
    return key


def _port_flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_flat(v, f"{prefix}['{k}']")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            yield from _port_flat(v, f"{prefix}.{f}")
    else:
        yield prefix, tree


@pytest.fixture(autouse=True)
def fresh_dense_body():
    """The reference registers its dense-layer body once per process, with
    the ``d_ff_dense`` of the first config it plans (a reduced one, when
    another test in this worker planned one first); drop it, so each test
    plans its own config's width (as ``tests/test_torch_lm.py`` does)."""
    BODY_REGISTRY.pop("mla_mlp_dense", None)


@pytest.mark.parametrize("arch", jzoo.ARCH_IDS)
def test_param_and_zero1_specs_equal_the_reference(arch):
    jspecs = JModel(jzoo.get_config(arch)).specs()
    specs = model_specs(zoo.get_config(arch))
    for shape, names in MESHES:
        jmesh = AbstractMesh(shape, names)
        mesh = Mesh(shape, names, device="cpu")
        jp, jz = jsharding.param_shardings(jmesh, jspecs), jsharding.zero1_shardings(jmesh, jspecs)
        pp, pz = param_shardings(mesh, specs), zero1_shardings(mesh, specs)
        for (k, jps, pps), (_, jzs, pzs) in zip(_pairs(jp, pp, jax.sharding.NamedSharding),
                                               _pairs(jz, pz, jax.sharding.NamedSharding)):
            assert pps.spec == tuple(jps.spec), (shape, k, pps.spec, jps.spec)
            assert pzs.spec == tuple(jzs.spec), (shape, k, pzs.spec, jzs.spec)
        for name, s in spec_leaves(specs):
            want = jsharding.spec_for(jmesh, s.shape, s.dims)
            got = spec_for(mesh, s.shape, s.dims)
            assert got == tuple(want), (shape, name)
            jps = jax.sharding.NamedSharding(jmesh, want)
            assert NamedSharding(mesh, got).shard_shape(s.shape) == jps.shard_shape(s.shape)
        for (k, jzs, pzs) in _pairs(jz, pz, jax.sharding.NamedSharding):
            leaf = _leaf_shape(jspecs, k)
            assert pzs.shard_shape(leaf) == jzs.shard_shape(leaf), (shape, k)


def _leaf_shape(jspecs, key: str):
    node = jspecs
    for k in key[2:-2].split("']['"):
        node = node[k]
    return node.shape


@pytest.mark.parametrize("arch", jzoo.ARCH_IDS)
def test_cache_and_serve_shardings_equal_the_reference(arch):
    jcfg, cfg = jzoo.get_config(arch), zoo.get_config(arch)     # an encoder's caches are {}
    for shape, names in MESHES:
        jmesh, mesh = AbstractMesh(shape, names), Mesh(shape, names, device="cpu")
        for batch in (8, 32):
            jc = jcache_shardings(jmesh, jcfg, batch, 64)
            pc = cache_shardings(mesh, cfg, batch, 64)
            for k, j, p in _pairs(jc, pc, jax.sharding.NamedSharding):
                assert p.spec == tuple(j.spec), (shape, batch, k, p.spec, j.spec)
        jp, jc, jt = jserve_shardings(jmesh, JModel(jcfg), 32, 64)
        model = build_model(cfg, device="meta")
        pp, pc, pt = serve_shardings(mesh, model, 32, 64)
        assert pt.spec == tuple(jt.spec)
        for k, j, p in _pairs(jp, pp, jax.sharding.NamedSharding) + _pairs(
                jc, pc, jax.sharding.NamedSharding):
            assert p.spec == tuple(j.spec), (shape, k)


def test_the_rules_and_hints():
    assert sharding.RULES == jsharding.RULES
    from repro.train.train_loop import batch_sharding as jbatch_sharding
    from repro_torch.train.train_loop import batch_sharding
    batch = {"tokens": np.zeros((8, 16), np.int32), "frames": np.zeros((8, 16, 4), np.float32)}
    for shape, names in MESHES:
        want = jbatch_sharding(AbstractMesh(shape, names), batch)
        got = batch_sharding(Mesh(shape, names, device="cpu"), batch)
        assert {k: v.spec for k, v in got.items()} == {k: tuple(v.spec) for k, v in want.items()}
    mesh = lmesh.small_mesh(2, 2, 2, device="cpu")
    assert sharding.axis_size(mesh, "pod") == 2 and sharding.axis_size(mesh, "seq") == 1
    x, q = torch.ones(4, 3), torch.zeros(2, 5, 4, 8)
    sharding.set_activation_mesh(mesh)
    try:
        assert sharding.activation_mesh() is mesh
        assert sharding.constrain(x, [("pod", "data")]) is x
        assert sharding.constrain_block_out(x) is x
        tree = {"a": x}
        assert sharding.constrain_batch_tree(tree) is tree
        assert all(a is b for a, b in zip(sharding.constrain_attention(q, q, q), (q, q, q)))
    finally:
        sharding.set_activation_mesh(None)
    assert sharding.activation_mesh() is None


def test_blocks_round_trip_with_copies():
    mesh = Mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    full = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    for spec in [(), ("data",), (None, "model"), (("pod", "data"), None, "model"),
                 ("model", None, ("data", "pod"))]:
        s = Sharded.of(full, NamedSharding(mesh, spec))
        assert s.block_shape == NamedSharding(mesh, spec).shard_shape(full.shape)
        assert torch.equal(s.full(), full)
        used = {a for e in spec for a in sharding.entry_axes(e)}
        grid = s.blocks.view(2, 2, 2, *s.block_shape)
        for i, a in enumerate(mesh.axis_names):      # copies along every axis left out
            if a not in used:
                assert torch.equal(grid.select(i, 0), grid.select(i, 1))
        prim = NamedSharding(mesh, spec).primary_devices()
        assert len(prim) == 8 // 2 ** (3 - len(used))
    # a block of device g is the slice its coordinates name (row-major ids)
    s = Sharded.of(full, NamedSharding(mesh, (("pod", "data"), None, "model")))
    for g in range(8):
        p, d, m = g // 4, (g // 2) % 2, g % 2
        assert torch.equal(s.blocks[g], full[(2 * p + d) * 2:(2 * p + d + 1) * 2, :, m * 2:m * 2 + 2])
    # the pod axis kept: one tensor per pod
    pods = torch.stack([full, full + 1])
    blocks = mesh.scatter_full(pods, ("data",), keep="pod")
    assert torch.equal(mesh.gather_full(blocks, ("data",), keep="pod"), pods)
    assert torch.equal(blocks[4], pods[1, :4])
    with pytest.raises(ValueError):
        Sharded.of(torch.ones(3, 4), NamedSharding(mesh, ("data",)))


def test_state_round_trip_and_zero1_leaves():
    cfg = zoo.reduced_config("deepseek-v2-lite-16b")
    model = build_model(cfg, device="cpu").init(seed=0)
    mesh = lmesh.small_mesh(2, 2, device="cpu")
    specs = model_specs(cfg)
    from repro_torch.convert import stack_model_params
    tree = stack_model_params(cfg, dict(model.named_parameters()))
    p_sh, z_sh = param_shardings(mesh, specs), zero1_shardings(mesh, specs)
    blocks = shard_state(tree, p_sh)
    back = unshard_state(blocks)
    flat_p, flat_z = dict(_port_flat(p_sh)), dict(_port_flat(z_sh))
    added = 0
    for k, v in _port_flat(tree):
        assert torch.equal(dict(_port_flat(back))[k], v)
        p, z = flat_p[k].spec, flat_z[k].spec
        if p != z:        # ZeRO-1 splits a leaf the parameters keep whole on data
            added += 1
            assert "data" not in {a for e in p for a in sharding.entry_axes(e)}
            assert sum(1 for e in z if e == "data") == 1
    assert added > 0      # the kv_lora norm at least
    assert flat_z["['moe_layers']['attn']['kv_norm']"].spec == (None, "data")


def test_mesh_axes_are_row_major():
    mesh = Mesh((2, 3, 2), ("pod", "data", "model"), device="cpu")
    g = np.arange(12).reshape(2, 3, 2)
    assert np.array_equal(mesh._members("data"), g.transpose(0, 2, 1).reshape(-1, 3))
    assert np.array_equal(mesh._members(("pod", "data")), g.transpose(2, 0, 1).reshape(-1, 6))
    assert np.array_equal(mesh._members(("model", "pod")), g.transpose(1, 2, 0).reshape(-1, 4))
    assert mesh.axis_size(("pod", "model")) == 4
    for bad in ("dr", ("data", "data"), ()):
        with pytest.raises(ValueError):
            mesh._members(bad)
    with pytest.raises(ValueError):
        Mesh((2, 2, 2, 2), ("a", "b", "c", "d"), device="cpu")


PRIMITIVES_WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
ALL = ("pod", "data", "model")
mesh = jax.make_mesh((2, 2, 2), ALL, axis_types=(jax.sharding.AxisType.Explicit,) * 3)
x = np.random.default_rng(0).standard_normal((8 * 8, 3)).astype(np.float32)
out = {"x": x}
def smap(f):
    return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=P(ALL), out_specs=P(ALL),
                                 check_vma=False))
for ax in eval(sys.argv[2]):
    name = "+".join((ax,) if isinstance(ax, str) else ax)
    n = int(np.prod([mesh.shape[a] for a in ((ax,) if isinstance(ax, str) else ax)]))
    out[f"all_gather/{name}"] = smap(lambda b: jax.lax.all_gather(b, ax, axis=0, tiled=True))(x)
    out[f"ppermute/{name}"] = smap(
        lambda b: jax.lax.ppermute(b, ax, [(i, (i + 1) % n) for i in range(n)]))(x)
    out[f"ppermute0/{name}"] = smap(lambda b: jax.lax.ppermute(b, ax, [(0, n - 1)]))(x)
    out[f"axis_index/{name}"] = smap(
        lambda b: jnp.full((1, 3), jax.lax.axis_index(ax), jnp.float32))(x)
    out[f"all_to_all/{name}"] = smap(lambda b: jax.lax.all_to_all(b, ax, 0, 0, tiled=True))(x)
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
print("PRIMITIVES_OK", len(out))
"""

AXES = ["pod", "data", "model", ("pod", "data"), ("data", "model"), ("pod", "model"),
        ("model", "pod"), ("pod", "data", "model")]


def test_three_axis_primitives_equal_jax_collectives(tmp_path):
    path = tmp_path / "prim.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_SRC + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", PRIMITIVES_WORKER, str(path), repr(AXES)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "PRIMITIVES_OK" in res.stdout, res.stdout + res.stderr[-3000:]
    ref = {k: torch.from_numpy(v) for k, v in np.load(path).items()}
    mesh = lmesh.small_mesh(2, 2, 2, device="cpu")
    x = ref["x"].reshape(8, 8, 3)             # device g's block: rows 8g..8g+7
    for ax in AXES:
        name = "+".join((ax,) if isinstance(ax, str) else ax)
        n = mesh.axis_size(ax)
        flat = lambda t: t.reshape(-1, 3)
        assert torch.equal(flat(mesh.all_gather(x, ax, dim=1)), ref[f"all_gather/{name}"]), name
        cyc = [(i, (i + 1) % n) for i in range(n)]
        assert torch.equal(flat(mesh.ppermute(x, ax, cyc)), ref[f"ppermute/{name}"]), name
        assert torch.equal(flat(mesh.ppermute(x, ax, [(0, n - 1)])), ref[f"ppermute0/{name}"])
        idx = mesh.axis_index(ax).float()[:, None].expand(8, 3)
        assert torch.equal(idx, ref[f"axis_index/{name}"]), name
        got = mesh.all_to_all(x.reshape(8, n, 8 // n, 3), ax)
        assert torch.equal(flat(got), ref[f"all_to_all/{name}"]), name
