"""The port's logical-axis partitioning (``repro_torch/partitioning.py``),
its mesh constructors (``repro_torch/launch/mesh.py``) and the model
facade's shape and axis functions against the JAX reference, on the CPU:

- the reference's four rule tests (``tests/test_partitioning.py``),
  with its ``FakeMesh``, against the port's ``resolve_spec`` and
  ``sharding_rules``;
- ``model_spec`` and ``param_axes`` (shapes, dtypes, logical axes of
  every leaf) for every config of ``configs/`` at f32 and bf16;
- ``cache_struct``, ``decode_cache_len``, ``supports_shape`` and
  ``input_specs`` for every config and every ``INPUT_SHAPES`` entry;
- ``tree_shardings`` and ``shard_local`` on a stand-in mesh, and the
  mesh constructors' refusal without enough ranks.

Nothing here allocates a model: the reference's stand-ins are
``ParamSpec``s and ``ShapeDtypeStruct``s, the port's ``(shape, dtype)``
pairs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import INPUT_SHAPES as JAX_SHAPES
from repro.models import model as JM
from repro.models.layers import is_spec
from repro.partitioning import resolve_spec as jax_resolve_spec
from repro.partitioning import sharding_rules as jax_sharding_rules
from repro_torch.configs import ALL_ARCH_IDS, get_config
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as M
from repro_torch.partitioning import (resolve_spec, shard_local,
                                      sharding_rules, tree_shardings,
                                      with_mesh_rules)

torch.set_num_threads(1)


class FakeMesh:
    axis_names = ("data", "model")

    class devices:
        shape = (4, 8)


# ---------------------------------------------------------------------------
# the reference's rule tests (tests/test_partitioning.py:19-41)
# ---------------------------------------------------------------------------

def test_resolve_divisible():
    rules = sharding_rules("train")
    spec = resolve_spec(("embed", "mlp"), (512, 1024), rules, FakeMesh())
    assert tuple(spec) == (None, "model")


def test_resolve_drops_nondivisible():
    rules = sharding_rules("decode")
    # 40 heads on an 8-way model axis shards; 9 heads does not
    s1 = resolve_spec(("q_heads",), (40,), rules, FakeMesh())
    s2 = resolve_spec(("q_heads",), (9,), rules, FakeMesh())
    assert tuple(s1) == ("model",)
    assert tuple(s2) == ()


def test_resolve_no_axis_reuse():
    rules = sharding_rules("train", fsdp=True)
    # both dims want 'data'-involving mappings; the second must not reuse it
    spec = resolve_spec(("embed", "embed"), (512, 512), rules, FakeMesh())
    assert tuple(spec) == ("data",)


def test_batch_axes_multi_pod():
    rules = sharding_rules("train", multi_pod=True)
    assert rules["act_batch"] == ("pod", "data")


@pytest.mark.parametrize("kw", [{}, {"multi_pod": True}, {"fsdp": True},
                                {"expert_2d": True},
                                {"fsdp": True, "multi_pod": True}],
                         ids=["plain", "multi_pod", "fsdp", "expert_2d",
                              "fsdp_multi_pod"])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_rules_and_specs_equal_the_reference(mode, kw):
    """The same rule table, and the same spec for every logical axis at
    dimensions that divide, do not divide, or divide by a prefix of a
    two-axis mapping."""
    rules = sharding_rules(mode, **kw)
    assert rules == jax_sharding_rules(mode, **kw)

    class Pod:
        axis_names = ("pod", "data", "model")

        class devices:
            shape = (2, 4, 8)
    for mesh in (FakeMesh(), Pod()):
        for ax in rules:
            for dims in ((64, 40), (9, 12), (4, 8), (128, 2)):
                axes = (ax, ax)
                assert resolve_spec(axes, dims, rules, mesh) == \
                    tuple(jax_resolve_spec(axes, dims, rules, mesh)), \
                    (ax, dims)


# ---------------------------------------------------------------------------
# the facade's shape and axis functions
# ---------------------------------------------------------------------------

def _dtype(dt) -> str:
    """A dtype's name, for either package."""
    if isinstance(dt, torch.dtype):
        return str(dt).split(".")[-1]
    return np.dtype(dt).name


def _jax_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _jax_leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, tuple) and not is_spec(tree) and tree and \
            not isinstance(tree[0], (str, type(None))):
        for i, v in enumerate(tree):
            yield from _jax_leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _port_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, tuple) and tree and isinstance(tree[0], tuple) \
            and not isinstance(tree, M.ParamStruct):
        for i, v in enumerate(tree):
            yield from _port_leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ALL_ARCH_IDS)
def test_model_spec_and_param_axes_equal_the_reference(arch, dtype):
    """Every parameter leaf: the same path, shape, dtype (f32 for the
    router and the SSM decay parameters) and logical axes."""
    jcfg, cfg = jax_config(arch), get_config(arch)
    want = dict(_jax_leaves(JM.model_spec(jcfg, getattr(jnp, dtype))))
    got = dict(_port_leaves(M.model_spec(cfg, getattr(torch, dtype))))
    assert sorted(got) == sorted(want)
    for path, spec in want.items():
        leaf = got[path]
        assert (tuple(leaf.shape), _dtype(leaf.dtype), tuple(leaf.axes)) \
            == (tuple(spec.shape), _dtype(spec.dtype), tuple(spec.axes)), \
            path
    jaxes = dict(_jax_leaves(JM.param_axes(jcfg)))
    taxes = dict(_port_leaves(M.param_axes(cfg)))
    assert taxes == {k: tuple(v) for k, v in jaxes.items()}


def _shapes():
    assert sorted(INPUT_SHAPES) == sorted(JAX_SHAPES)
    return sorted(INPUT_SHAPES)


@pytest.mark.parametrize("shape", _shapes())
@pytest.mark.parametrize("arch", ALL_ARCH_IDS)
def test_shape_functions_equal_the_reference(arch, shape):
    """``decode_cache_len``, ``supports_shape``, ``input_specs`` (shapes,
    dtypes, axes) and ``cache_struct`` at the shape's batch and cache
    length (shapes, dtypes, axes of every cache leaf), bf16 and f32."""
    jcfg, cfg = jax_config(arch), get_config(arch)
    jshape, tshape = JAX_SHAPES[shape], INPUT_SHAPES[shape]
    assert M.supports_shape(cfg, tshape) == JM.supports_shape(jcfg, jshape)
    seq = M.decode_cache_len(cfg, tshape)
    assert seq == JM.decode_cache_len(jcfg, jshape)
    want = JM.input_specs(jcfg, jshape)
    got = M.input_specs(cfg, tshape)
    assert got["axes"] == want["axes"]
    assert {k: (tuple(s), _dtype(d)) for k, (s, d) in got["specs"].items()} \
        == {k: (tuple(v.shape), _dtype(v.dtype))
            for k, v in want["specs"].items()}
    for dt in ("bfloat16", "float32"):
        jshapes, jaxes = JM.cache_struct(jcfg, jshape.global_batch, seq,
                                         getattr(jnp, dt))
        tshapes, taxes = M.cache_struct(cfg, tshape.global_batch, seq,
                                        getattr(torch, dt))
        assert taxes == jaxes
        assert {k: tuple((tuple(s), _dtype(d)) for s, d in v)
                for k, v in tshapes.items()} == \
            {k: tuple((tuple(x.shape), _dtype(x.dtype)) for x in v)
             for k, v in jshapes.items()}


# ---------------------------------------------------------------------------
# placement on a mesh
# ---------------------------------------------------------------------------

class _Rank(FakeMesh):
    """A (2, 2) stand-in mesh at one rank's coordinates."""

    class devices:
        shape = (2, 2)

    def __init__(self, data, model):
        self._coord = {"data": data, "model": model}

    def get_local_rank(self, axis):
        return self._coord[axis]


def test_tree_shardings_and_shard_local_cut_a_cache():
    """qwen2.5-14b's decode cache at decode_32k's length on a (2, 2)
    mesh: the batch over data, the sequence over model, the heads and
    layers whole; the four ranks' blocks tile the cache exactly."""
    cfg = get_config("qwen2.5-14b")
    rules = sharding_rules("decode")
    shapes, axes = M.cache_struct(cfg, 4, 32768)
    specs = tree_shardings(axes, shapes, rules, _Rank(0, 0))
    assert specs == {"kv": ((None, "data", "model"),) * 2}
    x = torch.arange(2 * 4 * 8 * 2).reshape(2, 4, 8, 2)
    spec = (None, "data", "model")
    blocks = {(d, m): shard_local(x, spec, _Rank(d, m))
              for d in range(2) for m in range(2)}
    assert all(b.shape == (2, 2, 4, 2) for b in blocks.values())
    whole = torch.cat([torch.cat([blocks[d, m] for m in range(2)], dim=2)
                       for d in range(2)], dim=1)
    assert torch.equal(whole, x)
    assert with_mesh_rules(rules, "mesh")["_mesh"] == "mesh"


def test_shard_cache_falls_back_where_the_model_axis_does_not_divide():
    """``shard_cache`` keeps a ``decode_cp`` cache whole, with the rules
    unchanged, when the model axis does not divide its length (the
    reference's plain-decode fallback), or for a config without
    ``decode_cp``; else it cuts each rank's block and records the whole
    cache's length in the rules it returns."""
    import dataclasses
    cfg = dataclasses.replace(get_config("chatglm-6b").reduced(),
                              decode_cp=True)
    rules = with_mesh_rules(sharding_rules("decode"), _Rank(1, 1))
    for c, s, cut in ((cfg, 8, True), (cfg, 7, False),
                      (dataclasses.replace(cfg, decode_cp=False), 8, False)):
        cache = M.init_cache(c, 2, s, dtype=torch.float32, device="cpu")
        local, r = M.shard_cache(c, cache, rules)
        if cut:
            assert r == dict(rules, _kv_len=s)
            assert local["kv"][0].shape[1:3] == (1, s // 2)
            assert local["kv"][0].is_contiguous()
        else:
            assert r is rules and "_kv_len" not in r
            assert local is cache


class _Pod:
    """A (pod 2, data 2, model 2) stand-in mesh at one rank's
    coordinates."""
    axis_names = ("pod", "data", "model")

    class devices:
        shape = (2, 2, 2)

    def __init__(self, pod, data, model):
        self._coord = {"pod": pod, "data": data, "model": model}

    def get_local_rank(self, axis):
        return self._coord[axis]


@pytest.mark.parametrize("rows", [2, 4, 8])
def test_shard_cache_rows_are_the_attention_rows(rows):
    """Under multi-pod rules (the batch over ("pod", "data")) the rows
    ``shard_cache`` keeps are the rows the context-parallel attention
    reads (``attention.batch_block``), on every rank: all of them where
    pod x data does not divide the batch (2 rows: the reference's
    ``bspec`` is None, though the pod axis alone divides it), else the
    rank's block.  Each (row, slot) is held by the four ranks of its
    model coordinate where the batch is whole, else by one rank."""
    import dataclasses
    from repro_torch.models.attention import batch_block
    cfg = dataclasses.replace(get_config("chatglm-6b").reduced(),
                              decode_cp=True)
    s = 8
    k = torch.arange(cfg.num_layers * rows * s * cfg.num_kv_heads
                     * cfg.head_dim, dtype=torch.float32).reshape(
        cfg.num_layers, rows, s, cfg.num_kv_heads, cfg.head_dim)
    cache = {"kv": (k, k.clone())}
    seen = torch.zeros(rows, s, dtype=torch.int64)
    for pod in range(2):
        for data in range(2):
            for model in range(2):
                mesh = _Pod(pod, data, model)
                rules = with_mesh_rules(
                    sharding_rules("decode", multi_pod=True), mesh)
                local, r = M.shard_cache(cfg, cache, rules)
                assert r["_kv_len"] == s
                b0, bl = batch_block(mesh, rows, rules["cache_batch"])
                assert bl == (rows if rows % 4 else rows // 4)
                want = k[:, b0:b0 + bl, model * s // 2:(model + 1) * s // 2]
                assert torch.equal(local["kv"][0], want)
                seen[b0:b0 + bl, model * s // 2:(model + 1) * s // 2] += 1
    assert bool((seen == (4 if rows % 4 else 1)).all())


def test_mesh_constructors_refuse_without_enough_ranks():
    """As the reference's: a ``RuntimeError`` when the group (here none)
    has fewer ranks than the mesh."""
    with pytest.raises(RuntimeError, match="need 256"):
        mesh_lib.make_production_mesh()
    with pytest.raises(RuntimeError, match="need 512"):
        mesh_lib.make_production_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match="need 4"):
        mesh_lib.make_test_mesh((2, 2))
