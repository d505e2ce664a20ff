"""The port's sharding rules (``repro_torch.distributed.sharding``), the
logical axes of its parameters (``lm.param_axes``) and the
tensor-parallel config helpers (``lm.tp_local_config``,
``lm.tp_param_specs``) against the JAX package's, in one process:

* twins of ``tests/test_distributed.py``'s rule, conflict, pod, unknown-
  axis, repair (with its hypothesis case and the awkward dims) and
  ``cache_spec`` cases, run on the same fake meshes through both
  packages;
* the axes tree of every LM config at ``reduced()`` equal to the JAX
  ``lm.init(key, cfg)[1]`` leaf for leaf, and of the port's values' ranks;
* ``param_specs`` and ``repair_specs`` equal to JAX's on those trees at
  (16, 16), (2, 16, 16), (4, 2) and (2, 1);
* ``tp_local_config`` and ``tp_param_specs`` equal to JAX's, the
  ``ValueError`` included."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.distributed import sharding as jshd
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.core.partition import PartitionSpec as P
from repro_torch.distributed import sharding as shd
from repro_torch.layers import base
from repro_torch.models import lm


class _FakeMesh:
    """Just enough of a mesh for spec logic (axis name -> size)."""

    def __init__(self, sizes: dict):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


MESH = _FakeMesh({"data": 16, "model": 16})
MESH_POD = _FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"16x16": MESH, "2x16x16": MESH_POD,
          "4x2": _FakeMesh({"data": 4, "model": 2}),
          "2x1": _FakeMesh({"data": 2, "model": 1})}


def _same(port, jax_spec) -> bool:
    return tuple(port) == tuple(jax_spec)


def _tree_same(port, jax_tree) -> None:
    """Port spec tree equal to the JAX one, leaf for leaf."""
    if isinstance(jax_tree, dict):
        assert set(port) == set(jax_tree)
        for k in jax_tree:
            _tree_same(port[k], jax_tree[k])
        return
    assert _same(port, jax_tree), (port, jax_tree)


# ---------------------------------------------------------------------------
# Rules (tests/test_distributed.py's cases through both packages).
# ---------------------------------------------------------------------------

RULE_CASES = [
    (("fsdp", "heads"), {}, "16x16"), (("vocab", None), {}, "16x16"),
    (("layers", "fsdp", "ffn"), {}, "16x16"), (("heads", "ffn"), {}, "16x16"),
    (("fsdp",), {"fsdp_over_pod": True}, "2x16x16"),
    (("fsdp",), {}, "2x16x16"), (("experts", None, "ffn"), {}, "16x16"),
    (("kv_heads", "fsdp"), {"fsdp": False}, "4x2"),
    (("experts",), {"expert_axis": "model"}, "4x2"),
]


@pytest.mark.parametrize("axes,kw,mesh", RULE_CASES)
def test_spec_for_axes_matches_jax(axes, kw, mesh):
    got = shd.spec_for_axes(axes, shd.ShardingRules(**kw), MESHES[mesh])
    want = jshd.spec_for_axes(axes, jshd.ShardingRules(**kw), MESHES[mesh])
    assert _same(got, want), (got, want)


def test_default_rules_and_first_wins():
    r = shd.ShardingRules()
    assert shd.spec_for_axes(("fsdp", "heads"), r, MESH) == P("data",
                                                              "model")
    assert shd.spec_for_axes(("heads", "ffn"), r, MESH) == P("model", None)
    assert shd.spec_for_axes(("fsdp",), shd.ShardingRules(
        fsdp_over_pod=True), MESH_POD) == P(("pod", "data"))


def test_unknown_axis_raises_as_jax():
    for mod in (shd, jshd):
        with pytest.raises(ValueError, match="unknown logical axis"):
            mod.spec_for_axes(("bogus",), mod.ShardingRules(), MESH)


@settings(deadline=None, max_examples=60)
@given(dim=st.integers(1, 4096))
def test_repaired_extent_divides_as_jax(dim):
    got = shd.repair_spec((dim, 64), P("model", None), MESH)
    want = jshd.repair_spec((dim, 64), JP("model", None), MESH)
    assert _same(got, want)
    if got[0] is not None:
        assert dim % MESH.shape[got[0]] == 0
    else:
        assert dim % 16 != 0


REPAIR_CASES = [
    ((32,), ("pod", "data"), "2x16x16"), ((16,), ("pod", "data"),
                                          "2x16x16"),
    ((50280, 2560), ("model", None), "16x16"),
    ((40, 1536, 512), ("data", None, "model"), "16x16"),
    ((49152, 64), ("model", None), "16x16"),
    ((32, 8, 8), ("data",), "16x16"),
]


@pytest.mark.parametrize("shape,entries,mesh", REPAIR_CASES)
def test_repair_spec_matches_jax(shape, entries, mesh):
    parts = [e for e in entries]
    got = shd.repair_spec(shape, P(*parts), MESHES[mesh])
    want = jshd.repair_spec(shape, JP(*parts), MESHES[mesh])
    assert _same(got, want), (got, want)


def test_batch_axes_and_spec_match_jax():
    batch = {"tokens": np.zeros((8, 16)), "frames": np.zeros((8, 16, 4))}
    for mesh in (MESH, MESH_POD):
        assert shd.batch_axes(mesh) == jshd.batch_axes(mesh)
        got = shd.batch_spec(batch, mesh)
        want = jshd.batch_spec(batch, mesh)
        _tree_same(got, want)


def test_opt_state_specs_match_jax():
    got = shd.opt_state_specs({"w": P("data", None)}, MESH)
    want = jshd.opt_state_specs({"w": JP("data", None)}, MESH)
    _tree_same(got, want)


CACHE_CASES = {
    "gqa_sequence_sharded": ((4, 8, 8, 32768, 128), jnp.bfloat16),
    "mha_head_sharded": ((4, 8, 32, 32768, 128), jnp.bfloat16),
    "ssm_state_head_sharded": ((4, 8, 80, 128, 64), jnp.float32),
    "lengths_batch_sharded": ((4, 8), jnp.int32),
    "mamba_conv": ((4, 8, 3, 256), jnp.bfloat16),
}


@pytest.mark.parametrize("case", sorted(CACHE_CASES))
def test_cache_spec_matches_jax(case):
    shape, dtype = CACHE_CASES[case]
    x = jax.ShapeDtypeStruct(shape, dtype)
    got = shd.cache_spec({"c": x}, MESH)["c"]
    want = jshd.cache_spec({"c": x}, MESH)["c"]
    assert _same(got, want), (got, want)


def test_cache_spec_walks_the_ports_cache_dataclasses():
    """The port's caches declare ``CACHE_AXES`` as the JAX package's do:
    ``cache_spec`` takes their declared path, field for field equal to
    JAX's on the same decode caches (dense and paged qwen2.5-32b, whose 8
    KV heads divide a model axis of 8 and not one of 16, and mamba2's
    conv window and SSM state)."""
    import torch

    from repro_torch.layers import attention, mamba2
    mesh8 = _FakeMesh({"data": 4, "model": 8})
    cases = [("qwen2.5-32b", {}), ("mamba2-2.7b", {}),
             ("qwen2.5-32b", dict(kv_layout="paged", kv_num_blocks=16,
                                  kv_block_size=16))]
    for arch, kw in cases:
        tcfg = tconfigs.get_config(arch)
        jcfg = jconfigs.get_config(arch)
        cache = lm.init_decode_cache(tcfg, 8, 64, dtype=torch.float32,
                                     device="meta", **kw)
        jcache = jax.eval_shape(lambda: jlm.init_decode_cache(
            jcfg, 8, 64, dtype=jnp.float32, **kw))
        for mesh in (MESH, mesh8):
            got = shd.cache_spec(cache, mesh)["blocks"]["sub0"]
            want = jshd.cache_spec(jcache, mesh)["blocks"]["sub0"]
            assert type(got).__name__ == type(want).__name__
            assert isinstance(got, (attention.KVCache,
                                    attention.PagedKVCache,
                                    mamba2.MambaCache))
            for f in type(got).CACHE_AXES:
                assert _same(getattr(got, f), getattr(want, f)), (arch, f)
    got = shd.cache_spec(lm.init_decode_cache(
        tconfigs.get_config("qwen2.5-32b"), 8, 64, device="meta"),
        mesh8)["blocks"]["sub0"]
    assert got.k == P(None, "data", "model", None, None)
    assert got.length == P(None, "data")


# ---------------------------------------------------------------------------
# Logical axes and the specs of whole models.
# ---------------------------------------------------------------------------

LM_ARCHS = tuple(a for a in tconfigs.ARCH_IDS)


@functools.lru_cache(maxsize=None)
def _jax_tree(arch: str):
    cfg = jconfigs.get_config(arch).reduced()
    shapes = jax.eval_shape(lambda k: jlm.init(k, cfg)[0],
                            jax.random.PRNGKey(0))
    return shapes, jlm.init(jax.random.PRNGKey(0), cfg)[1]


def _axes_same(port, jax_axes) -> None:
    if isinstance(jax_axes, dict):
        assert set(port) == set(jax_axes)
        for k in jax_axes:
            _axes_same(port[k], jax_axes[k])
        return
    assert tuple(port) == tuple(jax_axes), (port, jax_axes)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_axes_equal_jax(arch):
    cfg = tconfigs.get_config(arch).reduced()
    axes = lm.param_axes(cfg)
    _axes_same(axes, _jax_tree(arch)[1])
    params, axes2 = lm.init(0, cfg, device="cpu", with_axes=True)
    assert axes2 == axes
    base.check_axes(params, axes)


def test_check_axes_catches_a_rank_mismatch():
    import torch
    with pytest.raises(ValueError, match="rank"):
        base.check_axes({"w": torch.zeros(2, 3)}, {"w": ("fsdp",)})
    with pytest.raises(ValueError, match="structure"):
        base.check_axes({"w": torch.zeros(2)}, {"v": (None,)})


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_and_repaired_specs_equal_jax(arch, mesh):
    m = MESHES[mesh]
    cfg = tconfigs.get_config(arch).reduced()
    shapes, jaxes = _jax_tree(arch)
    rules = shd.ShardingRules()
    specs = shd.param_specs(lm.param_axes(cfg), rules, m)
    jspecs = jshd.param_specs(jaxes, jshd.ShardingRules(), m)
    _tree_same(specs, jspecs)
    _tree_same(shd.repair_specs(shapes, specs, m),
               jshd.repair_specs(shapes, jspecs, m))


# ---------------------------------------------------------------------------
# Tensor-parallel helpers.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek-7b", "qwen2.5-14b",
                                  "paligemma-3b", "zamba2-7b"])
@pytest.mark.parametrize("m", [1, 2, 4])
def test_tp_local_config_matches_jax(arch, m):
    cfg = tconfigs.get_config(arch)
    jcfg = jconfigs.get_config(arch)
    try:
        want = jlm.tp_local_config(jcfg, m)
    except ValueError as e:
        with pytest.raises(ValueError, match="not divisible"):
            lm.tp_local_config(cfg, m)
        assert "not divisible" in str(e)
        return
    got = lm.tp_local_config(cfg, m)
    assert (got.n_heads, got.n_kv_heads, got.head_dim) == (
        want.n_heads, want.n_kv_heads, want.head_dim)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "zamba2-7b",
                                  "granite-moe-3b-a800m"])
@pytest.mark.parametrize("m", [1, 2])
def test_tp_param_specs_match_jax(arch, m):
    cfg = tconfigs.get_config(arch).reduced()
    shapes, _ = _jax_tree(arch)
    params = lm.init(0, cfg, device="cpu")
    _tree_same(lm.tp_param_specs(params, m), jlm.tp_param_specs(shapes, m))


def test_tp_kept_splits_only_what_divides():
    """The sharded step keeps the model split of attention where both head
    counts divide the extent and of the MLP where its specs split d_ff:
    paligemma's one KV head keeps its attention whole, its MLP split;
    granite's MoE experts and shared expert stay gathered."""
    mesh = _FakeMesh({"data": 2, "model": 2})
    for arch, attn, mlp in (("qwen2.5-14b", True, True),
                            ("paligemma-3b", False, True),
                            ("granite-moe-3b-a800m", True, None)):
        cfg = tconfigs.get_config(arch).reduced()
        params = lm.init(0, cfg, device="cpu")
        specs = shd.repair_specs(params, shd.param_specs(
            lm.param_axes(cfg), shd.ShardingRules(), mesh), mesh)
        keep = lm.tp_kept(cfg, specs, 2)["blocks"]["sub0"]
        assert keep["attn"]["wq"] is attn and keep["attn"]["wo"] is attn
        if mlp is None:
            assert not any(base.tree_leaves(keep["moe"]))
        else:
            assert keep["mlp"]["wd"] is mlp
        assert not any(base.tree_leaves(keep["norm1"]))
        assert not lm.tp_kept(cfg, specs, 1)["blocks"]["sub0"]["attn"][
            "wq"]


def test_tp_attention_checks_the_slices_it_is_handed():
    """A head slice that does not hold whole query-head groups with their
    KV heads raises, naming the shapes."""
    import torch

    from repro_torch.configs.base import RuntimeConfig
    cfg = tconfigs.get_config("qwen2.5-14b").reduced()   # 4 heads over 2
    hd = cfg.head_dim
    rt = RuntimeConfig(tp_axis="model")
    good = {"wq": torch.zeros(cfg.d_model, 2 * hd),
            "wk": torch.zeros(cfg.d_model, hd)}
    local, rt_local = lm._tp_attention(good, cfg, rt)
    assert (local.n_heads, local.n_kv_heads, rt_local.tp_axis) == (2, 1,
                                                                    "model")
    bad = {"wq": torch.zeros(cfg.d_model, 2 * hd),
           "wk": torch.zeros(cfg.d_model, 2 * hd)}
    with pytest.raises(ValueError, match="do not hold"):
        lm._tp_attention(bad, cfg, rt)
    whole = {"wq": torch.zeros(cfg.d_model, 4 * hd),
             "wk": torch.zeros(cfg.d_model, 2 * hd)}
    assert lm._tp_attention(whole, cfg, rt)[1].tp_axis is None
