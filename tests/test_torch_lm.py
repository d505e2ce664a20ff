"""The port's dense LM (``repro_torch.models.lm`` and the layers under it)
against the JAX package's, on the CPU, with the JAX weights carried across
by ``convert.lm_params_from_numpy``.

At ``deepseek-7b`` and ``qwen2.5-14b`` ``reduced()`` (float32; the latter
has GQA and qkv bias), in all three modes, ``lm.forward``, ``lm.prefill``
and five ``lm.decode_step`` calls agree with the JAX package within 2e-4 of
max|logit| (float32 products summed in another order, through 4 layers).
JAX runs its Pallas kernels in interpret mode; the port runs the kernels'
plain versions.  JAX results are computed once per module."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import RuntimeConfig as JRuntime
from repro.layers import attention as jattn
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs.base import RuntimeConfig as TRuntime
from repro_torch.kernels.attention import ops as tattn_ops
from repro_torch.layers import attention as tattn
from repro_torch.layers import base as tbase
from repro_torch.models import lm as tlm

ARCHS = ("deepseek-7b", "qwen2.5-14b")
MODES = ("brainslug", "xla", "barrier")
REL = 2e-4
B, S, STEPS = 2, 12, 5


def _assert_logits(got, want, what):
    got = got.float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= REL * scale, f"{what}: max|d| {err:.3e} > {REL} x {scale:.3e}"


@pytest.fixture(scope="module")
def models():
    """Per arch: configs, JAX params, the port's copy, and the JAX results
    of forward, prefill and STEPS decode steps in every mode."""
    out = {}
    for arch in ARCHS:
        jcfg = jconfigs.get_config(arch).reduced()
        tcfg = tconfigs.get_config(arch).reduced()
        jparams, _ = jlm.init(jax.random.PRNGKey(0), jcfg)
        np_params = jax.tree_util.tree_map(np.asarray, jparams)
        rng = np.random.default_rng(1)
        tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
        steps = rng.integers(0, jcfg.vocab_size, (STEPS, B, 1)).astype(
            np.int32)
        res = {}
        for mode in MODES:
            rt = JRuntime(mode=mode, interpret=True)
            fwd = jax.jit(lambda p, t, rt=rt, c=jcfg: jlm.forward(
                p, {"tokens": t}, c, rt)[0])
            pre = jax.jit(lambda p, t, rt=rt, c=jcfg: jlm.prefill(
                p, {"tokens": t}, c, rt))
            dec = jax.jit(lambda p, c_, t, rt=rt, c=jcfg: jlm.decode_step(
                p, c_, t, c, rt))
            cache = jlm.init_decode_cache(jcfg, B, 16, dtype=jnp.float32)
            dlogits = []
            for t in steps:
                lo, cache = dec(jparams, cache, jnp.asarray(t))
                dlogits.append(np.asarray(lo))
            res[mode] = dict(
                forward=np.asarray(fwd(jparams, jnp.asarray(tokens))),
                prefill=np.asarray(pre(jparams, jnp.asarray(tokens))),
                decode=dlogits,
                lengths=np.asarray(cache["blocks"]["sub0"].length))
        out[arch] = dict(tcfg=tcfg, jcfg=jcfg, np_params=np_params,
                         tparams=convert.lm_params_from_numpy(np_params,
                                                              "cpu"),
                         tokens=tokens, steps=steps, res=res)
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", MODES)
def test_forward_and_prefill_match_jax(models, arch, mode):
    m = models[arch]
    rt = TRuntime(mode=mode)
    batch = {"tokens": torch.from_numpy(m["tokens"]).long()}
    logits, aux = tlm.forward(m["tparams"], batch, m["tcfg"], rt)
    _assert_logits(logits, m["res"][mode]["forward"], f"{arch} {mode} forward")
    assert float(aux["router_aux_loss"]) == 0.0
    _assert_logits(tlm.prefill(m["tparams"], batch, m["tcfg"], rt),
                   m["res"][mode]["prefill"], f"{arch} {mode} prefill")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", MODES)
def test_decode_steps_match_jax(models, arch, mode):
    m = models[arch]
    cfg = m["tcfg"]
    rt = TRuntime(mode=mode)
    cache = tlm.init_decode_cache(cfg, B, 16, dtype=torch.float32,
                                  device="cpu")
    before = tattn_ops.STATS.snapshot()
    for i, t in enumerate(m["steps"]):
        logits, cache = tlm.decode_step(m["tparams"], cache,
                                        torch.from_numpy(t).long(), cfg, rt)
        _assert_logits(logits, m["res"][mode]["decode"][i],
                       f"{arch} {mode} decode step {i}")
    np.testing.assert_array_equal(cache["blocks"]["sub0"].length.numpy(),
                                  m["res"][mode]["lengths"])
    key = "decode_plain" if mode == "brainslug" else "decode_ref"
    assert tattn_ops.STATS.delta(before)[key] == STEPS * cfg.n_layers


def test_decode_with_inactive_slot_matches_jax(models):
    """An inactive slot neither writes its K/V nor advances its length."""
    m = models["qwen2.5-14b"]
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    active = np.array([True, False])
    jrt, trt = JRuntime(mode="xla"), TRuntime(mode="xla")
    jcache = jlm.init_decode_cache(jcfg, B, 8, dtype=jnp.float32)
    tcache = tlm.init_decode_cache(tcfg, B, 8, dtype=torch.float32,
                                   device="cpu")
    for t in m["steps"][:3]:
        jlo, jcache = jlm.decode_step(m["np_params"], jcache, jnp.asarray(t),
                                      jcfg, jrt, active=jnp.asarray(active))
        tlo, tcache = tlm.decode_step(m["tparams"], tcache,
                                      torch.from_numpy(t).long(), tcfg, trt,
                                      active=torch.from_numpy(active))
        _assert_logits(tlo, jlo, "decode with an inactive slot")
    jc, tc = jcache["blocks"]["sub0"], tcache["blocks"]["sub0"]
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=1e-5,
                               rtol=1e-5)
    tlm.reset_slots(tcache, torch.tensor([True, False]))
    jcache = jlm.reset_slots(jcache, jnp.asarray([True, False]))
    np.testing.assert_array_equal(tc.length.numpy(),
                                  np.asarray(jcache["blocks"]["sub0"].length))
    assert float(tc.v[:, 0].abs().max()) == 0.0


def test_init_matches_jax_tree_and_scales():
    for arch in ARCHS:
        jcfg = jconfigs.get_config(arch).reduced()
        tcfg = tconfigs.get_config(arch).reduced()
        jparams, _ = jlm.init(jax.random.PRNGKey(0), jcfg)
        tparams = tlm.init(0, tcfg, device="cpu")
        jflat = {jax.tree_util.keystr(k): v for k, v in
                 jax.tree_util.tree_flatten_with_path(jparams)[0]}
        tflat = {}

        def walk(node, path):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, path + f"['{k}']")
                else:
                    tflat[path + f"['{k}']"] = v
        walk(tparams, "")
        assert set(tflat) == set(jflat)
        for k in jflat:
            assert tuple(tflat[k].shape) == tuple(jflat[k].shape), k
            js, ts = float(np.std(np.asarray(jflat[k]))), float(
                tflat[k].std()) if tflat[k].numel() > 1 else 0.0
            assert abs(ts - js) <= 0.1 * js + 1e-6, (k, ts, js)
        assert tbase.param_count(tparams) == sum(
            int(v.size) for v in jax.tree_util.tree_leaves(jparams))


def test_unported_families_and_layouts_raise():
    # the frontends are ported (tests/test_torch_multimodal.py holds them):
    # init, the decode cache and the backbone run
    for arch in ("hubert-xlarge", "paligemma-3b"):
        mm = tconfigs.get_config(arch).reduced()
        params = tlm.init(0, mm, device="cpu")
        assert tuple(params["frontend_proj"].shape) == (mm.frontend_dim,
                                                        mm.d_model)
        assert "sub0" in tlm.init_decode_cache(mm, 1, 4,
                                               device="cpu")["blocks"]
        rng = np.random.default_rng(0)
        batch = ({"frames": torch.from_numpy(rng.standard_normal(
            (1, 6, mm.frontend_dim)).astype(np.float32))}
            if mm.frontend == "audio_frames" else
            {"tokens": torch.arange(6)[None],
             "patches": torch.from_numpy(rng.standard_normal(
                 (1, mm.n_prefix_tokens, mm.frontend_dim)).astype(
                     np.float32))})
        h, _ = tlm.hidden(params, batch, mm, TRuntime(mode="barrier"))
        assert tuple(h.shape) == (1, 6 + mm.n_prefix_tokens, mm.d_model)
    # the MoE family is ported (tests/test_torch_moe.py holds it)
    assert "moe" in tlm.init(0, tconfigs.get_config(
        "granite-moe-3b-a800m").reduced(), device="cpu")["blocks"]["sub0"]
    cfg = tconfigs.get_config("deepseek-7b").reduced()
    with pytest.raises(ValueError, match="kv_layout"):
        tlm.init_decode_cache(cfg, 1, 4, kv_layout="ring", device="cpu")
    with pytest.raises(ValueError, match="kv_num_blocks"):
        tlm.init_decode_cache(cfg, 1, 4, kv_layout="paged", device="cpu")
    paged = tlm.init_decode_cache(cfg, 2, 4, kv_layout="paged",
                                  kv_num_blocks=3, kv_block_size=4,
                                  device="cpu")["blocks"]["sub0"]
    assert isinstance(paged, tattn.PagedKVCache)
    assert tuple(paged.k_pool.shape) == (4, 3, cfg.n_kv_heads, 4,
                                         cfg.head_dim)
    assert tuple(paged.length.shape) == (4, 2)
    assert tlm.layer_plan(cfg) == tlm.LayerPlan(("attn_dense",), 4, ())
    jplan = jlm.layer_plan(jconfigs.get_config("llama4-maverick-400b-a17b"))
    tplan = tlm.layer_plan(tconfigs.get_config("llama4-maverick-400b-a17b"))
    assert dataclasses.asdict(tplan) == dataclasses.asdict(jplan)


def test_entry_points_run_on_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    cfg = tconfigs.get_config("deepseek-7b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.init(0, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.init_decode_cache(cfg, 1, 4)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_cores_match_jax(causal):
    """rope, the full-score and the chunked (xla, long sequence) cores."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 4, 40, 16), np.float32)
    k = rng.standard_normal((1, 2, 40, 16), np.float32)
    v = rng.standard_normal((1, 2, 40, 16), np.float32)
    pos = np.arange(40)
    np.testing.assert_allclose(
        tattn.rope(torch.from_numpy(q), torch.from_numpy(pos), 1e4).numpy(),
        np.asarray(jattn.rope(jnp.asarray(q), jnp.asarray(pos), 1e4)),
        rtol=1e-5, atol=1e-5)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    want = np.asarray(jattn._full_attention(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), causal, False))
    np.testing.assert_allclose(tattn._full_attention(tq, tk, tv, causal)
                               .numpy(), want, rtol=2e-5, atol=2e-5)
    want = np.asarray(jattn._chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, block_k=16))
    np.testing.assert_allclose(tattn._chunked_attention(
        tq, tk, tv, causal, block_k=16).numpy(), want, rtol=2e-5, atol=2e-5)


def test_lm_params_from_numpy_keeps_bf16_values():
    rng = np.random.default_rng(4)
    w = jnp.asarray(rng.standard_normal((3, 5), np.float32)).astype(
        jnp.bfloat16)
    tree = {"a": {"w": np.asarray(w)}, "b": np.arange(3, dtype=np.int32)}
    got = convert.lm_params_from_numpy(tree, "cpu")
    assert got["a"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["a"]["w"].float().numpy(),
                                  np.asarray(w.astype(jnp.float32)))
    assert got["b"].dtype == torch.int32


def test_tree_helpers_and_skip_core_match_jax(models):
    """``stack_layer_trees``/``cast_tree``/``param_count`` and the
    ``attn_impl="skip_core"`` cost probe of ``attention.apply``."""
    from repro.layers import base as jbase
    m = models["qwen2.5-14b"]
    layer = {"a": np.ones((2, 3), np.float32), "b": {"c": np.arange(4.0)}}
    jstack = jbase.stack_layer_trees([jbase.Box(jnp.asarray(layer["a"]),
                                                (None, None))] * 3)
    tstack = tbase.stack_layer_trees([{k: (torch.from_numpy(v) if k == "a"
                                           else {"c": torch.from_numpy(
                                               v["c"])})
                                       for k, v in layer.items()}] * 3)
    assert tuple(tstack["a"].shape) == tuple(jstack.value.shape)
    cast = tbase.cast_tree({"w": torch.ones(2), "i": torch.arange(2)},
                           torch.bfloat16)
    assert cast["w"].dtype == torch.bfloat16 and cast["i"].dtype == torch.int64
    assert tbase.param_count(tstack) == 3 * (6 + 4)
    blocks = m["np_params"]["blocks"]["sub0"]["attn"]
    x = np.random.default_rng(6).standard_normal((1, 5, 128), np.float32)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), blocks)
    tp = {k: torch.tensor(np.asarray(v[0])) for k, v in blocks.items()}
    for impl in ("skip_core", "auto"):
        want = jattn.apply(jp, jnp.asarray(x), m["jcfg"],
                           JRuntime(mode="xla", attn_impl=impl))
        got = tattn.apply(tp, torch.from_numpy(x), m["tcfg"],
                          TRuntime(mode="xla", attn_impl=impl))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)
