"""The port's hybrid family (zamba2: mamba blocks with one shared attention
block, ``repro_torch.models.lm``) against the JAX package's, on the CPU.

The config is ``zamba2-7b`` ``reduced()`` cut to 8 layers with the shared
attention every 3rd (d_model 128, 4 heads of 32, mamba N 16 and 8 heads of
32, float32): two super-blocks of (mamba, mamba, shared_attn) and a 2-layer
mamba tail, so every part of the plan is present.  The stock ``reduced()``
(28 layers, no tail) is held for the plan and the trees only.  JAX weights
are carried across by ``convert.lm_params_from_numpy``.

Tolerances: logits within 1e-4 of max|logit| (float32 products summed in
another order, through 8 layers); the loss within 1e-4 relative and every
gradient, ``shared_attn``'s (the sum over its two applications) included,
within rtol 1e-4 and atol 1e-4 x max|g|; decode logits and caches within
1e-4 of max; greedy tokens of ``Server.generate`` and ``Engine.run``
identical; three ``Trainer`` steps' losses within 1e-4 relative and grad
norms within 1e-3.  JAX runs its Pallas kernels in interpret mode; the port
runs the kernels' plain versions."""
from __future__ import annotations

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import RuntimeConfig as JRuntime
from repro.launch import engine as jengine
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.checkpoint import checkpointer as tckpt
from repro_torch.configs.base import RuntimeConfig as TRuntime
from repro_torch.kernels.attention import ops as tattn_ops
from repro_torch.launch import engine as tengine
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.layers import attention as tattn
from repro_torch.layers import base as tbase
from repro_torch.layers import mamba2 as tmamba
from repro_torch.models import lm as tlm

torch.set_num_threads(1)

ARCH = "zamba2-7b"
CUT = (("attn_layer_period", 3), ("n_layers", 8))
MODES = ("brainslug", "xla", "barrier")
REL = 1e-4
B, S, STEPS = 2, 24, 5


def _rel(got, want):
    got = got.detach().float().numpy() if torch.is_tensor(got) else \
        np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def _cfgs(cut=True):
    kw = dict(CUT) if cut else {}
    return (dataclasses.replace(jconfigs.get_config(ARCH).reduced(), **kw),
            dataclasses.replace(tconfigs.get_config(ARCH).reduced(), **kw))


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jparams, _ = jlm.init(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, np_params=np_params,
                tokens=tokens)


def _tparams(model):
    return convert.lm_params_from_numpy(model["np_params"], "cpu")


def _flat(tree, path=""):
    """A torch tree as {JAX keystr: leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, path + f"['{k}']"))
        else:
            out[path + f"['{k}']"] = v
    return out


def _cache_shapes(cache):
    """{(group, sub, field): (shape, dtype name)} of a decode cache, the
    port's (dataclasses) or the JAX package's (dataclass pytrees)."""
    return {(grp, sub, f.name): (tuple(getattr(c, f.name).shape),
                                 str(getattr(c, f.name).dtype).replace(
                                     "torch.", ""))
            for grp, subs in cache.items() for sub, c in subs.items()
            for f in dataclasses.fields(c)}


@pytest.mark.parametrize("cut", [True, False], ids=["8-layers", "reduced"])
def test_layer_plan_and_init_tree_match_jax(cut):
    """The plan (super-block kinds, count, tail), the init tree's names,
    shapes and dtypes, and each leaf's std within 10% of the JAX init's
    (zeros and ones exactly; leaves under 4096 values within three
    sampling spreads); ``shared_attn`` stored once, no layer axis."""
    jcfg, tcfg = _cfgs(cut)
    jplan, tplan = jlm.layer_plan(jcfg), tlm.layer_plan(tcfg)
    assert dataclasses.asdict(tplan) == dataclasses.asdict(jplan)
    if cut:
        assert tplan == tlm.LayerPlan(("mamba", "mamba", "shared_attn"), 2,
                                      ("mamba", "mamba"))
    jparams, _ = jlm.init(jax.random.PRNGKey(0), jcfg)
    jflat = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
             jax.tree_util.tree_flatten_with_path(jparams)[0]}
    tparams = tlm.init(0, tcfg, device="cpu")
    tflat = _flat(tparams)
    assert set(tflat) == set(jflat)
    for k, jv in jflat.items():
        tv = tflat[k]
        assert tuple(tv.shape) == jv.shape, k
        assert str(tv.dtype).replace("torch.", "") == str(jv.dtype), k
        # a std over n draws spreads by about 1/sqrt(2n) of itself: 10%
        # holds from 4096 values; below, three such spreads
        js, ts = float(np.std(jv)), float(tv.float().std())
        tol = max(0.1, 3.0 / np.sqrt(2 * jv.size))
        assert abs(ts - js) <= tol * js + 1e-6, (k, ts, js)
    assert tuple(tparams["shared_attn"]["attn"]["wq"].shape) == (
        tcfg.d_model, tcfg.n_heads * tcfg.head_dim)
    assert ("tail" in tparams) == bool(tplan.tail)
    assert tbase.param_count(tparams) == sum(
        int(v.size) for v in jflat.values())


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_decode_cache_tree_matches_jax(layout):
    """A cache per block of the super-block, stacked over the super-blocks
    (the shared attention: a KV cache per application), and the tail's:
    names, shapes and dtypes as the JAX package's."""
    jcfg, tcfg = _cfgs()
    kw = dict(kv_layout=layout, kv_num_blocks=6, kv_block_size=4) \
        if layout == "paged" else {}
    jcache = jlm.init_decode_cache(jcfg, 3, 16, dtype=jnp.float32, **kw)
    tcache = tlm.init_decode_cache(tcfg, 3, 16, dtype=torch.float32,
                                   device="cpu", **kw)
    assert _cache_shapes(tcache) == _cache_shapes(jcache)
    kv = tcache["blocks"]["sub2"]
    assert isinstance(kv, tattn.PagedKVCache if layout == "paged"
                      else tattn.KVCache)
    assert kv.length.shape == (2, 3)
    assert isinstance(tcache["tail"]["sub0"], tmamba.MambaCache)


@pytest.mark.parametrize("mode", MODES)
def test_forward_and_prefill_match_jax(model, mode):
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    tok = model["tokens"]
    want = jlm.forward(model["jparams"], {"tokens": jnp.asarray(tok)}, jcfg,
                       JRuntime(mode=mode, interpret=True))[0]
    params = _tparams(model)
    batch = {"tokens": torch.from_numpy(tok).long()}
    got = tlm.forward(params, batch, tcfg, TRuntime(mode=mode))[0]
    assert _rel(got, want) <= REL
    assert _rel(tlm.prefill(params, batch, tcfg, TRuntime(mode=mode)),
                np.asarray(want)[:, -1:]) <= REL


def test_cut_below_the_period_matches_jax():
    """A hybrid cut below its attention period (2 layers at period 3: no
    whole super-block, the tail alone, ``shared_attn`` initialised and
    unused) runs as the JAX package's: logits and loss within 1e-4."""
    jcfg, tcfg = (dataclasses.replace(c, attn_layer_period=3, n_layers=2)
                  for c in _cfgs(cut=False))
    assert tlm.layer_plan(tcfg).n_super == 0
    jparams, _ = jlm.init(jax.random.PRNGKey(3), jcfg)
    params = convert.lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    assert "blocks" not in params and "shared_attn" in params
    tok = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(tok, -1, axis=1)
    rt_j, rt_t = JRuntime(mode="barrier", interpret=True), \
        TRuntime(mode="barrier")
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(tok).long(),
          "labels": torch.from_numpy(labels).long()}
    assert _rel(tlm.forward(params, tb, tcfg, rt_t)[0],
                jlm.forward(jparams, jb, jcfg, rt_j)[0]) <= REL
    np.testing.assert_allclose(
        float(tlm.loss_fn(params, tb, tcfg, rt_t)[0]),
        float(jlm.loss_fn(jparams, jb, jcfg, rt_j)[0]), rtol=REL)


@pytest.fixture(scope="module")
def loss_case(model):
    """The batch (labels shifted, every 7th masked) and the JAX loss and
    gradients per mode, computed once."""
    tok = model["tokens"]
    labels = np.roll(tok, -1, axis=1)
    labels[:, ::7] = -1
    jbatch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(labels)}
    res = {}
    for mode in ("brainslug", "xla"):
        jrt = JRuntime(mode=mode, interpret=True)
        (loss, _), grads = jax.value_and_grad(
            lambda p, rt=jrt: jlm.loss_fn(p, jbatch, model["jcfg"], rt),
            has_aux=True)(model["jparams"])
        res[mode] = (float(loss), grads)
    return labels, res


@pytest.mark.parametrize("mode,remat", [("brainslug", "none"),
                                        ("brainslug", "dots"),
                                        ("brainslug", "full"),
                                        ("xla", "dots"),
                                        ("xla", "full")])
def test_loss_and_grads_match_jax(model, loss_case, mode, remat):
    """The fused CE loss (brainslug: the head is untied) and the plain one;
    ``remat="full"`` recomputes each super-block and tail layer, and
    ``remat="dots"`` all but their unbatched products, bit for bit with
    ``remat="none"``.  The
    shared block's gradient sums its applications, as ``jax.grad``'s."""
    tcfg, tok = model["tcfg"], model["tokens"]
    labels, res = loss_case
    want_loss, want = res[mode]
    params = _tparams(model)
    leaves = tbase.tree_leaves(params)
    for p in leaves:
        p.requires_grad_()
    batch = {"tokens": torch.from_numpy(tok).long(),
             "labels": torch.from_numpy(labels).long()}
    loss, _ = tlm.loss_fn(params, batch, tcfg,
                          TRuntime(mode=mode, remat=remat))
    grads = torch.autograd.grad(loss, leaves)
    if remat == "dots":                 # bit for bit with remat="none"
        ref = _tparams(model)
        ref_leaves = tbase.tree_leaves(ref)
        for p in ref_leaves:
            p.requires_grad_()
        loss0, _ = tlm.loss_fn(ref, batch, tcfg, TRuntime(mode=mode))
        assert torch.equal(loss.detach(), loss0.detach())
        assert all(torch.equal(a, b) for a, b in zip(
            grads, torch.autograd.grad(loss0, ref_leaves)))
    it = iter(grads)
    got = convert.grads_to_numpy(tbase.tree_map(lambda _: next(it), params),
                                 like=model["np_params"])
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=REL)
    jflat = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    gflat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert set(jflat) == set(gflat)
    assert any("shared_attn" in jax.tree_util.keystr(k) for k in jflat)
    for k, w in jflat.items():
        w = np.asarray(w)
        assert float(np.abs(w).max()) > 0, jax.tree_util.keystr(k)
        np.testing.assert_allclose(gflat[k], w, rtol=REL,
                                   atol=REL * float(np.abs(w).max()),
                                   err_msg=jax.tree_util.keystr(k))


def _decode_run(model, mode, layout):
    """STEPS rolled decode steps (the last with slot 0 inactive) in both
    packages, dense or paged (blocks of 4 through a shuffled table); per
    step the two logits, then both caches."""
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    steps = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    kw, table = {}, None
    if layout == "paged":
        kw = dict(kv_layout="paged", kv_num_blocks=7, kv_block_size=4)
        table = np.random.default_rng(4).permutation(7)[:2 * 3].reshape(
            2, 3).astype(np.int32)
    jcache = jlm.init_decode_cache(jcfg, B, 12, dtype=jnp.float32, **kw)
    tcache = tlm.init_decode_cache(tcfg, B, 12, dtype=torch.float32,
                                   device="cpu", **kw)
    params = _tparams(model)
    out = []
    for i, t in enumerate(steps):
        active = None if i < STEPS - 1 else np.array([False, True])
        jlo, jcache = jlm.decode_step(
            model["jparams"], jcache, jnp.asarray(t), jcfg,
            JRuntime(mode=mode, interpret=True),
            active=None if active is None else jnp.asarray(active),
            block_tables=None if table is None else jnp.asarray(table))
        tlo, same = tlm.decode_step(
            params, tcache, torch.from_numpy(t).long(), tcfg,
            TRuntime(mode=mode),
            active=None if active is None else torch.from_numpy(active),
            block_tables=None if table is None else torch.from_numpy(table))
        assert same is tcache
        out.append((tlo, jlo))
    return out, tcache, jcache


@pytest.mark.parametrize("mode,layout", [
    ("brainslug", "dense"), ("xla", "dense"), ("barrier", "dense"),
    ("brainslug", "paged"), ("xla", "paged")])
def test_decode_steps_match_jax(model, mode, layout):
    """Every step's logits and, after the last, every sub's cache and the
    tail's; the attention dispatches count one a shared application a
    step (the kernel's plain version in brainslug)."""
    before = tattn_ops.STATS.snapshot()
    steps, tcache, jcache = _decode_run(model, mode, layout)
    for i, (tlo, jlo) in enumerate(steps):
        assert _rel(tlo, jlo) <= REL, i
    delta = tattn_ops.STATS.delta(before)
    key = ("paged_" if layout == "paged" else "") + (
        "decode_plain" if mode == "brainslug" else "decode_ref")
    assert {k: v for k, v in delta.items() if v} == {key: 2 * STEPS}
    for grp, subs in tcache.items():
        for sub, c in subs.items():
            jc = jcache[grp][sub]
            for f in dataclasses.fields(c):
                t, j = getattr(c, f.name), np.asarray(getattr(jc, f.name))
                if f.name == "length":
                    np.testing.assert_array_equal(t.numpy(), j)
                elif float(np.abs(j).max()) > 0:
                    assert _rel(t, j) <= REL, (grp, sub, f.name)


def test_cache_primitives_act_on_every_sub_and_the_tail(model):
    """``reset_slots`` zeroes slot 1 of every dense leaf (conv window, SSM
    state, K/V and length) in every sub and in the tail, rewrites a paged
    length (to a prefix length where given), and ``copy_blocks`` copies a
    block in every application's pool, as the JAX primitives do."""
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    mask = np.array([False, True, False])
    for layout in ("dense", "paged"):
        kw = dict(kv_layout="paged", kv_num_blocks=5, kv_block_size=4) \
            if layout == "paged" else {}
        tcache = tlm.init_decode_cache(tcfg, 3, 8, dtype=torch.float32,
                                       device="cpu", **kw)
        for c in tlm._caches(tcache):
            for f in dataclasses.fields(c):
                getattr(c, f.name).copy_(torch.arange(
                    getattr(c, f.name).numel()).reshape(
                        getattr(c, f.name).shape) % 7 + 1)
        jcache = jlm.init_decode_cache(jcfg, 3, 8, dtype=jnp.float32, **kw)
        jcache = jax.tree_util.tree_map(
            lambda a: (jnp.arange(a.size).reshape(a.shape) % 7 + 1).astype(
                a.dtype), jcache)
        lengths = np.array([0, 5, 0], np.int32)
        tlm.reset_slots(tcache, torch.from_numpy(mask),
                        torch.from_numpy(lengths) if layout == "paged"
                        else None)
        jcache = jlm.reset_slots(jcache, jnp.asarray(mask),
                                 jnp.asarray(lengths) if layout == "paged"
                                 else None)
        if layout == "paged":
            tlm.copy_blocks(tcache, 1, 3)
            jcache = jlm.copy_blocks(jcache, jnp.int32(1), jnp.int32(3))
        seen = set()
        for grp, subs in tcache.items():
            for sub, c in subs.items():
                for f in dataclasses.fields(c):
                    np.testing.assert_array_equal(
                        getattr(c, f.name).numpy(),
                        np.asarray(getattr(jcache[grp][sub], f.name)),
                        err_msg=f"{layout} {grp}/{sub}.{f.name}")
                seen.add((grp, sub))
        assert seen == {("blocks", "sub0"), ("blocks", "sub1"),
                        ("blocks", "sub2"), ("tail", "sub0")}
        assert float(tcache["tail"]["sub0"].state[:, 1].abs().max()) == 0


SC = dict(arch=ARCH, batch=2, prompt_len=8, new_tokens=5, max_len=16)


class _Cut:
    """Stands in for the config ``jserve.Server`` looks up: its
    ``reduced()`` is the 8-layer config (the JAX Server takes no config)."""

    def __init__(self, cfg):
        self.cfg = cfg

    def reduced(self):
        return self.cfg


@pytest.fixture(scope="module")
def servers():
    """The JAX and the port's Server at the 8-layer config, per mode, on
    the JAX weights."""
    out, params = {}, None
    jcfg, tcfg = _cfgs()
    for mode in ("xla", "brainslug"):
        with mock.patch.object(jserve, "get_config", lambda _: _Cut(jcfg)):
            js = jserve.Server(jserve.ServeConfig(mode=mode, **SC))
        assert js.cfg is jcfg
        if params is None:
            params = convert.lm_params_from_numpy(
                jax.tree_util.tree_map(np.asarray, js.params), "cpu")
        ts = tserve.Server(tserve.ServeConfig(mode=mode, torch_device="cpu",
                                              **SC), params=params, cfg=tcfg)
        out[mode] = (js, ts)
    return out


@pytest.mark.parametrize("mode", ["xla", "brainslug"])
def test_server_and_engine_match_jax(servers, mode):
    """Greedy tokens of ``Server.generate`` and of ``Engine.run`` (dense,
    and paged with the ``kv.*`` check strict) equal the JAX drivers';
    prefix sharing is off for the hybrid and ``report()`` names the
    attention decode path."""
    js, ts = servers[mode]
    vocab = ts.cfg.vocab_size
    prompts = np.random.default_rng(0).integers(0, vocab, (2, 8)).astype(
        np.int32)
    np.testing.assert_array_equal(ts.generate(prompts), js.generate(prompts))
    rng = np.random.default_rng(1)
    reqs = [dict(request_id=i,
                 prompt=rng.integers(1, vocab, int(rng.integers(0, 8))
                                     ).tolist(),
                 max_new_tokens=int(rng.integers(1, 5))) for i in range(5)]
    for kw in (dict(prefill_chunk=3),
               dict(prefill_chunk=3, kv_layout="paged", kv_block_size=4,
                    verify_mode="strict")):
        jc = js.engine(slots=2, **kw).run(
            [jengine.Request(**r) for r in reqs])
        eng = ts.engine(slots=2, **kw)
        tc = eng.run([tengine.Request(**r) for r in reqs])
        assert [list(map(int, c.tokens)) for c in tc] == \
            [list(map(int, c.tokens)) for c in jc], kw
        assert [c.status for c in tc] == [c.status for c in jc]
        assert eng.prefix_sharing is False
        paged = "paged" if kw.get("kv_layout") == "paged" else "flash"
        want = (f"plain-{paged}-decode" if mode == "brainslug"
                else ("ref-paged-decode" if paged == "paged"
                      else "ref-decode"))
        assert eng.report()["decode_path"] == want


@pytest.mark.parametrize("mode", ["xla", "brainslug"])
def test_trainer_matches_jax_trainer(mode):
    """Three AdamW steps of both ``Trainer``s from the JAX weights: the
    shared block's summed gradient updated once a step."""
    kw = dict(arch=ARCH, reduced=True, batch_override=2, seq_override=16,
              steps=3, lr=3e-3, mode=mode, log_every=100,
              config_overrides=CUT)
    want = jtrain.train(jtrain.TrainerConfig(**kw))
    jcfg, _ = _cfgs()
    np_params = jax.tree_util.tree_map(
        np.asarray, jlm.init(jax.random.PRNGKey(0), jcfg)[0])
    got = ttrain.train(ttrain.TrainerConfig(**kw, device="cpu"),
                       init_params=lambda cfg, dev:
                       convert.lm_params_from_numpy(np_params, dev))
    assert [h["step"] for h in got] == [h["step"] for h in want]
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in want], rtol=REL)
    np.testing.assert_allclose([h["grad_norm"] for h in got],
                               [h["grad_norm"] for h in want], rtol=1e-3)


def test_checkpoint_round_trip_and_resume(model, tmp_path):
    """The hybrid's tree (blocks, shared_attn, tail) with its AdamW state
    saves and restores bit for bit; a run killed at step 2 resumes from its
    step-1 checkpoint onto the uninterrupted step-3 loss exactly."""
    from repro_torch.distributed import fault_tolerance as ft
    from repro_torch.optim import adamw
    params = _tparams(model)
    tree = {"params": params, "opt": adamw.init(params)}
    tckpt.save(str(tmp_path / "rt"), 1, tree, extra={"next_step": 2})
    like = tbase.tree_map(torch.zeros_like, tree)
    got, extra = tckpt.restore(str(tmp_path / "rt"), 1, like)
    assert extra["next_step"] == 2
    for a, b in zip(tbase.tree_leaves(got), tbase.tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert set(got["params"]) == {"embed", "out_head", "final_norm",
                                  "blocks", "shared_attn", "tail"}
    kw = dict(arch=ARCH, reduced=True, batch_override=2, seq_override=16,
              steps=3, lr=3e-3, mode="brainslug", log_every=100,
              config_overrides=CUT, device="cpu")
    full = ttrain.train(ttrain.TrainerConfig(**kw))
    d = str(tmp_path / "kill")
    with pytest.raises(ft.SimulatedFailure):
        ttrain.train(ttrain.TrainerConfig(**kw, ckpt_dir=d, ckpt_every=1),
                     failure_hook=ft.failure_injector({2}))
    resumed = ttrain.train(ttrain.TrainerConfig(**kw, ckpt_dir=d,
                                                ckpt_every=1))
    assert [h["step"] for h in resumed] == [2]
    assert resumed[-1]["loss"] == full[-1]["loss"]
