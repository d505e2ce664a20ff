"""The port's MoE family (``repro_torch.layers.moe`` and the ``attn_moe``
block through ``repro_torch.models.lm``) against the JAX package's, on the
CPU.

The configs are ``granite-moe-3b-a800m`` and ``llama4-maverick-400b-a17b``
``reduced()``: 4 layers, d_model 128, 4 heads of 32, 8 experts; granite
top-2 with every layer MoE, llama4 top-1 with a shared expert of 128 on
every second layer (dense layers between).  JAX weights are carried across
by ``convert.lm_params_from_numpy``; JAX runs its Pallas kernels in
interpret mode, the port the kernels' plain versions.

Tolerances: ``moe.apply``'s output within 1e-5 of max|y| and its aux within
1e-6 (float32 products summed in another order); gradients within rtol
1e-4 and atol 1e-4 x max|g|; logits within 1e-4 of max|logit| through 4
layers; the loss within 1e-4 relative; greedy tokens of ``Server.generate``
and ``Engine.run`` identical; three ``Trainer`` steps' losses within 1e-4
relative and grad norms within 1e-3.  The combine is held bit for bit
against a sequential scatter-add.  Routing is discrete: a near-tie between
two experts could pick differently in the two packages, so the inputs are
random and the choices are compared where the packages agree on them (they
do on every case here)."""
from __future__ import annotations

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import checkpointer as jckpt
from repro.configs.base import RuntimeConfig as JRuntime
from repro.launch import engine as jengine
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.layers import moe as jmoe
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.checkpoint import checkpointer as tckpt
from repro_torch.configs.base import RuntimeConfig as TRuntime
from repro_torch.kernels.attention import ops as tattn_ops
from repro_torch.launch import engine as tengine
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.layers import base as tbase
from repro_torch.layers import moe as tmoe
from repro_torch.models import lm as tlm

torch.set_num_threads(1)

GRANITE, LLAMA4 = "granite-moe-3b-a800m", "llama4-maverick-400b-a17b"
ARCHS = (GRANITE, LLAMA4)
MODES = ("brainslug", "xla", "barrier")
REL = 1e-4
B, S, STEPS = 2, 16, 4


def _rel(got, want):
    got = got.detach().float().numpy() if torch.is_tensor(got) else \
        np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def _cfgs(arch, **kw):
    return (dataclasses.replace(jconfigs.get_config(arch).reduced(), **kw),
            dataclasses.replace(tconfigs.get_config(arch).reduced(), **kw))


def _unbox(tree):
    """A JAX init tree with its logical-axis boxes taken off, as numpy."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(getattr(a, "value", a)), tree,
        is_leaf=lambda a: hasattr(a, "value"))


def _flat(tree, path=""):
    """A torch tree as {JAX keystr: leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, path + f"['{k}']"))
        else:
            out[path + f"['{k}']"] = v
    return out


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg, tcfg = _cfgs(request.param)
    jparams, _ = jlm.init(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return dict(arch=request.param, jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                np_params=np_params, tokens=tokens)


def _tparams(model):
    return convert.lm_params_from_numpy(model["np_params"], "cpu")


#: The JAX package's decode step, traced once a config and mode (an eager
#: step runs every op of 4 layers one by one).
_jdecode = jax.jit(jlm.decode_step, static_argnums=(3, 4))


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------

#: (dispatch, dropless, capacity_factor): the grouped and the global sort,
#: capacity and dropless, and a capacity that drops
APPLY_CASES = [(disp, dl, 1.25) for disp in ("grouped", "global")
               for dl in (False, True)] + [("grouped", False, 0.5),
                                           ("global", False, 0.5)]


def _layer_case(arch, cf, seed=0, shape=(2, 24)):
    jcfg, tcfg = _cfgs(arch, capacity_factor=cf)
    np_p = _unbox(jmoe.init(jax.random.PRNGKey(seed), jcfg))
    x = np.random.default_rng(seed).standard_normal(
        shape + (jcfg.d_model,)).astype(np.float32)
    return jcfg, tcfg, np_p, x


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("disp,dropless,cf", APPLY_CASES,
                         ids=lambda v: str(v))
def test_moe_apply_matches_jax(arch, disp, dropless, cf):
    """y within 1e-5 of max|y|, ``router_aux_loss`` and ``drop_fraction``
    within 1e-6, in every mode's routing of the dispatch; at capacity
    factor 0.5 the global sort drops assignments (``drop_fraction > 0``)
    and dropless drops none."""
    jcfg, tcfg, np_p, x = _layer_case(arch, cf)
    jy, jaux = jmoe.apply(jax.tree_util.tree_map(jnp.asarray, np_p),
                          jnp.asarray(x), jcfg,
                          JRuntime(mode="brainslug", interpret=True,
                                   moe_dispatch=disp), dropless=dropless)
    ty, taux = tmoe.apply(convert.lm_params_from_numpy(np_p, "cpu"),
                          torch.from_numpy(x), tcfg,
                          TRuntime(mode="brainslug", moe_dispatch=disp),
                          dropless=dropless)
    assert _rel(ty, jy) <= 1e-5
    for k in ("router_aux_loss", "drop_fraction"):
        assert taux[k].dtype == torch.float32 and taux[k].shape == ()
        assert abs(float(taux[k]) - float(jaux[k])) <= 1e-6, k
    if dropless:
        assert float(taux["drop_fraction"]) == 0.0
    if cf == 0.5 and disp == "global":
        assert float(taux["drop_fraction"]) > 0.0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("disp,cf", [("grouped", 1.25), ("global", 0.5)])
def test_moe_grads_match_jax(arch, disp, cf):
    """``jax.grad`` of ``sum(y * cot) + router_aux_loss`` against autograd
    through the deterministic dispatch and combine, for the input and
    every parameter (the shared expert's too), with and without drops."""
    jcfg, tcfg, np_p, x = _layer_case(arch, cf, seed=1)
    cot = np.random.default_rng(2).standard_normal(x.shape).astype(
        np.float32)
    jrt = JRuntime(mode="brainslug", interpret=True, moe_dispatch=disp)

    def jloss(p, x):
        y, aux = jmoe.apply(p, x, jcfg, jrt)
        return jnp.sum(y * cot) + aux["router_aux_loss"]

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, np_p), jnp.asarray(x))
    params = convert.lm_params_from_numpy(np_p, "cpu")
    leaves = tbase.tree_leaves(params)
    tx = torch.from_numpy(x).requires_grad_()
    for p in leaves:
        p.requires_grad_()
    y, aux = tmoe.apply(params, tx, tcfg, TRuntime(mode="brainslug",
                                                   moe_dispatch=disp))
    loss = torch.sum(y * torch.from_numpy(cot)) + aux["router_aux_loss"]
    grads = torch.autograd.grad(loss, [tx] + leaves)
    it = iter(grads[1:])
    got = convert.grads_to_numpy(tbase.tree_map(lambda _: next(it), params),
                                 like=np_p)
    pairs = [(grads[0].numpy(), np.asarray(jgx), "x")] + [
        (gflat, np.asarray(w), jax.tree_util.keystr(k)) for (k, w), gflat in
        zip(jax.tree_util.tree_flatten_with_path(jgp)[0],
            jax.tree_util.tree_leaves(got))]
    assert len(pairs) == 1 + len(leaves)
    for g, w, what in pairs:
        assert float(np.abs(w).max()) > 0, what
        np.testing.assert_allclose(g, w, rtol=REL,
                                   atol=REL * float(np.abs(w).max()),
                                   err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_is_the_sequential_scatter_add(dtype):
    """The combine adds each token's slot rows in slot order: bit for bit
    the sequential ``y[table[s]] += ye[s]`` over the slots in order (the
    JAX package's scatter-add on the CPU) in float32 and bf16, with drops
    and empty slots; the dispatch's and the combine's backwards are each
    other's forwards, equal to autograd of plain indexing, and give the
    same bits twice."""
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    rng = np.random.default_rng(7)
    g, tg, k, e, cap, d = 3, 40, 4, 8, 16, 24
    idx = np.stack([np.stack([rng.permutation(e)[:k] for _ in range(tg)])
                    for _ in range(g)])
    idx[0, :30, 0] = 2                      # an expert past its capacity
    keep, slot, table, token_slots = tmoe.assign(
        torch.from_numpy(idx).long(), e, cap)
    assert not bool(keep.all()) and bool((table == tg).any())
    ye = torch.from_numpy(rng.standard_normal((g, e * cap, d)).astype(
        np.float32)).to(tdt)
    got = tmoe._Combine.apply(ye, token_slots, table)
    want = torch.zeros((g, tg + 1, d), dtype=tdt)
    for gi in range(g):
        for s in range(e * cap):
            want[gi, table[gi, s]] += ye[gi, s]
    assert got.dtype == tdt
    assert torch.equal(got, want[:, :tg])
    jwant = jnp.zeros((g, tg + 1, d), ml_dtypes.bfloat16 if dtype ==
                      "bfloat16" else jnp.float32).at[
        jnp.arange(g)[:, None], jnp.asarray(table.numpy())].add(
        jnp.asarray(ye.float().numpy()).astype(
            ml_dtypes.bfloat16 if dtype == "bfloat16" else jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(jwant[:, :tg]).astype(
                                      np.float32))
    # backwards, float32 against autograd of plain indexing
    x = torch.from_numpy(rng.standard_normal((g, tg, d)).astype(np.float32))
    cot_e = torch.from_numpy(rng.standard_normal((g, e * cap, d)).astype(
        np.float32))
    cot_t = torch.from_numpy(rng.standard_normal((g, tg, d)).astype(
        np.float32))
    gi = torch.arange(g)[:, None]
    for fn, plain, inp, cot in (
            (lambda a: tmoe._Dispatch.apply(a, table, token_slots),
             lambda a: torch.cat([a, a.new_zeros(g, 1, d)], 1)[gi, table],
             x, cot_e),
            (lambda a: tmoe._Combine.apply(a, token_slots, table),
             lambda a: torch.zeros(g, tg + 1, d).index_put(
                 (gi.expand(g, e * cap), table), a, accumulate=True)[:, :tg],
             cot_e, cot_t)):
        runs = []
        for f in (fn, fn, plain):
            a = inp.clone().requires_grad_()
            runs.append(torch.autograd.grad(f(a), a, cot)[0])
        assert torch.equal(runs[0], runs[1])
        torch.testing.assert_close(runs[0], runs[2], rtol=1e-6, atol=1e-6)


def test_capacity_at_prefill_and_dropless_at_decode():
    """The JAX package's capacities at granite's full config: 512 slots an
    expert at prefill (1, 2048), 1024 at a 4096-token step, ceil8 of the
    tokens when dropless (8 at a decode step of 4 slots).  At the reduced
    config with a capacity that drops, ``lm.forward`` drops tokens (its
    aux says so) and ``decode_step`` rolled over the same prompt does not,
    so their logits differ; each route equals the JAX package's."""
    full_j = jconfigs.get_config(GRANITE)
    full_t = tconfigs.get_config(GRANITE)
    for n, dl in ((2048, False), (4096, False), (4, True), (2048, True)):
        assert tmoe.capacity(full_t, n, dropless=dl) == jmoe.capacity(
            full_j, n, dropless=dl)
    assert [tmoe.capacity(full_t, n) for n in (2048, 4096)] == [512, 1024]
    assert tmoe.capacity(full_t, 4, dropless=True) == 8
    jcfg, tcfg = _cfgs(GRANITE, capacity_factor=0.5, n_layers=2)
    np_params = jax.tree_util.tree_map(
        np.asarray, jlm.init(jax.random.PRNGKey(3), jcfg)[0])
    tok = np.random.default_rng(4).integers(0, jcfg.vocab_size,
                                            (1, 48)).astype(np.int32)
    params = convert.lm_params_from_numpy(np_params, "cpu")
    jlo, jaux = jlm.forward(np_params, {"tokens": jnp.asarray(tok)}, jcfg,
                            JRuntime(mode="xla", interpret=True))
    tlo, taux = tlm.forward(params, {"tokens": torch.from_numpy(tok).long()},
                            tcfg, TRuntime(mode="xla"))
    assert _rel(tlo, jlo) <= REL
    assert float(taux["drop_fraction"]) > 0
    for k in taux:
        assert abs(float(taux[k]) - float(jaux[k])) <= 1e-6, k
    cache = tlm.init_decode_cache(tcfg, 1, 48, dtype=torch.float32,
                                  device="cpu")
    jcache = jlm.init_decode_cache(jcfg, 1, 48, dtype=jnp.float32)
    rolled, jrolled = [], []
    for t in range(tok.shape[1]):
        lo, _ = tlm.decode_step(params, cache,
                                torch.from_numpy(tok[:, t:t + 1]).long(),
                                tcfg, TRuntime(mode="xla"))
        jlo_t, jcache = _jdecode(np_params, jcache,
                                 jnp.asarray(tok[:, t:t + 1]), jcfg,
                                 JRuntime(mode="xla", interpret=True))
        rolled.append(lo[:, 0])
        jrolled.append(np.asarray(jlo_t)[:, 0])
    rolled = torch.stack(rolled, 1)
    assert _rel(rolled, np.stack(jrolled, 1)) <= REL
    assert _rel(rolled, tlo) > 1e-2          # the drops change the logits


def test_moe_constraint_other_than_none_raises():
    """``moe_constraint`` is the identity on one device; the mesh layouts
    (resolved by the dry-run's ``plan_cell``) raise and name their item of
    the roadmap, an unknown dispatch raises."""
    assert TRuntime().moe_constraint == JRuntime().moe_constraint == "none"
    assert TRuntime().moe_dispatch == JRuntime().moe_dispatch == "grouped"
    for value in ("tokens", "experts", "auto"):
        with pytest.raises(NotImplementedError, match="item 6d"):
            TRuntime(moe_constraint=value)
    with pytest.raises(ValueError, match="moe_dispatch"):
        TRuntime(moe_dispatch="sorted")


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def test_layer_plan_and_init_tree_match_jax(model):
    """The plan, the init tree's names, shapes and dtypes, and each leaf's
    std within 10% of the JAX init's (zeros and ones exactly; small leaves
    within three sampling spreads); every MoE block holds ``moe``, every
    dense one ``mlp``."""
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    jplan, tplan = jlm.layer_plan(jcfg), tlm.layer_plan(tcfg)
    assert dataclasses.asdict(tplan) == dataclasses.asdict(jplan)
    assert tplan.superblock[-1] == "attn_moe"
    jflat = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
             jax.tree_util.tree_flatten_with_path(model["jparams"])[0]}
    tparams = tlm.init(0, tcfg, device="cpu")
    tflat = _flat(tparams)
    assert set(tflat) == set(jflat)
    for k, jv in jflat.items():
        tv = tflat[k]
        assert tuple(tv.shape) == jv.shape, k
        assert str(tv.dtype).replace("torch.", "") == str(jv.dtype), k
        js, ts = float(np.std(jv)), float(tv.float().std())
        tol = max(0.1, 3.0 / np.sqrt(2 * jv.size))
        assert abs(ts - js) <= tol * js + 1e-6, (k, ts, js)
    moe_sub = tparams["blocks"][f"sub{len(tplan.superblock) - 1}"]
    assert "moe" in moe_sub and "mlp" not in moe_sub
    assert tuple(moe_sub["moe"]["wg"].shape) == (
        tplan.n_super, tcfg.n_experts, tcfg.d_model, tcfg.d_ff)
    assert ("shared" in moe_sub["moe"]) == bool(tcfg.shared_expert_ff)
    assert tbase.param_count(tparams) == sum(
        int(v.size) for v in jflat.values())


@pytest.mark.parametrize("mode", MODES)
def test_forward_and_prefill_match_jax(model, mode):
    """Logits within 1e-4 of max; the aux, summed over the MoE layers,
    within 1e-6."""
    jcfg, tcfg, tok = model["jcfg"], model["tcfg"], model["tokens"]
    want, jaux = jlm.forward(model["jparams"], {"tokens": jnp.asarray(tok)},
                             jcfg, JRuntime(mode=mode, interpret=True))
    params = _tparams(model)
    batch = {"tokens": torch.from_numpy(tok).long()}
    got, aux = tlm.forward(params, batch, tcfg, TRuntime(mode=mode))
    assert _rel(got, want) <= REL
    for k in ("router_aux_loss", "drop_fraction"):
        assert abs(float(aux[k]) - float(jaux[k])) <= 1e-6, k
    assert float(aux["router_aux_loss"]) > 0
    assert _rel(tlm.prefill(params, batch, tcfg, TRuntime(mode=mode)),
                np.asarray(want)[:, -1:]) <= REL


@pytest.fixture(scope="module")
def loss_case(model):
    """The batch (labels shifted, every 7th masked) and the JAX loss, its
    aux and gradients per mode, computed once."""
    tok = model["tokens"]
    labels = np.roll(tok, -1, axis=1)
    labels[:, ::7] = -1
    jbatch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(labels)}
    res = {}
    for mode in ("brainslug", "xla"):
        jrt = JRuntime(mode=mode, interpret=True)
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p, rt=jrt: jlm.loss_fn(p, jbatch, model["jcfg"], rt),
            has_aux=True))(model["jparams"])
        res[mode] = (float(loss), metrics, grads)
    return labels, res


@pytest.mark.parametrize("mode,remat", [("brainslug", "none"),
                                        ("brainslug", "dots"),
                                        ("brainslug", "full"),
                                        ("xla", "dots"),
                                        ("xla", "full")])
def test_loss_and_grads_match_jax(model, loss_case, mode, remat):
    """The loss carries ``router_aux_weight x router_aux_loss``; its
    gradient reaches the routers through the aux and the gate weights, and
    the experts through the deterministic dispatch and combine;
    ``remat="full"`` recomputes the MoE blocks, and ``remat="dots"`` all
    but their unbatched products, bit for bit with ``remat="none"``."""
    tcfg, tok = model["tcfg"], model["tokens"]
    labels, res = loss_case
    want_loss, jmetrics, want = res[mode]
    params = _tparams(model)
    leaves = tbase.tree_leaves(params)
    for p in leaves:
        p.requires_grad_()
    batch = {"tokens": torch.from_numpy(tok).long(),
             "labels": torch.from_numpy(labels).long()}
    loss, metrics = tlm.loss_fn(params, batch, tcfg,
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
    metrics = {k: v.detach() for k, v in metrics.items()}
    got = convert.grads_to_numpy(tbase.tree_map(lambda _: next(it), params),
                                 like=model["np_params"])
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=REL)
    for k in ("router_aux_loss", "drop_fraction"):
        assert abs(float(metrics[k]) - float(jmetrics[k])) <= 1e-6, k
    jflat = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    gflat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert set(jflat) == set(gflat)
    assert any("router" in jax.tree_util.keystr(k) for k in jflat)
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
        kw = dict(kv_layout="paged", kv_num_blocks=5, kv_block_size=4)
        table = np.random.default_rng(4).permutation(5)[:2 * 2].reshape(
            2, 2).astype(np.int32)
    jcache = jlm.init_decode_cache(jcfg, B, 8, dtype=jnp.float32, **kw)
    tcache = tlm.init_decode_cache(tcfg, B, 8, dtype=torch.float32,
                                   device="cpu", **kw)
    params = _tparams(model)
    out = []
    for i, t in enumerate(steps):
        active = None if i < STEPS - 1 else np.array([False, True])
        jlo, jcache = _jdecode(
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
    ("brainslug", "dense"), ("barrier", "dense"), ("brainslug", "paged"),
    ("xla", "paged")])
def test_decode_steps_match_jax(model, mode, layout):
    """Every step's logits (the MoE blocks dropless) and, after the last,
    every sub's cache; one attention decode a layer a step (the kernel's
    plain version in brainslug)."""
    before = tattn_ops.STATS.snapshot()
    steps, tcache, jcache = _decode_run(model, mode, layout)
    for i, (tlo, jlo) in enumerate(steps):
        assert _rel(tlo, jlo) <= REL, i
    delta = tattn_ops.STATS.delta(before)
    key = ("paged_" if layout == "paged" else "") + (
        "decode_plain" if mode == "brainslug" else "decode_ref")
    n_layers = model["tcfg"].n_layers
    assert {k: v for k, v in delta.items() if v} == {key: n_layers * STEPS}
    for grp, subs in tcache.items():
        for sub, c in subs.items():
            jc = jcache[grp][sub]
            for f in dataclasses.fields(c):
                t, j = getattr(c, f.name), np.asarray(getattr(jc, f.name))
                if f.name == "length":
                    np.testing.assert_array_equal(t.numpy(), j)
                elif float(np.abs(j).max()) > 0:
                    assert _rel(t, j) <= REL, (grp, sub, f.name)


SC = dict(batch=2, prompt_len=8, new_tokens=5, max_len=32)


class _Cut:
    """Stands in for the config ``jserve.Server`` looks up: its
    ``reduced()`` is the test's config (the JAX Server takes no config)."""

    def __init__(self, cfg):
        self.cfg = cfg

    def reduced(self):
        return self.cfg


@pytest.mark.parametrize("mode", ["xla", "brainslug"])
def test_server_and_engine_match_jax(model, mode):
    """Greedy tokens of ``Server.generate`` and of ``Engine.run`` (dense,
    and paged with prefix sharing on and the ``kv.*`` check strict, over
    requests that share a prompt prefix) equal the JAX drivers'."""
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    sc = dict(arch=model["arch"], mode=mode, **SC)
    with mock.patch.object(jserve, "get_config", lambda _: _Cut(jcfg)):
        js = jserve.Server(jserve.ServeConfig(**sc))
    ts = tserve.Server(tserve.ServeConfig(torch_device="cpu", **sc),
                       params=convert.lm_params_from_numpy(
                           jax.tree_util.tree_map(np.asarray, js.params),
                           "cpu"), cfg=tcfg)
    vocab = tcfg.vocab_size
    prompts = np.random.default_rng(0).integers(0, vocab, (2, 8)).astype(
        np.int32)
    np.testing.assert_array_equal(ts.generate(prompts), js.generate(prompts))
    rng = np.random.default_rng(1)
    common = rng.integers(1, vocab, 8).tolist()
    reqs = [dict(request_id=i,
                 prompt=(common if i % 2 == 0 else []) + rng.integers(
                     1, vocab, int(rng.integers(0, 6))).tolist(),
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
        paged = kw.get("kv_layout") == "paged"
        assert eng.prefix_sharing is paged
        if paged:
            assert eng.last_stats.prefix_hit_tokens > 0


@pytest.mark.parametrize("arch,mode", [(GRANITE, "brainslug"),
                                       (LLAMA4, "xla")])
def test_trainer_matches_jax_trainer(arch, mode):
    """Three AdamW steps of both ``Trainer``s from the JAX weights; each
    step logs the MoE aux."""
    kw = dict(arch=arch, reduced=True, batch_override=2, seq_override=16,
              steps=3, lr=3e-3, mode=mode, log_every=100)
    want = jtrain.train(jtrain.TrainerConfig(**kw))
    jcfg, _ = _cfgs(arch)
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
    assert all(h["router_aux_loss"] > 0
               and 0 <= h["drop_fraction_per_moe_layer"] <= 1 for h in got)


def test_trainer_logs_drop_fraction_a_moe_layer(capsys):
    """The loss's ``drop_fraction`` sums over the MoE layers, as the JAX
    package's does; the ``Trainer`` records and logs it a MoE layer.  At
    capacity factor 0.25 (256 tokens) over granite's 4 MoE layers the sum
    passes 1 and the logged value stays the sum / 4."""
    kw = dict(arch=GRANITE, reduced=True, batch_override=2, seq_override=128,
              steps=2, mode="barrier", log_every=1, device="cpu",
              config_overrides=(("capacity_factor", 0.25),))
    trainer = ttrain.build_trainer(ttrain.TrainerConfig(**kw))
    n_moe = tlm.n_moe_layers(trainer.cfg)
    assert n_moe == trainer.cfg.n_layers == 4
    sums = []
    step_fn = trainer.step_fn

    def recording(params, opt_state, batch):
        out = step_fn(params, opt_state, batch)
        sums.append(float(out[2]["drop_fraction"]))
        return out

    trainer.step_fn = recording
    hist = trainer.run()
    assert len(hist) == len(sums) == 2
    assert max(sums) > 1
    for h, s in zip(hist, sums):
        assert h["drop_fraction_per_moe_layer"] == s / n_moe
        assert 0 < h["drop_fraction_per_moe_layer"] <= 1
    log = capsys.readouterr().out
    assert [f"drop/layer={h['drop_fraction_per_moe_layer']:.4f}" in log
            for h in hist] == [True, True]


def test_checkpoints_cross_and_resume(tmp_path):
    """A bf16 MoE tree written by the JAX checkpointer restores in the port
    bit for bit (experts, routers, the shared expert); a run killed at step
    2 resumes from its step-1 checkpoint onto the uninterrupted step-3 loss
    exactly."""
    from repro_torch.distributed import fault_tolerance as ft
    jcfg, tcfg = _cfgs(LLAMA4, dtype="bfloat16")
    jtree = jax.tree_util.tree_map(
        np.asarray, jlm.init(jax.random.PRNGKey(5), jcfg)[0])
    jckpt.save(str(tmp_path / "j"), 1, jtree, extra={"next_step": 2})
    like = tlm.init(0, tcfg, device="cpu")
    got, extra = tckpt.restore(str(tmp_path / "j"), 1, like)
    assert extra["next_step"] == 2
    want = convert.lm_params_from_numpy(jtree, "cpu")
    assert "shared" in got["blocks"]["sub1"]["moe"]
    for a, b in zip(tbase.tree_leaves(got), tbase.tree_leaves(want)):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    kw = dict(arch=GRANITE, reduced=True, batch_override=2, seq_override=16,
              steps=3, lr=3e-3, mode="brainslug", log_every=100,
              device="cpu")
    full = ttrain.train(ttrain.TrainerConfig(**kw))
    d = str(tmp_path / "kill")
    with pytest.raises(ft.SimulatedFailure):
        ttrain.train(ttrain.TrainerConfig(**kw, ckpt_dir=d, ckpt_every=1),
                     failure_hook=ft.failure_injector({2}))
    resumed = ttrain.train(ttrain.TrainerConfig(**kw, ckpt_dir=d,
                                                ckpt_every=1))
    assert [h["step"] for h in resumed] == [2]
    assert resumed[-1]["loss"] == full[-1]["loss"]
