"""The port's SSM family (``repro_torch.layers.mamba2`` and the ``ssm``
path of ``repro_torch.models.lm``) against the JAX package's, on the CPU,
at ``mamba2-2.7b`` ``reduced()`` (4 layers, d_model 128, 8 heads of 32,
N 16, float32), with the JAX weights carried across by
``convert.lm_params_from_numpy``.

In all three modes: the mixer's ``apply`` and ``decode``; ``lm.forward``
and ``lm.prefill`` logits within 1e-4 of max|logit| (float32 products
summed in another order, through 4 layers); ``lm.loss_fn`` and every
parameter gradient within rtol 1e-4 and atol 1e-4 x max|g|; rolled
``lm.decode_step`` logits and caches.  Greedy tokens of ``Server.generate``
and of ``Engine.run`` (dense and paged) are identical to the JAX drivers';
three ``Trainer`` steps' losses agree within 1e-4 relative, grad norms
within 1e-3.  In bf16 both packages' logits lie within 2e-1 of max|logit|
of the float32 logits of the same weights (the JAX package's own
``brainslug`` and ``barrier`` sit 1.2e-1 and 1.8e-1 from them here: bf16
rounding at other places through 4 random layers), and within 2e-1 of
each other.  JAX runs its Pallas kernels in interpret mode; the port runs
the kernels' plain versions."""
from __future__ import annotations

import dataclasses

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
from repro.layers import mamba2 as jmamba
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs.base import RuntimeConfig as TRuntime
from repro_torch.kernels.ssd import ops as tssd_ops
from repro_torch.launch import engine as tengine
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.layers import base as tbase
from repro_torch.layers import mamba2 as tmamba
from repro_torch.models import lm as tlm

torch.set_num_threads(1)

ARCH = "mamba2-2.7b"
MODES = ("brainslug", "xla", "barrier")
REL = 1e-4
BF16_REL = 2e-1
B, S, STEPS = 2, 40, 5


def _rel(got, want):
    got = got.detach().float().numpy() if torch.is_tensor(got) else \
        np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jconfigs.get_config(ARCH).reduced(),
                                dtype=dtype),
            dataclasses.replace(tconfigs.get_config(ARCH).reduced(),
                                dtype=dtype))


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_matches_jax_tree(dtype):
    """Names, shapes and dtypes of ``lm.init`` are the JAX tree's;
    ``A_log`` and ``D`` stay float32 in a bf16 model, and
    ``lm_params_from_numpy`` keeps them so."""
    jcfg, tcfg = _cfgs(dtype)
    jparams = jax.eval_shape(lambda k: jlm.init(k, jcfg)[0],
                             jax.random.PRNGKey(0))
    jflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(jparams)[0]}
    tparams = tlm.init(0, tcfg, device="cpu")
    tflat = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + f"['{k}']")
            else:
                tflat[path + f"['{k}']"] = v
    walk(tparams, "")
    assert set(tflat) == set(jflat)
    for k, v in jflat.items():
        assert tuple(tflat[k].shape) == tuple(v.shape), k
        assert str(tflat[k].dtype).replace("torch.", "") == str(v.dtype), k
    mixer = tparams["blocks"]["sub0"]["mixer"]
    assert mixer["A_log"].dtype == mixer["D"].dtype == torch.float32
    if dtype == "bfloat16":
        np_params = jax.tree_util.tree_map(
            np.asarray, jlm.init(jax.random.PRNGKey(0), jcfg)[0])
        got = convert.lm_params_from_numpy(np_params, "cpu")
        gm = got["blocks"]["sub0"]["mixer"]
        assert gm["A_log"].dtype == torch.float32
        assert gm["wx"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            gm["D"].numpy(), np_params["blocks"]["sub0"]["mixer"]["D"])


@pytest.mark.parametrize("mode", MODES)
def test_mixer_apply_and_decode_match_jax(model, mode):
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    jl0 = jax.tree_util.tree_map(
        lambda a: a[0], model["jparams"]["blocks"]["sub0"]["mixer"])
    tl0 = {k: v[0] for k, v in
           _tparams(model)["blocks"]["sub0"]["mixer"].items()}
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 21, jcfg.d_model)).astype(np.float32)
    jrt, trt = JRuntime(mode=mode, interpret=True), TRuntime(mode=mode)
    want = jmamba.apply(jl0, jnp.asarray(x), jcfg, jrt)
    assert _rel(tmamba.apply(tl0, torch.from_numpy(x), tcfg, trt),
                want) <= REL
    jcache = jmamba.init_cache(jcfg, B, jnp.float32)
    tcache = tmamba.init_cache(tcfg, B, torch.float32, n_layers=1,
                               dev=torch.device("cpu"))
    tcache = tmamba.MambaCache(conv=tcache.conv[0], state=tcache.state[0])
    for t in range(6):
        active = None if t < 5 else np.array([True, False])
        jy, jcache = jmamba.decode(
            jl0, jnp.asarray(x[:, t:t + 1]), jcache, jcfg, jrt,
            active=None if active is None else jnp.asarray(active))
        ty, same = tmamba.decode(
            tl0, torch.from_numpy(x[:, t:t + 1]), tcache, tcfg, trt,
            active=None if active is None else torch.from_numpy(active))
        assert same is tcache
        assert _rel(ty, jy) <= REL, t
        assert _rel(tcache.conv, jcache.conv) <= REL, t
        assert _rel(tcache.state, jcache.state) <= REL, t


@pytest.mark.parametrize("mode", MODES)
def test_forward_and_prefill_match_jax(model, mode):
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    tok = model["tokens"]
    jrt = JRuntime(mode=mode, interpret=True)
    want = jlm.forward(model["jparams"], {"tokens": jnp.asarray(tok)}, jcfg,
                       jrt)[0]
    params = _tparams(model)
    batch = {"tokens": torch.from_numpy(tok).long()}
    tssd_ops.STATS.reset()
    got = tlm.forward(params, batch, tcfg, TRuntime(mode=mode))[0]
    assert _rel(got, want) <= REL
    # one SSD dispatch per layer in brainslug (the plain version on the CPU)
    assert tssd_ops.STATS.counts == {
        "kernel": 0, "plain": tcfg.n_layers if mode == "brainslug" else 0}
    assert _rel(tlm.prefill(params, batch, tcfg, TRuntime(mode=mode)),
                np.asarray(want)[:, -1:]) <= REL


def test_bf16_forward_near_float32():
    jcfg, tcfg = _cfgs("bfloat16")
    jparams, _ = jlm.init(jax.random.PRNGKey(0), jcfg)
    tparams = convert.lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    tok = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                            (B, S)).astype(np.int32)
    f32 = jlm.forward(jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                             jparams),
                      {"tokens": jnp.asarray(tok)},
                      dataclasses.replace(jcfg, dtype="float32"),
                      JRuntime(mode="xla"))[0]
    for mode in ("brainslug", "barrier"):
        j = jlm.forward(jparams, {"tokens": jnp.asarray(tok)}, jcfg,
                        JRuntime(mode=mode, interpret=True))[0]
        t = tlm.forward(tparams, {"tokens": torch.from_numpy(tok).long()},
                        tcfg, TRuntime(mode=mode))[0]
        assert t.dtype == torch.bfloat16
        assert _rel(j, f32) <= BF16_REL, mode
        assert _rel(t, f32) <= BF16_REL, mode
        assert _rel(t, j) <= BF16_REL, mode


@pytest.fixture(scope="module")
def loss_case(model):
    """The batch (labels shifted, every 7th masked) and the JAX loss and
    gradients per mode, computed once."""
    tok = model["tokens"]
    labels = np.roll(tok, -1, axis=1)
    labels[:, ::7] = -1
    jbatch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(labels)}
    res = {}
    for mode in MODES:
        jrt = JRuntime(mode=mode, interpret=True)
        (loss, _), grads = jax.value_and_grad(
            lambda p, rt=jrt: jlm.loss_fn(p, jbatch, model["jcfg"], rt),
            has_aux=True)(model["jparams"])
        res[mode] = (float(loss), grads)
    return labels, res


@pytest.mark.parametrize("mode,remat", [("brainslug", "none"),
                                        ("brainslug", "full"),
                                        ("xla", "none"), ("barrier", "full")])
def test_loss_and_grads_match_jax(model, loss_case, mode, remat):
    """mamba2 ties its embeddings, so every mode takes the plain loss."""
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
    it = iter(torch.autograd.grad(loss, leaves))
    got = convert.grads_to_numpy(tbase.tree_map(lambda _: next(it), params),
                                 like=model["np_params"])
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=REL)
    jflat = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    gflat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert set(jflat) == set(gflat)
    for k, w in jflat.items():
        w = np.asarray(w)
        np.testing.assert_allclose(gflat[k], w, rtol=REL,
                                   atol=REL * float(np.abs(w).max()),
                                   err_msg=jax.tree_util.keystr(k))


@pytest.mark.parametrize("mode", MODES)
def test_decode_steps_match_jax(model, mode):
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    steps = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    jrt = JRuntime(mode=mode, interpret=True)
    jcache = jlm.init_decode_cache(jcfg, B, 16, dtype=jnp.float32)
    params = _tparams(model)
    tcache = tlm.init_decode_cache(tcfg, B, 16, dtype=torch.float32,
                                   device="cpu")
    c = tcache["blocks"]["sub0"]
    assert isinstance(c, tmamba.MambaCache)
    assert tuple(c.conv.shape) == (4, B, 3, tcfg.d_inner + 2 * 16)
    assert tuple(c.state.shape) == (4, B, 8, 16, 32)
    assert c.state.dtype == torch.float32
    for i, t in enumerate(steps):
        active = None if i < STEPS - 1 else np.array([False, True])
        jlo, jcache = jlm.decode_step(
            model["jparams"], jcache, jnp.asarray(t), jcfg, jrt,
            active=None if active is None else jnp.asarray(active))
        tlo, same = tlm.decode_step(
            params, tcache, torch.from_numpy(t).long(), tcfg,
            TRuntime(mode=mode),
            active=None if active is None else torch.from_numpy(active))
        assert same is tcache
        assert _rel(tlo, jlo) <= REL, i
    jc = jcache["blocks"]["sub0"]
    assert _rel(c.conv, jc.conv) <= REL
    assert _rel(c.state, jc.state) <= REL


def test_cache_primitives_on_mamba_layers(model):
    """``reset_slots`` zeroes batch axis 1 of the conv window and state;
    ``copy_blocks`` leaves mamba caches alone; the JAX primitives agree."""
    tcfg, jcfg = model["tcfg"], model["jcfg"]
    cache = tlm.init_decode_cache(tcfg, 3, 8, dtype=torch.float32,
                                  device="cpu")
    c = cache["blocks"]["sub0"]
    c.conv.uniform_(1, 2)
    c.state.uniform_(1, 2)
    before = (c.conv.clone(), c.state.clone())
    assert tlm.copy_blocks(cache, 0, 1) is cache
    assert torch.equal(c.conv, before[0]) and torch.equal(c.state, before[1])
    mask = np.array([False, True, False])
    tlm.reset_slots(cache, torch.from_numpy(mask))
    jcache = jlm.init_decode_cache(jcfg, 3, 8, dtype=jnp.float32)
    jcache = jax.tree_util.tree_map(lambda a: jnp.ones_like(a), jcache)
    jcache = jlm.reset_slots(jcache, jnp.asarray(mask))
    jc = jcache["blocks"]["sub0"]
    np.testing.assert_array_equal(c.conv.numpy() == 0,
                                  np.asarray(jc.conv) == 0)
    np.testing.assert_array_equal(c.state.numpy() == 0,
                                  np.asarray(jc.state) == 0)
    assert torch.equal(c.conv[:, 0], before[0][:, 0])


SC = dict(arch=ARCH, batch=3, prompt_len=10, new_tokens=6, max_len=20)


@pytest.fixture(scope="module")
def servers():
    out, params = {}, None
    for mode in ("xla", "brainslug"):
        js = jserve.Server(jserve.ServeConfig(mode=mode, **SC))
        if params is None:
            params = convert.lm_params_from_numpy(
                jax.tree_util.tree_map(np.asarray, js.params), "cpu")
        ts = tserve.Server(tserve.ServeConfig(mode=mode, torch_device="cpu",
                                              **SC), params=params)
        out[mode] = (js, ts)
    return out


@pytest.mark.parametrize("mode", ["xla", "brainslug"])
def test_server_and_engine_match_jax(servers, mode):
    js, ts = servers[mode]
    vocab = ts.cfg.vocab_size
    prompts = np.random.default_rng(0).integers(0, vocab, (3, 10)).astype(
        np.int32)
    np.testing.assert_array_equal(ts.generate(prompts), js.generate(prompts))
    rng = np.random.default_rng(1)
    reqs = [dict(request_id=i,
                 prompt=rng.integers(1, vocab, int(rng.integers(0, 9))
                                     ).tolist(),
                 max_new_tokens=int(rng.integers(1, 6))) for i in range(6)]
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
        assert eng.report()["decode_path"] == "ssm-recurrent"
        assert eng.prefix_sharing is False


@pytest.mark.parametrize("mode", ["xla", "brainslug"])
def test_trainer_matches_jax_trainer(mode):
    kw = dict(arch=ARCH, reduced=True, batch_override=2, seq_override=32,
              steps=3, lr=3e-3, mode=mode, log_every=100)
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


def test_hybrid_still_raises():
    cfg = tconfigs.get_config("zamba2-7b").reduced()
    for fn in (lambda: tlm.init(0, cfg, device="cpu"),
               lambda: tlm.init_decode_cache(cfg, 1, 4, device="cpu")):
        with pytest.raises(NotImplementedError, match="hybrid slice") as e:
            fn()
        assert "128" in str(e.value)
    with pytest.raises(ValueError, match="ssd_chunk"):
        TRuntime(ssd_chunk=0)
