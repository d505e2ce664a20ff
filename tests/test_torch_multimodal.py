"""The port's multimodal frontends (``repro_torch.models.lm`` with
``audio_frames`` and ``vision_patches``) against the JAX package's, on the
CPU.

The configs are ``hubert-xlarge`` and ``paligemma-3b`` ``reduced()``: 4
layers, d_model 128, 4 heads of 32 (paligemma over 1 KV head), frontend 64
wide (paligemma 8 patches).  hubert is an encoder over frame embeddings
(``frames @ frontend_proj``, no causal mask, an untied head, no decode
path); paligemma puts its projected patches in front of the tied, scaled
token embeddings under the plain causal mask, reads the loss on the text
positions only, and serves text alone.  JAX weights are carried across by
``convert.lm_params_from_numpy``; JAX runs its Pallas kernels in interpret
mode, the port the kernels' plain versions.

Tolerances: float32 logits within 1e-5 of max|logit| and the loss within
1e-5 relative (products summed in another order through 4 layers); every
leaf's gradient within rtol 1e-4 and atol 1e-4 x max|g|; hubert's bf16
weights under float32 frames compute in float32 (jnp's promotion), their
logits within 2e-2 of max (bf16 weights rounded at other places); two
``Trainer`` steps' losses within 1e-5 relative and grad norms within
1e-4; greedy tokens identical."""
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
from repro.data import pipeline as jpipe
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs.base import RuntimeConfig as TRuntime
from repro_torch.launch import engine as tengine
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.layers import base as tbase
from repro_torch.models import lm as tlm

torch.set_num_threads(1)

HUBERT, PALIGEMMA = "hubert-xlarge", "paligemma-3b"
ARCHS = (HUBERT, PALIGEMMA)
REL = 1e-5
GRAD_REL = 1e-4
B, S = 2, 16


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


def _flat(tree, path=""):
    """A torch tree as {JAX keystr: leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, path + f"['{k}']"))
        else:
            out[path + f"['{k}']"] = v
    return out


def _batch(jcfg, seed=1):
    """A training batch of the JAX pipeline at (B, S): float32 frames and
    frame labels (hubert), or tokens, next-token labels (every 5th masked)
    and float32 patches (paligemma)."""
    shape = dataclasses.replace(jconfigs.LM_SHAPES["train_4k"], seq_len=S,
                                global_batch=B)
    batch = jpipe.synth_batch(jcfg, shape, 0, seed=seed)
    batch["labels"][:, ::5] = -1
    return batch


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg, tcfg = _cfgs(request.param)
    jparams, _ = jlm.init(jax.random.PRNGKey(0), jcfg)
    return dict(arch=request.param, jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                np_params=jax.tree_util.tree_map(np.asarray, jparams),
                batch=_batch(jcfg))


def _tparams(model):
    return convert.lm_params_from_numpy(model["np_params"], "cpu")


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in batch.items()}


def test_init_tree_matches_jax(model):
    """The init tree's names, shapes and dtypes, ``frontend_proj`` (frontend
    x d_model) among them, and each leaf's std within 10% of the JAX
    init's (zeros and ones exactly): ``frontend_proj`` at 1 / sqrt(64),
    paligemma's tied ``embed`` at 0.02."""
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    jflat = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
             jax.tree_util.tree_flatten_with_path(model["jparams"])[0]}
    tparams = tlm.init(0, tcfg, device="cpu")
    tflat = _flat(tparams)
    assert set(tflat) == set(jflat)
    assert tuple(tparams["frontend_proj"].shape) == (tcfg.frontend_dim,
                                                     tcfg.d_model)
    assert ("out_head" in tparams) == (model["arch"] == HUBERT)
    for k, jv in jflat.items():
        tv = tflat[k]
        assert tuple(tv.shape) == jv.shape, k
        assert str(tv.dtype).replace("torch.", "") == str(jv.dtype), k
        js, ts = float(np.std(jv)), float(tv.float().std())
        tol = max(0.1, 3.0 / np.sqrt(2 * jv.size))
        assert abs(ts - js) <= tol * js + 1e-6, (k, ts, js)
    assert tbase.param_count(tparams) == sum(
        int(v.size) for v in jflat.values())


def test_embed_inputs_match_jax(model):
    """hubert: ``frames @ frontend_proj``; paligemma: the projected patches
    in front of the token embeddings scaled by sqrt(d_model) (the scale on
    the tokens only)."""
    jcfg, tcfg, batch = model["jcfg"], model["tcfg"], model["batch"]
    want = np.asarray(jlm.embed_inputs(model["jparams"], _jbatch(batch),
                                       jcfg))
    got = tlm.embed_inputs(_tparams(model), _tbatch(batch), tcfg)
    extra = tcfg.n_prefix_tokens if model["arch"] == PALIGEMMA else 0
    assert tuple(got.shape) == (B, S + extra, tcfg.d_model)
    assert _rel(got, want) <= REL
    if model["arch"] == PALIGEMMA:      # the patches carry no scale
        proj = batch["patches"] @ model["np_params"]["frontend_proj"]
        np.testing.assert_allclose(got[:, :extra].numpy(), proj, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(proj).max()))


@pytest.mark.parametrize("mode", ["brainslug", "barrier"])
def test_forward_and_prefill_match_jax(model, mode):
    """Logits over every position (paligemma's patch positions too) within
    1e-5 of max; prefill's last position likewise."""
    jcfg, tcfg, batch = model["jcfg"], model["tcfg"], model["batch"]
    want, _ = jlm.forward(model["jparams"], _jbatch(batch), jcfg,
                          JRuntime(mode=mode, interpret=True))
    params = _tparams(model)
    got, _ = tlm.forward(params, _tbatch(batch), tcfg, TRuntime(mode=mode))
    assert got.dtype == torch.float32
    assert _rel(got, want) <= REL
    assert _rel(tlm.prefill(params, _tbatch(batch), tcfg,
                            TRuntime(mode=mode)),
                np.asarray(want)[:, -1:]) <= REL


@pytest.fixture(scope="module")
def jax_grads(model):
    """The JAX loss and gradients in brainslug mode, computed once."""
    jrt = JRuntime(mode="brainslug", interpret=True)
    jb = _jbatch(model["batch"])
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jb, model["jcfg"], jrt),
        has_aux=True))(model["jparams"])
    return float(loss), grads


def _port_grads(model, mode):
    params = _tparams(model)
    leaves = tbase.tree_leaves(params)
    for p in leaves:
        p.requires_grad_()
    loss, _ = tlm.loss_fn(params, _tbatch(model["batch"]), model["tcfg"],
                          TRuntime(mode=mode))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, grads)])
    return float(loss.detach()), convert.grads_to_numpy(
        tbase.tree_map(lambda _: next(it), params), like=model["np_params"])


@pytest.mark.parametrize("mode", ["brainslug", "barrier"])
def test_loss_and_grads_match_jax(model, jax_grads, mode):
    """The loss within 1e-5 and every leaf's gradient within rtol / atol
    1e-4 of JAX's: ``frontend_proj``'s is nonzero; paligemma's tied
    ``embed`` takes gradient from the input and from the logits of the
    text positions; hubert's ``embed`` (no token input) gets none, as
    JAX's is zero."""
    want_loss, want = jax_grads
    loss, got = _port_grads(model, mode)
    np.testing.assert_allclose(loss, want_loss, rtol=REL)
    jflat = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
             jax.tree_util.tree_flatten_with_path(want)[0]}
    gflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(got)[0]}
    assert set(jflat) == set(gflat)
    for k, w in jflat.items():
        np.testing.assert_allclose(
            gflat[k], w, rtol=GRAD_REL,
            atol=GRAD_REL * max(float(np.abs(w).max()), 1e-30), err_msg=k)
    assert float(np.abs(gflat["['frontend_proj']"]).max()) > 0
    embed = float(np.abs(gflat["['embed']"]).max())
    assert (embed > 0) == (model["arch"] == PALIGEMMA)


def test_vision_loss_reads_the_text_positions():
    """paligemma's loss is the mean over the text positions: labels as
    long as the tokens, the patch positions' hidden states dropped."""
    jcfg, tcfg = _cfgs(PALIGEMMA)
    params = tlm.init(0, tcfg, device="cpu")
    batch = _tbatch(_batch(jcfg, seed=3))
    rt = TRuntime(mode="barrier")
    h, _ = tlm.hidden(params, batch, tcfg, rt)
    assert h.shape[1] == S + tcfg.n_prefix_tokens
    loss, _ = tlm.loss_fn(params, batch, tcfg, rt)
    text = tlm._logits(params, h[:, tcfg.n_prefix_tokens:], tcfg).float()
    labels = batch["labels"]
    mask = labels >= 0
    nll = (torch.logsumexp(text, -1) - torch.gather(
        text, -1, labels.clamp_min(0)[..., None])[..., 0])[mask].mean()
    torch.testing.assert_close(loss, nll, rtol=1e-6, atol=0)


@pytest.mark.parametrize("frames_dtype", ["float32", "bfloat16"])
def test_hubert_bf16_weights_promote_as_jax(frames_dtype):
    """bf16 weights under float32 frames: jnp promotes every product of
    the float32 stream with a bf16 weight to float32, so JAX's hidden state
    and logits are float32, and so are the port's (within 2e-2 of max,
    brainslug and barrier); the weight gradients come back in bf16, and
    ``frontend_proj``'s is nonzero.  Under bf16 frames both stay bf16."""
    jcfg, tcfg = _cfgs(HUBERT, dtype="bfloat16")
    jparams, _ = jlm.init(jax.random.PRNGKey(2), jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    batch = _batch(jcfg, seed=4)
    jb = _jbatch(batch)
    tb = _tbatch(batch)
    if frames_dtype == "bfloat16":
        jb["frames"] = jb["frames"].astype(jnp.bfloat16)
        tb["frames"] = tb["frames"].bfloat16()
    want_dt = torch.float32 if frames_dtype == "float32" else torch.bfloat16
    for mode in ("brainslug", "barrier"):
        jrt = JRuntime(mode=mode, interpret=True)
        jh, _ = jlm.hidden(jparams, jb, jcfg, jrt)
        jlo, _ = jlm.forward(jparams, jb, jcfg, jrt)
        params = convert.lm_params_from_numpy(np_params, "cpu")
        h, _ = tlm.hidden(params, tb, tcfg, TRuntime(mode=mode))
        lo, _ = tlm.forward(params, tb, tcfg, TRuntime(mode=mode))
        assert str(jh.dtype) == str(jlo.dtype) == str(want_dt)[6:]
        assert h.dtype == lo.dtype == want_dt
        assert _rel(lo, np.asarray(jlo, np.float32)) <= 2e-2
    leaves = tbase.tree_leaves(params)
    for p in leaves:
        p.requires_grad_()
    loss, _ = tlm.loss_fn(params, tb, tcfg, TRuntime(mode="brainslug"))
    assert loss.dtype == torch.float32
    (g,) = torch.autograd.grad(loss, [params["frontend_proj"]])
    assert g.dtype == torch.bfloat16 and float(g.abs().max()) > 0


def _trainer_kw(arch, mode):
    return dict(arch=arch, reduced=True, batch_override=B, seq_override=S,
                steps=2, lr=3e-3, mode=mode, log_every=100)


@pytest.mark.parametrize("arch,mode", [(HUBERT, "brainslug"),
                                       (PALIGEMMA, "barrier")])
def test_trainer_matches_jax_trainer(arch, mode):
    """Two AdamW steps of both ``Trainer``s from the JAX weights over the
    pipeline's float32 frames or patches."""
    kw = _trainer_kw(arch, mode)
    want = jtrain.train(jtrain.TrainerConfig(**kw))
    jcfg, _ = _cfgs(arch)
    np_params = jax.tree_util.tree_map(
        np.asarray, jlm.init(jax.random.PRNGKey(0), jcfg)[0])
    got = ttrain.train(ttrain.TrainerConfig(**kw, device="cpu"),
                       init_params=lambda cfg, dev:
                       convert.lm_params_from_numpy(np_params, dev))
    assert [h["step"] for h in got] == [h["step"] for h in want] == [0, 1]
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in want], rtol=REL)
    np.testing.assert_allclose([h["grad_norm"] for h in got],
                               [h["grad_norm"] for h in want], rtol=1e-4)


SC = dict(batch=2, prompt_len=8, new_tokens=5, max_len=32)


class _Cut:
    """Stands in for the config ``jserve.Server`` looks up: its
    ``reduced()`` is the test's config."""

    def __init__(self, cfg):
        self.cfg = cfg

    def reduced(self):
        return self.cfg


@pytest.mark.parametrize("mode", ["brainslug", "barrier"])
def test_paligemma_server_serves_text_as_jax(mode):
    """The Server drops the vision frontend and serves text: greedy tokens
    of ``Server.generate`` and of the paged ``Engine.run`` equal the JAX
    ``Server``'s on its own parameters, 1 KV head of 32."""
    jcfg, tcfg = _cfgs(PALIGEMMA)
    sc = dict(arch=PALIGEMMA, mode=mode, **SC)
    with mock.patch.object(jserve, "get_config", lambda _: _Cut(jcfg)):
        js = jserve.Server(jserve.ServeConfig(**sc))
    assert "frontend_proj" not in js.params
    ts = tserve.Server(tserve.ServeConfig(torch_device="cpu", **sc),
                       params=convert.lm_params_from_numpy(
                           jax.tree_util.tree_map(np.asarray, js.params),
                           "cpu"), cfg=tcfg)
    assert ts.cfg.frontend is None and ts.cfg.n_prefix_tokens == 0
    prompts = np.random.default_rng(0).integers(
        0, tcfg.vocab_size, (2, 8)).astype(np.int32)
    np.testing.assert_array_equal(ts.generate(prompts), js.generate(prompts))
    reqs = [dict(request_id=i, prompt=prompts[i % 2, :4 + i].tolist(),
                 max_new_tokens=3) for i in range(3)]
    kw = dict(prefill_chunk=3, kv_layout="paged", kv_block_size=4,
              verify_mode="strict")
    from repro.launch import engine as jengine
    jc = js.engine(slots=2, **kw).run([jengine.Request(**r) for r in reqs])
    tc = ts.engine(slots=2, **kw).run([tengine.Request(**r) for r in reqs])
    assert [list(map(int, c.tokens)) for c in tc] == \
        [list(map(int, c.tokens)) for c in jc]


def test_hubert_server_and_engine_raise():
    """An encoder has no decode path: the Server and the Engine refuse it,
    as the JAX package's do; its decode cache still builds."""
    _, tcfg = _cfgs(HUBERT)
    with pytest.raises(ValueError, match="encoder-only"):
        tserve.Server(tserve.ServeConfig(arch=HUBERT, torch_device="cpu"))
    params = tlm.init(0, tcfg, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        tengine.Engine(tcfg, params, TRuntime(), slots=2, max_len=16)
    cache = tlm.init_decode_cache(tcfg, 2, 8, device="cpu")
    assert tuple(cache["blocks"]["sub0"].k.shape) == (
        tcfg.n_layers, 2, tcfg.n_kv_heads, 8, tcfg.head_dim)
