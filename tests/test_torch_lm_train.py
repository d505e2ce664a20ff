"""The port's LM training path against the JAX package's, on the CPU.

* the backwards of the ported forward kernels (``rmsnorm``, ``swiglu``,
  ``flash_attention``: ``torch.autograd.Function``s recomputing through
  their oracles) against ``jax.vjp`` of the JAX ops, float32, 1e-5;
* ``lm.loss_fn`` and every parameter gradient against
  ``jax.value_and_grad(repro.models.lm.loss_fn)`` at reduced deepseek-7b
  (float32, the same weights via ``convert``), in all three modes, with
  ``fused_loss_chunk`` 0 and 16 and ``remat`` "none", "dots" and "full"
  (``dots`` against the JAX package's ``dots``, and bit for bit against
  the port's ``none``): losses
  within 1e-4 relative, gradients within rtol 1e-4 and atol 1e-4 x max|g|
  per leaf (float32 sums in another order through 4 layers);
* ``adamw.update`` with ``warmup_cosine`` against the JAX functions over
  three steps on the same trees, 1e-6, the decay of the layer-stacked
  (L, d_model) norm scales included;
* ``synth_batch`` equal to the JAX package's, bit for bit.

JAX runs its Pallas kernels in interpret mode; the port runs the kernels'
plain versions.  JAX results are computed once per module."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import RuntimeConfig as JRuntime
from repro.configs.base import ShapeConfig as JShape
from repro.data import pipeline as jpipe
from repro.kernels.attention import ops as jattn_ops
from repro.kernels.rmsnorm import ops as jrms_ops
from repro.kernels.swiglu import ops as jswiglu_ops
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs.base import RuntimeConfig as TRuntime
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels.attention import ops as tattn_ops
from repro_torch.kernels.rmsnorm import ops as trms_ops
from repro_torch.kernels.swiglu import ops as tswiglu_ops
from repro_torch.layers import base as tbase
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import schedule as tschedule

# one intra-op thread: these small tensors gain nothing from more, and
# under pytest-xdist several workers' thread pools on the same cores
# made a 0.6 s test take minutes
torch.set_num_threads(1)

TOL = 1e-5
TRAIN_RTOL = 1e-4
B, S = 2, 32


def _randn(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32)).requires_grad_()


# -- the kernels' backwards --------------------------------------------------

def _case_rmsnorm(rng, residual):
    x, s = _randn(rng, (3, 5, 64)), 1.0 + _randn(rng, (64,), 0.1)
    r = _randn(rng, (3, 5, 64)) if residual else None
    gy, gh = _randn(rng, x.shape), _randn(rng, x.shape)
    if residual:
        _, vjp = jax.vjp(lambda a, b, c: jrms_ops.rmsnorm(
            a, b, c, 1e-6, 256, True), x, s, r)
        want = vjp((gy, gh))
        ts = [_t(a) for a in (x, s, r)]
        y, h = trms_ops.rmsnorm(*ts, 1e-6)
        got = torch.autograd.grad((y, h), ts, (torch.from_numpy(gy),
                                               torch.from_numpy(gh)))
    else:
        _, vjp = jax.vjp(lambda a, b: jrms_ops.rmsnorm(
            a, b, None, 1e-6, 256, True)[0], x, s)
        want = vjp(gy)
        ts = [_t(a) for a in (x, s)]
        y, h = trms_ops.rmsnorm(*ts, None, 1e-6)
        assert h is ts[0]
        got = torch.autograd.grad(y, ts, torch.from_numpy(gy))
    return got, want


def _case_swiglu(rng, act):
    g, u = _randn(rng, (4, 3, 48), 1.5), _randn(rng, (4, 3, 48))
    gy = _randn(rng, g.shape)
    _, vjp = jax.vjp(lambda a, b: jswiglu_ops.swiglu(a, b, act, 256, True),
                     g, u)
    ts = [_t(a) for a in (g, u)]
    y = tswiglu_ops.swiglu(*ts, act)
    return torch.autograd.grad(y, ts, torch.from_numpy(gy)), vjp(gy)


def _case_flash(rng, causal):
    q = _randn(rng, (1, 4, 24, 32))
    k, v = _randn(rng, (1, 2, 24, 32)), _randn(rng, (1, 2, 24, 32))
    g = _randn(rng, q.shape)
    _, vjp = jax.vjp(lambda a, b, c: jattn_ops.flash_attention(
        a, b, c, causal, 8, 8, True, None), q, k, v)
    ts = [_t(a) for a in (q, k, v)]
    o = tattn_ops.flash_attention(*ts, causal, 8, 8)
    return torch.autograd.grad(o, ts, torch.from_numpy(g)), vjp(g)


KERNEL_BWD_CASES = {
    "rmsnorm_residual": lambda rng: _case_rmsnorm(rng, True),
    "rmsnorm": lambda rng: _case_rmsnorm(rng, False),
    "swiglu_silu": lambda rng: _case_swiglu(rng, "silu"),
    "swiglu_gelu": lambda rng: _case_swiglu(rng, "gelu"),
    "flash_causal": lambda rng: _case_flash(rng, True),
    "flash": lambda rng: _case_flash(rng, False),
}


@pytest.mark.parametrize("name", sorted(KERNEL_BWD_CASES))
def test_kernel_backward_matches_jax_vjp(name):
    rng = np.random.default_rng(sorted(KERNEL_BWD_CASES).index(name))
    got, want = KERNEL_BWD_CASES[name](rng)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


# -- lm.loss_fn ---------------------------------------------------------------

@pytest.fixture(scope="module")
def lm_case():
    """Reduced deepseek-7b, the JAX weights, a synthetic batch with a few
    masked labels, and the JAX loss and gradients per (mode, chunk)."""
    jcfg = jconfigs.get_config("deepseek-7b").reduced()
    jparams, _ = jlm.init(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    batch = jpipe.synth_batch(jcfg, JShape("t", S, B, "train"), 0)
    batch["labels"][:, ::9] = -1
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    res = {}
    for mode, chunk in (("brainslug", 0), ("xla", 0), ("xla", 16),
                        ("barrier", 0), ("barrier", 16)):
        for remat in ("none", "dots"):
            rt = JRuntime(mode=mode, interpret=True, fused_loss_chunk=chunk,
                          remat=remat)
            fn = jax.jit(jax.value_and_grad(
                lambda p, b, rt=rt: jlm.loss_fn(p, b, jcfg, rt),
                has_aux=True))
            (loss, metrics), grads = fn(jparams, jbatch)
            res[(mode, chunk, remat)] = (
                float(loss), float(metrics["nll"]),
                jax.tree_util.tree_map(np.asarray, grads))
    return dict(tcfg=tconfigs.get_config("deepseek-7b").reduced(),
                np_params=np_params, batch=batch, res=res)


def _assert_grads(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_grads(got[k], want[k], f"{what}/{k}")
        return
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=TRAIN_RTOL,
                               atol=TRAIN_RTOL * scale, err_msg=what)


def _loss_and_grads(lm_case, rt):
    params = convert.lm_params_from_numpy(lm_case["np_params"], "cpu")
    leaves = tbase.tree_leaves(params)
    for p in leaves:
        p.requires_grad_()
    batch = {k: torch.from_numpy(v) for k, v in lm_case["batch"].items()}
    loss, metrics = tlm.loss_fn(params, batch, lm_case["tcfg"], rt)
    return params, leaves, loss, metrics, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
@pytest.mark.parametrize("chunk", [0, 16])
@pytest.mark.parametrize("mode", ["brainslug", "xla", "barrier"])
def test_loss_and_grads_match_jax(lm_case, mode, chunk, remat):
    """``brainslug`` takes the fused CE kernel whatever the chunk (its JAX
    reference too); the other modes take ``_nll_from_hidden``, chunked
    under ``torch.utils.checkpoint`` at 16.  ``remat="dots"`` is held
    against the JAX package's own ``dots``, and against the port's
    ``remat="none"`` bit for bit."""
    rt = TRuntime(mode=mode, remat=remat, fused_loss_chunk=chunk)
    params, _, loss, metrics, grads = _loss_and_grads(lm_case, rt)
    assert set(metrics) == {"loss", "nll", "router_aux_loss",
                            "drop_fraction"}
    it = iter(grads)
    gtree = convert.grads_to_numpy(tbase.tree_map(lambda _: next(it), params),
                                   like=lm_case["np_params"])
    want_loss, want_nll, want_grads = lm_case["res"][
        (mode, 0 if mode == "brainslug" else chunk,
         "dots" if remat == "dots" else "none")]
    np.testing.assert_allclose(float(loss.detach()), want_loss,
                               rtol=TRAIN_RTOL)
    np.testing.assert_allclose(float(metrics["nll"].detach()), want_nll,
                               rtol=TRAIN_RTOL)
    _assert_grads(gtree, want_grads, f"{mode} chunk={chunk} remat={remat}")
    if remat == "dots":
        _, _, loss0, _, grads0 = _loss_and_grads(
            lm_case, TRuntime(mode=mode, fused_loss_chunk=chunk))
        assert torch.equal(loss.detach(), loss0.detach())
        assert all(torch.equal(a, b) for a, b in zip(grads, grads0))


class _OpCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the aten products that run while it is active."""

    OPS = {"mm": torch.ops.aten.mm.default,
           "addmm": torch.ops.aten.addmm.default,
           "bmm": torch.ops.aten.bmm.default}

    def __init__(self):
        super().__init__()
        self.counts = dict.fromkeys(self.OPS, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        for name, op in self.OPS.items():
            if func is op:
                self.counts[name] += 1
        return func(*args, **(kwargs or {}))


def _products(lm_case, remat):
    """The products of the forward, and of the backward (where the
    recomputation runs), at ``mode="barrier"``: the plain attention's
    QK^T and PV are ``bmm``s, the projections and the MLP ``mm``s."""
    params = convert.lm_params_from_numpy(lm_case["np_params"], "cpu")
    leaves = tbase.tree_leaves(params)
    for p in leaves:
        p.requires_grad_()
    batch = {k: torch.from_numpy(v) for k, v in lm_case["batch"].items()}
    with _OpCounter() as fwd:
        loss, _ = tlm.loss_fn(params, batch, lm_case["tcfg"],
                              TRuntime(mode="barrier", remat=remat))
    with _OpCounter() as bwd:
        torch.autograd.grad(loss, leaves)
    return fwd.counts, bwd.counts


def test_remat_dots_saves_unbatched_products_only(lm_case):
    """During the backward ``dots`` recomputes no ``mm`` / ``addmm`` (they
    are as many as under ``none``) and recomputes every ``bmm`` of the
    blocks; ``full`` recomputes the blocks' products too.  The vocab head
    sits outside the remat'd blocks and is not recomputed; nor is a
    block's last product (the MLP's down projection): non-reentrant
    checkpointing stops recomputing once it has every tensor the backward
    saved, and that product's output is not one."""
    fwd, none = _products(lm_case, "none")
    _, dots = _products(lm_case, "dots")
    _, full = _products(lm_case, "full")
    layers = lm_case["tcfg"].n_layers
    assert fwd["bmm"] == 2 * layers and fwd["mm"] == 7 * layers + 1
    assert dots["mm"] == none["mm"] and dots["addmm"] == none["addmm"]
    assert dots["bmm"] == none["bmm"] + fwd["bmm"]
    assert full["mm"] == none["mm"] + 6 * layers
    assert full["bmm"] == dots["bmm"]


def test_remat_rejects_unknown_policies():
    with pytest.raises(ValueError, match="remat"):
        TRuntime(remat="some")


# -- AdamW and the schedule ---------------------------------------------------

def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_adamw_and_schedule_match_jax():
    """Three updates with a warmup-cosine rate: parameters, moments, count
    and metrics equal the JAX package's within 1e-6; the stacked (L,
    d_model) norm scales, with zero gradients, decay as the JAX rule
    decays every leaf of two or more dimensions."""
    jcfg = jconfigs.get_config("deepseek-7b").reduced()
    jparams = _tree_np(jlm.init(jax.random.PRNGKey(1), jcfg)[0])
    rng = np.random.default_rng(5)
    grads_seq = [jax.tree_util.tree_map(
        lambda a: _randn(rng, a.shape, 0.5), jparams) for _ in range(3)]
    for g in grads_seq:
        g["blocks"]["sub0"]["norm1"]["scale"][...] = 0.0
    jcfg_opt = jadamw.AdamWConfig(lr=jschedule.warmup_cosine(1e-2, 2, 5))
    tcfg_opt = tadamw.AdamWConfig(lr=tschedule.warmup_cosine(1e-2, 2, 5))
    jp, jstate = jparams, jadamw.init(jparams)
    tp = convert.lm_params_from_numpy(jparams, "cpu")
    tstate = tadamw.init(tp)
    assert tstate["count"].dtype == torch.int32
    norm0 = tp["blocks"]["sub0"]["norm1"]["scale"].clone()
    for g in grads_seq:
        jp, jstate, jm = jadamw.update(
            jcfg_opt, jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
        tp, tstate, tm = tadamw.update(
            tcfg_opt, convert.lm_params_from_numpy(g, "cpu"), tstate, tp)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    assert int(tstate["count"]) == int(jstate["count"]) == 3
    for got, want in ((tp, jp), (tstate["mu"], jstate["mu"]),
                      (tstate["nu"], jstate["nu"])):
        _assert_tree_close(convert.grads_to_numpy(got), _tree_np(want))
    norm = tp["blocks"]["sub0"]["norm1"]["scale"]
    assert norm.shape == (jcfg.n_layers, jcfg.d_model)
    assert float((norm - norm0).abs().max()) > 0      # decayed, no gradient
    assert tp["final_norm"]["scale"].dim() == 1
    for step in (0, 1, 2, 3, 7):
        np.testing.assert_allclose(
            float(tschedule.warmup_cosine(3e-4, 3, 10)(torch.tensor(step))),
            float(jschedule.warmup_cosine(3e-4, 3, 10)(jnp.asarray(step))),
            rtol=1e-6)


def _assert_tree_close(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree_close(got[k], want[k])
        return
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_adamw_keeps_bf16_params_and_f32_moments():
    p = {"w": torch.ones((3, 4), dtype=torch.bfloat16),
         "b": torch.ones((4,), dtype=torch.bfloat16)}
    state = tadamw.init(p)
    assert all(m.dtype == torch.float32 for m in tbase.tree_leaves(
        state["mu"]))
    w_before = p["w"]
    g = {"w": torch.full((3, 4), 0.5, dtype=torch.bfloat16),
         "b": torch.zeros((4,), dtype=torch.bfloat16)}
    p, state, _ = tadamw.update(tadamw.AdamWConfig(lr=0.1), g, state, p)
    assert p["w"] is w_before and p["w"].dtype == torch.bfloat16
    assert float(p["b"][0]) == 1.0                  # 1-d: no decay
    assert float(p["w"][0, 0]) < 1.0


# -- data ------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek-7b", "qwen2.5-14b"])
def test_synth_batch_equals_jax(arch):
    jcfg = jconfigs.get_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    for step, seed in ((0, 1234), (3, 1234), (2, 7)):
        want = jpipe.synth_batch(jcfg, JShape("t", 64, 3, "train"), step,
                                 seed)
        got = tpipe.synth_batch(tcfg, TShape("t", 64, 3, "train"), step,
                                seed)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
