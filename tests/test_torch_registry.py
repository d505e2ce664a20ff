"""The kernel registry of the port (``repro_torch.core.registry``) on the
traced LM twins, against the JAX package on the CPU: the transformer block
at head dim 128, 112 and 64 (every kernel dispatches) and 16, 96 and 136
(attention falls back to its plain version, the reason in ``report()``),
the CE tail, their
gradients against ``jax.grad``; the probe's fence veto, a vetoed match
shown in ``report()``, device errors that propagate, the KERNEL op's
interpreter semantics, the shared kernel cache and ``with_ref_vjp``."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro_torch import api
from repro_torch.convert import params_from_numpy
from repro_torch.core import autodiff, codegen, ir, registry
from repro_torch.models import lm as tlm

TOL = 2e-4
K = ir.OpKind


def _cfg(mode, **kw):
    return api.OptimizeConfig(mode=mode, torch_device="cpu", **kw)


def _block_case(d_model, n_heads, d_ff, seq, seed=0):
    """numpy weights, input and cotangent of a transformer block; the JAX
    output and gradients of the input and every weight."""
    rng = np.random.default_rng(seed)
    like = tlm.transformer_block_params(d_model, n_heads, d_ff, device="cpu")
    np_params = {k: (rng.standard_normal(v.shape) * (
        0.1 if k.startswith("norm") else 1.0 / v.shape[0] ** 0.5)
        + (1.0 if k.startswith("norm") else 0.0)).astype(np.float32)
        for k, v in like.items()}
    x = rng.standard_normal((2, seq, d_model)).astype(np.float32)
    cot = rng.standard_normal((2, seq, d_model)).astype(np.float32)

    def jloss(x, p):
        y = jlm.transformer_block_fn(x, p, n_heads=n_heads)
        return jnp.sum(y * cot), y

    (_, y), (gx, gp) = jax.value_and_grad(jloss, argnums=(0, 1),
                                          has_aux=True)(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in np_params.items()})
    params = params_from_numpy(np_params, "cpu", like=like)
    return params, x, cot, np.asarray(y), np.asarray(gx), \
        {k: np.asarray(v) for k, v in gp.items()}


def _run_block(params, x, cot, n_heads, mode):
    fn = lambda x, p: tlm.transformer_block_fn(x, p, n_heads=n_heads)  # noqa
    net = api.optimize(fn, torch.from_numpy(x), params,
                       config=_cfg(mode, differentiable=True))
    xt = torch.from_numpy(x).requires_grad_()
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    before = registry.STATS.snapshot()
    y = net(xt, leaves)
    torch.sum(y * torch.from_numpy(cot)).backward()
    return net, y, xt.grad, {k: v.grad for k, v in leaves.items()}, \
        registry.STATS.delta(before)


def _assert_grads(gx, gp, jgx, jgp, tol):
    np.testing.assert_allclose(gx.numpy(), jgx, rtol=tol,
                               atol=tol * float(np.abs(jgx).max()))
    for k, g in jgp.items():
        np.testing.assert_allclose(gp[k].numpy(), g, rtol=tol,
                                   atol=tol * float(np.abs(g).max()))


@pytest.mark.parametrize("mode", ["brainslug", "barrier"])
def test_block_at_head_dim_128_dispatches_every_kernel(mode):
    params, x, cot, jy, jgx, jgp = _block_case(256, 2, 512, 16)
    net, y, gx, gp, delta = _run_block(params, x, cot, 2, mode)
    np.testing.assert_allclose(y.detach().numpy(), jy, rtol=TOL, atol=TOL)
    _assert_grads(gx, gp, jgx, jgp, 1e-4)
    report = net.report()
    if mode == "brainslug":
        assert report.kernel_hits == {"attention": 1, "rmsnorm": 2,
                                      "swiglu": 1}
        assert report.kernel_fallbacks == {}
        # CPU tensors: the kernels' wrappers run their plain versions
        assert {k: v for k, v in delta.items() if v} == {
            "attention_plain": 1, "rmsnorm_plain": 2, "swiglu_plain": 1}
    else:
        # rmsnorm and swiglu stay with the stacks where no kernel runs
        assert report.kernel_hits == {"attention": 1}
        assert report.kernel_fallbacks == {"attention": 1}
        assert {k: v for k, v in delta.items() if v} == {"attention_ref": 1}
    assert "kernel attention" in net.explain()
    assert K.ROW_SOFTMAX not in [op.kind for op in net.graph.ops]


def test_block_at_head_dim_16_falls_back_with_its_reason():
    params, x, cot, jy, jgx, jgp = _block_case(32, 2, 64, 8, seed=1)
    net, y, gx, gp, delta = _run_block(params, x, cot, 2, "brainslug")
    np.testing.assert_allclose(y.detach().numpy(), jy, rtol=TOL, atol=TOL)
    _assert_grads(gx, gp, jgx, jgp, 1e-4)
    report = net.report()
    assert report.kernel_fallbacks == {"attention": 1}
    (att,) = [k for k in report.kernels if k.kernel == "attention"]
    assert att.backend == "ref" and att.fallback_reason == \
        "head_dim 16 is not one of the kernel's (64, 80, 112, 128, 256)"
    assert ("(fallback: head_dim 16 is not one of the kernel's "
            "(64, 80, 112, 128, 256))") in net.explain()
    assert delta["attention_ref"] == 1 and delta["attention_plain"] == 0
    assert report.kernel_hits == {"attention": 1, "rmsnorm": 2, "swiglu": 1}


def test_block_at_head_dim_112_dispatches_attention_to_the_kernel():
    """zamba2-7b's head dim (3584 / 32 = 112): the kernel's predicate takes
    it, so the registry dispatches attention to the kernel entry (its plain
    version on CPU tensors) with no fallback; a head dim the kernel refuses
    (136) records its reason."""
    params, x, cot, jy, jgx, jgp = _block_case(224, 2, 128, 8, seed=2)
    net, y, gx, gp, delta = _run_block(params, x, cot, 2, "brainslug")
    np.testing.assert_allclose(y.detach().numpy(), jy, rtol=TOL, atol=TOL)
    _assert_grads(gx, gp, jgx, jgp, 1e-4)
    report = net.report()
    assert report.kernel_hits == {"attention": 1, "rmsnorm": 2, "swiglu": 1}
    assert report.kernel_fallbacks == {}
    (att,) = [k for k in report.kernels if k.kernel == "attention"]
    assert att.backend == "hopper" and att.fallback_reason is None
    assert {k: v for k, v in delta.items() if v} == {
        "attention_plain": 1, "rmsnorm_plain": 2, "swiglu_plain": 1}
    params, x, cot, jy, jgx, jgp = _block_case(272, 2, 64, 8, seed=3)
    net, y, gx, gp, delta = _run_block(params, x, cot, 2, "brainslug")
    np.testing.assert_allclose(y.detach().numpy(), jy, rtol=TOL, atol=TOL)
    (att,) = [k for k in net.report().kernels if k.kernel == "attention"]
    assert att.backend == "ref" and att.fallback_reason == \
        "head_dim 136 is not one of the kernel's (64, 80, 112, 128, 256)"
    params, x, cot, jy, jgx, jgp = _block_case(192, 2, 64, 8, seed=5)
    net, y, gx, gp, delta = _run_block(params, x, cot, 2, "brainslug")
    np.testing.assert_allclose(y.detach().numpy(), jy, rtol=TOL, atol=TOL)
    (att,) = [k for k in net.report().kernels if k.kernel == "attention"]
    assert att.backend == "ref" and att.fallback_reason == \
        "head_dim 96 is not one of the kernel's (64, 80, 112, 128, 256)"


def test_block_at_head_dim_64_dispatches_attention_to_the_kernel():
    """granite-moe-3b's head dim (1536 / 24 = 64): the kernel's predicate
    takes it, so the registry dispatches attention to the kernel entry (its
    plain version on CPU tensors) with no fallback."""
    params, x, cot, jy, jgx, jgp = _block_case(128, 2, 64, 8, seed=4)
    net, y, gx, gp, delta = _run_block(params, x, cot, 2, "brainslug")
    np.testing.assert_allclose(y.detach().numpy(), jy, rtol=TOL, atol=TOL)
    _assert_grads(gx, gp, jgx, jgp, 1e-4)
    report = net.report()
    assert report.kernel_hits == {"attention": 1, "rmsnorm": 2, "swiglu": 1}
    assert report.kernel_fallbacks == {}
    (att,) = [k for k in report.kernels if k.kernel == "attention"]
    assert att.backend == "hopper" and att.fallback_reason is None
    assert {k: v for k, v in delta.items() if v} == {
        "attention_plain": 1, "rmsnorm_plain": 2, "swiglu_plain": 1}


@pytest.mark.parametrize("mode", ["brainslug", "barrier"])
def test_ce_tail_matches_jax_with_its_gradient(mode):
    rng = np.random.default_rng(2)
    t, d, v = 24, 32, 300
    h = rng.standard_normal((t, d)).astype(np.float32)
    w = (0.3 * rng.standard_normal((d, v))).astype(np.float32)
    labels = rng.integers(0, v, (t,)).astype(np.int64)
    labels[::4] = -1
    (jl, (jgh, jgw)) = jax.value_and_grad(jlm.ce_loss_fn, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels))
    ht, wt = torch.from_numpy(h), torch.from_numpy(w)
    lt = torch.from_numpy(labels)
    net = api.optimize(tlm.ce_loss_fn, ht, wt, lt,
                       config=_cfg(mode, differentiable=True))
    hg, wg = ht.clone().requires_grad_(), wt.clone().requires_grad_()
    before = registry.STATS.snapshot()
    loss = net(hg, wg, lt)
    loss.backward()
    delta = registry.STATS.delta(before)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(hg.grad.numpy(), np.asarray(jgh), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(wg.grad.numpy(), np.asarray(jgw), rtol=1e-4,
                               atol=1e-6)
    assert net.report().kernel_hits == {"vocab_ce": 1}
    assert delta["vocab_ce_plain" if mode == "brainslug"
                 else "vocab_ce_ref"] == 1
    assert "log_softmax" not in [op.attrs.get("prim")
                                 for op in net.graph.ops]


def _attention(q, k, v, fence=False):
    s = (q @ k.transpose(-2, -1)) * 0.125
    if fence:
        s = s.detach()
    return torch.softmax(s, dim=-1) @ v


def test_a_fence_in_the_cluster_vetoes_the_rewrite():
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(1, 2, 8, 16, generator=g) for _ in range(3))
    plain = api.optimize(_attention, q, k, v, config=_cfg("brainslug"))
    assert plain.report().kernel_hits == {"attention": 1}
    assert not plain.kernel_matches[0].op.attrs["causal"]
    fenced = api.optimize(lambda q, k, v: _attention(q, k, v, fence=True),
                          q, k, v, config=_cfg("brainslug"))
    assert fenced.report().kernels == ()
    off = api.optimize(_attention, q, k, v,
                       config=_cfg("brainslug", kernel_registry=False))
    assert off.report().kernels == ()
    torch.testing.assert_close(plain(q, k, v), _attention(q, k, v))


def test_a_non_causal_mask_is_not_claimed():
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(1, 2, 8, 16, generator=g) for _ in range(3))
    band = torch.where(torch.rand(8, 8, generator=g) > 0.5, 0.0, -1e30)

    def fn(q, k, v):
        return torch.softmax(q @ k.transpose(-2, -1) + band, dim=-1) @ v

    net = api.optimize(fn, q, k, v, config=_cfg("brainslug"))
    assert net.report().kernels == ()
    torch.testing.assert_close(net(q, k, v), fn(q, k, v))


def _scaled_ce(h, w, labels):
    logp = 2.0 * torch.log_softmax(h @ w, dim=-1)
    return torch.gather(logp, -1, labels[:, None])[:, 0].sum()


def _ce_case():
    g = torch.Generator().manual_seed(6)
    return (torch.randn(6, 8, generator=g), torch.randn(8, 20, generator=g),
            torch.randint(0, 20, (6,), generator=g))


def test_a_vetoed_match_is_reported_with_its_reason():
    # the CE walk takes the scaled log-softmax; the forward probe does not
    h, w, labels = _ce_case()
    net = api.optimize(_scaled_ce, h, w, labels, config=_cfg("brainslug"))
    report = net.report()
    assert report.kernels == ()
    (veto,) = report.vetoes
    assert veto.kernel == "vocab_ce" and veto.reason == \
        "the forward probe differs from the plain version"
    assert report.kernel_fallbacks == {"vocab_ce": 1}
    assert "vetoed, runs as traced (the forward probe differs" in \
        net.explain()
    torch.testing.assert_close(net(h, w, labels), _scaled_ce(h, w, labels))


@pytest.mark.parametrize("error, vetoed", [
    (torch.cuda.OutOfMemoryError, False), (RuntimeError, True)])
def test_probe_errors_of_the_device_propagate(monkeypatch, error, vetoed):
    def ref(args, attrs):
        raise error("probe failure")

    monkeypatch.setitem(registry.REGISTRY, "vocab_ce", dataclasses.replace(
        registry.REGISTRY["vocab_ce"], ref=ref))
    h, w, labels = _ce_case()
    if not vetoed:
        with pytest.raises(error, match="probe failure"):
            api.optimize(tlm.ce_loss_fn, h, w, labels,
                         config=_cfg("brainslug"))
        return
    net = api.optimize(tlm.ce_loss_fn, h, w, labels, config=_cfg("brainslug"))
    (veto,) = net.report().vetoes
    assert veto.reason == "the probe raised RuntimeError: probe failure"


def test_kernel_op_interprets_as_its_plain_version_and_sites_share():
    params, x, cot, *_ = _block_case(256, 2, 512, 16)
    fn = lambda x, p: tlm.transformer_block_fn(x, p, n_heads=2)  # noqa
    codegen.clear_cache()
    net = api.optimize(fn, torch.from_numpy(x), params,
                       config=_cfg("brainslug"))
    n_entries = len(codegen._CODE_CACHE)
    api.optimize(fn, torch.from_numpy(x), params, config=_cfg("brainslug"))
    assert len(codegen._CODE_CACHE) == n_entries     # shared, not rebuilt
    # the two rmsnorm sites have one shape and one eps: one closure
    rms = [k for k in codegen._CODE_CACHE if k[:2] == ("kernel", "rmsnorm")]
    assert len(rms) == 1
    env = {"arg0": torch.from_numpy(x)}
    p = net.trace_result.bind_params(
        torch.utils._pytree.tree_leaves((torch.from_numpy(x), params)))
    for op in net.graph.ops:
        env[op.output] = ir.apply_op(op, env, p)
    torch.testing.assert_close(env[net.graph.output],
                               fn(torch.from_numpy(x), params),
                               rtol=1e-5, atol=1e-5)
    codegen.clear_cache()
    assert sum(registry.STATS.counts.values()) == 0


def test_with_ref_vjp_differentiates_the_plain_version():
    g = torch.Generator().manual_seed(5)
    a, b = (torch.randn(4, 6, generator=g, requires_grad=True)
            for _ in range(2))
    fwd = lambda a, b: (a * b).detach() + 0.0        # noqa: E731 (no grad)
    run = autodiff.with_ref_vjp(fwd, lambda a, b: a * torch.sin(b))
    y = run(a, b)
    torch.testing.assert_close(y, a * b)
    ga, gb = torch.autograd.grad(y.sum(), (a, b))
    torch.testing.assert_close(ga, torch.sin(b))
    torch.testing.assert_close(gb, a * torch.cos(b))
