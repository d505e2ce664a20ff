"""The training slice as a whole, on the CPU: ``torch.autograd`` through the
port's ``optimize_graph`` / ``optimize_stack`` (``mode="brainslug"``,
``differentiable=True``) against ``jax.grad`` through the JAX package's, on
the same weights (``convert.params_from_numpy``) and compared by name
(``convert.grads_to_numpy``), to 1e-4 (the JAX package's own tolerance,
``tests/test_nhwc_bwd.py``); three SGD steps give the same losses.

On CPU tensors the port runs the plain versions of its kernels, so the
counters must show ``bwd_reference`` and no ``bwd_generated``."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.layers import stacks as jstacks
from repro.models import cnn as jcnn
from repro_torch.convert import grads_to_numpy, params_from_numpy
from repro_torch.core import api as tapi
from repro_torch.kernels.fused_stack import ops as tops
from repro_torch.layers import stacks as tstacks
from repro_torch.models import cnn as tcnn

TOL = 1e-4

NETS = {
    # name: (jax builder, port builder, input shape, loss, SGD step size)
    "block_net3": (lambda: jcnn.block_net(3, channels=8),
                   lambda: tcnn.block_net(3, channels=8, device="cpu"),
                   (2, 11, 13, 8), "square", 0.1),
    "vgg_8_16": (lambda: jcnn.vgg_net((8, 16)),
                 lambda: tcnn.vgg_net((8, 16), device="cpu"),
                 (2, 16, 16, 3), "xent", 0.01),
}


def _loss_jax(y, kind, labels):
    if kind == "square":
        return 0.5 * jnp.mean(jnp.square(y))
    logp = jax.nn.log_softmax(y, axis=-1)
    return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=-1))


def _loss_torch(y, kind, labels):
    if kind == "square":
        return 0.5 * torch.mean(torch.square(y))
    return torch.nn.functional.cross_entropy(y, labels)


def _nets(name):
    jmake, tmake, shape, kind, _ = NETS[name]
    jgraph, jparams = jmake()
    tgraph, tparams = tmake()
    cfg = dict(mode="brainslug", differentiable=True)
    jnet = japi.optimize_graph(jgraph, shape, japi.OptimizeConfig(
        verify="off", **cfg))
    tnet = tapi.optimize_graph(tgraph, shape, tapi.OptimizeConfig(
        torch_device="cpu", **cfg))
    params = {k: np.asarray(v) for k, v in jparams.items()}
    rng = np.random.default_rng(11)
    x = rng.standard_normal(shape).astype(np.float32)
    labels = rng.integers(0, 10, shape[0])
    return jnet, tnet, tparams, params, x, labels, kind


@pytest.mark.parametrize("name", sorted(NETS))
def test_optimize_graph_grads_match_jax(name):
    jnet, tnet, tparams, params, x, labels, kind = _nets(name)
    want = jax.grad(lambda p: _loss_jax(jnet(jnp.asarray(x), p), kind,
                                        jnp.asarray(labels)))(
        {k: jnp.asarray(v) for k, v in params.items()})
    tp = {k: v.requires_grad_() for k, v in params_from_numpy(
        params, "cpu", like=tparams).items()}
    xt = torch.from_numpy(x).requires_grad_()
    before = tops.STATS.snapshot()
    loss = _loss_torch(tnet(xt, tp), kind, torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, [xt, *tp.values()])
    delta = tops.STATS.delta(before)
    assert delta["bwd_reference"] == tnet.n_sequences > 0
    assert delta["bwd_generated"] == 0 and delta["fwd_generated"] == 0
    assert torch.isfinite(grads[0]).all()
    got = grads_to_numpy(dict(zip(tp, grads[1:])), like=want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)


@pytest.mark.parametrize("name", sorted(NETS))
def test_three_sgd_steps_match_jax(name):
    jnet, tnet, tparams, params, x, labels, kind = _nets(name)
    lr = NETS[name][-1]
    jx, jl = jnp.asarray(x), jnp.asarray(labels)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    loss_grad = jax.value_and_grad(lambda p: _loss_jax(jnet(jx, p), kind, jl))
    tp = params_from_numpy(params, "cpu", like=tparams)
    xt, lt = torch.from_numpy(x), torch.from_numpy(labels)
    jlosses, tlosses = [], []
    for _ in range(3):
        lj, gj = loss_grad(jp)
        jlosses.append(float(lj))
        jp = {k: jp[k] - lr * gj[k] for k in jp}
        leaves = {k: v.requires_grad_() for k, v in tp.items()}
        lt_ = _loss_torch(tnet(xt, leaves), kind, lt)
        gt = torch.autograd.grad(lt_, list(leaves.values()))
        tlosses.append(float(lt_.detach()))
        with torch.no_grad():
            tp = {k: v - lr * g for (k, v), g in zip(leaves.items(), gt)}
    np.testing.assert_allclose(tlosses, jlosses, rtol=TOL)
    assert tlosses[-1] < tlosses[0]


STACKS = {
    "norm_rms": (("norm_program", "rms", 1e-6, False), {"x": (3, 7, 48)},
                 {"scale": (48,)}),
    "addnorm_rms": (("addnorm_program", "rms", 1e-6, False),
                    {"x": (2, 9, 40), "res": (2, 9, 40)}, {"scale": (40,)}),
    "glu_silu": (("glu_program", "silu"), {"gate": (3, 5, 72),
                                           "up": (3, 5, 72)}, {}),
}


@pytest.mark.parametrize("case", sorted(STACKS))
def test_optimize_stack_grads_match_jax(case):
    """The LM block's three row chains: gradients of every input and
    parameter through a weighted sum of every output."""
    (maker, *args), in_shapes, p_shapes = STACKS[case]
    rng = np.random.default_rng(12)
    inputs = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in in_shapes.items()}
    params = {k: (1.0 + rng.standard_normal(s)).astype(np.float32)
              for k, s in p_shapes.items()}
    jprog, tprog = getattr(jstacks, maker)(*args), getattr(tstacks, maker)(
        *args)
    lead = next(iter(in_shapes.values()))
    weights = {v: rng.standard_normal(lead).astype(np.float32)
               for v in tprog.outputs}
    cfg = dict(mode="brainslug", differentiable=True)
    jexe = japi.optimize_stack(jprog, in_shapes, japi.OptimizeConfig(**cfg))
    texe = tapi.optimize_stack(tprog, in_shapes, tapi.OptimizeConfig(
        torch_device="cpu", **cfg))

    def jloss(ins, ps):
        out = jexe(ins, ps)
        return sum(jnp.sum(out[v] * weights[v]) for v in weights)

    jgi, jgp = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in inputs.items()},
        {k: jnp.asarray(v) for k, v in params.items()})
    ti = {k: torch.from_numpy(v).requires_grad_() for k, v in inputs.items()}
    tp = {k: v.requires_grad_() for k, v in params_from_numpy(
        params, "cpu").items()}
    before = tops.STATS.snapshot()
    out = texe(ti, tp)
    loss = sum((out[v] * torch.from_numpy(weights[v])).sum() for v in weights)
    grads = torch.autograd.grad(loss, [*ti.values(), *tp.values()])
    delta = tops.STATS.delta(before)
    assert delta["bwd_reference"] == 1 and delta["bwd_generated"] == 0
    got = grads_to_numpy(dict(zip([*ti, *tp], grads)))
    for k, want in {**jgi, **jgp}.items():
        np.testing.assert_allclose(got[k], np.asarray(want), rtol=TOL,
                                   atol=TOL, err_msg=k)


def test_grads_to_numpy_checks_names_and_shapes():
    g = {"a": torch.ones(3)}
    assert grads_to_numpy(g, like={"a": np.zeros(3)})["a"].dtype == np.float32
    with pytest.raises(ValueError, match="names differ"):
        grads_to_numpy(g, like={"b": np.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        grads_to_numpy(g, like={"a": np.zeros(4)})


def test_differentiable_config_is_validated_and_explained():
    with pytest.raises(ValueError, match="differentiable"):
        tapi.OptimizeConfig(differentiable="yes")
    graph, _ = tcnn.block_net(8, channels=32, device="cpu")
    net = tapi.optimize_graph(graph, (1, 56, 56, 32), tapi.OptimizeConfig(
        mode="brainslug", torch_device="cpu", differentiable=True))
    assert net.n_sequences == 3                 # it splits for training
    assert "fwd+bwd" in net.explain() and "8x8" in net.explain()
