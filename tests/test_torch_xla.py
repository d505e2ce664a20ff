"""``mode="xla"``: each stack's plain function under ``torch.compile``
(inductor, ``fullgraph=True``), against the JAX package's ``xla`` mode (the
plain path under XLA), on the CPU.

* ``optimize_graph`` of the bn block network and a narrow VGG (nhwc
  stacks) and ``optimize_stack`` of the LM block's row chains
  (``norm_rms``, ``addnorm_rms``, ``glu_silu``, ``act_gelu``): forward
  and ``differentiable`` gradients against the JAX package's ``xla`` on
  the same seeded numpy inputs and against the port's ``barrier``, float32
  within 1e-5 of max|ref|;
* bfloat16 row chains: inductor computes a pointwise chain in float32 and
  rounds once at its outputs, the eager ``barrier`` rounds after every op
  and XLA rounds elsewhere again, so the limit is 2^-7 of max|ref| (one
  bfloat16 step at the largest value) against both;
* every call is counted compiled (``fwd_xla_compiled``), dynamo records no
  graph break, 10 distinct programs at 4 row counts each make 10 graphs
  (the row dims compile dynamic), and a recompile-limit hit raises instead
  of running eager;
* ``brainslug`` never reaches ``torch.compile``, and ``xla`` with
  ``remat="dots"`` runs its stacks compiled in the forward and in the
  recomputation."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch._dynamo
from torch._dynamo.utils import counters

from repro import configs as jconfigs
from repro.core import api as japi
from repro.layers import stacks as jstacks
from repro.models import cnn as jcnn
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs.base import RuntimeConfig as TRuntime
from repro_torch.convert import grads_to_numpy, params_from_numpy
from repro_torch.core import api as tapi
from repro_torch.core import ir
from repro_torch.kernels.fused_stack import ops as tops
from repro_torch.layers import base as tbase
from repro_torch.layers import stacks as tstacks
from repro_torch.models import cnn as tcnn
from repro_torch.models import lm as tlm

torch.set_num_threads(1)

F32_REL = 1e-5
BF16_REL = 2.0 ** -7

NETS = {
    # name: (jax builder, port builder, input shape)
    "block_net3": (lambda: jcnn.block_net(3, channels=8),
                   lambda: tcnn.block_net(3, channels=8, device="cpu"),
                   (2, 11, 13, 8)),
    "vgg_8_16": (lambda: jcnn.vgg_net((8, 16)),
                 lambda: tcnn.vgg_net((8, 16), device="cpu"),
                 (2, 16, 16, 3)),
}

STACKS = {
    "norm_rms": (("norm_program", "rms", 1e-6, False), {"x": (3, 7, 48)},
                 {"scale": (48,)}),
    "addnorm_rms": (("addnorm_program", "rms", 1e-6, False),
                    {"x": (2, 9, 40), "res": (2, 9, 40)}, {"scale": (40,)}),
    "glu_silu": (("glu_program", "silu"), {"gate": (3, 5, 72),
                                           "up": (3, 5, 72)}, {}),
    "act_gelu": (("act_program", "gelu"), {"x": (4, 6, 64)}, {}),
}


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _stats():
    return (counters["stats"]["unique_graphs"],
            sum(counters["graph_break"].values()))


@pytest.mark.parametrize("name", sorted(NETS))
def test_optimize_graph_xla_matches_jax_and_barrier(name):
    """Forward and the gradient of every parameter and the input through
    ``0.5 mean(y^2)``: the port's compiled ``xla`` against the JAX
    package's ``xla`` and against the port's ``barrier``; each stack
    sequence is one compiled call, in the forward and again in the
    training forward."""
    jmake, tmake, shape = NETS[name]
    (jgraph, jparams), (tgraph, tparams) = jmake(), tmake()
    params = {k: np.asarray(v) for k, v in jparams.items()}
    x = np.random.default_rng(11).standard_normal(shape).astype(np.float32)
    jnet = japi.optimize_graph(jgraph, shape, japi.OptimizeConfig(
        mode="xla", differentiable=True, verify="off"))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jy, (jgx, jgp) = jnet(jnp.asarray(x), jp), jax.grad(
        lambda x, p: 0.5 * jnp.mean(jnp.square(jnet(x, p))),
        argnums=(0, 1))(jnp.asarray(x), jp)
    got = {}
    for mode in ("xla", "barrier"):
        tnet = tapi.optimize_graph(tgraph, shape, tapi.OptimizeConfig(
            mode=mode, differentiable=True, torch_device="cpu"))
        tp = {k: v.requires_grad_() for k, v in params_from_numpy(
            params, "cpu", like=tparams).items()}
        xt = torch.from_numpy(x).requires_grad_()
        before = tops.STATS.snapshot()
        y = tnet(xt, tp)
        grads = torch.autograd.grad(0.5 * torch.mean(torch.square(y)),
                                    [xt, *tp.values()])
        delta = tops.STATS.delta(before)
        assert tnet.n_sequences > 0
        assert delta["fwd_xla_compiled"] == (
            tnet.n_sequences if mode == "xla" else 0)
        got[mode] = (y.detach(), grads[0],
                     grads_to_numpy(dict(zip(tp, grads[1:])), like=jgp))
    for mode, (y, gx, gp) in got.items():
        assert _rel(y, jy) <= F32_REL, mode
        assert _rel(gx, jgx) <= F32_REL, mode
        for k in jgp:
            assert _rel(gp[k], jgp[k]) <= F32_REL, (mode, k)
    y, gx, gp = got["xla"]
    assert _rel(y, got["barrier"][0]) <= F32_REL
    assert _rel(gx, got["barrier"][1]) <= F32_REL


def _stack_case(case, dtype=np.float32):
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
    return jprog, tprog, in_shapes, inputs, params, weights


@pytest.mark.parametrize("case", sorted(STACKS))
def test_optimize_stack_xla_matches_jax_and_barrier(case):
    """The LM block's row chains, forward and the gradients of every input
    and parameter through a weighted sum of every output."""
    jprog, tprog, in_shapes, inputs, params, weights = _stack_case(case)
    jexe = japi.optimize_stack(jprog, in_shapes, japi.OptimizeConfig(
        mode="xla", differentiable=True))

    def jloss(ins, ps):
        out = jexe(ins, ps)
        return sum(jnp.sum(out[v] * weights[v]) for v in weights)

    jins = {k: jnp.asarray(v) for k, v in inputs.items()}
    jps = {k: jnp.asarray(v) for k, v in params.items()}
    jout = jexe(jins, jps)
    jgi, jgp = jax.grad(jloss, argnums=(0, 1))(jins, jps)
    got = {}
    for mode in ("xla", "barrier"):
        texe = tapi.optimize_stack(tprog, in_shapes, tapi.OptimizeConfig(
            mode=mode, differentiable=True, torch_device="cpu"))
        ti = {k: torch.from_numpy(v).requires_grad_()
              for k, v in inputs.items()}
        tp = {k: v.requires_grad_() for k, v in params_from_numpy(
            params, "cpu").items()}
        before = tops.STATS.snapshot()
        out = texe(ti, tp)
        loss = sum((out[v] * torch.from_numpy(weights[v])).sum()
                   for v in weights)
        grads = torch.autograd.grad(loss, [*ti.values(), *tp.values()])
        assert tops.STATS.delta(before)["fwd_xla_compiled"] == (
            1 if mode == "xla" else 0)
        got[mode] = ({v: out[v].detach() for v in out},
                     grads_to_numpy(dict(zip([*ti, *tp], grads))))
    for mode, (out, g) in got.items():
        for v in jout:
            assert _rel(out[v], jout[v]) <= F32_REL, (mode, v)
        for k, want in {**jgi, **jgp}.items():
            assert _rel(g[k], want) <= F32_REL, (mode, k)
    for v in jout:
        assert _rel(got["xla"][0][v], got["barrier"][0][v]) <= F32_REL


@pytest.mark.parametrize("case", sorted(STACKS))
def test_bf16_row_chains_within_one_step(case):
    """bfloat16 operands: compiled ``xla`` within 2^-7 of max|ref| of the
    JAX package's ``xla`` and of the port's ``barrier``."""
    jprog, tprog, in_shapes, inputs, params, _ = _stack_case(case)
    jexe = japi.optimize_stack(jprog, in_shapes, japi.OptimizeConfig(
        mode="xla", itemsize=2))
    jout = jexe({k: jnp.asarray(v, jnp.bfloat16) for k, v in inputs.items()},
                {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()})
    ti = {k: torch.from_numpy(v).bfloat16() for k, v in inputs.items()}
    tp = {k: torch.from_numpy(v).bfloat16() for k, v in params.items()}
    out = {}
    for mode in ("xla", "barrier"):
        texe = tapi.optimize_stack(tprog, in_shapes, tapi.OptimizeConfig(
            mode=mode, itemsize=2, torch_device="cpu"))
        out[mode] = {v: t.float() for v, t in texe(ti, tp).items()}
        assert all(t.dtype == torch.bfloat16
                   for t in texe(ti, tp).values())
    for v in jout:
        want = np.asarray(jout[v].astype(jnp.float32))
        assert _rel(out["xla"][v], want) <= BF16_REL, v
        assert _rel(out["xla"][v], out["barrier"][v]) <= BF16_REL, v


def _chain(i: int) -> ir.StackProgram:
    acts = ("relu", "silu", "gelu", "tanh", "sigmoid")
    ops = [ir.OpNode(ir.OpKind.EW_UNARY, "a0", ("x",), "h0",
                     fn=acts[i % 5])]
    for j in range(1, 1 + i // 5):
        ops.append(ir.OpNode(ir.OpKind.EW_BINARY, f"m{j}", (f"h{j - 1}",),
                             f"h{j}", fn="mul", params=("scale",)))
    ops.append(ir.OpNode(ir.OpKind.ROW_NORM, "n", (ops[-1].output,), "y",
                         params=("scale",), attrs={"norm": "rms",
                                                   "eps": 1e-6}))
    return ir.StackProgram(name=f"chain{i}", inputs=("x",), outputs=("y",),
                           layout="rows", ops=tuple(ops))


def test_many_programs_and_row_counts_stay_compiled():
    """10 distinct programs (past dynamo's recompile limit of 8 a code
    object), each at 4 row counts: 40 compiled calls, one graph a program,
    no graph break, outputs equal to the eager interpreter within 1e-5."""
    programs = [_chain(i) for i in range(10)]
    assert len({p.signature() for p in programs}) == 10
    scale = torch.linspace(0.5, 1.5, 24)
    graphs, breaks = _stats()
    before = tops.STATS.snapshot()
    rng = np.random.default_rng(3)
    for rows in (5, 9, 17, 33):
        for p in programs:
            x = torch.from_numpy(rng.standard_normal((rows, 24))
                                 .astype(np.float32))
            got = tops.fused_stack_apply(p, {"x": x}, {"scale": scale},
                                         mode="xla")["y"]
            want = ir.run_program(p, {"x": x}, {"scale": scale})["y"]
            assert _rel(got, want) <= F32_REL
    assert tops.STATS.delta(before)["fwd_xla_compiled"] == 40
    assert _stats() == (graphs + 10, breaks)


def test_recompile_limit_hit_raises_not_eager():
    """An nhwc program compiles static; with the limit cut to one entry a
    second shape must raise, never run the plain function eagerly."""
    prog = ir.StackProgram(
        name="pool_relu", inputs=("x",), outputs=("y",), layout="nhwc",
        ops=(ir.OpNode(ir.OpKind.POOL2D, "p", ("x",), "h", fn="max",
                       attrs={"window": (2, 2), "stride": (2, 2),
                              "padding": (0, 0)}),
             ir.OpNode(ir.OpKind.EW_UNARY, "r", ("h",), "y", fn="relu")))
    x = torch.randn(1, 8, 8, 4, dtype=torch.float64)
    tops.fused_stack_apply(prog, {"x": x}, {}, mode="xla")
    before = tops.STATS.snapshot()
    with torch._dynamo.config.patch(recompile_limit=1):
        with pytest.raises(torch._dynamo.exc.FailOnRecompileLimitHit):
            tops.fused_stack_apply(prog, {"x": torch.randn(
                1, 12, 12, 4, dtype=torch.float64)}, {}, mode="xla")
    assert tops.STATS.delta(before)["fwd_xla_compiled"] == 0


@pytest.fixture(scope="module")
def lm_case():
    jcfg = jconfigs.get_config("deepseek-7b").reduced()
    np_params = jax.tree_util.tree_map(
        np.asarray, jlm.init(jax.random.PRNGKey(0), jcfg)[0])
    tok = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 16))
    batch = {"tokens": torch.from_numpy(tok).long(),
             "labels": torch.from_numpy(np.roll(tok, -1, 1)).long()}
    return tconfigs.get_config("deepseek-7b").reduced(), np_params, batch


def _step(lm_case, mode, remat):
    cfg, np_params, batch = lm_case
    params = convert.lm_params_from_numpy(np_params, "cpu")
    leaves = tbase.tree_leaves(params)
    for p in leaves:
        p.requires_grad_()
    before, dyn = tops.STATS.snapshot(), _stats()
    loss, _ = tlm.loss_fn(params, batch, cfg, TRuntime(mode=mode,
                                                       remat=remat))
    fwd = tops.STATS.delta(before)["fwd_xla_compiled"]
    grads = torch.autograd.grad(loss, leaves)
    total = tops.STATS.delta(before)["fwd_xla_compiled"]
    return loss.detach(), grads, fwd, total, dyn


def test_brainslug_never_compiles(lm_case):
    """A ``brainslug`` forward and training step leave dynamo's counters
    and the compiled-call counter where they were."""
    _, _, fwd, total, dyn = _step(lm_case, "brainslug", "none")
    assert fwd == total == 0
    assert _stats() == dyn


def test_xla_with_remat_dots_runs_compiled(lm_case):
    """``xla`` + ``remat="dots"``: the block stacks run compiled in the
    forward and again in the recomputation (4 layers x 3 stacks, and the
    final norm once), with no new graph after ``remat="none"`` built
    them; the gradients equal ``remat="none"``'s bit for bit."""
    cfg = lm_case[0]
    loss0, g0, fwd0, total0, _ = _step(lm_case, "xla", "none")
    assert fwd0 == total0 == 3 * cfg.n_layers + 1
    loss1, g1, fwd1, total1, dyn = _step(lm_case, "xla", "dots")
    assert fwd1 == fwd0 and total1 == fwd0 + 3 * cfg.n_layers
    assert _stats() == dyn
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
