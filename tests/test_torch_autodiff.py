"""The port's VJP rules and training-time planner against the JAX
package's, on the CPU: every rule of ``repro_torch.core.autodiff`` against
``repro.core.autodiff`` on the same inputs (to 1e-5), ``program_vjp`` on
random programs and with a NaN-poisoned row mask, the joint forward +
backward resource accounting, and ``collapse(..., differentiable=True)``
plans equal to the JAX plans on ``TINY_DEVICE``."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analyzer as janalyzer
from repro.core import autodiff as jad
from repro.core import collapse as jcollapse
from repro.core import ir as jir
from repro.core import resource as jresource
from repro.layers import stacks as jstacks
from repro.models import cnn as jcnn
from repro_torch.core import analyzer as tanalyzer
from repro_torch.core import autodiff as tad
from repro_torch.core import collapse as tcollapse
from repro_torch.core import ir as tir
from repro_torch.core import resource as tresource
from repro_torch.layers import stacks as tstacks
from repro_torch.models import cnn as tcnn

TOL = 1e-5


def _randn(rng, shape, scale=1.0):
    return np.asarray(scale * rng.standard_normal(shape), np.float32)


def _both(vjp_args):
    """(jax arrays, torch tensors) of a dict of numpy arrays."""
    return ({k: jnp.asarray(v) for k, v in vjp_args.items()},
            {k: torch.from_numpy(np.asarray(v)) for k, v in vjp_args.items()})


def _check_op(make_op, inputs, params, g, row_mask=None, rtol=TOL):
    """``op_vjp`` of both packages on the same inputs, environment and
    cotangent; both results compared name by name."""
    jop, top = make_op(jir), make_op(tir)
    jenv, tenv = _both(inputs)
    jps, tps = _both(params)
    jenv[jop.output] = jir.apply_op(jop, jenv, jps)
    tenv[top.output] = tir.apply_op(top, tenv, tps)
    jm = None if row_mask is None else jnp.asarray(row_mask)
    tm = None if row_mask is None else torch.from_numpy(row_mask)
    jdin, jdp = jad.op_vjp(jop, jenv, jps, jnp.asarray(g), jm)
    tdin, tdp = tad.op_vjp(top, tenv, tps, torch.from_numpy(g), tm)
    assert set(jdin) == set(tdin) and set(jdp) == set(tdp)
    for k in jdin:
        np.testing.assert_allclose(tdin[k].numpy(), np.asarray(jdin[k]),
                                   rtol=rtol, atol=TOL, err_msg=f"d{k}")
    for k in jdp:
        np.testing.assert_allclose(tdp[k].numpy(), np.asarray(jdp[k]),
                                   rtol=rtol, atol=TOL, err_msg=f"d{k}")


@pytest.mark.parametrize("fn", sorted(tad._UNARY_DERIVS))
def test_unary_rules_match_jax(fn):
    rng = np.random.default_rng(1)
    x = _randn(rng, (5, 17), 2.0)
    x[0, :3] = 0.0                              # the kinks of relu, abs
    x[1, :2] = 6.0
    _check_op(lambda m: m.OpNode(m.OpKind.EW_UNARY, "u", ("x",), "y", fn=fn),
              {"x": x}, {}, _randn(rng, (5, 17)))


@pytest.mark.parametrize("with_param", [False, True])
@pytest.mark.parametrize("fn", sorted(tad.BINARY_VJP_FNS))
def test_binary_rules_match_jax(fn, with_param):
    """Values or a parameter as second operand, with exact ties planted
    (max/min split them 0.5 / 0.5)."""
    rng = np.random.default_rng(2)
    a = _randn(rng, (6, 8))
    b = _randn(rng, (8,)) if with_param else _randn(rng, (6, 8))
    b = np.where(np.abs(b) < 0.3, 1.0, b).astype(np.float32)  # divisors
    a[0, :4] = b[:4] if with_param else b[0, :4]              # ties
    if with_param:
        def make(m):
            return m.OpNode(m.OpKind.EW_BINARY, "b", ("a",), "y", fn=fn,
                            params=("p",))
        _check_op(make, {"a": a}, {"p": b}, _randn(rng, (6, 8)))
    else:
        def make(m):
            return m.OpNode(m.OpKind.EW_BINARY, "b", ("a", "c"), "y", fn=fn)
        _check_op(make, {"a": a, "c": b}, {}, _randn(rng, (6, 8)))


@pytest.mark.parametrize("fn", ["add", "mul", "max"])
def test_value_consumed_twice(fn):
    rng = np.random.default_rng(3)
    _check_op(lambda m: m.OpNode(m.OpKind.EW_BINARY, "b", ("x", "x"), "y",
                                 fn=fn),
              {"x": _randn(rng, (4, 9))}, {}, _randn(rng, (4, 9)))


def test_broadcast_value_operand_reduces_with_row_mask():
    """A (rows, 1) operand's cotangent sums over F; the row mask keeps the
    rows it marks out of a reduced operand."""
    rng = np.random.default_rng(4)
    mask = np.array([[True], [True], [False], [True]])
    _check_op(lambda m: m.OpNode(m.OpKind.EW_BINARY, "b", ("x", "s"), "y",
                                 fn="mul"),
              {"x": _randn(rng, (4, 6)), "s": _randn(rng, (1, 6))}, {},
              _randn(rng, (4, 6)), row_mask=mask)


def test_affine_rule_matches_jax():
    rng = np.random.default_rng(5)
    _check_op(lambda m: m.OpNode(m.OpKind.AFFINE, "a", ("x",), "y",
                                 params=("s", "o")),
              {"x": _randn(rng, (3, 4, 10))},
              {"s": _randn(rng, (10,)), "o": _randn(rng, (10,))},
              _randn(rng, (3, 4, 10)))


@pytest.mark.parametrize("n_params", [0, 1, 2])
@pytest.mark.parametrize("norm", ["rms", "layer"])
def test_row_norm_rules_match_jax(norm, n_params):
    rng = np.random.default_rng(6)
    names = ("s", "o")[:n_params]
    _check_op(lambda m: m.OpNode(m.OpKind.ROW_NORM, "n", ("x",), "y",
                                 params=names,
                                 attrs={"norm": norm, "eps": 1e-5}),
              {"x": _randn(rng, (7, 33), 1.5)},
              {p: _randn(rng, (33,)) for p in names}, _randn(rng, (7, 33)))


def test_softmax_rule_matches_jax():
    rng = np.random.default_rng(7)
    _check_op(lambda m: m.OpNode(m.OpKind.ROW_SOFTMAX, "s", ("x",), "y"),
              {"x": _randn(rng, (6, 21), 2.0)}, {}, _randn(rng, (6, 21)))


@pytest.mark.parametrize("fn", ["max", "avg"])
@pytest.mark.parametrize("window,stride,padding,hw", [
    ((2, 2), (2, 2), (0, 0), (8, 8)),
    ((3, 3), (1, 1), (1, 1), (7, 9)),
    ((3, 3), (2, 2), (1, 1), (11, 13)),     # stride does not tile the image
])
def test_pool_rules_match_jax(fn, window, stride, padding, hw):
    rng = np.random.default_rng(8)
    x = _randn(rng, (2, *hw, 3))

    def make(m):
        return m.OpNode(m.OpKind.POOL2D, "p", ("x",), "y", fn=fn,
                        attrs={"window": window, "stride": stride,
                               "padding": padding})

    shape = tir.infer_shapes(tir.StackProgram(
        name="p", inputs=("x",), outputs=("y",), ops=(make(tir),),
        layout="nhwc"), {"x": x.shape})["y"]
    _check_op(make, {"x": x}, {}, _randn(rng, shape))


def test_max_pool_ties_route_to_first_max():
    """An all-equal input: every window ties, the first maximal position
    (row-major) takes the whole cotangent, never a split."""
    x = np.zeros((1, 5, 5, 2), np.float32)

    def make(m):
        return m.OpNode(m.OpKind.POOL2D, "p", ("x",), "y", fn="max",
                        attrs={"window": (3, 3), "stride": (1, 1),
                               "padding": (1, 1)})

    g = np.ones((1, 5, 5, 2), np.float32)
    _check_op(make, {"x": x}, {}, g)
    op = make(tir)
    env = {"x": torch.from_numpy(x)}
    env["y"] = tir.apply_op(op, env, {})
    dx = tad.op_vjp(op, env, {}, torch.from_numpy(g))[0]["x"].numpy()
    assert np.all(dx == np.round(dx)) and dx.sum() == g.sum()


# ---------------------------------------------------------------------------
# Whole programs.
# ---------------------------------------------------------------------------

_UNARY = sorted(tad._UNARY_DERIVS)
_BINARY = sorted(tad.BINARY_VJP_FNS - {"div"})


def _random_program(m, seed, features=12):
    """A seeded rows program over every op kind; value names and op order
    come from the seed, so both IR modules get the same program."""
    rng = np.random.default_rng(seed)
    ops, vals, n_p = [], ["x", "z"], 0
    for i in range(8):
        kind = rng.integers(5)
        v = vals[int(rng.integers(len(vals)))]
        out = f"t{i}"
        if kind == 0:
            ops.append(m.OpNode(m.OpKind.EW_UNARY, f"o{i}", (v,), out,
                                fn=_UNARY[int(rng.integers(len(_UNARY)))]))
        elif kind == 1:
            w = vals[int(rng.integers(len(vals)))]
            ops.append(m.OpNode(m.OpKind.EW_BINARY, f"o{i}", (v, w), out,
                                fn=_BINARY[int(rng.integers(len(_BINARY)))]))
        elif kind == 2:
            ops.append(m.OpNode(m.OpKind.AFFINE, f"o{i}", (v,), out,
                                params=(f"s{n_p}", f"b{n_p}")))
            n_p += 1
        elif kind == 3:
            ops.append(m.OpNode(m.OpKind.ROW_NORM, f"o{i}", (v,), out,
                                params=(f"s{n_p}",),
                                attrs={"norm": ("rms", "layer")[i % 2],
                                       "eps": 1e-5}))
            n_p += 1
        else:
            ops.append(m.OpNode(m.OpKind.ROW_SOFTMAX, f"o{i}", (v,), out))
        vals.append(out)
    return m.StackProgram(name=f"rand{seed}", inputs=("x", "z"),
                          outputs=(vals[-1], vals[4]), ops=tuple(ops))


def _program_vjp_both(make, inputs, params, gouts, row_mask=None):
    jprog, tprog = make(jir), make(tir)
    ji, ti = _both(inputs)
    jp, tp = _both(params)
    jenv = dict(ji)
    for op in jprog.ops:
        jenv[op.output] = jir.apply_op(op, jenv, jp)
    tenv = tad.forward_env(tprog, ti, tp)
    jm = None if row_mask is None else jnp.asarray(row_mask)
    tm = None if row_mask is None else torch.from_numpy(row_mask)
    jg, tg = _both(gouts)
    return (jad.program_vjp(jprog, jenv, jp, jg, jm),
            tad.program_vjp(tprog, tenv, tp, tg, tm))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_program_vjp_random_programs_match_jax(seed):
    prog = _random_program(tir, seed)
    rng = np.random.default_rng(100 + seed)
    inputs = {"x": _randn(rng, (6, 12)), "z": _randn(rng, (6, 12))}
    params = {p: _randn(rng, (12,)) + (1.0 if p[0] == "s" else 0.0)
              for p in prog.param_names}
    gouts = {v: _randn(rng, (6, 12)) for v in prog.outputs}
    (jdin, jdp), (tdin, tdp) = _program_vjp_both(
        lambda m: _random_program(m, seed), inputs, params, gouts)
    for k in jdin:
        np.testing.assert_allclose(tdin[k].numpy(), np.asarray(jdin[k]),
                                   rtol=1e-4, atol=TOL, err_msg=k)
    for k in jdp:
        np.testing.assert_allclose(tdp[k].numpy(), np.asarray(jdp[k]),
                                   rtol=1e-4, atol=TOL, err_msg=k)


def test_row_mask_keeps_nan_rows_out_of_param_grads():
    """Padded rows recompute 0 / 0 = NaN; the row mask keeps them out of the
    parameter sums, in both packages alike."""
    def make(m):
        return m.StackProgram(name="pad", inputs=("x", "z"), outputs=("y",),
                              ops=(
            m.OpNode(m.OpKind.EW_BINARY, "d", ("x", "z"), "a", fn="div"),
            m.OpNode(m.OpKind.AFFINE, "f", ("a",), "y", params=("s", "o"))))

    rng = np.random.default_rng(9)
    x, z = _randn(rng, (6, 8)), np.abs(_randn(rng, (6, 8))) + 1.0
    x[4:], z[4:] = 0.0, 0.0                      # two padded rows
    g = _randn(rng, (6, 8))
    g[4:] = 0.0
    mask = (np.arange(6) < 4)[:, None]
    params = {"s": _randn(rng, (8,)), "o": _randn(rng, (8,))}
    (_, jdp), (_, tdp) = _program_vjp_both(make, {"x": x, "z": z}, params,
                                           {"y": g}, mask)
    for k in jdp:
        assert np.isfinite(tdp[k].numpy()).all()
        np.testing.assert_allclose(tdp[k].numpy(), np.asarray(jdp[k]),
                                   rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# The joint forward + backward planner.
# ---------------------------------------------------------------------------

def _plan_key(plan):
    return ([([tuple(op.name for op in st.ops) for st in seq.steps],
              seq.tile_rows, seq.tile_out_h, seq.tile_out_w)
             for seq in plan.sequences], plan.differentiable)


def test_bwd_resource_counts_match_jax():
    for seed in range(3):
        assert tresource.max_live_values_bwd(_random_program(tir, seed)) == \
            jresource.max_live_values_bwd(_random_program(jir, seed))
    for name, args in (("addnorm_program", ("rms", 1e-6, False)),
                       ("glu_program", ("silu",)),
                       ("norm_program", ("layer", 1e-5, True))):
        assert tresource.max_live_values_bwd(
            getattr(tstacks, name)(*args)) == jresource.max_live_values_bwd(
            getattr(jstacks, name)(*args))
    jg, _ = jcnn.block_net(3, channels=16)
    seg, = janalyzer.analyze(jg, keep=frozenset({jg.output}))
    steps = [s.ops for s in jcollapse.build_steps(seg.stack)]
    tg, _ = tcnn.block_net(3, channels=16, device="cpu")
    tseg, = tanalyzer.analyze(tg, keep=frozenset({tg.output}))
    tsteps = [s.ops for s in tcollapse.build_steps(tseg.stack)]
    for th in (2, 4, 8):
        jf = jresource.sequence_footprint(steps, th, th, 16, 4,
                                          jresource.TINY_DEVICE)
        tf = tresource.sequence_footprint(tsteps, th, th, 16, 4,
                                          tresource.TINY_DEVICE)
        assert tresource.sequence_bwd_bytes(tf) == \
            jresource.sequence_bwd_bytes(jf)


def _graph_plans(jgraph, tgraph, input_shape):
    from repro.core import api as japi
    jsegs = janalyzer.analyze(jgraph, keep=frozenset({jgraph.output}))
    tsegs = tanalyzer.analyze(tgraph, keep=frozenset({tgraph.output}))
    shapes = {jgraph.input: input_shape}
    out = []
    for js, ts in zip(jsegs, tsegs):
        if not js.is_stack:
            japi._infer_opaque_shape(js.op, shapes)
            continue
        in_shapes = {v: shapes[v] for v in js.stack.inputs}
        shapes.update(jir.infer_shapes(js.stack, in_shapes))
        jp = jcollapse.collapse(js.stack, in_shapes, jresource.TINY_DEVICE,
                                itemsize=4, differentiable=True)
        tp = tcollapse.collapse(ts.stack, in_shapes, tresource.TINY_DEVICE,
                                itemsize=4, differentiable=True)
        out.append((jp, tp))
    return out


@pytest.mark.parametrize("net", ["block_net8", "vgg_net"])
def test_differentiable_graph_plans_match_jax(net):
    if net == "block_net8":
        (jg, _), (tg, _) = (jcnn.block_net(8, channels=32),
                            tcnn.block_net(8, channels=32, device="cpu"))
        shape = (1, 56, 56, 32)
    else:
        (jg, _), (tg, _) = (jcnn.vgg_net((32, 64, 128)),
                            tcnn.vgg_net((32, 64, 128), device="cpu"))
        shape = (1, 32, 32, 3)
    plans = _graph_plans(jg, tg, shape)
    assert plans
    for jp, tp in plans:
        assert _plan_key(jp) == _plan_key(tp)
        assert tresource.plan_vmem_bytes(tp, itemsize=4,
                                         differentiable=True) == \
            jresource.plan_vmem_bytes(jp, itemsize=4, differentiable=True)
    if net == "block_net8":
        assert len(plans[0][1].sequences) > 1


@pytest.mark.parametrize("name,args,shapes", [
    ("addnorm_program", ("rms", 1e-6, False), {"x": (4, 64, 256),
                                               "res": (4, 64, 256)}),
    ("norm_program", ("layer", 1e-5, True), {"x": (3, 640)}),
    ("glu_program", ("silu",), {"gate": (2, 16, 256), "up": (2, 16, 256)}),
    ("act_program", ("gelu",), {"x": (5, 256)}),
])
def test_differentiable_stack_plans_match_jax(name, args, shapes):
    """Training plans on TINY_DEVICE (no F chunk) equal the JAX plans; at
    512 features the glu's joint working set no longer fits there, and both
    packages refuse it alike."""
    jp = jcollapse.collapse(getattr(jstacks, name)(*args), shapes,
                            jresource.TINY_DEVICE, itemsize=4,
                            differentiable=True)
    tp = tcollapse.collapse(getattr(tstacks, name)(*args), shapes,
                            tresource.TINY_DEVICE, itemsize=4,
                            differentiable=True)
    assert _plan_key(jp) == _plan_key(tp)
    wide = {k: v[:-1] + (512,) for k, v in shapes.items()}
    if name == "glu_program":
        with pytest.raises(jresource.ResourceError):
            jcollapse.collapse(getattr(jstacks, name)(*args), wide,
                               jresource.TINY_DEVICE, itemsize=4,
                               differentiable=True)
        with pytest.raises(tresource.ResourceError):
            tcollapse.collapse(getattr(tstacks, name)(*args), wide,
                               tresource.TINY_DEVICE, itemsize=4,
                               differentiable=True)


D_MODEL, D_FF, ROWS = 4096, 11008, (4, 2048)     # deepseek-7b widths


@pytest.mark.parametrize("program,shapes,tile", [
    (tstacks.norm_program("rms", 1e-6, False), {"x": ROWS + (D_MODEL,)}, 2),
    (tstacks.norm_program("layer", 1e-5, True), {"x": ROWS + (D_MODEL,)}, 2),
    (tstacks.addnorm_program("rms", 1e-6, False),
     {"x": ROWS + (D_MODEL,), "res": ROWS + (D_MODEL,)}, 1),
    (tstacks.glu_program("silu"), {"gate": ROWS + (D_FF,),
                                   "up": ROWS + (D_FF,)}, 2),
])
def test_h100_plans_every_slice_program_for_training(program, shapes, tile):
    plan = tcollapse.collapse(program, shapes, tresource.H100,
                              differentiable=True)
    assert [s.tile_rows for s in plan.sequences] == [tile]
    need, = tresource.plan_vmem_bytes(plan, itemsize=4, differentiable=True)
    assert need <= tresource.H100.resource_limit


def test_h100_glu_plans_through_the_f_chunk():
    """6 live buffers x 11008 x 4 B = 264,192 B for one row: above the
    145,280 B budget, so the glu plans only through its F chunk; a chain
    that reduces over F gets no chunk."""
    glu = tstacks.glu_program("silu")
    assert tresource.max_live_values_bwd(glu) == 6
    assert tresource.rows_tile_bytes(6, 1, D_FF, 4, tresource.H100) == \
        264_192 > tresource.H100.resource_limit == 145_280
    assert tresource.planned_features(glu, D_FF, tresource.H100, True) == 2048
    assert tresource.planned_features(glu, D_FF, tresource.H100, False) == D_FF
    norm = tstacks.norm_program("rms", 1e-6, False)
    assert tresource.planned_features(norm, D_MODEL, tresource.H100,
                                      True) == D_MODEL
    assert tresource.TINY_DEVICE.f_chunk == 0
