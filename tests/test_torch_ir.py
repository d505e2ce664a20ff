"""The port's IR interpreter against the JAX package's, op by op.

Same inputs (made from a numpy seed) go through ``repro.core.ir`` and
``repro_torch.core.ir``; outputs agree within 1e-5 (float32, the two differ
only in the order of a few roundings)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ir as jir
from repro_torch.core import ir as tir

TOL = 1e-5


def _both(make):
    """Build the same program in both packages: ``make(ir_module)``."""
    return make(jir), make(tir)


def _run_both(make, inputs: dict, params: dict, barrier: bool = False):
    jprog, tprog = _both(make)
    jout = jir.run_program(jprog, {k: jnp.asarray(v) for k, v in inputs.items()},
                           {k: jnp.asarray(v) for k, v in params.items()},
                           barrier=barrier)
    tout = tir.run_program(tprog,
                           {k: torch.from_numpy(v) for k, v in inputs.items()},
                           {k: torch.from_numpy(v) for k, v in params.items()},
                           barrier=barrier)
    assert set(jout) == set(tout)
    for k in jout:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=TOL, atol=TOL)
    return tout


def _randn(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def test_unary_and_binary_tables_match():
    assert set(tir.UNARY_FNS) == set(jir._UNARY_FNS)
    assert set(tir.BINARY_FNS) == set(jir._BINARY_FNS)
    assert tir.OPTIMIZABLE_KINDS and {k.value for k in tir.OpKind} == {
        k.value for k in jir.OpKind}


@pytest.mark.parametrize("fn", sorted(jir._UNARY_FNS))
def test_unary(fn):
    rng = np.random.default_rng(1)
    x = _randn(rng, (4, 33), 3.0)

    def make(m):
        return m.StackProgram(name="u", inputs=("x",), outputs=("y",), ops=(
            m.OpNode(m.OpKind.EW_UNARY, "u", ("x",), "y", fn=fn),))

    _run_both(make, {"x": x}, {})


@pytest.mark.parametrize("fn", sorted(jir._BINARY_FNS))
@pytest.mark.parametrize("operand", ["value", "param"])
def test_binary(fn, operand):
    rng = np.random.default_rng(2)
    x = _randn(rng, (3, 17))
    other = _randn(rng, (3, 17) if operand == "value" else (17,))
    if fn == "div":
        other = np.where(np.abs(other) < 0.1, 0.5, other).astype(np.float32)

    def make(m):
        if operand == "value":
            op = m.OpNode(m.OpKind.EW_BINARY, "b", ("x", "z"), "y", fn=fn)
            return m.StackProgram(name="b", inputs=("x", "z"), outputs=("y",),
                                  ops=(op,))
        op = m.OpNode(m.OpKind.EW_BINARY, "b", ("x",), "y", fn=fn,
                      params=("z",))
        return m.StackProgram(name="b", inputs=("x",), outputs=("y",),
                              ops=(op,))

    if operand == "value":
        _run_both(make, {"x": x, "z": other}, {})
    else:
        _run_both(make, {"x": x}, {"z": other})


@pytest.mark.parametrize("norm,bias", [("rms", False), ("rms", True),
                                       ("layer", False), ("layer", True)])
def test_row_norm(norm, bias):
    rng = np.random.default_rng(3)
    x = _randn(rng, (5, 48), 2.0) + 0.5
    params = {"s": _randn(rng, (48,))}
    if bias:
        params["b"] = _randn(rng, (48,))

    def make(m):
        return m.StackProgram(name="n", inputs=("x",), outputs=("y",), ops=(
            m.OpNode(m.OpKind.ROW_NORM, "n", ("x",), "y",
                     params=tuple(params), attrs={"norm": norm, "eps": 1e-5}),))

    _run_both(make, {"x": x}, params)


def test_softmax_affine_chain_with_barrier():
    rng = np.random.default_rng(4)
    x = _randn(rng, (2, 3, 40), 4.0)
    params = {"s": _randn(rng, (40,)), "o": _randn(rng, (40,))}

    def make(m):
        return m.StackProgram(name="c", inputs=("x",), outputs=("y", "a"), ops=(
            m.OpNode(m.OpKind.AFFINE, "a", ("x",), "a", params=("s", "o")),
            m.OpNode(m.OpKind.EW_UNARY, "g", ("a",), "g", fn="gelu"),
            m.OpNode(m.OpKind.ROW_SOFTMAX, "sm", ("g",), "y"),
        ))

    for barrier in (False, True):
        _run_both(make, {"x": x}, params, barrier=barrier)


@pytest.mark.parametrize("fn", ["max", "avg"])
@pytest.mark.parametrize("window,stride,padding", [
    ((3, 3), (1, 1), (1, 1)), ((2, 2), (2, 2), (0, 0)),
    ((3, 3), (2, 2), (1, 1)), ((3, 2), (2, 1), (1, 0))])
def test_pool2d(fn, window, stride, padding):
    rng = np.random.default_rng(5)
    x = _randn(rng, (2, 11, 9, 5))

    def make(m):
        return m.StackProgram(name="p", inputs=("x",), outputs=("y",),
                              layout="nhwc", ops=(
            m.OpNode(m.OpKind.POOL2D, "p", ("x",), "y", fn=fn,
                     attrs={"window": window, "stride": stride,
                            "padding": padding}),))

    out = _run_both(make, {"x": x}, {})
    jprog, tprog = _both(make)
    assert tuple(out["y"].shape) == tir.infer_shapes(
        tprog, {"x": x.shape})["y"] == jir.infer_shapes(jprog, {"x": x.shape})["y"]


@pytest.mark.parametrize("seed", range(6))
def test_random_programs(seed):
    """Random rows programs over every unary/binary fn and the row ops."""
    rng = np.random.default_rng(100 + seed)
    unary = sorted(jir._UNARY_FNS)
    binary = sorted(jir._BINARY_FNS)
    spec = []
    for i in range(8):
        spec.append(int(rng.integers(0, 5)))
    picks = [(unary[int(rng.integers(len(unary)))],
              binary[int(rng.integers(len(binary)))]) for _ in spec]
    feat = 24
    params = {}
    for i, kind in enumerate(spec):
        params[f"s{i}"] = _randn(rng, (feat,))
        params[f"o{i}"] = _randn(rng, (feat,))
    inputs = {"x": _randn(rng, (3, feat)), "z": _randn(rng, (3, feat))}

    def make(m):
        ops, v = [], "x"
        for i, (kind, (uf, bf)) in enumerate(zip(spec, picks)):
            out = f"v{i}"
            if kind == 0:
                ops.append(m.OpNode(m.OpKind.EW_UNARY, f"op{i}", (v,), out,
                                    fn=uf))
            elif kind == 1:
                ops.append(m.OpNode(m.OpKind.EW_BINARY, f"op{i}", (v, "z"),
                                    out, fn=bf))
            elif kind == 2:
                ops.append(m.OpNode(m.OpKind.AFFINE, f"op{i}", (v,), out,
                                    params=(f"s{i}", f"o{i}")))
            elif kind == 3:
                ops.append(m.OpNode(m.OpKind.ROW_NORM, f"op{i}", (v,), out,
                                    params=(f"s{i}",),
                                    attrs={"norm": ("rms", "layer")[i % 2],
                                           "eps": 1e-5}))
            else:
                ops.append(m.OpNode(m.OpKind.ROW_SOFTMAX, f"op{i}", (v,), out))
            v = out
        return m.StackProgram(name="r", inputs=("x", "z"), outputs=(v,),
                              ops=tuple(ops))

    used = {f"s{i}" for i, k in enumerate(spec) if k in (2, 3)} | {
        f"o{i}" for i, k in enumerate(spec) if k == 2}
    # keep divisors away from zero
    if any(k == 1 and p[1] == "div" for k, p in zip(spec, picks)):
        inputs["z"] = np.where(np.abs(inputs["z"]) < 0.5, 1.0,
                               inputs["z"]).astype(np.float32)
    _run_both(make, inputs, {k: v for k, v in params.items() if k in used})


def test_signature_matches_reference_structure():
    def make(m):
        return m.StackProgram(name="s", inputs=("x",), outputs=("y",),
                              layout="nhwc", ops=(
            m.OpNode(m.OpKind.POOL2D, "p", ("x",), "y", fn="max",
                     attrs={"window": (2, 2), "stride": (2, 2),
                            "padding": (0, 0)}),))

    jprog, tprog = _both(make)
    assert jprog.signature() == tprog.signature()
    assert tprog.param_names == jprog.param_names


def test_program_validation():
    with pytest.raises(ValueError, match="unknown unary"):
        tir.StackProgram(name="bad", inputs=("x",), outputs=("y",), ops=(
            tir.OpNode(tir.OpKind.EW_UNARY, "u", ("x",), "y", fn="nope"),))
    with pytest.raises(ValueError, match="undefined"):
        tir.NetGraph(name="g", input="x", output="y", ops=(
            tir.OpNode(tir.OpKind.EW_UNARY, "u", ("q",), "y", fn="relu"),))
