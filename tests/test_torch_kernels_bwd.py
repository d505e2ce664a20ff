"""The port's backward kernels against the JAX package's Pallas backward
kernels (run in interpret mode), on the CPU.

* rows: the generated Triton source of ``rows_bwd.emit_bwd_source``, run
  on the numpy stand-in for ``triton.language`` of
  ``tests/test_torch_kernels.py``, program by program as the persistent
  launch runs it, then the partial-sum reduction;
* nhwc: ``_run_bwd_descriptor``, a transliteration of
  ``csrc/fused_nhwc_bwd.cu`` over the descriptor the wrapper builds
  (``nhwc_bwd.launch_plan``'s items, persistent CTAs that keep a channel
  block, the reverse sweep, per-lane gradient partials summed in a fixed
  order, the overlap-add or direct ``dx`` write), and the launch plan's
  coverage;
* both plain versions (what a CPU tensor runs).

Both are held to ``fused_rows_bwd_call`` / ``fused_nhwc_bwd_call`` with
``interpret=True``.  The kernels themselves run only on the card
(``chip_smoke.py``)."""
from __future__ import annotations

import math
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import ir as jir
from repro.kernels.fused_stack import nhwc_bwd as jnhwc_bwd
from repro.kernels.fused_stack import rows_bwd as jrows_bwd
from repro.layers import stacks as jstacks
from repro_torch.core import autodiff as tad
from repro_torch.core import ir as tir
from repro_torch.core import resource as tresource
from repro_torch.kernels.fused_stack import nhwc as tnhwc
from repro_torch.kernels.fused_stack import nhwc_bwd as tnhwc_bwd
from repro_torch.kernels.fused_stack import rows as trows
from repro_torch.kernels.fused_stack import rows_bwd as trows_bwd
from repro_torch.layers import stacks as tstacks

from test_torch_kernels import (NHWC_CASES, _NP_DTYPE, _T_DTYPE,
                                _fake_triton, _np_int64, _Ptr, _randn,
                                _rows_inputs, _tile_forward, _vec_fn)

TOL = 1e-5
# the stand-ins sum rows, windows and tiles in another order than XLA
RTOL_SUM = 1e-4


def _assert_close(got, want, what, rtol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=TOL, err_msg=what)


# ---------------------------------------------------------------------------
# rows
# ---------------------------------------------------------------------------

BWD_ROWS_CASES = {
    # name: (forward case, tile_rows, programs of the persistent launch)
    "all_fns": ("all_fns", 4, 2),
    "norms_softmax": ("norms_softmax", 4, 3),
    "addnorm_rms": ("addnorm_rms", 8, 2),
    "addnorm_layer_bias": ("addnorm_layer_bias", 4, 3),
    "glu_silu": ("glu_silu", 4, 2),
    "scalar": ("scalar", 4, 2),
}


def _rows_cotangents(program, inputs, params, seed):
    """Seeded cotangents of every program output, at the output's width."""
    rng = np.random.default_rng(seed)
    in_w = {k: v.shape[-1] for k, v in inputs.items()}
    p_w = {k: int(np.asarray(v).size) for k, v in params.items()}
    widths = trows.value_widths(program, in_w, p_w)
    lead = next(iter(inputs.values())).shape[:-1]
    return {v: _randn(rng, lead + (widths[v],)) for v in program.outputs}


def _jax_rows_bwd(make, inputs, params, gs, tile):
    dins, dps = jrows_bwd.fused_rows_bwd_call(
        make(jir), {k: jnp.asarray(v) for k, v in inputs.items()},
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in gs.items()}, tile_rows=tile,
        interpret=True)
    return ({k: np.asarray(v) for k, v in dins.items()},
            {k: np.asarray(v) for k, v in dps.items()})


def _run_generated_bwd(program, inputs, params, gs, tile, n_prog,
                       monkeypatch, f_chunk=tresource.H100.f_chunk,
                       partials=None):
    """Execute ``emit_bwd_source`` on the fake Triton: every program of a
    persistent launch of ``n_prog`` programs, with ``launch_plan``'s
    sub-blocks for a card of ``n_prog / PROGRAMS_PER_SM`` SMs, then the
    reduction of the partials.  ``tile`` is the plan's row tile, which the
    launch no longer reads (as ``fused_rows_bwd``).  The partial-sum buffer
    is appended to ``partials`` when one is given."""
    arrays = [inputs[n] for n in program.inputs]
    lead = arrays[0].shape[:-1]
    n_rows = math.prod(lead)
    in_w = {n: a.shape[-1] for n, a in zip(program.inputs, arrays)}
    p_w = {p: int(np.asarray(params[p]).size) for p in program.param_names}
    feat = max(list(in_w.values()) + list(p_w.values()))
    f_block = tresource.feature_block(program, feat, f_chunk)
    # float32 or bfloat16 arrays, each in its own dtype, as the kernel
    # reads them
    dtypes = {k: _T_DTYPE[np.asarray(v).dtype]
              for k, v in {**inputs, **params}.items()}
    steps = trows.value_dtypes(
        program, {n: dtypes[n] for n in program.inputs},
        {p: torch.empty(np.shape(params[p]), dtype=dtypes[p])
         for p in program.param_names})
    src = trows_bwd.emit_bwd_source(program, in_w, p_w, feat, f_block,
                                    dtypes, steps)
    modules, state = _fake_triton()          # after the meta-tensor steps
    modules["triton.language"].debug_barrier = lambda: None
    for k, v in modules.items():
        monkeypatch.setitem(sys.modules, k, v)
    src = src.replace("rows.to(tl.int64)", "_np_int64(rows)")
    ns = {"_np_int64": _np_int64}
    exec(compile(src, "<generated>", "exec"), ns)
    dins = [np.full(n_rows * in_w[n], np.nan, _NP_DTYPE[dtypes[n]])
            for n in program.inputs]
    pw = sum(p_w.values())
    partial = np.full(n_prog * max(pw, 1), np.nan, np.float32)
    plan = trows_bwd.launch_plan(
        n_rows, feat, f_block, max(1, n_prog // trows_bwd.PROGRAMS_PER_SM))
    args = ([_Ptr(a.reshape(-1)) for a in arrays]
            + [_Ptr(np.asarray(params[p]).reshape(-1))
               for p in program.param_names]
            + [_Ptr(np.asarray(gs[v]).reshape(-1)) for v in program.outputs]
            + [_Ptr(d) for d in dins] + [_Ptr(partial)])
    for pid in range(n_prog):
        state["pid"] = pid
        ns["fused_rows_bwd_kernel"](*args, n_rows, plan.n_sub, n_prog,
                                    F=feat, R_SUB=plan.r_sub,
                                    BLOCK_F=plan.block_f, P_W=pw,
                                    LOOP_STAGES=plan.loop_stages)
    if partials is not None:
        partials.append(partial.reshape(n_prog, max(pw, 1)))
    total = np.full(max(pw, 1), np.nan, np.float32)
    for pid in range(-(-pw // 8)):
        state["pid"] = pid
        ns["reduce_partials_kernel"](_Ptr(partial), _Ptr(total), n_prog, pw,
                                     BLOCK=8, P_BLOCK=2)
    dparams, off = {}, 0
    for p in program.param_names:
        # the wrapper's one cast of the reduced sum to the parameter's dtype
        dparams[p] = total[off: off + p_w[p]].reshape(
            np.shape(params[p])).astype(_NP_DTYPE[dtypes[p]])
        off += p_w[p]
    return ({n: d.reshape(*lead, in_w[n])
             for n, d in zip(program.inputs, dins)}, dparams)


@pytest.mark.parametrize("name", sorted(BWD_ROWS_CASES))
def test_rows_bwd_paths_match_jax_kernel(name, monkeypatch):
    """Plain version and the generated Triton source (fake Triton), each
    against the Pallas backward in interpret mode: a tail tile, F not a
    power of two, more tiles than programs."""
    case, tile, n_prog = BWD_ROWS_CASES[name]
    make, inputs, params, _ = _rows_inputs(case)
    tprog = make(tir)
    gs = _rows_cotangents(tprog, inputs, params, 70)
    want_in, want_p = _jax_rows_bwd(make, inputs, params, gs, tile)
    plain_in, plain_p = trows_bwd.fused_rows_bwd(
        tprog, {k: torch.from_numpy(v) for k, v in inputs.items()},
        {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()},
        {k: torch.from_numpy(v) for k, v in gs.items()}, tile_rows=tile)
    gen_in, gen_p = _run_generated_bwd(tprog, inputs, params, gs, tile,
                                       n_prog, monkeypatch)
    for k in want_in:
        _assert_close(plain_in[k].numpy(), want_in[k], f"plain d{k}")
        _assert_close(gen_in[k], want_in[k], f"generated d{k}", RTOL_SUM)
    for k in want_p:
        _assert_close(plain_p[k].numpy(), want_p[k], f"plain d{k}", RTOL_SUM)
        _assert_close(gen_p[k], want_p[k], f"generated d{k}", RTOL_SUM)


BF16_BWD_CASES = {
    # name: (make, {input: shape}, {param: shape}); a bf16 LM's chains
    "norm_rms": (lambda m: (jstacks if m is jir else tstacks)
                 .norm_program("rms", 1e-6, False), {"x": (3, 7, 40)},
                 {"scale": (40,)}),
    "addnorm_layer_bias": (lambda m: (jstacks if m is jir else tstacks)
                           .addnorm_program("layer", 1e-5, True),
                           {"x": (21, 96), "res": (21, 96)},
                           {"scale": (96,), "bias": (96,)}),
    "glu_silu": (lambda m: (jstacks if m is jir else tstacks)
                 .glu_program("silu"), {"gate": (4, 5, 72), "up": (4, 5, 72)},
                 {}),
}
BF16_STEP = 2.0 ** -8
#: Against the Pallas backward the two packages round at other places
#: (XLA's and PyTorch's bf16 ops, and the rounded recompute): an element
#: may differ by a bf16 step of its own size plus one of the tensor's
#: largest entry (cancellation in a norm's dx), on all but this share of
#: the elements, and by at most four steps of the largest entry anywhere.
BF16_BWD_SHARE = 0.03
BF16_BWD_MAX_STEPS = 4


@pytest.mark.parametrize("name", sorted(BF16_BWD_CASES))
def test_rows_bwd_bf16_matches_jax_kernel(name, monkeypatch):
    """bfloat16 primals and cotangents: the generated source (fake Triton;
    several programs, row tile 4) and the plain version against the Pallas
    backward in interpret mode (one tile, so its bf16 parameter
    accumulator adds once).  Each gradient has its primal's dtype; the
    generated kernel agrees with the plain version to a bf16 step."""
    make, in_shapes, p_shapes = BF16_BWD_CASES[name]
    rng = np.random.default_rng(7)
    bf = ml_dtypes.bfloat16
    inputs = {k: _randn(rng, sh, 1.5).astype(bf)
              for k, sh in in_shapes.items()}
    params = {k: ((1.0 + 0.1 * _randn(rng, sh)) if k == "scale"
                  else 0.1 * _randn(rng, sh)).astype(bf)
              for k, sh in p_shapes.items()}
    tprog = make(tir)
    lead = next(iter(in_shapes.values()))[:-1]
    width = next(iter(in_shapes.values()))[-1]
    gs = {v: _randn(rng, lead + (width,)).astype(bf) for v in tprog.outputs}
    want_in, want_p = _jax_rows_bwd(make, inputs, params, gs, 32)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)

    plain_in, plain_p = trows_bwd.fused_rows_bwd(
        tprog, {k: t(v) for k, v in inputs.items()},
        {k: t(v) for k, v in params.items()},
        {k: t(v) for k, v in gs.items()}, tile_rows=4)
    gen_in, gen_p = _run_generated_bwd(tprog, inputs, params, gs, 4, 3,
                                       monkeypatch)
    for k, w in {**want_in, **want_p}.items():
        w = np.asarray(w, np.float32)
        plain = {**plain_in, **plain_p}[k]
        gen = np.asarray({**gen_in, **gen_p}[k])
        assert plain.dtype == torch.bfloat16 and gen.dtype == bf, k
        scale = float(np.abs(w).max())
        for what, got in (("plain", plain.float().numpy()),
                          ("generated", gen.astype(np.float32))):
            d = np.abs(got - w)
            share = float((d > BF16_STEP * (np.abs(w) + scale)).mean())
            assert share <= BF16_BWD_SHARE, (what, k, share)
            assert d.max() <= BF16_BWD_MAX_STEPS * BF16_STEP * scale, (
                what, k, float(d.max()), scale)
        np.testing.assert_allclose(gen.astype(np.float32),
                                   plain.float().numpy(), rtol=BF16_STEP,
                                   atol=1e-6, err_msg=f"generated vs plain "
                                                      f"d{k}")


def test_rows_bwd_bf16_source_rounds_each_step():
    """The bf16 reverse sweep of the silu gate rounds after each PyTorch op
    of the derivative and the products, as ``program_vjp`` on bf16 tensors
    does; in float32 the same chain rounds nowhere."""
    prog = tstacks.glu_program("silu")
    widths = {"gate": 64, "up": 64}
    bf, f32 = torch.bfloat16, torch.float32
    steps = trows.value_dtypes(prog, {"gate": bf, "up": bf}, {})
    src = trows_bwd.emit_bwd_source(prog, widths, {}, 64, 64,
                                    {"gate": bf, "up": bf}, steps)
    # recompute: act, mul; reverse: 5 derivative steps, g * d, and the two
    # products of the mul rule
    assert src.count("= round_bf16(") == 2 + 5 + 1 + 2
    assert "tl.cast(cv0, tl.bfloat16)" in src
    src32 = trows_bwd.emit_bwd_source(prog, widths, {}, 64, 64,
                                      {"gate": f32, "up": f32},
                                      trows.value_dtypes(
                                          prog, {"gate": f32, "up": f32},
                                          {}))
    assert "round_bf16" not in src32


@pytest.mark.parametrize("fn", sorted(tad._UNARY_DERIVS))
def test_rows_bwd_bf16_derivative_is_the_interpreters(fn, monkeypatch):
    """Each unary fn's bf16 derivative is ``autodiff._UNARY_DERIVS`` itself,
    traced op by op: the generated backward of ``y = fn(x)`` on the numpy
    stand-in equals ``program_vjp`` on bf16 tensors bit for bit on all but
    1% of the elements (numpy's and PyTorch's float32 transcendentals may
    differ by an ulp) and within one bf16 step on every element."""
    def make(m):
        return m.StackProgram(name=f"d_{fn}", inputs=("x",), outputs=("y",),
                              ops=(m.OpNode(m.OpKind.EW_UNARY, "f", ("x",),
                                            "y", fn=fn),))

    rng = np.random.default_rng(11)
    bf = ml_dtypes.bfloat16
    x = (2.0 * _randn(rng, (16, 96))).astype(bf)
    g = _randn(rng, (16, 96)).astype(bf)
    prog = make(tir)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)

    plain, _ = trows_bwd.fused_rows_bwd(prog, {"x": t(x)}, {}, {"y": t(g)})
    gen, _ = _run_generated_bwd(prog, {"x": x}, {}, {"y": g}, 4, 2,
                                monkeypatch)
    got = np.asarray(gen["x"]).astype(np.float32)
    want = plain["x"].float().numpy()
    assert float((got != want).mean()) <= 0.01, fn
    np.testing.assert_allclose(got, want, rtol=BF16_STEP, atol=0, err_msg=fn)


def test_rows_bwd_walks_f_in_chunks(monkeypatch):
    """The glu is F-separable: with a 32-feature chunk the kernel walks 72
    features in three chunks (the last one ragged) and still matches."""
    make, inputs, params, _ = _rows_inputs("glu_silu")
    tprog = make(tir)
    assert tresource.feature_block(tprog, 72, 32) == 32
    assert trows_bwd.launch_config(32, 4)[0] == 32
    gs = _rows_cotangents(tprog, inputs, params, 71)
    want_in, _ = _jax_rows_bwd(make, inputs, params, gs, 8)
    gen_in, _ = _run_generated_bwd(tprog, inputs, params, gs, 4, 3,
                                   monkeypatch, f_chunk=32)
    for k in want_in:
        _assert_close(gen_in[k], want_in[k], f"generated d{k}")


def _chunk_scalar(m):
    """An F-separable chain with width-1 operands: a scalar parameter on
    the F-wide path, and a (rows, 1) input scaled by a (1,) parameter into
    a width-1 value that is both an output and added to the F-wide path."""
    K = m.OpKind
    return m.StackProgram(name="chunk_scalar", inputs=("x", "r"),
                          outputs=("y", "u"), ops=(
        m.OpNode(K.EW_BINARY, "k", ("x",), "a", fn="mul", params=("k",)),
        m.OpNode(K.EW_BINARY, "t", ("r",), "u", fn="mul", params=("t",)),
        m.OpNode(K.EW_BINARY, "b", ("a", "u"), "b", fn="add"),
        m.OpNode(K.AFFINE, "f", ("b",), "y", params=("s", "o"))))


@pytest.mark.parametrize("f_chunk", [32, 0])
def test_rows_bwd_chunks_width1_operands(f_chunk, monkeypatch):
    """Width-1 parameters, inputs and outputs of an F-separable chain walked
    in 32-feature chunks (72 features: three chunks, the last ragged) or
    whole: each chunk's partial gradients add up to the Pallas backward's,
    the width-1 output's cotangent enters once."""
    rng = np.random.default_rng(73)
    inputs = {"x": _randn(rng, (7, 72)), "r": _randn(rng, (7, 1))}
    params = {"k": _randn(rng, ()), "t": _randn(rng, (1,)),
              "s": _randn(rng, (72,)), "o": _randn(rng, (72,))}
    tprog = _chunk_scalar(tir)
    assert tresource.feature_block(tprog, 72, f_chunk) == (f_chunk or 72)
    gs = _rows_cotangents(tprog, inputs, params, 74)
    want_in, want_p = _jax_rows_bwd(_chunk_scalar, inputs, params, gs, 4)
    gen_in, gen_p = _run_generated_bwd(tprog, inputs, params, gs, 4, 3,
                                       monkeypatch, f_chunk=f_chunk)
    for k in want_in:
        _assert_close(gen_in[k], want_in[k], f"generated d{k}", RTOL_SUM)
    for k in want_p:
        _assert_close(gen_p[k], want_p[k], f"generated d{k}", RTOL_SUM)


def test_rows_bwd_keeps_padded_rows_out_of_param_grads(monkeypatch):
    """Rows past the end recompute 0 / 0 (a div by a zero input); the row
    mask must keep that NaN out of the parameter sums."""
    def make(m):
        return m.StackProgram(name="pad", inputs=("x", "z"), outputs=("y",),
                              ops=(
            m.OpNode(m.OpKind.EW_BINARY, "d", ("x", "z"), "a", fn="div"),
            m.OpNode(m.OpKind.AFFINE, "f", ("a",), "y", params=("s", "o"))))

    rng = np.random.default_rng(5)
    inputs = {"x": _randn(rng, (7, 24)),
              "z": np.abs(_randn(rng, (7, 24))) + 1.0}
    params = {"s": _randn(rng, (24,)), "o": _randn(rng, (24,))}
    tprog = make(tir)
    gs = _rows_cotangents(tprog, inputs, params, 72)
    _, want_p = _jax_rows_bwd(make, inputs, params, gs, 4)
    _, gen_p = _run_generated_bwd(tprog, inputs, params, gs, 4, 2,
                                  monkeypatch)
    for k in want_p:
        assert np.isfinite(gen_p[k]).all()
        _assert_close(gen_p[k], want_p[k], f"d{k}", RTOL_SUM)


def test_rows_bwd_chunk_is_the_planner_chunk():
    """The kernel holds what the training planner counts: one predicate
    (``resource.feature_block``) at the plan's device's chunk."""
    from repro_torch.layers import stacks as tstacks
    glu = tstacks.glu_program("silu")
    norm = tstacks.norm_program("rms", 1e-6, False)
    for prog, feat, held in ((glu, 11008, 2048), (norm, 4096, 4096)):
        block = tresource.feature_block(prog, feat, tresource.H100.f_chunk)
        assert block == held == tresource.planned_features(
            prog, feat, tresource.H100, True)
    assert tresource.feature_block(glu, 11008,
                                   tresource.TINY_DEVICE.f_chunk) == 11008
    assert trows_bwd.launch_config(2048, 2) == (2048, 2, 8)
    assert trows_bwd.launch_config(4096, 2) == (4096, 1, 8)
    # the grid follows the rows and the card, not the plan's tile
    assert trows_bwd.launch_plan(8192, 4096, 4096, 132).n_prog == 264
    assert trows_bwd.launch_plan(5, 4096, 4096, 132).n_prog == 5
    # the loop is pipelined where two sub-blocks of loads fit: mamba2's
    # gated norm (y, z and the cotangent in bf16), rms in float32; not a
    # float32 row of 16384
    assert trows_bwd.launch_plan(4096, 5120, 5120, 132, 6).loop_stages == 2
    assert trows_bwd.launch_plan(8192, 4096, 4096, 132, 8).loop_stages == 2
    assert trows_bwd.launch_plan(8192, 16384, 16384, 132, 8).loop_stages == 1


@pytest.mark.parametrize("n_rows,features", [
    (4096, 5120), (8192, 4096), (2048, 5120), (4097, 5120), (1000, 96),
    (21, 24), (1, 4096)])
def test_rows_bwd_launch_plan_covers_every_row_once(n_rows, features):
    """``launch_plan`` on the H100's 132 SMs: every SM gets a program where
    the rows allow it (mamba2's gated norm at (4096, 5120), rms at (8192,
    4096)); the strided walk of sub-blocks covers every row exactly once,
    ragged tails included; one partial row a program."""
    sm = 132
    plan = trows_bwd.launch_plan(n_rows, features, features, sm)
    if n_rows >= 2048:
        assert plan.n_prog >= sm
    assert plan.n_prog == min(plan.n_sub, trows_bwd.PROGRAMS_PER_SM * sm)
    assert plan.block_f >= features and plan.n_sub * plan.r_sub >= n_rows
    assert plan.r_sub == 1 or plan.r_sub * plan.block_f <= trows_bwd.SUB_ELEMS
    seen = np.zeros(n_rows, np.int64)
    for pid in range(plan.n_prog):
        for sb in range(pid, plan.n_sub, plan.n_prog):
            r = sb * plan.r_sub + np.arange(plan.r_sub)
            np.add.at(seen, r[r < n_rows], 1)
    assert (seen == 1).all()


@pytest.mark.parametrize("name", ["addnorm_layer_bias", "norms_softmax",
                                  "glu_silu", "scalar"])
def test_rows_bwd_program_counts_agree(name, monkeypatch):
    """The generated source at 1, 3 and 5 programs: one count twice gives
    the same bits; every count agrees with the plain version within this
    file's float32 tolerance; each program writes its one partial row."""
    make, inputs, params, _ = _rows_inputs(name)
    tprog = make(tir)
    gs = _rows_cotangents(tprog, inputs, params, 76)
    want_in, want_p = trows_bwd.fused_rows_bwd(
        tprog, {k: torch.from_numpy(v) for k, v in inputs.items()},
        {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()},
        {k: torch.from_numpy(v) for k, v in gs.items()})
    for n_prog in (1, 3, 5):
        parts = []
        runs = [_run_generated_bwd(tprog, inputs, params, gs, 4, n_prog,
                                   monkeypatch, partials=parts)
                for _ in range(2)]
        for (a_in, a_p), (b_in, b_p) in [runs]:
            for k in a_in:
                np.testing.assert_array_equal(a_in[k], b_in[k])
            for k in a_p:
                np.testing.assert_array_equal(a_p[k], b_p[k])
        p_w = sum(int(np.asarray(v).size) for v in params.values())
        assert parts[0].shape[0] == n_prog
        assert np.isfinite(parts[0][:, :p_w]).all()
        gen_in, gen_p = runs[0]
        for k in want_in:
            _assert_close(gen_in[k], want_in[k].numpy(),
                          f"{n_prog} programs d{k}", RTOL_SUM)
        for k in want_p:
            _assert_close(gen_p[k], want_p[k].numpy(),
                          f"{n_prog} programs d{k}", RTOL_SUM)


@pytest.mark.parametrize("n_prog", [1, 3, 4])
def test_rows_bwd_padded_rows_out_at_every_program_count(n_prog,
                                                         monkeypatch):
    """Padded rows recompute 0 / 0; at every program count the row mask
    keeps that NaN out of the parameter sums."""
    def make(m):
        return m.StackProgram(name="pad", inputs=("x", "z"), outputs=("y",),
                              ops=(
            m.OpNode(m.OpKind.EW_BINARY, "d", ("x", "z"), "a", fn="div"),
            m.OpNode(m.OpKind.AFFINE, "f", ("a",), "y", params=("s", "o"))))

    rng = np.random.default_rng(6)
    inputs = {"x": _randn(rng, (11, 24)),
              "z": np.abs(_randn(rng, (11, 24))) + 1.0}
    params = {"s": _randn(rng, (24,)), "o": _randn(rng, (24,))}
    tprog = make(tir)
    gs = _rows_cotangents(tprog, inputs, params, 77)
    _, want_p = _jax_rows_bwd(make, inputs, params, gs, 4)
    _, gen_p = _run_generated_bwd(tprog, inputs, params, gs, 4, n_prog,
                                  monkeypatch)
    for k in want_p:
        assert np.isfinite(gen_p[k]).all()
        _assert_close(gen_p[k], want_p[k], f"d{k}", RTOL_SUM)


# ---------------------------------------------------------------------------
# nhwc
# ---------------------------------------------------------------------------

def _stride2_11x13(m):
    """A stride that does not tile 11 x 13, padded borders, then a stride-1
    pool whose halos overlap."""
    ops = []
    v = "x"
    for i, stride in enumerate(((2, 2), (1, 1))):
        ops += [m.OpNode(m.OpKind.POOL2D, f"p{i}", (v,), f"q{i}", fn="max",
                         attrs={"window": (3, 3), "stride": stride,
                                "padding": (1, 1)}),
                m.OpNode(m.OpKind.AFFINE, f"bn{i}", (f"q{i}",), f"b{i}",
                         params=(f"s{i}", f"o{i}")),
                m.OpNode(m.OpKind.EW_UNARY, f"r{i}", (f"b{i}",), f"v{i}",
                         fn="relu")]
        v = f"v{i}"
    return m.StackProgram(name="s2", inputs=("x",), outputs=(v,),
                          ops=tuple(ops), layout="nhwc")


def _avg_then_max(m):
    return m.StackProgram(name="avgmax", inputs=("x",), outputs=("y",),
                          layout="nhwc", ops=(
        m.OpNode(m.OpKind.POOL2D, "a", ("x",), "a", fn="avg",
                 attrs={"window": (3, 3), "stride": (1, 1),
                        "padding": (1, 1)}),
        m.OpNode(m.OpKind.POOL2D, "m", ("a",), "y", fn="max",
                 attrs={"window": (2, 2), "stride": (2, 2),
                        "padding": (0, 0)})))


def _vgg_stage(m, fn="relu", pool="max", pad=0):
    """VGG-16's stage chain: batch norm (affine), ReLU, 2x2/s2 max pool (or
    another activation, pool and padding); the kernel's fused path."""
    return m.StackProgram(name="vggstage", inputs=("x",), outputs=("y",),
                          layout="nhwc", ops=(
        m.OpNode(m.OpKind.AFFINE, "bn", ("x",), "b", params=("s", "o")),
        m.OpNode(m.OpKind.EW_UNARY, "r", ("b",), "r", fn=fn),
        m.OpNode(m.OpKind.POOL2D, "p", ("r",), "y", fn=pool,
                 attrs={"window": (2, 2), "stride": (2, 2),
                        "padding": (pad, pad)})))


BWD_NHWC_CASES = {
    # name: (make, x shape, tile, extras shapes, planted ties)
    **{k: (make, shape, tile, extra, False)
       for k, (make, shape, tile, extra) in NHWC_CASES.items()},
    "stride2_11x13": (_stride2_11x13, (2, 11, 13, 8), 2, {}, False),
    "ties": (_stride2_11x13, (1, 11, 13, 4), 4, {}, True),
    "avg_then_max": (_avg_then_max, (1, 9, 10, 4), 2, {}, False),
    # two 64-channel blocks, the second ragged; an odd row the tiles miss
    "vgg_stage_two_blocks": (_vgg_stage, (2, 9, 14, 72), 2, {}, False),
    # the fused path with tanh, an avg pool over padded borders, 6 channels
    "fused_avg_tanh_padded": (lambda m: _vgg_stage(m, "tanh", "avg", 1),
                              (2, 9, 10, 6), 2, {}, False),
}


def _nhwc_bwd_inputs(name):
    make, shape, tile, extra_shapes, ties = BWD_NHWC_CASES[name]
    rng = np.random.default_rng(100 + sorted(BWD_NHWC_CASES).index(name))
    x = _randn(rng, shape, 2.0)
    if ties:                       # integer grid: every window has ties
        x = np.round(x).astype(np.float32)
    jprog = make(jir)
    c = shape[-1]
    params = {p: _randn(rng, (c,), 0.3) + (1.0 if p[0] in "sg" else 0.0)
              for p in jprog.param_names}
    extras = {k: _randn(rng, s) for k, s in extra_shapes.items()}
    shapes = jir.infer_shapes(jprog, {"x": shape, **extra_shapes})
    g = _randn(rng, shapes[jprog.outputs[0]])
    return make, x, params, extras, g, tile


def _jax_nhwc_bwd(make, x, params, extras, g, tile):
    dx, dex, dps = jnhwc_bwd.fused_nhwc_bwd_call(
        make(jir), jnp.asarray(x), {k: jnp.asarray(v) for k, v in extras.items()},
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(g),
        tile_out_h=tile, tile_out_w=tile, interpret=True)
    return (np.asarray(dx), {k: np.asarray(v) for k, v in dex.items()},
            {k: np.asarray(v) for k, v in dps.items()})


def _bwd_desc(program, x, extras, vecs, tile):
    strides = tuple(int(v.numel() != 1) for v in vecs)
    blob = tnhwc_bwd.bwd_template(
        program, x.shape, tuple(sorted((k, v.shape) for k, v in
                                       extras.items())), strides, tile, tile)
    return tnhwc_bwd.NhwcBwdDesc.from_buffer_copy(blob)


def _cta_items(b, programs):
    """CTA ``p``'s channel block and its spatial items as (n, ti, tj), in
    the kernel's order: block ``p % n_cb``, items ``p // n_cb``, then every
    ``programs // n_cb``-th."""
    d = b.f
    for p in range(programs):
        items = []
        for s in range(p // d.n_cb, b.spatial, programs // d.n_cb):
            items.append((s // (d.tiles_w * d.tiles_h),
                          (s // d.tiles_w) % d.tiles_h, s % d.tiles_w))
        yield p, p % d.n_cb, items


def _lane_sums(contrib, lanes):
    """``(n_pos, cb)`` terms summed per position lane (lane ``l`` takes
    positions ``l, l + lanes, ...``): ``(lanes, cb)``."""
    n_pos, cb = contrib.shape
    pad = torch.zeros((-n_pos) % lanes, cb)
    return torch.cat([contrib, pad]).view(-1, lanes, cb).sum(0)


def _fused_item(d, b, vec, xt, gt, dx, n, ti, tj, c0, accs):
    """``fused_item`` of the .cu file on one item: per output position its
    window's x, affine (rounded) and unary values, the pool and its first
    maximum, g, and the chain rule back to dx; the scale and bias terms of
    the valid window positions summed per position lane into ``accs``."""
    aff, un, pool = d.ops[0], d.ops[1], d.ops[2]
    _, H, W, C = xt.shape
    L0, L1 = d.levels[0], d.levels[1]
    cb, lanes = d.cb, b.lanes
    gh, gw = ti * d.th * L0.mul_h - L0.off_h, tj * d.tw * L0.mul_w - L0.off_w
    p = torch.arange(L1.eh * L1.ew)
    r, c = p // L1.ew, p % L1.ew
    cg = c0 + torch.arange(cb)
    live = (cg < C)[None]
    oh, ow = ti * d.th + r, tj * d.tw + c
    gv = torch.where(((oh < d.OH) & (ow < d.OW))[:, None] & live, gt[
        n, oh.clamp(max=d.OH - 1), ow.clamp(max=d.OW - 1)][:, cg.clamp(
            max=C - 1)], 0.0)
    s, t = vec(aff.b_idx, cg)[None], vec(aff.c_idx, cg)[None]
    fn = {i: k for k, i in tnhwc.UNARY_IDS.items()}[un.fn]
    is_max = pool.fn == 0
    neutral = -np.finfo(np.float32).max if is_max else 0.0
    wins = []
    for k in range(pool.kh * pool.kw):
        h = gh + r * pool.sh + k // pool.kw
        w = gw + c * pool.sw + k % pool.kw
        ok = ((h >= 0) & (h < H) & (w >= 0) & (w < W))[:, None]
        xk = torch.where(ok & live, xt[n, h.clamp(0, H - 1), w.clamp(
            0, W - 1)][:, cg.clamp(max=C - 1)], 0.0)
        bk = xk * s + t
        vk = torch.where(ok, tir.UNARY_FNS[fn](bk), neutral)
        wins.append((h, w, ok, xk, bk, vk))
    y = wins[0][5]
    for *_, vk in wins[1:]:
        y = torch.maximum(y, vk) if is_max else y + vk
    code = torch.full(y.shape, -1)
    for k, (*_, vk) in enumerate(wins):
        code = torch.where((code < 0) & (vk == y), k, code)
    scale, bias = torch.zeros_like(gv), torch.zeros_like(gv)
    for k, (h, w, ok, xk, bk, _) in enumerate(wins):
        du = (torch.where(code == k, gv, 0.0) if is_max
              else gv / float(pool.kh * pool.kw))
        db = torch.where(ok, du, 0.0) * tad._UNARY_DERIVS[fn](
            bk, tir.UNARY_FNS[fn](bk))
        m = ok & live
        rows = torch.nonzero(m)
        dx[n, h[rows[:, 0]], w[rows[:, 0]], cg[rows[:, 1]]] = (db * s)[m]
        scale = scale + torch.where(ok, db * xk, 0.0)
        bias = bias + torch.where(ok, db, 0.0)
    accs[:, aff.b_idx] += _lane_sums(scale, lanes)
    accs[:, aff.c_idx] += _lane_sums(bias, lanes)


def _run_bwd_descriptor(program, x, params, extras, g, tile, card=(3, 1)):
    """``csrc/fused_nhwc_bwd.cu`` in Python over the descriptor
    :func:`nhwc_bwd.fused_nhwc_bwd` passes, on a card of ``card`` = (SMs,
    CTAs an SM): ``launch_programs`` persistent CTAs, each keeping one
    channel block and walking its spatial items (``_cta_items``); per item
    the interior test, the recompute (``_tile_forward``), the reverse sweep
    (masking only off the interior; a pool whose windows do not overlap in
    one pass over its windows, else marked then gathered), vector gradients
    summed per position lane into the lane's partials; at the CTA's end the
    lanes summed in order; per channel the owning CTAs' partials summed in
    CTA order; the direct or patch write of dx and the overlap-add."""
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    names = list(program.inputs[1:]) + list(program.param_names)
    vals = {**extras, **params}
    vecs = [torch.from_numpy(np.asarray(vals[n], np.float32)).reshape(-1)
            for n in names]
    strides = tuple(int(v.numel() != 1) for v in vecs)
    b = _bwd_desc(program, x, extras, vecs, tile)
    d = b.f
    N, H, W, C = x.shape
    cb, nq, lanes = d.cb, d.cb // 4, b.lanes
    assert cb % 4 == 0 and lanes == tnhwc_bwd.THREADS // nq
    assert not d.rowred or cb == C      # _tile_forward's rows span cb
    vec = _vec_fn(d, vecs, C)
    unary = {i: n for n, i in tnhwc.UNARY_IDS.items()}
    binary = {i: n for n, i in tnhwc.BINARY_IDS.items()}
    L0, Lout = d.levels[0], d.levels[d.n_levels - 1]
    # NaN where the direct write must reach every element unzeroed
    dx = torch.full((N, H, W, C), float("nan")) if tnhwc_bwd.direct_covers(
        b) else torch.zeros(N, H, W, C)
    patches = torch.full((N, d.tiles_h, d.tiles_w, L0.eh * L0.ew, C),
                         float("nan"))
    programs = tnhwc_bwd.launch_programs(b.spatial, d.n_cb, *card)
    assert programs % d.n_cb == 0
    partials = torch.full((programs, b.n_vecs, cb), float("nan"))

    def origin(L, ti, tj):
        return ti * d.th * L.mul_h - L.off_h, tj * d.tw * L.mul_w - L.off_w

    def valid(L, gh, gw, p):
        h, w = gh + p // L.ew, gw + p % L.ew
        return (h >= 0) & (h < L.ih) & (w >= 0) & (w < L.iw)

    def put(smem, slot, e, v, acc):
        smem[slot, e] = smem[slot, e] + v if acc else v

    for blk, cblk, items in _cta_items(b, programs):
        c0 = cblk * cb
        accs = torch.zeros(lanes, b.n_vecs, cb)     # per-lane partials
        for n, ti, tj in items:
            if b.fused:
                _fused_item(d, b, vec, xt, gt, dx, n, ti, tj, c0, accs)
                continue
            interior = all(
                gh >= 0 and gh + L.eh <= L.ih and gw >= 0
                and gw + L.ew <= L.iw
                for L in d.levels[:d.n_levels]
                for gh, gw in [origin(L, ti, tj)])
            smem = _tile_forward(d, vec, xt, n, ti, tj, c0)

            def operand(src, idx, e, cg):
                return smem[idx, e] if src == tnhwc.SRC_SLOT else vec(idx, cg)

            e = torch.arange(d.th * d.tw * cb)
            c, p = e % cb, e // cb
            oh, ow, cg = ti * d.th + p // d.tw, tj * d.tw + p % d.tw, c0 + c
            ok = (oh < d.OH) & (ow < d.OW) & (cg < C)
            assert Lout.eh * Lout.ew == d.th * d.tw
            smem[b.g_slot, e] = torch.where(ok, gt[
                n, oh.clamp(max=d.OH - 1), ow.clamp(max=d.OW - 1),
                cg.clamp(max=C - 1)], 0.0)
            for k in reversed(range(d.n_ops)):
                op, bo = d.ops[k], b.bops[k]
                if bo.g < 0:
                    continue
                pool = op.kind == tnhwc.K_POOL
                Li = d.levels[bo.level]
                Lo = d.levels[bo.level + int(pool)]
                ghi, gwi = origin(Li, ti, tj)
                gho, gwo = origin(Lo, ti, tj)
                e = torch.arange(Lo.eh * Lo.ew * cb)
                if not interior:
                    smem[bo.g, e] = torch.where(valid(Lo, gho, gwo, e // cb),
                                                smem[bo.g, e], 0.0)
                else:           # the skip changes nothing: all inside
                    assert valid(Lo, gho, gwo, e // cb).all()
                G = smem[bo.g]
                if pool:
                    eo = torch.arange(Lo.eh * Lo.ew * cb)
                    co, po = eo % cb, eo // cb
                    oi, oj = po // Lo.ew, po % Lo.ew
                    direct = op.kh == op.sh and op.kw == op.sw
                    if op.fn == 0:              # the first max offset
                        y = smem[op.out, eo]
                        code = torch.full(eo.shape, -1.0)
                        for di in range(op.kh):
                            for dj in range(op.kw):
                                hi, wj = oi * op.sh + di, oj * op.sw + dj
                                okv = ((ghi + hi >= 0) & (ghi + hi < Li.ih)
                                       & (gwi + wj >= 0) & (gwi + wj < Li.iw))
                                v = torch.where(okv, smem[
                                    op.a_idx, (hi * Li.ew + wj) * cb + co],
                                    -np.finfo(np.float32).max)
                                code = torch.where((code < 0) & (v == y),
                                                   float(di * op.kw + dj),
                                                   code)
                        if not direct:          # marked in the dead slot
                            smem[op.out, eo] = code
                    if direct:      # each window's owner writes it whole
                        assert Li.eh == Lo.eh * op.sh and Li.ew == Lo.ew * op.sw
                        for di in range(op.kh):
                            for dj in range(op.kw):
                                hi, wj = oi * op.sh + di, oj * op.sw + dj
                                ei = (hi * Li.ew + wj) * cb + co
                                s = (torch.where(code == di * op.kw + dj,
                                                 G[eo], 0.0) if op.fn == 0
                                     else G[eo] / float(op.kh * op.kw))
                                okv = valid(Li, ghi, gwi, ei // cb)
                                put(smem, bo.da, ei, torch.where(okv, s, 0.0),
                                    bo.da_acc)
                        continue
                    ei = torch.arange(Li.eh * Li.ew * cb)
                    ci, pi = ei % cb, ei // cb
                    hi, wj = pi // Li.ew, pi % Li.ew
                    s = torch.zeros(ei.shape)
                    for di in range(op.kh):
                        for dj in range(op.kw):
                            th_, tw_ = hi - di, wj - dj
                            okh = (th_ >= 0) & (th_ % op.sh == 0) & (
                                th_ // op.sh < Lo.eh)
                            okw = (tw_ >= 0) & (tw_ % op.sw == 0) & (
                                tw_ // op.sw < Lo.ew)
                            o = ((th_ // op.sh).clamp(0, Lo.eh - 1) * Lo.ew
                                 + (tw_ // op.sw).clamp(0, Lo.ew - 1)) * cb + ci
                            if op.fn == 0:
                                take = okh & okw & (smem[op.out, o]
                                                    == float(di * op.kw + dj))
                                s = s + torch.where(take, G[o], 0.0)
                            else:
                                s = s + torch.where(okh & okw, G[o] / float(
                                    op.kh * op.kw), 0.0)
                    put(smem, bo.da, ei, torch.where(
                        valid(Li, ghi, gwi, pi), s, 0.0), bo.da_acc)
                    continue
                n_pos = Lo.eh * Lo.ew
                okp = valid(Lo, gho, gwo, torch.arange(n_pos))[:, None]
                cgs = c0 + torch.arange(cb)
                e2 = (torch.arange(n_pos)[:, None] * cb
                      + torch.arange(cb)[None, :])
                cg2 = cgs.expand_as(e2)

                def add(idx, contrib):      # the lanes' partials of idx
                    accs[:, idx] += _lane_sums(torch.where(okp, contrib, 0.0),
                                               lanes)

                if op.kind in (tnhwc.K_NORM, tnhwc.K_SOFTMAX):
                    sl = slice(0, n_pos * cb)
                    gv = G[sl].view(n_pos, cb)
                    if op.kind == tnhwc.K_SOFTMAX:
                        yv = smem[op.out, sl].view(n_pos, cb)
                        dot = (gv * yv).sum(-1, keepdim=True)
                        dxv = yv * (gv - dot)
                    else:
                        xv = smem[op.a_idx, sl].view(n_pos, cb)
                        mu = xv.mean(-1, keepdim=True) if op.norm == 1 else 0.0
                        var = torch.square(xv - mu).mean(-1, keepdim=True)
                        r = torch.rsqrt(var + op.eps)
                        xh = (xv - mu) * r
                        cc = torch.arange(cb)
                        gy = gv * vec(op.b_idx, cc) if op.b_idx >= 0 else gv
                        if op.b_idx >= 0:
                            smem[b.scratch, sl] = torch.where(
                                okp, gv * xh, 0.0).reshape(-1)
                        if op.norm == 0:
                            m1 = (gy * xv).mean(-1, keepdim=True)
                            dxv = r * gy - xv * (r * r * r) * m1
                        else:
                            m1 = gy.mean(-1, keepdim=True)
                            m2 = (gy * xh).mean(-1, keepdim=True)
                            dxv = r * (gy - m1 - xh * m2)
                    put(smem, bo.da, torch.arange(n_pos * cb),
                        dxv.reshape(-1), bo.da_acc)
                    if op.kind == tnhwc.K_NORM and op.b_idx >= 0:
                        add(op.b_idx, smem[b.scratch, e2])
                        if op.c_idx >= 0:
                            add(op.c_idx, G[e2])
                    continue
                # an element-wise op, its vector gradients in the same pass
                a = operand(op.a_src, op.a_idx, e2, cg2)
                gv = G[e2]
                db = torch.zeros_like(a)
                if op.kind == tnhwc.K_UNARY:
                    fn = unary[op.fn]
                    da = gv * tad._UNARY_DERIVS[fn](a, tir.UNARY_FNS[fn](a))
                elif op.kind == tnhwc.K_BINARY:
                    bv = operand(op.b_src, op.b_idx, e2, cg2)
                    da, db = tad._binary_vjp(binary[op.fn], a, bv, gv)
                else:
                    da = gv * vec(op.b_idx, cg2)
                if bo.da >= 0:
                    put(smem, bo.da, e2, da + db if bo.same else da,
                        bo.da_acc)
                if bo.db >= 0:
                    put(smem, bo.db, e2, db, bo.db_acc)
                a_vec = op.a_src == tnhwc.SRC_VEC
                b_vec = (op.kind == tnhwc.K_BINARY
                         and op.b_src == tnhwc.SRC_VEC)
                if op.kind == tnhwc.K_AFFINE:
                    add(op.b_idx, gv * a)
                    add(op.c_idx, gv)
                    if a_vec:
                        add(op.a_idx, da)
                else:
                    if a_vec:
                        add(op.a_idx, da)
                    if b_vec:
                        add(op.b_idx, db)
            # the primary input's cotangent
            e = torch.arange(L0.eh * L0.ew * cb)
            c, p = e % cb, e // cb
            cg = c0 + c
            v = smem[b.dx_slot, e] if b.dx_slot >= 0 else torch.zeros(e.shape)
            if b.patches:
                patches[n, ti, tj, p[cg < C], cg[cg < C]] = v[cg < C]
            else:
                gh, gw = origin(L0, ti, tj)
                h, w_ = gh + p // L0.ew, gw + p % L0.ew
                ok = (h >= 0) & (h < H) & (w_ >= 0) & (w_ < W) & (cg < C)
                dx[n, h[ok], w_[ok], cg[ok]] = v[ok]
        partials[blk] = accs.sum(0)     # lanes in order
    if b.patches:                      # overlap-add, row-major tile order
        for ti in range(d.tiles_h):
            for tj in range(d.tiles_w):
                gh, gw = origin(L0, ti, tj)
                pt = patches[:, ti, tj].view(N, L0.eh, L0.ew, C)
                h0, h1 = max(gh, 0), min(gh + L0.eh, H)
                w0, w1 = max(gw, 0), min(gw + L0.ew, W)
                dx[:, h0:h1, w0:w1] += pt[:, h0 - gh: h1 - gh,
                                          w0 - gw: w1 - gw]
    total = torch.zeros(b.n_vecs, C)
    for ch in range(C):                 # the owners of ch, in CTA order
        for p in range(ch // cb, programs, d.n_cb):
            total[:, ch] += partials[p, :, ch % cb]
    grads = {}
    for i, name in enumerate(names):
        grad = total[i] if strides[i] else total[i].sum().reshape(1)
        grads[name] = grad.reshape(np.shape(vals[name])).numpy()
    return (dx.numpy(), {k: grads[k] for k in program.inputs[1:]},
            {k: grads[k] for k in program.param_names})


@pytest.mark.parametrize("name", sorted(BWD_NHWC_CASES))
def test_nhwc_bwd_paths_match_jax_kernel(name):
    """Plain version and the transliteration of ``fused_nhwc_bwd.cu``, each
    against the Pallas backward in interpret mode."""
    make, x, params, extras, g, tile = _nhwc_bwd_inputs(name)
    want_dx, want_dex, want_dp = _jax_nhwc_bwd(make, x, params, extras, g,
                                               tile)
    tprog = make(tir)
    plain = tnhwc_bwd.fused_nhwc_bwd(
        tprog, torch.from_numpy(x),
        {k: torch.from_numpy(v) for k, v in extras.items()},
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(g), tile_out_h=tile, tile_out_w=tile)
    kernel = _run_bwd_descriptor(tprog, x, params, extras, g, tile)
    for got, how in ((tuple(t.numpy() if torch.is_tensor(t) else
                            {k: v.numpy() for k, v in t.items()}
                            for t in plain), "plain"), (kernel, "kernel")):
        gdx, gdex, gdp = got
        _assert_close(gdx, want_dx, f"{how} dx", RTOL_SUM)
        for k in want_dex:
            _assert_close(gdex[k], want_dex[k], f"{how} d{k}", RTOL_SUM)
        for k in want_dp:
            _assert_close(gdp[k], want_dp[k], f"{how} d{k}", RTOL_SUM)


def test_nhwc_bwd_ties_route_whole():
    """Planted ties: the first maximal window position takes the whole
    cotangent, so with g = 1 every dx entry is an integer count."""
    make, x, params, extras, _, tile = _nhwc_bwd_inputs("ties")
    pool = make(tir).ops[0]
    prog = tir.StackProgram(name="mp", inputs=("x",), outputs=(pool.output,),
                            layout="nhwc", ops=(pool,))
    y_shape = tir.infer_shapes(prog, {"x": x.shape})[pool.output]
    dx, _, _ = _run_bwd_descriptor(prog, x, {}, {}, np.ones(y_shape,
                                                           np.float32), tile)
    assert np.all(dx == np.round(dx)) and dx.sum() == np.prod(y_shape)


@pytest.mark.parametrize("graph,shape", [
    ("block_net8", (32, 56, 56, 32)),
    ("vgg16", (32, 224, 224, 3)),
])
def test_bwd_descriptor_builds_for_main_path_stacks(graph, shape):
    """Every differentiable sequence of the main paths fits the backward's
    descriptor and, with its launch plan's items, two CTAs an SM (VGG-16's
    five, block_net(8)'s three)."""
    from repro_torch.core import analyzer, collapse
    from repro_torch.models import cnn
    g, _ = (cnn.block_net(8, channels=32, device="cpu") if graph == "block_net8"
            else cnn.vgg_net((64, 128, 256, 512, 512), device="cpu"))
    x_shape, n_seq = shape, 0
    for seg in analyzer.analyze(g, keep=frozenset({g.output})):
        if not seg.is_stack:
            if seg.op.kind == tir.OpKind.CONV2D:
                x_shape = x_shape[:3] + (seg.op.attrs["kernel_shape"][-1],)
            continue
        plan = collapse.collapse(seg.stack, {seg.stack.inputs[0]: x_shape},
                                 tresource.H100, differentiable=True)
        for i, seq in enumerate(plan.sequences):
            sub = plan.subprogram(i)
            sub_shape = tir.infer_shapes(seg.stack, {seg.stack.inputs[0]:
                                                     x_shape})[sub.inputs[0]]
            blob = tnhwc_bwd.bwd_template(sub, sub_shape, (), (1,) * len(
                sub.param_names), seq.tile_out_h, seq.tile_out_w)
            b = tnhwc_bwd.NhwcBwdDesc.from_buffer_copy(blob)
            assert tnhwc_bwd.desc_smem(b) <= tnhwc_bwd.SMEM_BWD  # 2 an SM
            assert b.f.n_slots <= tnhwc_bwd.BWD_MAX_SLOTS
            # VGG's 2x2/s2 pools: halos do not overlap, dx is written
            # directly and whole, with no zero fill first
            assert b.patches == (graph == "block_net8")
            assert tnhwc_bwd.direct_covers(b) == (graph == "vgg16")
            n_seq += 1
        x_shape = tir.infer_shapes(seg.stack, {seg.stack.inputs[0]: x_shape})[
            seg.stack.outputs[0]]
    assert n_seq == (3 if graph == "block_net8" else 5)


def _main_path_sequences(graph, shape):
    """(name, sub-program, input shape, planner tile) of every
    differentiable sequence of VGG-16's or block_net(8, 32)'s stacks."""
    from repro_torch.core import analyzer, collapse
    from repro_torch.models import cnn
    g, _ = (cnn.block_net(8, channels=32, device="cpu") if graph == "block_net8"
            else cnn.vgg_net((64, 128, 256, 512, 512), device="cpu"))
    x_shape, out = shape, []
    for seg in analyzer.analyze(g, keep=frozenset({g.output})):
        if not seg.is_stack:
            if seg.op.kind == tir.OpKind.CONV2D:
                x_shape = x_shape[:3] + (seg.op.attrs["kernel_shape"][-1],)
            continue
        plan = collapse.collapse(seg.stack, {seg.stack.inputs[0]: x_shape},
                                 tresource.H100, differentiable=True)
        for i, seq in enumerate(plan.sequences):
            sub = plan.subprogram(i)
            sub_shape = tir.infer_shapes(seg.stack, {seg.stack.inputs[0]:
                                                     x_shape})[sub.inputs[0]]
            out.append((f"{graph}_{len(out)}", sub, sub_shape,
                        seq.tile_out_h))
        x_shape = tir.infer_shapes(seg.stack, {seg.stack.inputs[0]: x_shape})[
            seg.stack.outputs[0]]
    return out


def _plan_cases():
    """VGG-16's five stages (batch 2), block_net(8, 32)'s three
    overlapping-window sequences, and stage 1's chain at 200 and 6
    channels (not a multiple of the 64-channel block, nor of a float4)."""
    cases = _main_path_sequences("vgg16", (2, 224, 224, 3))
    cases += _main_path_sequences("block_net8", (2, 56, 56, 32))
    _, prog, shape, tile = cases[0]
    for c in (200, 6):
        cases.append((f"vgg16_0_c{c}", prog, shape[:3] + (c,), tile))
    return cases


_PLAN_CASES = {name: case for name, *case in _plan_cases()}


@pytest.mark.parametrize("name", sorted(_PLAN_CASES))
def test_nhwc_bwd_launch_plan_covers_every_element_once(name):
    """Each (image, output position, channel) in exactly one item of one
    CTA, one position lane and one channel quad; on the direct path each
    (image, input position, channel) of dx too, so dx needs no zero fill."""
    prog, shape, tile = _PLAN_CASES[name]
    b = _bwd_desc(prog, np.zeros(shape, np.float32), {},
                  [torch.ones(shape[-1])] * len(prog.param_names), tile)
    d = b.f
    N, H, W, C = shape
    nq = d.cb // 4
    programs = tnhwc_bwd.launch_programs(b.spatial, d.n_cb, 132, 2)
    rows = [(n, ti, tj, cblk) for _, cblk, items in _cta_items(b, programs)
            for n, ti, tj in items]
    n, ti, tj, cblk = (np.array(v)[:, None] for v in zip(*rows))
    assert len(rows) == b.work == b.spatial * d.n_cb

    def covered(L, ih, iw, windows=False):
        """Counts of (image, h, w, channel) over the items' positions of
        level L (each lane's walk; with ``windows``, the fused path's: each
        lane's output positions and their pool windows) and their channel
        quads."""
        if windows:
            pool, Lo = prog.ops[-1], d.levels[d.n_levels - 1]
            (kh, kw), (sh, sw) = pool.attrs["window"], pool.attrs["stride"]
            out = np.concatenate([np.arange(lane, Lo.eh * Lo.ew, b.lanes)
                                  for lane in range(b.lanes)])
            rr = (out[:, None] // Lo.ew * sh + np.arange(kh * kw) // kw)
            cc = (out[:, None] % Lo.ew * sw + np.arange(kh * kw) % kw)
            pos = (rr * L.ew + cc).ravel()
        else:
            pos = np.concatenate([np.arange(lane, L.eh * L.ew, b.lanes)
                                  for lane in range(b.lanes)])
        assert np.array_equal(np.sort(pos), np.arange(L.eh * L.ew))
        h = ti * d.th * L.mul_h - L.off_h + pos[None] // L.ew
        w = tj * d.tw * L.mul_w - L.off_w + pos[None] % L.ew
        ch = cblk * d.cb + (4 * np.arange(nq)[:, None]
                            + np.arange(4)[None]).reshape(1, -1)
        flat = ((n * ih + h) * iw + w)[:, :, None] * C + ch[:, None, :]
        keep = (((h >= 0) & (h < ih) & (w >= 0) & (w < iw))[:, :, None]
                & (ch < C)[:, None, :])
        return np.bincount(flat[keep], minlength=N * ih * iw * C)

    Lout = d.levels[d.n_levels - 1]
    assert (Lout.eh, Lout.ew) == (d.th, d.tw)
    assert (covered(Lout, d.OH, d.OW) == 1).all()
    if not b.patches:
        assert (covered(d.levels[0], H, W, windows=bool(b.fused)) == 1).all()
        assert tnhwc_bwd.direct_covers(b)
    assert b.patches == name.startswith("block_net8")
    # VGG's stage chain (batch norm, ReLU, 2x2/s2 max pool) takes the fused
    # path, 8 x 8 output positions of all 64 channels an item at stage 1
    assert b.fused == name.startswith("vgg16")
    if name == "vgg16_0":
        assert (d.th, d.tw, d.cb, b.lanes) == (8, 8, 64, 16)


def test_broadcast_only_op_trains_through_both_packages():
    """y = x + e * e at (2, 8, 8, 4): the op e * e reads only the broadcast
    extra.  The JAX package runs it through both generated Pallas kernels;
    the port's dispatch takes the kernel path (on the CPU, the kernels'
    plain versions), and the transliterated CUDA descriptors, forward and
    ``dx``/``de`` equal to it."""
    from repro.kernels.fused_stack import ops as jops
    from repro_torch.kernels.fused_stack import ops as tops
    from test_torch_kernels import _extra_only_op
    rng = np.random.default_rng(13)
    x = _randn(rng, (2, 8, 8, 4))
    e = _randn(rng, (1, 1, 1, 4))
    g = _randn(rng, (2, 8, 8, 4))
    jprog, tprog = _extra_only_op(jir), _extra_only_op(tir)

    def jloss(x_, e_):
        y = jops.fused_stack_apply(jprog, {"x": x_, "e": e_}, {},
                                   mode="brainslug", interpret=True)["y"]
        return jnp.sum(y * g), y

    before = jops.STATS.snapshot()
    (_, jy), (jdx, jde) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(jnp.asarray(x),
                                                           jnp.asarray(e))
    assert {k: v for k, v in jops.STATS.delta(before).items() if v} == {
        "fwd_generated": 1, "bwd_generated": 1}
    np.testing.assert_allclose(np.asarray(jde), (2 * e * g.sum(
        (0, 1, 2), keepdims=True)), rtol=1e-5, atol=1e-5)

    tx = torch.from_numpy(x).requires_grad_()
    te = torch.from_numpy(e).requires_grad_()
    tbefore = tops.STATS.snapshot()
    ty = tops.fused_stack_apply(tprog, {"x": tx, "e": te}, {},
                                mode="brainslug", differentiable=True)["y"]
    tdx, tde = torch.autograd.grad(ty, (tx, te), torch.from_numpy(g))
    assert {k: v for k, v in tops.STATS.delta(tbefore).items() if v} == {
        "fwd_reference": 1, "bwd_reference": 1}
    _assert_close(ty.detach().numpy(), np.asarray(jy), "y")
    _assert_close(tdx.numpy(), np.asarray(jdx), "dx")
    _assert_close(tde.numpy(), np.asarray(jde), "de", RTOL_SUM)
    # the CUDA kernels' descriptors, transliterated, at the training tile
    from test_torch_kernels import _run_descriptor
    _assert_close(_run_descriptor(tprog, x, {}, {"e": e}, 4), np.asarray(jy),
                  "kernel y")
    kdx, kde, _ = _run_bwd_descriptor(tprog, x, {}, {"e": e}, g, 4)
    _assert_close(kdx, np.asarray(jdx), "kernel dx")
    _assert_close(kde["e"], np.asarray(jde), "kernel de", RTOL_SUM)
