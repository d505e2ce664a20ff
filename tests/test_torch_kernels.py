"""The port's fused-stack kernel modules against the JAX package's Pallas
kernels (run in interpret mode), on the CPU.

* nhwc geometry (``_plan_levels``/``plan_geometry``) equals the JAX
  kernel's for strided, padded and multi-pool chains;
* the plain versions (what a CPU tensor runs) agree with
  ``fused_nhwc_call``/``fused_rows_call`` at 1e-5;
* the CUDA kernel's algorithm is held to the same reference through
  ``_run_descriptor``, a line-by-line transliteration of
  ``csrc/fused_nhwc.cu``'s generic kernel over the descriptor the wrapper
  builds, and ``_run_fused_forward``, of its fused path (persistent CTAs
  over ``fused_plan``'s items), bit for bit with the plain version on
  VGG-like chains; the fused plan stores every output element once, and
  ``fused_chain`` takes VGG's stacks and leaves block_net's;
* the generated Triton source parses, names the expected ops, and, run
  against ``_fake_triton`` (numpy standing in for ``triton.language``,
  with bf16 from ``ml_dtypes``), computes what the JAX kernel computes, in
  float32 and in bfloat16.

The kernels themselves run only on the card (``chip_smoke.py``)."""
from __future__ import annotations

import ast
import math
import sys
import types

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import ir as jir
from repro.kernels.fused_stack import nhwc as jnhwc
from repro.kernels.fused_stack import rows as jrows
from repro.layers import stacks as jstacks
from repro_torch.core import ir as tir
from repro_torch.kernels.fused_stack import nhwc as tnhwc
from repro_torch.kernels.fused_stack import ops as tops
from repro_torch.kernels.fused_stack import rows as trows
from repro_torch.layers import stacks as tstacks

TOL = 1e-5


def _randn(rng, shape, scale=1.0):
    return np.asarray(scale * rng.standard_normal(shape), np.float32)


def _pool(m, name, vin, vout, fn="max", window=(3, 3), stride=(1, 1),
          padding=(1, 1)):
    return m.OpNode(m.OpKind.POOL2D, name, (vin,), vout, fn=fn,
                    attrs={"window": window, "stride": stride,
                           "padding": padding})


# ---------------------------------------------------------------------------
# nhwc cases: (make(ir_module) -> program, input shape, tile, extras shapes)
# ---------------------------------------------------------------------------

def _block_chain(m, n=3, **pool):
    ops, v = [], "x"
    for i in range(n):
        ops += [_pool(m, f"p{i}", v, f"pp{i}", **pool),
                m.OpNode(m.OpKind.AFFINE, f"bn{i}", (f"pp{i}",), f"b{i}",
                         params=(f"s{i}", f"o{i}")),
                m.OpNode(m.OpKind.EW_UNARY, f"r{i}", (f"b{i}",), f"v{i}",
                         fn="relu")]
        v = f"v{i}"
    return m.StackProgram(name="chain", inputs=("x",), outputs=(v,),
                          ops=tuple(ops), layout="nhwc")


def _avg_pad(m):
    return m.StackProgram(name="avg", inputs=("x",), outputs=("y",),
                          layout="nhwc", ops=(_pool(m, "p", "x", "y", "avg"),))


def _strided(m):
    return m.StackProgram(name="strided", inputs=("x",), outputs=("y",),
                          layout="nhwc", ops=(
        _pool(m, "p0", "x", "a", "max", (3, 3), (2, 2), (1, 1)),
        m.OpNode(m.OpKind.EW_UNARY, "t", ("a",), "b", fn="tanh"),
        _pool(m, "p1", "b", "y", "avg", (2, 2), (2, 2), (0, 0))))


def _extra(m):
    return m.StackProgram(name="extra", inputs=("x", "cb"), outputs=("y",),
                          layout="nhwc", ops=(
        m.OpNode(m.OpKind.EW_BINARY, "add", ("x", "cb"), "a", fn="add"),
        m.OpNode(m.OpKind.EW_BINARY, "mul", ("cb", "a"), "b", fn="mul"),
        _pool(m, "p", "b", "y", "max", (2, 2), (2, 2), (0, 0))))


def _extra_only_op(m):
    """y = x + e * e: the op e * e reads broadcast operands only."""
    return m.StackProgram(name="extra_only", inputs=("x", "e"),
                          outputs=("y",), layout="nhwc", ops=(
        m.OpNode(m.OpKind.EW_BINARY, "t", ("e", "e"), "t", fn="mul"),
        m.OpNode(m.OpKind.EW_BINARY, "y", ("x", "t"), "y", fn="add")))


_ALL_UNARY = ("tanh", "sigmoid", "relu", "relu6", "squared_relu", "gelu",
              "gelu_exact", "silu", "exp", "abs", "square", "identity",
              "neg", "softplus")


def _all_unary(m):
    ops, v = [], "x"
    for i, fn in enumerate(_ALL_UNARY):
        ops.append(m.OpNode(m.OpKind.EW_UNARY, f"u{i}", (v,), f"u{i}", fn=fn))
        v = f"u{i}"
    ops.append(_pool(m, "p", v, "y", "max", (3, 3), (2, 2), (1, 1)))
    return m.StackProgram(name="unary", inputs=("x",), outputs=("y",),
                          ops=tuple(ops), layout="nhwc")


def _swish_twice(m):
    """A value read twice within one level: mul(x, sigmoid(x)), and
    binary ops between two slots."""
    return m.StackProgram(name="swish", inputs=("x",), outputs=("y",),
                          layout="nhwc", ops=(
        m.OpNode(m.OpKind.EW_UNARY, "s", ("x",), "s", fn="sigmoid"),
        m.OpNode(m.OpKind.EW_BINARY, "m", ("x", "s"), "a", fn="mul"),
        m.OpNode(m.OpKind.EW_BINARY, "d", ("a", "s"), "b", fn="div"),
        m.OpNode(m.OpKind.EW_BINARY, "mx", ("b", "x"), "c", fn="max"),
        _pool(m, "p", "c", "y")))


def _row_ops(m):
    return m.StackProgram(name="rowops", inputs=("x",), outputs=("y",),
                          layout="nhwc", ops=(
        m.OpNode(m.OpKind.ROW_NORM, "ln", ("x",), "a", params=("g", "b"),
                 attrs={"norm": "layer", "eps": 1e-5}),
        _pool(m, "p", "a", "c", "max", (2, 2), (2, 2), (0, 0)),
        m.OpNode(m.OpKind.ROW_NORM, "rms", ("c",), "d", params=("g",),
                 attrs={"norm": "rms", "eps": 1e-6}),
        m.OpNode(m.OpKind.ROW_SOFTMAX, "sm", ("d",), "y")))


NHWC_CASES = {
    # name: (make, x shape, tile, extras shapes)
    "block3": (_block_chain, (2, 13, 11, 8), 4, {}),
    "block2_wide_c": (lambda m: _block_chain(m, 2), (1, 10, 9, 48), 8, {}),
    "avg_pad": (_avg_pad, (1, 5, 5, 8), 4, {}),
    "strided": (_strided, (2, 17, 13, 4), 2, {}),
    "extra": (_extra, (1, 9, 10, 8), 2, {"cb": (1, 1, 1, 8)}),
    "extra_only_op": (_extra_only_op, (2, 8, 8, 4), 4, {"e": (1, 1, 1, 4)}),
    "all_unary": (_all_unary, (1, 9, 7, 4), 4, {}),
    "swish": (_swish_twice, (2, 7, 6, 3), 4, {}),
    "row_ops": (_row_ops, (1, 8, 10, 16), 2, {}),
}


def _nhwc_inputs(name):
    make, shape, tile, extra_shapes = NHWC_CASES[name]
    rng = np.random.default_rng(sorted(NHWC_CASES).index(name))
    x = _randn(rng, shape, 2.0)
    jprog = make(jir)
    c = shape[-1]
    params = {p: _randn(rng, (c,), 0.3) + (1.0 if p[0] in "sg" else 0.0)
              for p in jprog.param_names}
    extras = {k: _randn(rng, s) for k, s in extra_shapes.items()}
    return make, x, params, extras, tile


def _jax_kernel(make, x, params, extras, tile):
    return np.asarray(jnhwc.fused_nhwc_call(
        make(jir), jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()},
        extras={k: jnp.asarray(v) for k, v in extras.items()},
        tile_out_h=tile, tile_out_w=tile, interpret=True))


# -- the CUDA kernel, transliterated ----------------------------------------

def _names(ids):
    return {i: name for name, i in ids.items()}


def _vec_fn(d, vecs, C):
    """``vec()`` of the .cu file: a vector operand at channels ``cg``."""
    def vec(idx, cg):
        if d.vec_stride[idx] == 0:
            return vecs[idx][0].expand(cg.shape)
        return torch.where(cg < C, vecs[idx][cg.clamp(max=C - 1)], 0.0)
    return vec


def _tile_forward(d, vec, xt, n, ti, tj, c0):
    """``load_patch`` + ``run_chain`` of ``csrc/fused_nhwc.cuh`` for one
    work item: the shared-memory slots after the recompute."""
    _, H, W, C = xt.shape
    cb = d.cb
    unary_name = _names(tnhwc.UNARY_IDS)
    binary_name = _names(tnhwc.BINARY_IDS)
    smem = torch.zeros(d.n_slots, d.slot_elems)

    def operand(src, idx, e, cg):
        return smem[idx, e] if src == tnhwc.SRC_SLOT else vec(idx, cg)

    L = d.levels[0]
    gh = ti * d.th * L.mul_h - L.off_h
    gw = tj * d.tw * L.mul_w - L.off_w
    e = torch.arange(L.eh * L.ew * cb)
    c, p = e % cb, e // cb
    h, w, cg = gh + p // L.ew, gw + p % L.ew, c0 + c
    ok = (h >= 0) & (h < H) & (w >= 0) & (w < W) & (cg < C)
    smem[d.in_slot, e] = torch.where(ok, xt[
        n, h.clamp(0, H - 1), w.clamp(0, W - 1), cg.clamp(max=C - 1)], 0.0)
    level, k = 0, 0
    while k < d.n_ops:
        op = d.ops[k]
        L = d.levels[level]
        if op.kind == tnhwc.K_POOL:
            Lo = d.levels[level + 1]
            gh = ti * d.th * L.mul_h - L.off_h
            gw = tj * d.tw * L.mul_w - L.off_w
            e = torch.arange(Lo.eh * Lo.ew * cb)
            c, p = e % cb, e // cb
            oi, oj = p // Lo.ew, p % Lo.ew
            neutral = -np.finfo(np.float32).max if op.fn == 0 else 0.0
            acc = None
            for di in range(op.kh):
                for dj in range(op.kw):
                    hi, wj = oi * op.sh + di, oj * op.sw + dj
                    ok = ((gh + hi >= 0) & (gh + hi < L.ih)
                          & (gw + wj >= 0) & (gw + wj < L.iw))
                    v = torch.where(
                        ok, smem[op.a_idx, (hi * L.ew + wj) * cb + c],
                        neutral)
                    acc = v if acc is None else (
                        torch.maximum(acc, v) if op.fn == 0 else acc + v)
            if op.fn == 1:
                acc = acc / float(op.kh * op.kw)
            smem[op.out, e] = acc
            level += 1
            k += 1
        elif op.kind in (tnhwc.K_NORM, tnhwc.K_SOFTMAX):
            n_pos = L.eh * L.ew
            xv = smem[op.a_idx, :n_pos * cb].view(n_pos, cb)
            if op.kind == tnhwc.K_SOFTMAX:
                y = torch.softmax(xv, dim=-1)
            else:
                mu = xv.mean(-1, keepdim=True) if op.norm == 1 else 0.0
                var = torch.square(xv - mu).mean(-1, keepdim=True)
                y = (xv - mu) * torch.rsqrt(var + op.eps)
                cc = torch.arange(cb)
                if op.b_idx >= 0:
                    y = y * vec(op.b_idx, cc)
                if op.c_idx >= 0:
                    y = y + vec(op.c_idx, cc)
            smem[op.out, :n_pos * cb] = y.reshape(-1)
            k += 1
        else:
            last = k
            while last < d.n_ops and d.ops[last].kind <= tnhwc.K_AFFINE:
                last += 1
            e = torch.arange(L.eh * L.ew * cb)
            cg = c0 + e % cb
            for q in range(k, last):
                o = d.ops[q]
                a = operand(o.a_src, o.a_idx, e, cg)
                if o.kind == tnhwc.K_UNARY:
                    r = tir.UNARY_FNS[unary_name[o.fn]](a)
                elif o.kind == tnhwc.K_BINARY:
                    r = tir.BINARY_FNS[binary_name[o.fn]](
                        a, operand(o.b_src, o.b_idx, e, cg))
                else:
                    r = a * vec(o.b_idx, cg) + vec(o.c_idx, cg)
                smem[o.out, e] = r
            k = last
    return smem


def _run_descriptor(program, x, params, extras, tile):
    """``csrc/fused_nhwc.cu`` in Python, element for element, over the
    descriptor :func:`repro_torch.kernels.fused_stack.nhwc.fused_nhwc`
    would pass: load, element-wise runs, pools, row passes, guarded store."""
    xt = torch.from_numpy(x)
    names = list(program.inputs[1:]) + list(program.param_names)
    vals = {**extras, **params}
    vecs = [torch.from_numpy(vals[n]).reshape(-1) for n in names]
    strides = tuple(int(v.numel() != 1) for v in vecs)
    _, blob = tnhwc._template(program, x.shape,
                              tuple(sorted((k, v.shape)
                                           for k, v in extras.items())),
                              strides, tile, tile)
    d = tnhwc.NhwcDesc.from_buffer_copy(blob)
    N, H, W, C = x.shape
    cb = d.cb
    out = torch.full((N, d.OH, d.OW, C), float("nan"))
    vec = _vec_fn(d, vecs, C)
    for n in range(N):
        for ti in range(d.tiles_h):
            for tj in range(d.tiles_w):
                for cblk in range(d.n_cb):
                    c0 = cblk * cb
                    smem = _tile_forward(d, vec, xt, n, ti, tj, c0)
                    e = torch.arange(d.th * d.tw * cb)
                    c, p = e % cb, e // cb
                    oh, ow = ti * d.th + p // d.tw, tj * d.tw + p % d.tw
                    cg = c0 + c
                    ok = (oh < d.OH) & (ow < d.OW) & (cg < C)
                    out[n, oh[ok], ow[ok], cg[ok]] = smem[d.out_slot, e[ok]]
    return out.numpy()


@pytest.mark.parametrize("name", sorted(NHWC_CASES))
def test_nhwc_kernel_paths_match_jax_kernel(name):
    """Plain version and the descriptor transliteration of the CUDA kernel,
    each against the Pallas kernel in interpret mode."""
    make, x, params, extras, tile = _nhwc_inputs(name)
    want = _jax_kernel(make, x, params, extras, tile)
    tprog = make(tir)
    plain = tnhwc.fused_nhwc(
        tprog, torch.from_numpy(x),
        {k: torch.from_numpy(v) for k, v in params.items()},
        extras={k: torch.from_numpy(v) for k, v in extras.items()},
        tile_out_h=tile, tile_out_w=tile)
    np.testing.assert_allclose(plain.numpy(), want, rtol=TOL, atol=TOL)
    kernel = _run_descriptor(tprog, x, params, extras, tile)
    np.testing.assert_allclose(kernel, want, rtol=TOL, atol=TOL)


def test_nhwc_channel_blocking_splits_wide_chains():
    make, x, params, extras, tile = _nhwc_inputs("block2_wide_c")
    _, blob = tnhwc._template(make(tir), x.shape, (), (1,) * 4, tile, tile)
    d = tnhwc.NhwcDesc.from_buffer_copy(blob)
    assert d.cb == 32 and d.n_cb == 2         # 48 channels: 32 + a tail
    assert d.n_slots * d.slot_elems * 4 <= tnhwc.SMEM_TARGET
    _, blob = tnhwc._template(_row_ops(tir), (1, 8, 10, 16), (), (1, 1), 2, 2)
    assert tnhwc.NhwcDesc.from_buffer_copy(blob).cb == 16   # rows need all C


def test_nhwc_masks_garbage_halo_to_neutral():
    """An affine of the zero-filled halo divides by zero (inf / NaN); the
    pool's select must keep it out of the result."""
    def make(m):
        return m.StackProgram(name="g", inputs=("x",), outputs=("y",),
                              layout="nhwc", ops=(
            m.OpNode(m.OpKind.EW_BINARY, "d", ("x",), "a", fn="div",
                     params=("z",)),
            m.OpNode(m.OpKind.EW_UNARY, "l", ("a",), "b", fn="exp"),
            _pool(m, "p", "b", "y", "max", (3, 3), (1, 1), (1, 1))))

    rng = np.random.default_rng(7)
    x = np.abs(_randn(rng, (1, 6, 5, 4))) + 1.0
    params = {"z": np.array([1.0, 2.0, 4.0, 8.0], np.float32)}
    want = _jax_kernel(make, x, params, {}, 4)
    got = _run_descriptor(make(tir), x, params, {}, 4)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["block3", "strided", "extra", "row_ops"])
@pytest.mark.parametrize("tile", [1, 3, 8])
def test_nhwc_geometry_matches_jax(name, tile):
    make, shape, _, extra_shapes = NHWC_CASES[name]
    xj = jnp.zeros(shape, jnp.float32)
    ej = {k: jnp.zeros(s) for k, s in extra_shapes.items()}
    levels, grid, _, left, out_hw, pad, thw = jnhwc.plan_geometry(
        make(jir), xj, ej, tile, tile)
    geo = tnhwc.plan_geometry(make(tir), shape, extra_shapes, tile, tile)
    assert [tuple(vars(lv).values()) for lv in levels] == [
        tuple(vars(lv).values()) for lv in geo.levels]
    assert (grid, out_hw, pad, thw) == (geo.grid, geo.out_hw, geo.grid_pad,
                                        geo.tile)
    assert left == (geo.levels[0].off_h, geo.levels[0].off_w)
    jl = jnhwc._plan_levels(make(jir).ops, 2, 3, [(9, 9)] * (len(
        make(jir).ops) + 1))
    tl_ = tnhwc._plan_levels(make(tir).ops, 2, 3, [(9, 9)] * (len(
        make(tir).ops) + 1))
    assert [vars(a) for a in jl] == [vars(b) for b in tl_]


def test_tile_valid_matches_jax():
    lv = tnhwc._Level(5, 6, 4, 4, 1, 1, 1, 1)
    jlv = jnhwc._Level(5, 6, 4, 4, 1, 1, 1, 1)
    for origin in ((-1, -1), (0, 2), (2, -3)):
        np.testing.assert_array_equal(
            tnhwc.tile_valid((5, 6), origin, lv).numpy(),
            np.asarray(jnhwc.tile_valid((5, 6), origin, jlv)))
    assert tnhwc.pool_neutral(torch.float32, "max") == float(
        np.finfo(np.float32).min)


def test_descriptor_limits_raise_named_errors():
    long = tir.StackProgram(name="long", inputs=("x",), outputs=("v32",),
                            layout="nhwc", ops=tuple(
        tir.OpNode(tir.OpKind.EW_UNARY, f"u{i}",
                   ("x" if i == 0 else f"v{i}",), f"v{i + 1}", fn="relu")
        for i in range(32)))
    tnhwc.compile_chain(long)                         # exactly MAX_OPS
    longer = tir.StackProgram(name="longer", inputs=("x",), outputs=("v33",),
                              layout="nhwc", ops=long.ops + (tir.OpNode(
                                  tir.OpKind.EW_UNARY, "u32", ("v32",),
                                  "v33", fn="relu"),))
    with pytest.raises(tnhwc.DescriptorError, match="MAX_OPS"):
        tnhwc.compile_chain(longer)
    cross = tir.StackProgram(name="cross", inputs=("x",), outputs=("y",),
                             layout="nhwc", ops=(
        _pool(tir, "p", "x", "a"),
        tir.OpNode(tir.OpKind.EW_BINARY, "add", ("a", "x"), "y", fn="add")))
    with pytest.raises(tnhwc.DescriptorError, match="level"):
        tnhwc.compile_chain(cross)


def test_descriptor_reuses_slots():
    chain = tnhwc.compile_chain(_block_chain(tir, 6))
    assert chain.n_slots == 2 and chain.n_pools == 6 and not chain.rowred
    assert tnhwc.compile_chain(_swish_twice(tir)).n_slots == 3


# -- the fused path (AFFINE -> UNARY -> POOL2D, window == stride) ---------

def _vgg_stage(m, fn="relu", pool="max", pad=0, window=2):
    """VGG-16's stage chain: batch norm (affine), ReLU, 2x2/s2 max pool (or
    another activation, pool, padding and window)."""
    return m.StackProgram(name="vggstage", inputs=("x",), outputs=("y",),
                          layout="nhwc", ops=(
        m.OpNode(m.OpKind.AFFINE, "bn", ("x",), "b", params=("s", "o")),
        m.OpNode(m.OpKind.EW_UNARY, "r", ("b",), "r", fn=fn),
        m.OpNode(m.OpKind.POOL2D, "p", ("r",), "y", fn=pool,
                 attrs={"window": (window, window),
                        "stride": (window, window),
                        "padding": (pad, pad)})))


FUSED_CASES = {
    # name: (make, x shape); every one is a fused chain
    "vgg_stage": (_vgg_stage, (2, 16, 16, 64)),
    # two channel blocks, the second ragged; an odd row no window reads
    "vgg_stage_odd_two_blocks": (_vgg_stage, (2, 9, 14, 72)),
    # odd extents whose windows reach past the edge (padded borders)
    "vgg_stage_padded_odd": (lambda m: _vgg_stage(m, pad=1), (1, 11, 13, 8)),
    # six channels: one float4 quad and a tail
    "vgg_stage_c6": (_vgg_stage, (2, 10, 10, 6)),
    "avg_tanh_padded": (lambda m: _vgg_stage(m, "tanh", "avg", 1),
                        (2, 9, 10, 6)),
    "silu_max_1x1": (lambda m: _vgg_stage(m, "silu", window=1), (1, 5, 7, 8)),
}
#: cases whose plain version is exact (relu and max): the walk equals it bit
#: for bit, as the kernel must on the card
EXACT_FUSED = ("vgg_stage", "vgg_stage_odd_two_blocks",
               "vgg_stage_padded_odd", "vgg_stage_c6")


def _fused_inputs(name):
    make, shape = FUSED_CASES[name]
    rng = np.random.default_rng(40 + sorted(FUSED_CASES).index(name))
    x = _randn(rng, shape, 2.0)
    c = shape[-1]
    params = {"s": _randn(rng, (c,), 0.3) + 1.0, "o": _randn(rng, (c,), 0.3)}
    return make, x, params


def _fused_cta_items(d, spatial, programs):
    """CTA ``p``'s channel block and items (n, ti, tj), in the kernel's
    order: block ``p % n_cb``, items ``p // n_cb``, then every
    ``programs // n_cb``-th."""
    for p in range(programs):
        for s in range(p // d.n_cb, spatial, programs // d.n_cb):
            yield p % d.n_cb, (s // (d.tiles_w * d.tiles_h),
                               (s // d.tiles_w) % d.tiles_h, s % d.tiles_w)


def _run_fused_forward(program, x, params, card=(3, 2), writes=None):
    """``fused_nhwc_kernel_fused`` of ``csrc/fused_nhwc.cu`` in torch over
    the descriptor and the plan ``nhwc.fused_nhwc`` passes, on a card of
    ``card`` = (SMs, CTAs an SM): ``launch_programs`` persistent CTAs, each
    keeping one channel block and walking its items; per item every thread
    (position lane, channel quad) takes output positions lane, lane +
    lanes, ... of the 8 x 8 tile that lie in the output; per position its
    window's x (0 past C), the affine rounded after the multiply, the unary
    op, the pool's neutral element at window positions outside the image,
    the max in window order (or the sum divided by the window).  ``writes``
    (an int tensor shaped as the output) counts the stores."""
    xt = torch.from_numpy(x)
    N, H, W, C = x.shape
    vecs = [torch.from_numpy(params[n]).reshape(-1)
            for n in program.param_names]
    _, blob = tnhwc._template(program, x.shape, (), (1,) * len(vecs), 8, 8)
    d = tnhwc.NhwcDesc.from_buffer_copy(blob)
    plan = tnhwc.fused_plan(program, x.shape)
    assert (d.th, d.tw, d.cb, d.n_slots) == (*plan.tile, plan.cb, 0)
    spatial = N * d.tiles_h * d.tiles_w
    assert spatial == plan.spatial
    programs = tnhwc.launch_programs(spatial, d.n_cb, *card)
    vec = _vec_fn(d, vecs, C)
    aff, un, pool = d.ops[0], d.ops[1], d.ops[2]
    fn = {i: k for k, i in tnhwc.UNARY_IDS.items()}[un.fn]
    is_max = pool.fn == tnhwc.POOL_IDS["max"]
    neutral = -np.finfo(np.float32).max if is_max else 0.0
    L0, L1 = d.levels[0], d.levels[1]
    nq = d.cb // 4
    lanes = tnhwc.THREADS // nq
    assert lanes == plan.lanes
    out = torch.full((N, d.OH, d.OW, C), float("nan"))
    for cblk, (n, ti, tj) in _fused_cta_items(d, spatial, programs):
        gh = ti * d.th * L0.mul_h - L0.off_h
        gw = tj * d.tw * L0.mul_w - L0.off_w
        # the lanes' positions, then the quads' channels
        p = torch.tensor([q for lane in range(lanes)
                          for q in range(lane, L1.eh * L1.ew, lanes)])
        r, c = p // L1.ew, p % L1.ew
        oh, ow = ti * d.th + r, tj * d.tw + c
        keep = (oh < d.OH) & (ow < d.OW)
        r, c, oh, ow = r[keep], c[keep], oh[keep], ow[keep]
        cg = cblk * d.cb + torch.arange(nq * 4)
        live = cg < C
        s, t = vec(aff.b_idx, cg)[None], vec(aff.c_idx, cg)[None]
        y = None
        for k in range(pool.kh * pool.kw):
            h = gh + r * pool.sh + k // pool.kw
            w = gw + c * pool.sw + k % pool.kw
            ok = ((h >= 0) & (h < H) & (w >= 0) & (w < W))[:, None]
            xk = torch.where(ok & live[None], xt[n, h.clamp(0, H - 1),
                                                w.clamp(0, W - 1)][
                :, cg.clamp(max=C - 1)], 0.0)
            v = torch.where(ok, tir.UNARY_FNS[fn](xk * s + t), neutral)
            y = v if y is None else (torch.maximum(y, v) if is_max
                                     else y + v)
        if not is_max:
            y = y / float(pool.kh * pool.kw)
        rows = oh[:, None].expand(-1, int(live.sum()))
        cols = ow[:, None].expand(-1, int(live.sum()))
        out[n, rows, cols, cg[live][None].expand(len(oh), -1)] = y[:, live]
        if writes is not None:
            writes[n, rows, cols, cg[live][None].expand(len(oh), -1)] += 1
    return out.numpy()


@pytest.mark.parametrize("name", sorted(FUSED_CASES))
def test_nhwc_fused_walk_matches_plain_and_jax(name):
    """The fused path's walk: bit for bit with the plain version where that
    is exact (relu, max), and within ``TOL`` of the Pallas kernel."""
    make, x, params = _fused_inputs(name)
    tprog = make(tir)
    assert tnhwc.fused_chain(tprog)
    got = _run_fused_forward(tprog, x, params)
    plain = tnhwc.fused_nhwc(tprog, torch.from_numpy(x),
                             {k: torch.from_numpy(v)
                              for k, v in params.items()}).numpy()
    if name in EXACT_FUSED:
        np.testing.assert_array_equal(got, plain)
    else:
        np.testing.assert_allclose(got, plain, rtol=TOL, atol=TOL)
    want = _jax_kernel(make, x, params, {}, 4)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _vgg_fused_cases():
    """(name, program, input shape) of VGG-16's five stacks at batch 2,
    stage 1's chain at odd extents and at 200 and 6 channels."""
    from repro_torch.core import analyzer, collapse, resource
    from repro_torch.models import cnn
    g, _ = cnn.vgg_net((64, 128, 256, 512, 512), device="cpu")
    x_shape, out = (2, 224, 224, 3), []
    for seg in analyzer.analyze(g, keep=frozenset({g.output})):
        if not seg.is_stack:
            if seg.op.kind == tir.OpKind.CONV2D:
                x_shape = x_shape[:3] + (seg.op.attrs["kernel_shape"][-1],)
            continue
        plan = collapse.collapse(seg.stack, {seg.stack.inputs[0]: x_shape},
                                 resource.H100)
        for i in range(len(plan.sequences)):
            out.append((f"vgg16_{len(out)}", plan.subprogram(i), x_shape))
        x_shape = tir.infer_shapes(seg.stack, {seg.stack.inputs[0]: x_shape})[
            seg.stack.outputs[0]]
    _, prog, shape = out[0]
    out += [("vgg16_0_odd", prog, (1, 33, 47, 64)),
            ("vgg16_0_c200", prog, shape[:3] + (200,)),
            ("vgg16_0_c6", prog, shape[:3] + (6,))]
    return out


_VGG_FUSED = {name: case for name, *case in _vgg_fused_cases()}


@pytest.mark.parametrize("name", sorted(_VGG_FUSED))
def test_nhwc_fused_launch_plan_writes_every_output_once(name):
    """Over ``launch_programs``' persistent CTAs, the items of
    ``fused_plan`` and each thread's positions and channel quad, every
    (image, output position, channel) is stored exactly once; the plan is
    the backward's fused plan."""
    from repro_torch.kernels.fused_stack import nhwc_bwd as tnhwc_bwd
    prog, shape = _VGG_FUSED[name]
    assert tnhwc.fused_chain(prog)
    plan = tnhwc.fused_plan(prog, shape)
    bwd = tnhwc_bwd.launch_plan(prog, shape, (), 8, 8)
    assert bwd.fused and (bwd.tile, bwd.cb, bwd.lanes, bwd.spatial) == (
        plan.tile, plan.cb, plan.lanes, plan.spatial)
    c = shape[-1]
    if name == "vgg16_0":
        assert (plan.tile, plan.cb, plan.lanes, plan.n_cb) == ((8, 8), 64,
                                                               16, 1)
    # the kernel's walk on zeros (values do not matter here), one image
    x = np.zeros((1,) + tuple(shape[1:]), np.float32)
    scale, offset = prog.ops[0].params
    params = {scale: np.ones(c, np.float32), offset: np.zeros(c, np.float32)}
    oh, ow = tir.infer_shapes(prog, {prog.inputs[0]: x.shape})[
        prog.outputs[0]][1:3]
    for card in ((132, 8), (3, 2)):
        writes = torch.zeros((1, oh, ow, c), dtype=torch.int32)
        _run_fused_forward(prog, x, params, card, writes)
        assert bool((writes == 1).all())


def test_fused_chain_takes_vgg_and_leaves_block_net():
    """VGG-16's five stacks (batch norm, ReLU, 2x2/s2 max pool) take the
    fused path forward and backward; block_net's overlapping pools keep
    the generic kernels."""
    from repro_torch.core import analyzer, collapse, resource
    from repro_torch.models import cnn
    vgg = [prog for name, prog, _ in _vgg_fused_cases()
           if name.count("_") == 1]
    assert len(vgg) == 5 and all(tnhwc.fused_chain(p) for p in vgg)
    g, _ = cnn.block_net(8, channels=32, device="cpu")
    seg, = analyzer.analyze(g, keep=frozenset({g.output}))
    plan = collapse.collapse(seg.stack, {"x": (8, 56, 56, 32)},
                             resource.H100)
    block = [plan.subprogram(i) for i in range(len(plan.sequences))]
    assert block and not any(tnhwc.fused_chain(p) for p in block)
    assert not tnhwc.fused_chain(_block_chain(tir, 1))
    assert not tnhwc.fused_chain(_vgg_stage(tir, window=3))   # 9 > FUSED_WIN
    header = (tnhwc.SOURCE.parent / "fused_nhwc.cuh").read_text()
    assert f"constexpr int FUSED_WIN = {tnhwc.FUSED_WIN};" in header


# ---------------------------------------------------------------------------
# rows
# ---------------------------------------------------------------------------

def _rows_all_fns(m):
    ops, v = [], "x"
    for i, fn in enumerate(_ALL_UNARY):
        ops.append(m.OpNode(m.OpKind.EW_UNARY, f"u{i}", (v,), f"u{i}", fn=fn))
        v = f"u{i}"
    for i, fn in enumerate(("add", "sub", "mul", "div", "max", "min")):
        ops.append(m.OpNode(m.OpKind.EW_BINARY, f"b{i}", (v, "z"), f"b{i}",
                            fn=fn))
        v = f"b{i}"
    ops.append(m.OpNode(m.OpKind.EW_BINARY, "bp", (v,), "bp", fn="mul",
                        params=("k",)))
    ops.append(m.OpNode(m.OpKind.AFFINE, "aff", ("bp",), "y",
                        params=("s", "o")))
    return m.StackProgram(name="allfns", inputs=("x", "z"),
                          outputs=("y", "u4"), ops=tuple(ops))


def _rows_norms(m):
    return m.StackProgram(name="norms", inputs=("x",), outputs=("y", "l"),
                          ops=(
        m.OpNode(m.OpKind.ROW_NORM, "l", ("x",), "l", params=("s", "o"),
                 attrs={"norm": "layer", "eps": 1e-5}),
        m.OpNode(m.OpKind.ROW_NORM, "r", ("l",), "r",
                 attrs={"norm": "rms", "eps": 1e-6}),
        m.OpNode(m.OpKind.ROW_SOFTMAX, "sm", ("r",), "y")))


def _rows_scalar(m):
    """Width-1 operands: a (rows, 1) input and a scalar parameter."""
    return m.StackProgram(name="scalar", inputs=("x", "g"), outputs=("y",),
                          ops=(
        m.OpNode(m.OpKind.EW_BINARY, "m", ("x", "g"), "a", fn="mul"),
        m.OpNode(m.OpKind.EW_BINARY, "t", ("a",), "y", fn="add",
                 params=("t",))))


ROWS_CASES = {
    # name: (make, {input: shape}, {param: shape}, tile_rows)
    "addnorm_rms": (lambda m: (jstacks if m is jir else tstacks)
                    .addnorm_program("rms", 1e-6, False),
                    {"x": (3, 7, 40), "res": (3, 7, 40)}, {"scale": (40,)}, 8),
    "addnorm_layer_bias": (lambda m: (jstacks if m is jir else tstacks)
                           .addnorm_program("layer", 1e-5, True),
                           {"x": (13, 96), "res": (13, 96)},
                           {"scale": (96,), "bias": (96,)}, 4),
    "glu_silu": (lambda m: (jstacks if m is jir else tstacks)
                 .glu_program("silu"), {"gate": (2, 5, 72), "up": (2, 5, 72)},
                 {}, 8),
    "all_fns": (_rows_all_fns, {"x": (9, 24), "z": (9, 24)},
                {"k": (24,), "s": (24,), "o": (24,)}, 8),
    "norms_softmax": (_rows_norms, {"x": (11, 33)},
                      {"s": (33,), "o": (33,)}, 8),
    "scalar": (_rows_scalar, {"x": (6, 16), "g": (6, 1)}, {"t": ()}, 4),
}


def _rows_inputs(name):
    make, in_shapes, p_shapes, tile = ROWS_CASES[name]
    rng = np.random.default_rng(50 + sorted(ROWS_CASES).index(name))
    inputs = {k: _randn(rng, s, 1.5) for k, s in in_shapes.items()}
    if "z" in inputs:            # divisor away from zero
        inputs["z"] = np.where(np.abs(inputs["z"]) < 0.5, 1.0,
                               inputs["z"]).astype(np.float32)
    params = {k: _randn(rng, s) for k, s in p_shapes.items()}
    return make, inputs, params, tile


def _jax_rows(make, inputs, params, tile):
    out = jrows.fused_rows_call(
        make(jir), {k: jnp.asarray(v) for k, v in inputs.items()},
        {k: jnp.asarray(v) for k, v in params.items()}, tile_rows=tile,
        interpret=True)
    return {k: np.asarray(v) for k, v in out.items()}


class _Ptr:
    """A pointer of the fake Triton: an array and an offset."""

    def __init__(self, buf, off=0):
        self.buf, self.off = buf, off

    def __add__(self, off):
        return _Ptr(self.buf, self.off + off)


def _fake_triton():
    """numpy in the place of ``triton`` / ``triton.language``: enough of
    the language for the generated kernels, with Triton's semantics
    (masked loads return ``other``, masked stores are dropped, block
    broadcasting, NaN-propagating max/min on request)."""
    tl = types.ModuleType("triton.language")
    tl.constexpr = object
    tl.int64 = np.int64
    tl.float32 = np.float32
    tl.bfloat16 = ml_dtypes.bfloat16
    tl.uint32 = np.uint32

    def cast(x, dtype, bitcast=False):
        x = np.asarray(x)
        return x.view(dtype) if bitcast else x.astype(dtype)

    tl.cast = cast

    def inline_asm_elementwise(asm, constraints, args, dtype, is_pure, pack):
        # the one asm the generated kernels use: round_bf16's conversion,
        # bf16(a) in the high half, bf16(b) in the low
        assert asm == "cvt.rn.bf16x2.f32 $0, $1, $2;", asm
        hi, lo = (np.asarray(a, np.uint32).view(np.float32).astype(
            ml_dtypes.bfloat16).view(np.uint16).astype(np.uint32)
            for a in args)
        return ((hi << 16) | lo).astype(dtype)

    tl.inline_asm_elementwise = inline_asm_elementwise
    tl.zeros = lambda shape, dtype: np.zeros(shape, dtype)
    tl.PropagateNan = types.SimpleNamespace(ALL="all", NONE="none")
    state = {"pid": 0}
    tl.program_id = lambda axis: state["pid"]
    tl.arange = lambda a, b: np.arange(a, b)
    tl.range = lambda start, stop, step=1, num_stages=None: range(
        start, stop, step)

    def load(ptr, mask=None, other=0.0):
        off = np.asarray(ptr.off)
        if mask is None:
            return np.float32(ptr.buf[off])
        mask = np.broadcast_to(mask, np.broadcast_shapes(off.shape,
                                                         np.shape(mask)))
        off = np.broadcast_to(off, mask.shape)
        safe = np.where(mask, off, 0)
        return np.where(mask, ptr.buf[safe], np.float32(other)).astype(
            np.float32)

    def store(ptr, val, mask=None):
        off = np.asarray(ptr.off)
        val = np.broadcast_to(np.asarray(val, np.float32), off.shape)
        if mask is None:
            mask = True
        mask = np.broadcast_to(mask, off.shape)
        ptr.buf[off[mask]] = val[mask]

    def nanmax(a, b, propagate_nan="none"):
        return (np.maximum if propagate_nan == "all" else np.fmax)(a, b)

    def nanmin(a, b, propagate_nan="none"):
        return (np.minimum if propagate_nan == "all" else np.fmin)(a, b)

    tl.load, tl.store = load, store
    tl.maximum, tl.minimum = nanmax, nanmin
    tl.where = lambda c, a, b: np.where(c, a, b).astype(np.float32)
    tl.sum = lambda x, axis: np.sum(x, axis=axis, dtype=np.float32)
    tl.max = lambda x, axis: np.max(x, axis=axis)
    tl.exp = lambda x: np.exp(x).astype(np.float32)
    tl.abs = np.abs
    tl.sigmoid = lambda x: (1.0 / (1.0 + np.exp(-x))).astype(np.float32)

    def div_rn(a, b):
        with np.errstate(divide="ignore", invalid="ignore"):  # masked lanes
            return np.float32(a) / np.float32(b)

    tl.div_rn = div_rn
    libdevice = types.ModuleType("triton.language.extra.libdevice")
    libdevice.tanh = np.tanh
    libdevice.erf = lambda x: torch.erf(torch.from_numpy(
        np.asarray(x, np.float32))).numpy()
    libdevice.log1p = np.log1p
    libdevice.rsqrt = lambda x: (1.0 / np.sqrt(x)).astype(np.float32)
    extra = types.ModuleType("triton.language.extra")
    extra.libdevice = libdevice
    tl.extra = extra
    triton = types.ModuleType("triton")
    triton.jit = lambda fn: fn
    triton.language = tl
    modules = {"triton": triton, "triton.language": tl,
               "triton.language.extra": extra,
               "triton.language.extra.libdevice": libdevice}
    return modules, state


def _np_int64(x):
    return np.asarray(x).astype(np.int64)


_T_DTYPE = {np.dtype(np.float32): torch.float32,
            np.dtype(ml_dtypes.bfloat16): torch.bfloat16}
_NP_DTYPE = {torch.float32: np.float32, torch.bfloat16: ml_dtypes.bfloat16}


def _run_generated(program, inputs, params, tile, monkeypatch, n_prog=None):
    """Execute :func:`rows.emit_source` for ``program`` on the fake Triton,
    program id by program id, as ``rows.fused_rows`` would launch it: a
    persistent launch of ``n_prog`` programs (default: the plan's on the
    H100's 132 SMs) with ``launch_plan``'s sub-blocks for a card of
    ``n_prog / PROGRAMS_PER_SM`` SMs.  ``tile`` is the plan's row tile,
    which the launch no longer reads (as ``fused_rows``)."""
    arrays = [inputs[n] for n in program.inputs]
    lead = arrays[0].shape[:-1]
    rows = math.prod(lead)
    in_w = {n: a.shape[-1] for n, a in zip(program.inputs, arrays)}
    p_w = {p: int(np.asarray(params[p]).size) for p in program.param_names}
    feat = max(list(in_w.values()) + list(p_w.values()))
    dtypes = {k: _T_DTYPE[np.asarray(v).dtype] for k, v in
              {**inputs, **params}.items()}
    steps = trows.value_dtypes(
        program, {n: dtypes[n] for n in program.inputs},
        {p: torch.empty(np.shape(params[p]), dtype=dtypes[p])
         for p in program.param_names})
    src = trows.emit_source(program, in_w, p_w, feat, dtypes, steps)
    modules, state = _fake_triton()
    for k, v in modules.items():
        monkeypatch.setitem(sys.modules, k, v)
    # numpy arrays have no .to(); the generated code casts with it
    src = src.replace("rows.to(tl.int64)", "_np_int64(rows)")
    ns = {"_np_int64": _np_int64}
    exec(compile(src, "<generated>", "exec"), ns)
    widths = trows.value_widths(program, in_w, p_w)
    out_dt = {**dtypes, **{v: st[-1] for v, st in steps.items()}}
    outs = [np.full(rows * widths[v], np.nan, _NP_DTYPE[out_dt[v]])
            for v in program.outputs]
    if n_prog is None:
        n_prog = trows.launch_plan(rows, feat, feat, 132).n_prog
    plan = trows.launch_plan(rows, feat, feat,
                             max(1, n_prog // trows.PROGRAMS_PER_SM))
    args = ([_Ptr(a.reshape(-1)) for a in arrays]
            + [_Ptr(np.asarray(params[p]).reshape(-1))
               for p in program.param_names]
            + [_Ptr(o) for o in outs])
    for pid in range(n_prog):
        state["pid"] = pid
        ns["fused_rows_kernel"](*args, rows, plan.n_sub, n_prog, F=feat,
                                R_SUB=plan.r_sub, BLOCK_F=plan.block_f,
                                LOOP_STAGES=plan.loop_stages)
    return {v: o.reshape(*lead, widths[v])
            for v, o in zip(program.outputs, outs)}


@pytest.mark.parametrize("name", sorted(ROWS_CASES))
def test_rows_paths_match_jax_kernel(name, monkeypatch):
    """Plain version and the generated Triton source (on the fake Triton),
    each against the Pallas kernel in interpret mode."""
    make, inputs, params, tile = _rows_inputs(name)
    want = _jax_rows(make, inputs, params, tile)
    tprog = make(tir)
    plain = trows.fused_rows(
        tprog, {k: torch.from_numpy(v) for k, v in inputs.items()},
        {k: torch.from_numpy(v) for k, v in params.items()}, tile_rows=tile)
    gen = _run_generated(tprog, inputs, params, tile, monkeypatch)
    # the numpy stand-in sums rows in another order than XLA: 1e-4
    # relative on the norms and softmax, as chip_smoke.py holds the kernel
    tol = 1e-4 if "norm" in name or "softmax" in name else TOL
    for k in want:
        np.testing.assert_allclose(plain[k].numpy(), want[k], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(gen[k], want[k], rtol=tol, atol=TOL)


BF16_ROWS_CASES = {
    # name: (make, {input: shape}, {param: shape}, tile_rows); inputs and
    # parameters in bfloat16, as a bf16 LM hands them to the rows kernel
    "norm_layer_bias": (lambda m: (jstacks if m is jir else tstacks)
                        .norm_program("layer", 1e-5, True), {"x": (3, 7, 40)},
                        {"scale": (40,), "bias": (40,)}, 8),
    "addnorm_rms": ROWS_CASES["addnorm_rms"],
    "glu_gelu": (lambda m: (jstacks if m is jir else tstacks)
                 .glu_program("gelu"), {"gate": (2, 5, 72), "up": (2, 5, 72)},
                 {}, 8),
}
#: bfloat16 against the JAX kernel: the two may round one output a bf16
#: step (2^-8 relative) apart where float32 sums differ in their last bits
BF16_TOL = 1e-2


@pytest.mark.parametrize("name", sorted(BF16_ROWS_CASES))
def test_rows_bf16_matches_jax_kernel(name, monkeypatch):
    """bfloat16 chains: the plain version and the generated source (on the
    fake Triton, rounding where the interpreter does) against the Pallas
    kernel in interpret mode, each output in bfloat16."""
    make, in_shapes, p_shapes, tile = BF16_ROWS_CASES[name]
    rng = np.random.default_rng(90 + sorted(BF16_ROWS_CASES).index(name))
    bf = ml_dtypes.bfloat16
    inputs = {k: _randn(rng, s, 1.5).astype(bf) for k, s in in_shapes.items()}
    params = {k: (1.0 + 0.3 * _randn(rng, s)).astype(bf)
              for k, s in p_shapes.items()}
    want = _jax_rows(make, inputs, params, tile)
    tprog = make(tir)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)

    plain = trows.fused_rows(tprog, {k: t(v) for k, v in inputs.items()},
                             {k: t(v) for k, v in params.items()},
                             tile_rows=tile)
    gen = _run_generated(tprog, inputs, params, tile, monkeypatch)
    for k in want:
        assert want[k].dtype == bf and gen[k].dtype == bf
        assert plain[k].dtype == torch.bfloat16
        w = want[k].astype(np.float32)
        np.testing.assert_allclose(plain[k].float().numpy(), w,
                                   rtol=BF16_TOL, atol=BF16_TOL)
        np.testing.assert_allclose(gen[k].astype(np.float32), w,
                                   rtol=BF16_TOL, atol=BF16_TOL)
        np.testing.assert_allclose(gen[k].astype(np.float32),
                                   plain[k].float().numpy(),
                                   rtol=BF16_TOL, atol=BF16_TOL)


def test_rows_value_dtypes_follow_the_interpreter():
    """Output dtypes and rounding steps of mixed chains are PyTorch's
    promotion, as the interpreter computes them: a float32 parameter lifts
    a bf16 value to float32, a 0-dim one does not."""
    bf, f32 = torch.bfloat16, torch.float32
    prog = tstacks.norm_program("layer", 1e-5, True)
    steps = trows.value_dtypes(prog, {"x": bf}, {
        "scale": torch.ones(4, dtype=f32), "bias": torch.ones(4, dtype=bf)})
    assert steps == {"y": (bf, f32, f32)}
    out = tir.run_program(prog, {"x": torch.ones(2, 4, dtype=bf)}, {
        "scale": torch.ones(4), "bias": torch.ones(4, dtype=bf)})
    assert out["y"].dtype == f32
    scalar = _rows_scalar(tir)
    steps = trows.value_dtypes(scalar, {"x": bf, "g": bf},
                               {"t": torch.ones((), dtype=f32)})
    assert steps == {"a": (bf,), "y": (bf,)}
    src = trows.emit_source(scalar, {"x": 16, "g": 1}, {"t": 1}, 16,
                            {"x": bf, "g": bf, "t": f32}, steps)
    assert src.count("= round_bf16(") == 2
    assert "tl.store(out0 + r64 * F + cols, tl.cast(v3, tl.bfloat16)" in src


@pytest.mark.parametrize("name", sorted(ROWS_CASES))
def test_rows_emitter_source(name):
    """The generated source parses, defines the kernel, and carries one
    statement block per op naming it."""
    make, inputs, params, _ = _rows_inputs(name)
    prog = make(tir)
    in_w = {k: v.shape[-1] for k, v in inputs.items()}
    p_w = {k: int(np.asarray(v).size) for k, v in params.items()}
    src = trows.emit_source(prog, in_w, p_w, max(in_w.values()))
    tree = ast.parse(src)
    fn, = [n for n in tree.body if isinstance(n, ast.FunctionDef)]
    assert fn.name == "fused_rows_kernel"
    for op in prog.ops:
        assert f"# {op.name}: {op.kind.value}" in src
    assert src.count("tl.store(") == len(prog.outputs)
    assert src.count("tl.load(in") == len(prog.inputs)


def test_rows_emitter_masks_lanes_for_reductions():
    src = trows.emit_source(_rows_norms(tir), {"x": 33}, {"s": 33, "o": 33},
                            33)
    assert "tl.where(cmask, v0, 0.0)" in src                    # sum over F
    assert "tl.where(cmask, v0 - v1_m, 0.0)" in src             # re-zeroed
    assert "-float('inf')" in src                               # softmax max
    assert "/ 33.0" in src                                      # real F


@pytest.mark.parametrize("features,tile,want", [
    (4096, 4, (4096, 2, 8)), (11008, 1, (16384, 1, 16)),
    (64, 256, (64, 128, 8)), (40, 8, (64, 8, 4))])
def test_rows_launch_config(features, tile, want):
    assert trows.launch_config(features, tile) == want


@pytest.mark.parametrize("sm", [132, 114, 7])
@pytest.mark.parametrize("n_rows,features", [
    (2048, 5120), (4096, 5120), (4, 5120), (8192, 4096), (8192, 11008),
    (4097, 96), (21, 24), (1, 4096), (0, 64)])
def test_rows_launch_plan_covers_every_row_once(n_rows, features, sm):
    """The forward's ``launch_plan``: ``PROGRAMS_PER_SM`` programs an SM
    where the rows allow it (mamba2's gated norm at (2048, 5120): 1056 on
    132 SMs, not the 8 of 256-row tiles), one a sub-block where they do
    not; whole rows in a sub-block of at most ``SUB_ELEMS``; the strided
    walk covers every row exactly once, ragged tails included."""
    plan = trows.launch_plan(n_rows, features, features, sm)
    if n_rows >= trows.PROGRAMS_PER_SM * sm:
        assert plan.n_prog == trows.PROGRAMS_PER_SM * sm
    assert plan.n_prog == max(1, min(plan.n_sub,
                                     trows.PROGRAMS_PER_SM * sm))
    assert plan.block_f >= features and plan.n_sub * plan.r_sub >= n_rows
    assert plan.r_sub == 1 or plan.r_sub * plan.block_f <= trows.SUB_ELEMS
    seen = np.zeros(n_rows, np.int64)
    for pid in range(plan.n_prog):
        for sb in range(pid, plan.n_sub, plan.n_prog):
            r = sb * plan.r_sub + np.arange(plan.r_sub)
            np.add.at(seen, r[r < n_rows], 1)
    assert (seen == 1).all()


def test_rows_launch_plan_pipelines_where_two_sub_blocks_fit():
    """The forward's loop runs two stages deep where two sub-blocks of its
    loads fit ``PIPELINE_BYTES``: mamba2's gated norm (y and z in bf16),
    rms over 4096 in float32; not a float32 row of 16384 with two
    inputs."""
    assert trows.launch_plan(2048, 5120, 5120, 132, 4).loop_stages == 2
    assert trows.launch_plan(8192, 4096, 4096, 132, 4).loop_stages == 2
    assert trows.launch_plan(8192, 16384, 16384, 132, 8).loop_stages == 1
    assert trows.launch_plan(2048, 5120, 5120, 132, 4).n_prog == 1056
    assert trows.launch_plan(4, 5120, 5120, 132, 4).n_prog == 4


@pytest.mark.parametrize("name", ["addnorm_layer_bias", "norms_softmax",
                                  "glu_silu", "scalar"])
def test_rows_program_counts_match_jax_kernel(name, monkeypatch):
    """The generated forward at 1, 3 and 5 programs of the persistent
    launch against the Pallas kernel in interpret mode, and one count twice
    bit for bit."""
    make, inputs, params, tile = _rows_inputs(name)
    want = _jax_rows(make, inputs, params, tile)
    tprog = make(tir)
    tol = 1e-4 if "norm" in name or "softmax" in name else TOL
    for n_prog in (1, 3, 5):
        a = _run_generated(tprog, inputs, params, tile, monkeypatch, n_prog)
        b = _run_generated(tprog, inputs, params, tile, monkeypatch, n_prog)
        for k in want:
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_allclose(a[k], want[k], rtol=tol, atol=TOL)


def test_dispatch_on_cpu_records_reference():
    prog = tstacks.glu_program("silu")
    g = torch.randn(4, 8, generator=torch.Generator().manual_seed(0))
    before = tops.STATS.snapshot()
    out = tops.fused_stack_apply(prog, {"gate": g, "up": g}, {},
                                 mode="brainslug")
    delta = tops.STATS.delta(before)
    assert delta["fwd_reference"] == 1 and delta["fwd_generated"] == 0
    torch.testing.assert_close(out["y"], torch.nn.functional.silu(g) * g)
    assert tops.is_broadcast_operand(torch.zeros(1, 1, 1, 4))
    assert not tops.is_broadcast_operand(torch.zeros(1, 2, 1, 4))
    assert not tops.is_broadcast_operand(torch.zeros(()))


@pytest.mark.parametrize("graph,shape", [
    ("block_net8", (8, 56, 56, 32)),
    ("vgg16", (2, 224, 224, 3)),
])
def test_descriptor_builds_for_main_path_stacks(graph, shape):
    """Every stack the main paths hand the kernel fits its descriptor."""
    from repro_torch.core import analyzer, collapse, resource
    from repro_torch.models import cnn
    g, _ = (cnn.block_net(8, channels=32, device="cpu") if graph == "block_net8"
            else cnn.vgg_net((64, 128, 256, 512, 512), device="cpu"))
    x_shape = shape
    for seg in analyzer.analyze(g, keep=frozenset({g.output})):
        if not seg.is_stack:
            if seg.op.kind == tir.OpKind.CONV2D:
                x_shape = x_shape[:3] + (seg.op.attrs["kernel_shape"][-1],)
            continue
        plan = collapse.collapse(seg.stack, {seg.stack.inputs[0]: x_shape},
                                 resource.H100)
        for i, seq in enumerate(plan.sequences):
            sub = plan.subprogram(i)
            _, blob = tnhwc._template(sub, x_shape, (), (1,) * len(
                sub.param_names), seq.tile_out_h, seq.tile_out_w)
            d = tnhwc.NhwcDesc.from_buffer_copy(blob)
            assert d.n_levels == 1 + sum(op.kind == tir.OpKind.POOL2D
                                         for op in sub.ops)
            assert d.n_slots * d.slot_elems * 4 <= tnhwc.SMEM_TARGET
        x_shape = tir.infer_shapes(seg.stack, {seg.stack.inputs[0]: x_shape})[
            seg.stack.outputs[0]]
