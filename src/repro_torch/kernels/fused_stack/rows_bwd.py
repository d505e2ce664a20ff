"""Depth-first backward kernel for rows-layout stacks, in Triton.

Replaces ``repro/kernels/fused_stack/rows_bwd.py:fused_rows_bwd_call`` (the
Pallas kernel).  :func:`emit_bwd_source` generates one kernel per stack
signature and widths.  On each sub-block of rows it

1. recomputes the chain's forward (the forward kernel's own statement
   tables, :func:`repro_torch.kernels.fused_stack.rows.op_lines`): nothing
   of the forward is saved to device memory;
2. runs the VJP rules of :mod:`repro_torch.core.autodiff` in reverse, one
   statement group per op;
3. writes each input cotangent once, and adds each parameter's gradient
   into a register accumulator.

Parameter gradients.  The Pallas kernel adds every tile's ``(1, F)`` partial
into one shared block, which is right only on a sequential grid.  Here a
fixed number of programs (:func:`n_programs`: four per SM) each walk a
strided set of row tiles and keep their partial in registers; each writes
one row of a ``(programs, params' widths)`` buffer, and a second kernel sums
that buffer over the programs in a fixed order.  Two runs give bitwise-equal
gradients, and the partials scale with the SM count, not the row count.

Masking, as in the forward kernel: rows past the end are masked, never
padded, and kept out of the parameter sums (the JAX ``row_mask`` fix for
0 * NaN); lanes past F are zeroed before every sum over F.

F chunks.  A chain with no op that reduces over F is walked in chunks of
``f_chunk`` features, the plan's device's (``resource.feature_block``, which
the planner asks too): the glu at d_ff = 11008 on the ``H100`` then holds
2048 features of a row, not all 11008.  Every other chain holds its whole
row, ``BLOCK_F = next_pow2(F)``.  Width-1 values of a chunked chain get one
partial cotangent per chunk; the VJP is linear in the cotangent, so the
partials add up: a width-1 output's cotangent enters in the first chunk
only, a width-1 parameter's accumulator lives across the chunks and is
stored once after them, and a width-1 input's cotangent is added into
``din`` chunk by chunk by the program that owns the rows (a barrier orders
each chunk's adds after the last one's stores).

Bound: device-memory bytes (inputs and output cotangents read once, input
cotangents written once); the recompute and the VJP run in registers.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Mapping

import torch

from repro_torch.core import autodiff, ir, resource
from repro_torch.kernels import _build
from repro_torch.kernels.fused_stack import rows

#: Elements one sub-block of rows holds in the backward (R_SUB * BLOCK_F):
#: half the forward's, for the cotangents live beside the recompute.
SUB_ELEMS = 4096
#: Programs per SM of the persistent launch.
PROGRAMS_PER_SM = 4

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
_K = repr(_SQRT_2_OVER_PI)
_K3 = repr(3.0 * 0.044715)


def _d_gelu(x: str) -> str:
    t = f"libdevice.tanh({_K} * ({x} + 0.044715 * {x} * {x} * {x}))"
    return (f"0.5 * (1.0 + {t}) + 0.5 * {x} * (1.0 - {t} * {t}) * "
            f"({_K} * (1.0 + {_K3} * {x} * {x}))")


#: d f / d x of each unary fn as an expression of ``x`` and ``y = f(x)``
#: (``autodiff._UNARY_DERIVS``).
_DERIV = {
    "relu": lambda x, y: f"tl.where({x} > 0, 1.0, 0.0)",
    "relu6": lambda x, y: f"tl.where(({x} > 0) & ({x} < 6), 1.0, 0.0)",
    "squared_relu": lambda x, y: (f"2.0 * tl.maximum({x}, 0.0, propagate_nan"
                                  f"=tl.PropagateNan.ALL)"),
    "gelu": lambda x, y: _d_gelu(x),
    "gelu_exact": lambda x, y: (
        f"0.5 * (1.0 + libdevice.erf({x} / 1.4142135623730951)) + {x} * "
        f"(tl.exp(-0.5 * {x} * {x}) * {_INV_SQRT_2PI!r})"),
    "silu": lambda x, y: (f"tl.sigmoid({x}) * (1.0 + {x} * (1.0 - "
                          f"tl.sigmoid({x})))"),
    "sigmoid": lambda x, y: f"{y} * (1.0 - {y})",
    "tanh": lambda x, y: f"1.0 - {y} * {y}",
    "exp": lambda x, y: y,
    "abs": lambda x, y: f"tl.where({x} > 0, 1.0, tl.where({x} < 0, -1.0, "
                        f"{x} * 0.0))",
    "square": lambda x, y: f"2.0 * {x}",
    "identity": lambda x, y: f"tl.where({x} == {x}, 1.0, 1.0)",
    "neg": lambda x, y: f"tl.where({x} == {x}, -1.0, -1.0)",
    "softplus": lambda x, y: f"tl.sigmoid({x})",
}


def emit_bwd_source(program: ir.StackProgram, in_widths: Mapping[str, int],
                    param_widths: Mapping[str, int], features: int,
                    f_block: int) -> str:
    """The Triton source of ``program``'s backward kernel and of the
    partial-sum reduction; ``f_block`` features of a row at a time
    (:func:`repro_torch.core.resource.feature_block`)."""
    widths = rows.value_widths(program, in_widths, param_widths)
    chunked = f_block < features
    scalar = [p for p in program.param_names if param_widths[p] == 1]
    var = {v: f"v{i}" for i, v in enumerate(
        list(program.inputs) + [op.output for op in program.ops])}
    pvar = {p: f"p{i}" for i, p in enumerate(program.param_names)}
    acc = {p: f"acc{i}" for i, p in enumerate(program.param_names)}
    n_in, n_out = len(program.inputs), len(program.outputs)
    args = ([f"in{i}" for i in range(n_in)]
            + [f"par{i}" for i in range(len(program.param_names))]
            + [f"g{i}" for i in range(n_out)]
            + [f"din{i}" for i in range(n_in)] + ["partial"])
    lines = [
        "import triton",
        "import triton.language as tl",
        "from triton.language.extra import libdevice",
        "",
        "",
        f"# generated from stack {program.name!r}",
        "@triton.jit",
        f"def fused_rows_bwd_kernel({', '.join(args)}, n_rows, n_tiles,",
        "                          n_prog, F: tl.constexpr,",
        "                          TILE_R: tl.constexpr, R_SUB: tl.constexpr,",
        "                          BLOCK_F: tl.constexpr, P_W: tl.constexpr):",
        "    pid = tl.program_id(0)",
    ]
    lines += [f"    {acc[p]} = tl.zeros([1], tl.float32)" for p in scalar]
    lines += ["    for f0 in range(0, F, BLOCK_F):"]
    if chunked and any(in_widths[v] == 1 for v in program.inputs):
        lines += ["        tl.debug_barrier()   # the last chunk's din stores"]
    lines += [
        "        cols = (f0 + tl.arange(0, BLOCK_F))[None, :]",
        "        cmask = cols < F",
    ]
    chunk = ["    " + ln for ln in rows.param_lines(program, pvar,
                                                    param_widths)]
    chunk += [f"    {acc[p]} = tl.zeros([BLOCK_F], tl.float32)"
              for p in program.param_names if p not in scalar]
    chunk += [
        "    for t in range(pid, n_tiles, n_prog):",
        "        row_start = t * TILE_R",
        "        row_end = tl.minimum(row_start + TILE_R, n_rows)",
        "        for r0 in range(row_start, row_start + TILE_R, R_SUB):",
        "            rows = (r0 + tl.arange(0, R_SUB))[:, None]",
        "            rmask = rows < row_end",
        "            r64 = rows.to(tl.int64)",
    ]
    body = [f"{var[v]} = {rows.load(f'in{i}', widths[v])}"
            for i, v in enumerate(program.inputs)]
    body += rows.op_lines(program, var, pvar, widths)
    body += _vjp_lines(program, var, pvar, acc, widths, param_widths,
                       chunked)
    chunk += ["            " + b for b in body]
    off, after = 0, []
    for p in program.param_names:
        base = f"partial + pid * P_W + {off}"
        if param_widths[p] == 1:
            after.append(f"    tl.store({base}, tl.sum({acc[p]}, axis=0))")
        else:
            chunk.append(f"    tl.store({base} + cols, {acc[p]}[None, :], "
                         f"mask=cmask)")
        off += param_widths[p]
    lines += ["    " + ln for ln in chunk] + after
    lines += [
        "",
        "",
        "@triton.jit",
        "def reduce_partials_kernel(partial, out, n_prog, W,",
        "                           BLOCK: tl.constexpr):",
        "    cols = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)",
        "    mask = cols < W",
        "    total = tl.zeros([BLOCK], tl.float32)",
        "    for p in range(0, n_prog):",
        "        total = total + tl.load(partial + p * W + cols, mask=mask,",
        "                                other=0.0)",
        "    tl.store(out + cols, total, mask=mask)",
    ]
    return "\n".join(lines) + "\n"


def _vjp_lines(program: ir.StackProgram, var: Mapping[str, str],
               pvar: Mapping[str, str], acc: Mapping[str, str],
               widths: Mapping[str, int],
               param_widths: Mapping[str, int], chunked: bool) -> list[str]:
    """The reverse sweep (``autodiff.program_vjp``) as statements: output
    cotangent loads, one group per op in reverse, input cotangent stores
    (a width-1 input's added to the earlier chunks' when ``chunked``)."""
    body: list[str] = []
    cot: dict[str, str] = {}
    for i, v in enumerate(program.outputs):
        g = rows.load(f"g{i}", widths[v])
        if widths[v] == 1 and chunked:            # seed the first chunk only
            g = g.replace("mask=rmask", "mask=rmask & (f0 == 0)")
        body.append(f"c{var[v]} = {g}")
        cot[v] = f"c{var[v]}"

    def add_cot(v: str, expr: str, w: int) -> None:
        if widths[v] == 1 and w != 1:             # undo the broadcast
            expr = f"tl.sum({rows.zeroed(f'({expr})', w)}, axis=1)[:, None]"
        if v in cot:
            body.append(f"{cot[v]} = {cot[v]} + ({expr})")
        else:
            cot[v] = f"c{var[v]}"
            body.append(f"{cot[v]} = {expr}")

    def add_param(p: str, expr: str, w: int) -> None:
        mask = "rmask" if w == 1 else "rmask & cmask"
        masked = f"tl.where({mask}, {expr}, 0.0)"
        if param_widths[p] == 1:
            body.append(f"{acc[p]} = {acc[p]} + tl.sum(tl.sum({masked}, "
                        f"axis=1), axis=0)")
        else:
            body.append(f"{acc[p]} = {acc[p]} + tl.sum({masked}, axis=0)")

    for k in reversed(range(len(program.ops))):
        op = program.ops[k]
        if op.output not in cot:                  # never used downstream
            continue
        g = cot.pop(op.output)
        wo = widths[op.output]
        x = var[op.inputs[0]]
        body.append(f"# d {op.name}: {op.kind.value} {op.fn or ''}".rstrip())
        if op.kind == ir.OpKind.EW_UNARY:
            d = _DERIV[op.fn](x, var[op.output])
            add_cot(op.inputs[0], f"{g} * ({d})", wo)
        elif op.kind == ir.OpKind.EW_BINARY:
            b = pvar[op.params[0]] if op.params else var[op.inputs[1]]
            da, db = _binary_vjp(op.fn, x, b, g, f"m{k}", body)
            if op.params:
                add_cot(op.inputs[0], da, wo)
                add_param(op.params[0], db, wo)
            elif op.inputs[1] == op.inputs[0]:     # x op x
                add_cot(op.inputs[0], f"({da}) + ({db})", wo)
            else:
                add_cot(op.inputs[0], da, wo)
                add_cot(op.inputs[1], db, wo)
        elif op.kind == ir.OpKind.AFFINE:
            s, _ = (pvar[p] for p in op.params)
            add_cot(op.inputs[0], f"{g} * {s}", wo)
            add_param(op.params[0], f"{g} * {x}", wo)
            add_param(op.params[1], g, wo)
        elif op.kind == ir.OpKind.ROW_NORM:
            _norm_vjp(op, k, x, var[op.output], g, wo, pvar, body, add_param)
            add_cot(op.inputs[0], f"n{k}_dx", wo)
        elif op.kind == ir.OpKind.ROW_SOFTMAX:
            y = var[op.output]
            body.append(f"s{k}_dot = tl.sum({rows.zeroed(f'{g} * {y}', wo)}, "
                        f"axis=1)[:, None]")
            add_cot(op.inputs[0], f"{y} * ({g} - s{k}_dot)", wo)
        else:
            raise ValueError(f"{program.name}: no VJP rule for {op.kind}")

    for i, v in enumerate(program.inputs):
        w = widths[v]
        val = cot.get(v, f"tl.zeros([R_SUB, {'1' if w == 1 else 'BLOCK_F'}],"
                         f" tl.float32)")
        if w == 1 and chunked:
            body.append(f"tl.store(din{i} + r64, tl.load(din{i} + r64, "
                        f"mask=rmask & (f0 > 0), other=0.0) + {val}, "
                        f"mask=rmask)")
        elif w == 1:
            body.append(f"tl.store(din{i} + r64, {val}, mask=rmask)")
        else:
            body.append(f"tl.store(din{i} + r64 * F + cols, {val}, "
                        f"mask=rmask & cmask)")
    return body


def _binary_vjp(fn: str, a: str, b: str, g: str, m: str,
                body: list[str]) -> tuple[str, str]:
    if fn == "add":
        return g, g
    if fn == "sub":
        return g, f"-{g}"
    if fn == "mul":
        return f"{g} * {b}", f"{g} * {a}"
    if fn == "div":
        return f"tl.div_rn({g}, {b})", f"tl.div_rn(-{g} * {a}, {b} * {b})"
    if fn in ("max", "min"):
        win = ">" if fn == "max" else "<"
        body.append(f"{m} = tl.where({a} {win} {b}, 1.0, tl.where({a} == {b}, "
                    f"0.5, 0.0))")
        return f"{g} * {m}", f"{g} * (1.0 - {m})"
    raise ValueError(f"no VJP rule for binary fn {fn!r}")


def _norm_vjp(op: ir.OpNode, k: int, x: str, out: str, g: str, w: int,
              pvar: Mapping[str, str], body: list[str], add_param) -> None:
    """``autodiff._row_norm_vjp`` on the forward's own statistics
    (``{out}_v``, and ``{out}_d = x - mean`` for layer norm)."""
    eps = float(op.attrs.get("eps", 1e-6))
    n = float(w)
    kind = op.attrs.get("norm", "rms")
    body.append(f"n{k}_r = libdevice.rsqrt({out}_v + {eps!r})")
    xh = f"{x} * n{k}_r" if kind == "rms" else f"{out}_d * n{k}_r"
    body.append(f"n{k}_xh = {xh}")
    if op.params:
        add_param(op.params[0], f"{g} * n{k}_xh", w)
        if len(op.params) > 1:
            add_param(op.params[1], g, w)
        body.append(f"n{k}_gy = {g} * {pvar[op.params[0]]}")
    else:
        body.append(f"n{k}_gy = {g}")

    def mean(e: str) -> str:
        return f"(tl.sum({rows.zeroed(e, w)}, axis=1) / {n!r})[:, None]"

    if kind == "rms":
        body.append(f"n{k}_dx = n{k}_r * n{k}_gy - {x} * (n{k}_r * n{k}_r * "
                    f"n{k}_r) * {mean(f'n{k}_gy * {x}')}")
    else:
        body.append(f"n{k}_dx = n{k}_r * (n{k}_gy - {mean(f'n{k}_gy')} - "
                    f"n{k}_xh * {mean(f'n{k}_gy * n{k}_xh')})")


def launch_config(f_block: int, tile_rows: int) -> tuple[int, int, int]:
    """(BLOCK_F, R_SUB, num_warps) of one backward kernel that holds
    ``f_block`` features of a row at a time."""
    block_f = rows._next_pow2(f_block)
    r_sub = 1
    while r_sub * 2 <= tile_rows and r_sub * 2 * block_f <= SUB_ELEMS:
        r_sub *= 2
    elems = r_sub * block_f
    num_warps = 4 if elems <= 1024 else 8 if elems <= 2048 else 16
    return block_f, r_sub, num_warps


def n_programs(n_tiles: int, sm_count: int) -> int:
    """Programs of the persistent launch: :data:`PROGRAMS_PER_SM` per SM,
    at most one per tile."""
    return max(1, min(n_tiles, PROGRAMS_PER_SM * sm_count))


#: Generated modules by (signature, widths, F, features held).
_MODULES: "OrderedDict[tuple, object]" = OrderedDict()
_MODULE_LIMIT = 256


def _module(program: ir.StackProgram, in_widths: dict[str, int],
            param_widths: dict[str, int], features: int, f_block: int):
    key = (program.signature(), tuple(sorted(in_widths.items())),
           tuple(sorted(param_widths.items())), features, f_block)
    mod = _MODULES.get(key)
    if mod is None:
        src = emit_bwd_source(program, in_widths, param_widths, features,
                              f_block)
        mod = _MODULES[key] = _build.import_generated("fused_rows_bwd", src)
    _MODULES.move_to_end(key)
    while len(_MODULES) > _MODULE_LIMIT:
        _MODULES.popitem(last=False)
    return mod


def fused_rows_bwd_ref(program: ir.StackProgram,
                       inputs: Mapping[str, torch.Tensor],
                       params: Mapping[str, torch.Tensor],
                       cotangents: Mapping[str, torch.Tensor]
                       ) -> tuple[dict[str, torch.Tensor],
                                  dict[str, torch.Tensor]]:
    """The plain version: ``autodiff.program_vjp`` on whole tensors (the
    JAX package's oracle path), not autograd of the forward."""
    env = autodiff.forward_env(program, inputs, params)
    return autodiff.program_vjp(program, env, params, cotangents)


def fused_rows_bwd(program: ir.StackProgram,
                   inputs: Mapping[str, torch.Tensor],
                   params: Mapping[str, torch.Tensor],
                   cotangents: Mapping[str, torch.Tensor],
                   *,
                   tile_rows: int = 256,
                   f_chunk: int = resource.H100.f_chunk
                   ) -> tuple[dict[str, torch.Tensor],
                              dict[str, torch.Tensor]]:
    """The backward of one rows sequence.  ``cotangents`` maps each program
    output to its cotangent; returns ``(dinputs, dparams)`` shaped as the
    primals.  ``f_chunk`` is the plan's device's (0: hold whole rows).  CPU
    tensors run the plain version; CUDA tensors launch the kernel or
    raise."""
    device = inputs[program.inputs[0]].device
    if device.type == "cpu":
        return fused_rows_bwd_ref(program, inputs, params, cotangents)
    if device.type != "cuda":
        raise ValueError(f"fused_rows_bwd takes cpu or cuda tensors, got "
                         f"{device}")
    operands = [*((n, inputs[n]) for n in program.inputs),
                *((p, params[p]) for p in program.param_names),
                *((v, cotangents[v]) for v in program.outputs)]
    for name, t in operands:
        if t.device != device or t.dtype != torch.float32:
            raise TypeError(f"{program.name}: {name!r} must be float32 on "
                            f"{device}, got {t.dtype} on {t.device}")
    flat, lead, n_rows = rows.flatten_rows(program.name, list(program.inputs),
                                           inputs)
    gflat, glead, _ = rows.flatten_rows(program.name, list(program.outputs),
                                        cotangents)
    if glead != lead:
        raise ValueError(f"{program.name}: cotangent leading shape {glead} "
                         f"!= input leading shape {lead}")
    pflat = rows.prep_params(program, params)
    in_widths = {n: a.shape[-1] for n, a in zip(program.inputs, flat)}
    param_widths = {p: v.numel() for p, v in zip(program.param_names, pflat)}
    features = max([*in_widths.values(), *param_widths.values()])
    for name, w in {**in_widths, **param_widths}.items():
        if w not in (1, features):
            raise ValueError(f"{program.name}: {name!r} has width {w}, "
                             f"neither 1 nor {features}")
    widths = rows.value_widths(program, in_widths, param_widths)
    for v, gv in zip(program.outputs, gflat):
        if gv.shape[-1] != widths[v]:
            raise ValueError(f"{program.name}: cotangent of {v!r} has width "
                             f"{gv.shape[-1]}, the value {widths[v]}")
    dins = [torch.empty_like(a) for a in flat]
    p_w = sum(param_widths.values())
    n_tiles = -(-n_rows // tile_rows)
    sm = torch.cuda.get_device_properties(device).multi_processor_count
    n_prog = n_programs(n_tiles, sm)
    partial = torch.empty((n_prog, max(p_w, 1)), device=device,
                          dtype=torch.float32)
    f_block = resource.feature_block(program, features, f_chunk)
    mod = _module(program, in_widths, param_widths, features, f_block)
    block_f, r_sub, num_warps = launch_config(f_block, tile_rows)
    total = torch.empty((max(p_w, 1),), device=device, dtype=torch.float32)
    if n_rows:
        with torch.cuda.device(device):
            mod.fused_rows_bwd_kernel[(n_prog,)](
                *flat, *pflat, *gflat, *dins, partial, n_rows, n_tiles,
                n_prog, F=features, TILE_R=tile_rows, R_SUB=r_sub,
                BLOCK_F=block_f, P_W=p_w, num_warps=num_warps)
            if p_w:
                mod.reduce_partials_kernel[(-(-p_w // 1024),)](
                    partial, total, n_prog, p_w, BLOCK=1024, num_warps=4)
        fused_rows_bwd.launches += 1
    else:
        total.zero_()
    dparams: dict[str, torch.Tensor] = {}
    off = 0
    for p in program.param_names:
        w = param_widths[p]
        dparams[p] = total[off: off + w].reshape(params[p].shape)
        off += w
    return ({n: d.reshape(*lead, d.shape[-1])
             for n, d in zip(program.inputs, dins)}, dparams)


fused_rows_bwd.launches = 0
