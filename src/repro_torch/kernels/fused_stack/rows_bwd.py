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

Launch geometry (:func:`launch_plan`).  The grid comes from the rows, the
widths and the card, not from the plan's row tile: a persistent grid of
:data:`PROGRAMS_PER_SM` programs an SM (fewer when there are fewer
sub-blocks) walks sub-blocks of ``R_SUB`` rows, program ``p`` taking
sub-blocks ``p, p + programs, ...``, so that at 2048-8192 rows every SM
has work whatever tile the planner chose.

Parameter gradients.  The Pallas kernel adds every tile's ``(1, F)`` partial
into one shared block, which is right only on a sequential grid.  Here each
program keeps its partial in registers and writes one row of a
``(programs, params' widths)`` buffer; a second kernel sums that buffer
over the programs in a fixed order, :data:`REDUCE_BLOCK` columns a program.
Two runs give bitwise-equal gradients, and the partials scale with the SM
count, not the row count.

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

Dtypes.  Inputs and parameters may be float32 or bfloat16, as the Pallas
backward takes the primals' dtypes; each cotangent has its value's dtype.
The recompute rounds where the forward kernel does; the reverse sweep
rounds where ``autodiff.program_vjp`` on bf16 tensors rounds (each PyTorch
op of a rule whose operands are all bf16, the cast of each contribution to
its value's dtype, the sum of two contributions; an activation's derivative
is ``autodiff``'s rule itself, traced op by op), with ``rows.round_bf16``,
so no FMA contraction crosses a rounding point; the
arithmetic between is float32.  Parameter partials stay float32, and the
fixed-order second pass's sum is cast to the parameter's dtype once.

Bound: device-memory bytes (inputs and output cotangents read once, input
cotangents written once); the recompute and the VJP run in registers.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Mapping

import torch

from repro_torch.core import autodiff, ir, resource
from repro_torch.kernels import _build
from repro_torch.kernels.fused_stack import rows

#: Elements one sub-block of rows holds in the backward (R_SUB * BLOCK_F):
#: half the forward's, for the cotangents live beside the recompute.
SUB_ELEMS = 4096
#: Programs per SM of the persistent launch (each writes one partial row).
PROGRAMS_PER_SM = 2
#: The second pass: columns a program reduces, and partial rows it loads
#: at a time (summed as one block, then block after block: a fixed order).
REDUCE_BLOCK = 128
REDUCE_ROWS = 32

def emit_bwd_source(program: ir.StackProgram, in_widths: Mapping[str, int],
                    param_widths: Mapping[str, int], features: int,
                    f_block: int,
                    dtypes: Mapping[str, torch.dtype] | None = None,
                    steps: Mapping[str, tuple[torch.dtype, ...]] | None = None
                    ) -> str:
    """The Triton source of ``program``'s backward kernel and of the
    partial-sum reduction; ``f_block`` features of a row at a time
    (:func:`repro_torch.core.resource.feature_block`).  ``dtypes`` gives
    each input's and parameter's dtype and ``steps`` each op's rounding
    steps (:func:`repro_torch.kernels.fused_stack.rows.value_dtypes`);
    without them everything is float32."""
    widths = rows.value_widths(program, in_widths, param_widths)
    dtypes = dict(dtypes or {})
    steps = dict(steps or {})
    vdt = {v: dtypes.get(v, torch.float32) for v in program.inputs}
    vdt.update({v: st[-1] for v, st in steps.items()})
    pdt = {p: dtypes.get(p, torch.float32) for p in program.param_names}
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
    ]
    if any(dt != torch.float32 for dt in [*vdt.values(), *pdt.values()]):
        lines += [rows.ROUND_BF16, ""]
    lines += [
        f"# generated from stack {program.name!r}",
        "@triton.jit",
        f"def fused_rows_bwd_kernel({', '.join(args)}, n_rows, n_sub,",
        "                          n_prog, F: tl.constexpr,",
        "                          R_SUB: tl.constexpr,",
        "                          BLOCK_F: tl.constexpr, P_W: tl.constexpr,",
        "                          LOOP_STAGES: tl.constexpr):",
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
                                                    param_widths, dtypes)]
    chunk += [f"    {acc[p]} = tl.zeros([BLOCK_F], tl.float32)"
              for p in program.param_names if p not in scalar]
    chunk += [
        "    for sb in tl.range(pid, n_sub, n_prog, num_stages=LOOP_STAGES):",
        "        rows = (sb * R_SUB + tl.arange(0, R_SUB))[:, None]",
        "        rmask = rows < n_rows",
        "        r64 = rows.to(tl.int64)",
    ]
    body = [f"{var[v]} = {rows.load(f'in{i}', widths[v], vdt[v])}"
            for i, v in enumerate(program.inputs)]
    body += rows.op_lines(program, var, pvar, widths, steps)
    body += _vjp_lines(program, var, pvar, acc, widths, param_widths,
                       chunked, vdt, pdt)
    chunk += ["        " + b for b in body]
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
        "                           BLOCK: tl.constexpr,",
        "                           P_BLOCK: tl.constexpr):",
        "    cols = (tl.program_id(0) * BLOCK + tl.arange(0, BLOCK))[None, :]",
        "    mask = cols < W",
        "    total = tl.zeros([BLOCK], tl.float32)",
        "    for p0 in range(0, n_prog, P_BLOCK):",
        "        ps = (p0 + tl.arange(0, P_BLOCK))[:, None]",
        "        part = tl.load(partial + ps * W + cols,",
        "                       mask=(ps < n_prog) & mask, other=0.0)",
        "        total = total + tl.sum(part, axis=0)",
        "    tl.store(out + cols, total[None, :], mask=mask)",
    ]
    return "\n".join(lines) + "\n"


BF16, F32 = torch.bfloat16, torch.float32


def _both(*dts: torch.dtype) -> torch.dtype:
    """The dtype PyTorch gives an operation on values of ``dts``: bfloat16
    only when every operand is (a float32 operand promotes)."""
    return BF16 if all(d == BF16 for d in dts) else F32


class _Emit:
    """Statements of the reverse sweep.  :meth:`value` gives an expression
    the dtype the interpreter's value has there: in bfloat16 it is named
    and rounded (``round_bf16``, which no FMA contraction crosses); in
    float32 it stays inline."""

    def __init__(self, body: list[str]) -> None:
        self.body = body
        self.n = 0

    def value(self, expr: str, dt: torch.dtype) -> str:
        if dt == F32:
            return f"({expr})"
        name = f"r{self.n}"
        self.n += 1
        self.body.append(f"{name} = {expr}")
        self.body += rows.rounded(name, dt)
        return name


class _Traced:
    """A value of a derivative rule of ``autodiff._UNARY_DERIVS``, traced:
    the rule runs on these stand-ins, so each PyTorch op it applies becomes
    one Triton expression, in its order, of the dtype PyTorch gives it
    (:meth:`_Emit.value`: a bfloat16 op is named and rounded, as the bf16
    tensor op rounds its result; a float32 one stays inline).  The kernel's
    derivative and its rounding steps are the interpreter's own."""

    _FNS = {
        torch.sigmoid: "tl.sigmoid({0})",
        torch.tanh: "libdevice.tanh({0})",
        torch.exp: "tl.exp({0})",
        torch.erf: "libdevice.erf({0})",
        torch.sign: "tl.where({0} > 0, 1.0, tl.where({0} < 0, -1.0, "
                    "{0} * 0.0))",
        torch.ones_like: "tl.where({0} == {0}, 1.0, 1.0)",
        torch.clamp_min: "tl.maximum({0}, {1}, "
                         "propagate_nan=tl.PropagateNan.ALL)",
    }

    def __init__(self, expr: str, dtype: torch.dtype, e: "_Emit") -> None:
        self.expr, self.dtype, self.e = expr, dtype, e

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func not in cls._FNS or kwargs:
            raise NotImplementedError(f"rows_bwd: no Triton expression for "
                                      f"{func}")
        return args[0]._new(cls._FNS[func].format(*map(_operand, args)))

    def _new(self, expr: str, dtype: torch.dtype | None = None) -> "_Traced":
        dtype = dtype or self.dtype
        if dtype == torch.bool:
            return _Traced(f"({expr})", dtype, self.e)
        return _Traced(self.e.value(expr, dtype), dtype, self.e)

    def _bin(self, fmt: str, o, dtype: torch.dtype | None = None
             ) -> "_Traced":
        if dtype is None and isinstance(o, _Traced):
            dtype = _both(self.dtype, o.dtype)
        return self._new(fmt.format(self.expr, _operand(o)), dtype)

    def __add__(self, o):
        return self._bin("{0} + {1}", o)

    def __radd__(self, o):
        return self._bin("{1} + {0}", o)

    def __sub__(self, o):
        return self._bin("{0} - {1}", o)

    def __rsub__(self, o):
        return self._bin("{1} - {0}", o)

    def __mul__(self, o):
        return self._bin("{0} * {1}", o)

    def __rmul__(self, o):
        return self._bin("{1} * {0}", o)

    def __truediv__(self, o):
        return self._bin("{0} / {1}", o)

    def __neg__(self):
        return self._new(f"-{self.expr}")

    def __gt__(self, o):
        return self._bin("{0} > {1}", o, torch.bool)

    def __lt__(self, o):
        return self._bin("{0} < {1}", o, torch.bool)

    def __and__(self, o):
        return self._bin("{0} & {1}", o, torch.bool)

    def to(self, dtype: torch.dtype) -> "_Traced":
        if self.dtype != torch.bool:
            raise NotImplementedError("rows_bwd: only a mask is cast")
        return self._new(f"tl.where({self.expr}, 1.0, 0.0)", dtype)


def _operand(o) -> str:
    return o.expr if isinstance(o, _Traced) else repr(float(o))


def _deriv(fn: str, x: str, y: str, dt: torch.dtype, e: _Emit) -> str:
    """d f / d x at ``x`` (``y = f(x)``), both of dtype ``dt``:
    ``autodiff._UNARY_DERIVS[fn]`` traced (:class:`_Traced`)."""
    return autodiff._UNARY_DERIVS[fn](_Traced(x, dt, e),
                                      _Traced(y, dt, e)).expr


def _vjp_lines(program: ir.StackProgram, var: Mapping[str, str],
               pvar: Mapping[str, str], acc: Mapping[str, str],
               widths: Mapping[str, int],
               param_widths: Mapping[str, int], chunked: bool,
               vdt: Mapping[str, torch.dtype] | None = None,
               pdt: Mapping[str, torch.dtype] | None = None) -> list[str]:
    """The reverse sweep (``autodiff.program_vjp``) as statements: output
    cotangent loads, one group per op in reverse, input cotangent stores
    (a width-1 input's added to the earlier chunks' when ``chunked``).

    ``vdt``/``pdt`` give each value's and parameter's dtype (default
    float32).  A value's cotangent has the value's dtype; where the
    interpreter's rule runs on bfloat16 tensors the statements round where
    it does (each product or sum of bf16 operands, the cast of each
    contribution, the sum of contributions); everything between is float32.
    Parameter partials stay float32 (the wrapper casts the reduced
    gradient to the parameter's dtype once)."""
    vdt, pdt = dict(vdt or {}), dict(pdt or {})
    body: list[str] = []
    e = _Emit(body)
    cot: dict[str, str] = {}

    def dv(v: str) -> torch.dtype:
        return vdt.get(v, F32)

    for i, v in enumerate(program.outputs):
        g = rows.load(f"g{i}", widths[v], dv(v))
        if widths[v] == 1 and chunked:            # seed the first chunk only
            g = g.replace("mask=rmask", "mask=rmask & (f0 == 0)")
        body.append(f"c{var[v]} = {g}")
        cot[v] = f"c{var[v]}"

    def add_cot(v: str, expr: str, w: int, dt: torch.dtype = F32) -> None:
        """Add ``expr``, a contribution of dtype ``dt``, to v's cotangent."""
        if widths[v] == 1 and w != 1:             # undo the broadcast
            expr = f"tl.sum({rows.zeroed(f'({expr})', w)}, axis=1)[:, None]"
            dt = F32
        if dt != dv(v):                           # the cast to v's dtype
            expr = e.value(expr, dv(v))
        if v in cot:
            body.append(f"{cot[v]} = {cot[v]} + {expr}")
            body.extend(rows.rounded(cot[v], dv(v)))
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
        dg = dv(op.output)
        wo = widths[op.output]
        x = var[op.inputs[0]]
        dx = dv(op.inputs[0])
        body.append(f"# d {op.name}: {op.kind.value} {op.fn or ''}".rstrip())
        if op.kind == ir.OpKind.EW_UNARY:
            d = _deriv(op.fn, x, var[op.output], dx, e)
            dt = _both(dg, dx)
            add_cot(op.inputs[0], e.value(f"{g} * {d}", dt), wo, dt)
        elif op.kind == ir.OpKind.EW_BINARY:
            if op.params:
                b, db_t = pvar[op.params[0]], pdt.get(op.params[0], F32)
            else:
                b, db_t = var[op.inputs[1]], dv(op.inputs[1])
            (da, da_t), (db, dbo_t) = _binary_vjp(
                op.fn, x, b, g, f"m{k}", body, e, (dg, dx, db_t))
            if op.params:
                add_cot(op.inputs[0], da, wo, da_t)
                add_param(op.params[0], db, wo)
            elif op.inputs[1] == op.inputs[0]:     # x op x
                da = da if da_t == dx else e.value(da, dx)
                db = db if dbo_t == dx else e.value(db, dx)
                add_cot(op.inputs[0], e.value(f"{da} + {db}", dx), wo, dx)
            else:
                add_cot(op.inputs[0], da, wo, da_t)
                add_cot(op.inputs[1], db, wo, dbo_t)
        elif op.kind == ir.OpKind.AFFINE:
            s = pvar[op.params[0]]
            ds = pdt.get(op.params[0], F32)
            dt = _both(dg, ds)
            add_cot(op.inputs[0], e.value(f"{g} * {s}", dt), wo, dt)
            add_param(op.params[0], e.value(f"{g} * {x}", _both(dg, dx)), wo)
            add_param(op.params[1], g, wo)
        elif op.kind == ir.OpKind.ROW_NORM:
            _norm_vjp(op, k, x, var[op.output], g, wo, pvar, body, add_param,
                      e, (dg, dx, pdt.get(op.params[0], F32)
                          if op.params else F32))
            add_cot(op.inputs[0], f"n{k}_dx", wo)
        elif op.kind == ir.OpKind.ROW_SOFTMAX:
            y = var[op.output]
            gy = e.value(f"{g} * {y}", dg)
            body.append(f"s{k}_dot = tl.sum({rows.zeroed(gy, wo)}, "
                        f"axis=1)[:, None]")
            diff = e.value(f"{g} - {e.value(f's{k}_dot', dg)}", dg)
            add_cot(op.inputs[0], e.value(f"{y} * {diff}", dg), wo, dg)
        else:
            raise ValueError(f"{program.name}: no VJP rule for {op.kind}")

    for i, v in enumerate(program.inputs):
        w, dt = widths[v], dv(v)
        val = cot.get(v, f"tl.zeros([R_SUB, {'1' if w == 1 else 'BLOCK_F'}],"
                         f" tl.float32)")
        if w == 1 and chunked:
            prev = rows.widened(f"tl.load(din{i} + r64, mask=rmask & "
                                f"(f0 > 0), other=0.0)", dt)
            val = e.value(f"{prev} + {val}", dt)
        if dt != F32:
            val = f"tl.cast({val}, {rows.DTYPES[dt]})"
        if w == 1:
            body.append(f"tl.store(din{i} + r64, {val}, mask=rmask)")
        else:
            body.append(f"tl.store(din{i} + r64 * F + cols, {val}, "
                        f"mask=rmask & cmask)")
    return body


def _binary_vjp(fn: str, a: str, b: str, g: str, m: str, body: list[str],
                e: _Emit, dts: tuple[torch.dtype, torch.dtype, torch.dtype]
                ) -> tuple[tuple[str, torch.dtype], tuple[str, torch.dtype]]:
    """``((da, its dtype), (db, its dtype))`` of ``a fn b`` under cotangent
    ``g``; ``dts`` are the dtypes of ``g``, ``a`` and ``b``."""
    dg, da, db = dts
    if fn == "add":
        return (g, dg), (g, dg)
    if fn == "sub":
        return (g, dg), (f"-{g}", dg)
    if fn == "mul":
        ta, tb = _both(dg, db), _both(dg, da)
        return ((e.value(f"{g} * {b}", ta), ta),
                (e.value(f"{g} * {a}", tb), tb))
    if fn == "div":
        ta, tb = _both(dg, db), _both(dg, da, db)
        num = e.value(f"-{g} * {a}", _both(dg, da))
        return ((e.value(f"tl.div_rn({g}, {b})", ta), ta),
                (e.value(f"tl.div_rn({num}, {e.value(f'{b} * {b}', db)})",
                         tb), tb))
    if fn in ("max", "min"):
        # the split mask is a float32 tensor: the products promote
        win = ">" if fn == "max" else "<"
        body.append(f"{m} = tl.where({a} {win} {b}, 1.0, tl.where({a} == {b}, "
                    f"0.5, 0.0))")
        return (f"{g} * {m}", F32), (f"{g} * (1.0 - {m})", F32)
    raise ValueError(f"no VJP rule for binary fn {fn!r}")


def _norm_vjp(op: ir.OpNode, k: int, x: str, out: str, g: str, w: int,
              pvar: Mapping[str, str], body: list[str], add_param, e: _Emit,
              dts: tuple[torch.dtype, torch.dtype, torch.dtype]) -> None:
    """``autodiff._row_norm_vjp`` on the forward's own statistics
    (``{out}_v``, and ``{out}_d = x - mean`` for layer norm); ``dts`` are the
    dtypes of ``g``, ``x`` and the scale.  The statistics and ``dx`` are
    float32; ``xhat`` is rounded to x's dtype for the scale's gradient, and
    ``g * scale`` to the product's dtype, as the rule casts them."""
    dg, dx, ds = dts
    eps = float(op.attrs.get("eps", 1e-6))
    n = float(w)
    kind = op.attrs.get("norm", "rms")
    body.append(f"n{k}_r = libdevice.rsqrt({out}_v + {eps!r})")
    xh = f"{x} * n{k}_r" if kind == "rms" else f"{out}_d * n{k}_r"
    body.append(f"n{k}_xh = {xh}")
    if op.params:
        xh_cast = e.value(f"n{k}_xh", dx)
        add_param(op.params[0], e.value(f"{g} * {xh_cast}", _both(dg, dx)),
                  w)
        if len(op.params) > 1:
            add_param(op.params[1], g, w)
        gy = e.value(f"{g} * {pvar[op.params[0]]}", _both(dg, ds))
        body.append(f"n{k}_gy = {gy}")
    else:
        body.append(f"n{k}_gy = {g}")

    def mean(expr: str) -> str:
        return f"(tl.sum({rows.zeroed(expr, w)}, axis=1) / {n!r})[:, None]"

    if kind == "rms":
        body.append(f"n{k}_dx = n{k}_r * n{k}_gy - {x} * (n{k}_r * n{k}_r * "
                    f"n{k}_r) * {mean(f'n{k}_gy * {x}')}")
    else:
        body.append(f"n{k}_dx = n{k}_r * (n{k}_gy - {mean(f'n{k}_gy')} - "
                    f"n{k}_xh * {mean(f'n{k}_gy * n{k}_xh')})")


def launch_config(f_block: int, max_rows: int) -> tuple[int, int, int]:
    """(BLOCK_F, R_SUB, num_warps) of one backward kernel that holds
    ``f_block`` features of a row at a time, at most ``max_rows`` rows a
    sub-block."""
    block_f = rows._next_pow2(f_block)
    r_sub = 1
    while r_sub * 2 <= max_rows and r_sub * 2 * block_f <= SUB_ELEMS:
        r_sub *= 2
    # 8 warps keep a whole 5120-feature row's live values in registers
    # (16 spill them: 128 registers a thread, 28 bytes spilled, on an H100)
    num_warps = 4 if r_sub * block_f <= 1024 else 8
    return block_f, r_sub, num_warps


def launch_plan(n_rows: int, features: int, f_block: int, sm_count: int,
                row_bytes: int = 0) -> rows.LaunchPlan:
    """The backward's grid: :func:`rows.launch_plan` (shared with the
    forward) with this direction's sub-blocks (:func:`launch_config`) and
    :data:`PROGRAMS_PER_SM`.
    ``row_bytes`` counts the inputs and the cotangents."""
    return rows.launch_plan(n_rows, features, f_block, sm_count, row_bytes,
                            launch_config, PROGRAMS_PER_SM)


#: Generated modules by (signature, widths, F, features held).
_MODULES: "OrderedDict[tuple, object]" = OrderedDict()
_MODULE_LIMIT = 256


def _module(program: ir.StackProgram, in_widths: dict[str, int],
            param_widths: dict[str, int], features: int, f_block: int,
            dtypes: dict[str, torch.dtype],
            steps: dict[str, tuple[torch.dtype, ...]]):
    key = (program.signature(), tuple(sorted(in_widths.items())),
           tuple(sorted(param_widths.items())), features, f_block,
           tuple(sorted((k, str(v)) for k, v in dtypes.items())),
           tuple(sorted((k, str(v)) for k, v in steps.items())))
    mod = _MODULES.get(key)
    if mod is None:
        src = emit_bwd_source(program, in_widths, param_widths, features,
                              f_block, dtypes, steps)
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
    output to its cotangent (in the output's dtype); returns ``(dinputs,
    dparams)`` shaped and typed as the primals.  Inputs and parameters are
    float32 or bfloat16.  ``tile_rows`` is the plan's row tile, which no
    longer sets the launch (:func:`launch_plan` takes it from the rows and
    the card); ``f_chunk`` is the plan's device's (0: hold whole rows).
    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise."""
    device = inputs[program.inputs[0]].device
    if device.type == "cpu":
        return fused_rows_bwd_ref(program, inputs, params, cotangents)
    if device.type != "cuda":
        raise ValueError(f"fused_rows_bwd takes cpu or cuda tensors, got "
                         f"{device}")
    operands = [*((n, inputs[n]) for n in program.inputs),
                *((p, params[p]) for p in program.param_names)]
    for name, t in operands:
        if t.device != device or t.dtype not in rows.DTYPES:
            raise TypeError(f"{program.name}: {name!r} must be float32 or "
                            f"bfloat16 on {device}, got {t.dtype} on "
                            f"{t.device}")
    dtypes = {name: t.dtype for name, t in operands}
    steps = rows.value_dtypes(program, {n: inputs[n].dtype
                                        for n in program.inputs}, params)
    for v in program.outputs:
        want = steps[v][-1] if v in steps else dtypes[v]
        t = cotangents[v]
        if t.device != device or t.dtype != want:
            raise TypeError(f"{program.name}: the cotangent of {v!r} must be "
                            f"{want} on {device} (the value's dtype), got "
                            f"{t.dtype} on {t.device}")
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
    sm = torch.cuda.get_device_properties(device).multi_processor_count
    f_block = resource.feature_block(program, features, f_chunk)
    row_bytes = sum(a.element_size() for a in [*flat, *gflat]
                    if a.shape[-1] != 1)
    plan = launch_plan(n_rows, features, f_block, sm, row_bytes)
    partial = torch.empty((plan.n_prog, max(p_w, 1)), device=device,
                          dtype=torch.float32)
    mod = _module(program, in_widths, param_widths, features, f_block,
                  dtypes, steps)
    total = torch.empty((max(p_w, 1),), device=device, dtype=torch.float32)
    if n_rows:
        with torch.cuda.device(device):
            mod.fused_rows_bwd_kernel[(plan.n_prog,)](
                *flat, *pflat, *gflat, *dins, partial, n_rows, plan.n_sub,
                plan.n_prog, F=features, R_SUB=plan.r_sub,
                BLOCK_F=plan.block_f, P_W=p_w, LOOP_STAGES=plan.loop_stages,
                num_warps=plan.num_warps)
            if p_w:
                mod.reduce_partials_kernel[(-(-p_w // REDUCE_BLOCK),)](
                    partial, total, plan.n_prog, p_w, BLOCK=REDUCE_BLOCK,
                    P_BLOCK=REDUCE_ROWS, num_warps=4)
        fused_rows_bwd.launches += 1
    else:
        total.zero_()
    dparams: dict[str, torch.Tensor] = {}
    off = 0
    for p in program.param_names:
        w = param_widths[p]
        dparams[p] = total[off: off + w].reshape(params[p].shape).to(
            params[p].dtype)
        off += w
    return ({n: d.reshape(*lead, d.shape[-1])
             for n, d in zip(program.inputs, dins)}, dparams)


fused_rows_bwd.launches = 0
