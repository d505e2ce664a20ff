"""Depth-first kernel for rows-layout stacks (LM chains), in Triton.

Replaces ``repro/kernels/fused_stack/rows.py:fused_rows_call`` (the Pallas
kernel).  One program owns ``tile_rows`` rows: it reads each input row once,
applies every op of the sequence while the row is in registers, and writes
each output once.  The Pallas kernel traces the IR interpreter into its
body; Triton cannot call torch ops, so :func:`emit_source` turns each
``OpKind``/``fn`` into a Triton expression instead, generating one kernel
per stack signature (Triton's JIT compiles one in about a second).

Bound: device-memory bytes (one read per input, one write per output).
The whole row sits in one ``BLOCK_F = next_power_of_2(F)`` block, so row
reductions (``ROW_NORM`` rms/layer, ``ROW_SOFTMAX``) need no second pass.

Launch geometry (:func:`launch_plan`, shared with the backward).  The grid
comes from the rows, the widths and the card, not from the plan's row
tile: :data:`PROGRAMS_PER_SM` programs an SM (fewer when there are fewer
sub-blocks) walk sub-blocks of ``R_SUB`` rows, program ``p`` taking
sub-blocks ``p, p + programs, ...``.  Sub-blocks are as tall as
:data:`SUB_ELEMS` allows (so a wide row, d_ff = 11008, still fits the
registers) but no taller than leaves every program work, and the loop's
loads are pipelined two deep where two sub-blocks fit
:data:`PIPELINE_BYTES`.  So mamba2's gated norm at (2048, 5120) runs 1056
programs, each walking one or two one-row sub-blocks, not 8 programs of
the plan's 256-row tiles, and a decode step's 4 rows run 4 programs.  Rows past the end are masked,
never padded, read or written.

Lanes past F: 0 in every sum (and re-zeroed after ``x - mu``), ``-inf``
before the softmax max; means divide by the real F.  Divisions
of one tensor by another are round-to-nearest (``tl.div_rn``), as in the
JAX reference; divisions by a constant use ``/``.

Inputs and parameters may be float32 or bfloat16, as the Pallas kernel
takes them.  Arithmetic runs in float32 registers; wherever the torch
interpreter's value is bfloat16 (:func:`value_dtypes`: each op's output,
and inside an ``AFFINE`` or ``ROW_NORM`` the steps PyTorch rounds
separately), the source rounds it to the nearest bfloat16 (ties to even)
and keeps it in float32, so the kernel rounds where
:func:`repro_torch.core.ir.run_program` does.  The rounding is one
hardware conversion in inline PTX (``round_bf16``): written as a float cast
pair, a bf16 multiply and the add after it came out of the compiler
rounded once, where the interpreter rounds twice (no compiler pass sees
through the asm).
Each output has the interpreter's dtype.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Mapping, NamedTuple

import torch

from repro_torch.core import ir
from repro_torch.kernels import _build
from repro_torch.kernels.fused_stack import ref

#: Elements one sub-block of rows holds (R_SUB * BLOCK_F), at least one row.
SUB_ELEMS = 8192
#: Programs per SM of the forward's launch, more than stay resident
#: (chip_smoke.py times each rows forward at 2 beside it: on an H100, 8 ran
#: mamba2's gated norm 12-14% faster than 2, while the deepseek-7b chains
#: read within about 7% either way from run to run).  The backward keeps
#: its own count, as each of its programs writes a partial row.
PROGRAMS_PER_SM = 8
#: Shared memory a program may give to loading its next sub-block while it
#: works on this one (Triton's loop pipelining, two stages); past it the
#: loop runs unpipelined.
PIPELINE_BYTES = 96 * 1024

_UNARY = {
    "relu": "tl.maximum({x}, 0.0, propagate_nan=tl.PropagateNan.ALL)",
    "relu6": ("tl.minimum(tl.maximum({x}, 0.0, propagate_nan=tl.PropagateNan"
              ".ALL), 6.0, propagate_nan=tl.PropagateNan.ALL)"),
    "squared_relu": ("tl.maximum({x}, 0.0, propagate_nan=tl.PropagateNan.ALL)"
                     " * tl.maximum({x}, 0.0, propagate_nan=tl.PropagateNan"
                     ".ALL)"),
    "gelu": ("{x} * (0.5 * (1.0 + libdevice.tanh(0.7978845608028654 * "
             "({x} + 0.044715 * ({x} * {x} * {x})))))"),
    "gelu_exact": ("{x} * (libdevice.erf({x} / 1.4142135623730951) + 1.0)"
                   " / 2.0"),
    "silu": "{x} * tl.sigmoid({x})",
    "sigmoid": "tl.sigmoid({x})",
    "tanh": "libdevice.tanh({x})",
    "exp": "tl.exp({x})",
    "abs": "tl.abs({x})",
    "square": "{x} * {x}",
    "identity": "{x}",
    "neg": "-{x}",
    "softplus": ("tl.where({x} != {x}, {x}, tl.maximum({x}, 0.0) + "
                 "libdevice.log1p(tl.exp(-tl.abs({x}))))"),
}

_BINARY = {
    "add": "{a} + {b}",
    "sub": "{a} - {b}",
    "mul": "{a} * {b}",
    "div": "tl.div_rn({a}, {b})",
    "max": "tl.maximum({a}, {b}, propagate_nan=tl.PropagateNan.ALL)",
    "min": "tl.minimum({a}, {b}, propagate_nan=tl.PropagateNan.ALL)",
}


#: The dtypes a rows kernel takes, and their Triton names.
DTYPES = {torch.float32: "tl.float32", torch.bfloat16: "tl.bfloat16"}


#: value_dtypes by (signature, input dtypes, parameter dtypes and shapes).
_STEPS: dict[tuple, dict[str, tuple[torch.dtype, ...]]] = {}


def value_dtypes(program: ir.StackProgram,
                 in_dtypes: Mapping[str, torch.dtype],
                 params: Mapping[str, torch.Tensor]
                 ) -> dict[str, tuple[torch.dtype, ...]]:
    """The dtype the torch interpreter gives after each rounding step of
    every op: ``(x * s, out)`` for an ``AFFINE``, ``(normed[, scaled][,
    biased])`` for a ``ROW_NORM``, ``(out,)`` for the rest.  Found by
    running the interpreter's steps on meta tensors (PyTorch's promotion,
    0-dim parameters included); the port's stand-in for the JAX kernel's
    ``_infer_outputs``.  Computed once per signature, dtypes and parameter
    shapes (on meta tensors it costs some 0.4 ms, at every launch of a
    decode step's many small chains)."""
    key = (program.signature(),
           tuple((v, in_dtypes[v]) for v in sorted(in_dtypes)),
           tuple((p, params[p].dtype, tuple(params[p].shape))
                 for p in program.param_names))
    steps = _STEPS.get(key)
    if steps is None:
        steps = _STEPS[key] = _value_dtypes(program, in_dtypes, params)
    return dict(steps)


def _value_dtypes(program: ir.StackProgram,
                  in_dtypes: Mapping[str, torch.dtype],
                  params: Mapping[str, torch.Tensor]
                  ) -> dict[str, tuple[torch.dtype, ...]]:
    def meta(dtype, shape=(1, 1)):
        return torch.empty(shape, dtype=dtype, device="meta")

    env = {v: meta(dt) for v, dt in in_dtypes.items()}
    ps = {p: meta(params[p].dtype, tuple(params[p].shape))
          for p in program.param_names}
    steps: dict[str, tuple[torch.dtype, ...]] = {}
    for op in program.ops:
        x = env[op.inputs[0]]
        if op.kind == ir.OpKind.AFFINE:
            s, c = (ps[p] for p in op.params)
            chain = [x * s]
            chain.append(chain[0] + c)
        elif op.kind == ir.OpKind.ROW_NORM:
            chain = [meta(x.dtype)]
            if op.params:
                chain.append(chain[-1] * ps[op.params[0]])
            if len(op.params) > 1:
                chain.append(chain[-1] + ps[op.params[1]])
        else:
            chain = [ir.apply_op(op, env, ps)]
        steps[op.output] = tuple(t.dtype for t in chain)
        env[op.output] = meta(chain[-1].dtype)
    return steps


def value_widths(program: ir.StackProgram, in_widths: Mapping[str, int],
                 param_widths: Mapping[str, int]) -> dict[str, int]:
    """Trailing width of every value (1 or F): the port's stand-in for the
    JAX kernel's ``_infer_outputs``; the leading shape is the inputs'."""
    widths = dict(in_widths)
    for op in program.ops:
        ws = [widths[v] for v in op.inputs] + [param_widths[p]
                                                for p in op.params]
        widths[op.output] = max(ws)
    return widths


def emit_source(program: ir.StackProgram, in_widths: Mapping[str, int],
                param_widths: Mapping[str, int], features: int,
                dtypes: Mapping[str, torch.dtype] | None = None,
                steps: Mapping[str, tuple[torch.dtype, ...]] | None = None
                ) -> str:
    """The Triton source of ``program``'s kernel: one statement per op.

    ``in_widths``/``param_widths`` give each input's and parameter's trailing
    width, each 1 or ``features``.  ``dtypes`` gives each input's and
    parameter's dtype and ``steps`` each op's rounding steps
    (:func:`value_dtypes`); without them everything is float32.  Row
    pointers are int64."""
    widths = value_widths(program, in_widths, param_widths)
    dtypes = dict(dtypes or {})
    out_dt = {v: dtypes.get(v, torch.float32) for v in program.inputs}
    out_dt.update({v: st[-1] for v, st in (steps or {}).items()})
    var = {v: f"v{i}" for i, v in enumerate(
        list(program.inputs) + [op.output for op in program.ops])}
    pvar = {p: f"p{i}" for i, p in enumerate(program.param_names)}
    args = ([f"in{i}" for i in range(len(program.inputs))]
            + [f"par{i}" for i in range(len(program.param_names))]
            + [f"out{i}" for i in range(len(program.outputs))])
    lines = [
        "import triton",
        "import triton.language as tl",
        "from triton.language.extra import libdevice",
        "",
        "",
    ]
    if any(dt != torch.float32 for st in (steps or {}).values()
           for dt in st):
        lines += [ROUND_BF16, ""]
    lines += [
        f"# generated from stack {program.name!r}",
        "@triton.jit",
        f"def fused_rows_kernel({', '.join(args)}, n_rows, n_sub, n_prog,",
        "                      F: tl.constexpr, R_SUB: tl.constexpr,",
        "                      BLOCK_F: tl.constexpr,",
        "                      LOOP_STAGES: tl.constexpr):",
        "    pid = tl.program_id(0)",
        "    cols = tl.arange(0, BLOCK_F)[None, :]",
        "    cmask = cols < F",
    ]
    lines += ["    " + ln for ln in param_lines(program, pvar, param_widths,
                                                  dtypes)]
    lines += [
        "    for sb in tl.range(pid, n_sub, n_prog, num_stages=LOOP_STAGES):",
        "        rows = (sb * R_SUB + tl.arange(0, R_SUB))[:, None]",
        "        rmask = rows < n_rows",
        "        r64 = rows.to(tl.int64)",
    ]
    body = [f"{var[v]} = {load(f'in{i}', widths[v], out_dt[v])}"
            for i, v in enumerate(program.inputs)]
    body += op_lines(program, var, pvar, widths, steps)
    for i, v in enumerate(program.outputs):
        dt = out_dt.get(v, torch.float32)
        val = (var[v] if dt == torch.float32
               else f"tl.cast({var[v]}, {DTYPES[dt]})")
        if widths[v] == 1:
            body.append(f"tl.store(out{i} + r64, {val}, mask=rmask)")
        else:
            body.append(f"tl.store(out{i} + r64 * F + cols, {val}, "
                        f"mask=rmask & cmask)")
    lines += ["        " + b for b in body]
    return "\n".join(lines) + "\n"


def load(ptr: str, w: int, dtype: torch.dtype = torch.float32) -> str:
    """A masked load of the current sub-block of rows (width 1 or F),
    widened to float32."""
    if w == 1:
        x = f"tl.load({ptr} + r64, mask=rmask, other=0.0)"
    else:
        x = f"tl.load({ptr} + r64 * F + cols, mask=rmask & cmask, other=0.0)"
    return widened(x, dtype)


def widened(x: str, dtype: torch.dtype) -> str:
    return x if dtype == torch.float32 else f"tl.cast({x}, tl.float32)"


def rounded(v: str, dtype: torch.dtype) -> list[str]:
    """The statement that rounds ``v`` to ``dtype`` (none for float32)."""
    if dtype == torch.float32:
        return []
    return [f"{v} = round_bf16({v})"]


#: Round-to-nearest-even of a float32 block to bfloat16, kept in float32,
#: on the bits: one ``cvt.rn.bf16x2.f32`` packs bf16(x) into the high half
#: of a word whose low half is bf16(0) = 0, which is the rounded float32.
#: The conversion is inline PTX, opaque to the compiler, so no FMA
#: contraction crosses it.
ROUND_BF16 = """\
@triton.jit
def round_bf16(x):
    u = tl.cast(x, tl.uint32, bitcast=True)
    r = tl.inline_asm_elementwise("cvt.rn.bf16x2.f32 $0, $1, $2;",
                                  "=r,r,r", [u, u * 0], dtype=tl.uint32,
                                  is_pure=True, pack=1)
    return tl.cast(r, tl.float32, bitcast=True)
"""


def zeroed(x: str, w: int) -> str:
    """``x`` with the lanes past F set to 0 (before a sum over F)."""
    return x if w == 1 else f"tl.where(cmask, {x}, 0.0)"


def param_lines(program: ir.StackProgram, pvar: Mapping[str, str],
                param_widths: Mapping[str, int],
                dtypes: Mapping[str, torch.dtype] | None = None) -> list[str]:
    """Loads of the parameters at the current columns, widened to
    float32."""
    lines = []
    for i, p in enumerate(program.param_names):
        dt = (dtypes or {}).get(p, torch.float32)
        if param_widths[p] == 1:
            x = f"tl.load(par{i})"
        else:
            x = f"tl.load(par{i} + cols, mask=cmask, other=0.0)"
        lines.append(f"{pvar[p]} = {widened(x, dt)}")
    return lines


def op_lines(program: ir.StackProgram, var: Mapping[str, str],
             pvar: Mapping[str, str], widths: Mapping[str, int],
             steps: Mapping[str, tuple[torch.dtype, ...]] | None = None
             ) -> list[str]:
    """One statement group per op: the chain's forward on the loaded
    sub-block, rounded after each step whose ``steps`` dtype is not float32
    (:func:`value_dtypes`; none given: all float32).  Shared by the forward
    kernel and the backward's recompute."""
    body: list[str] = []
    for op in program.ops:
        out = var[op.output]
        x = var[op.inputs[0]]
        wx = widths[op.inputs[0]]
        st = (steps or {}).get(op.output)
        body.append(f"# {op.name}: {op.kind.value} {op.fn or ''}".rstrip())
        if op.kind == ir.OpKind.EW_UNARY:
            body.append(f"{out} = {_UNARY[op.fn].format(x=x)}")
        elif op.kind == ir.OpKind.EW_BINARY:
            b = pvar[op.params[0]] if op.params else var[op.inputs[1]]
            body.append(f"{out} = {_BINARY[op.fn].format(a=x, b=b)}")
        elif op.kind == ir.OpKind.AFFINE:
            s, c = (pvar[p] for p in op.params)
            if st is None or st == (torch.float32, torch.float32):
                body.append(f"{out} = {x} * {s} + {c}")
            else:
                body.append(f"{out} = {x} * {s}")
                body += rounded(out, st[0])
                body.append(f"{out} = {out} + {c}")
        elif op.kind == ir.OpKind.ROW_NORM:
            eps = float(op.attrs.get("eps", 1e-6))
            n = float(wx)
            kind = op.attrs.get("norm", "rms")
            if kind == "rms":
                body.append(f"{out}_v = (tl.sum({zeroed(f'{x} * {x}', wx)}, "
                            f"axis=1) / {n!r})[:, None]")
                body.append(f"{out} = {x} * libdevice.rsqrt({out}_v + {eps!r})")
            elif kind == "layer":
                body.append(f"{out}_m = (tl.sum({zeroed(x, wx)}, axis=1) / "
                            f"{n!r})[:, None]")
                body.append(f"{out}_d = {zeroed(f'{x} - {out}_m', wx)}")
                body.append(f"{out}_v = (tl.sum({out}_d * {out}_d, axis=1) / "
                            f"{n!r})[:, None]")
                body.append(f"{out} = {out}_d * libdevice.rsqrt({out}_v + "
                            f"{eps!r})")
            else:
                raise ValueError(f"unknown norm kind {kind!r}")
            if st is not None and op.params:
                body += rounded(out, st[0])
            if op.params:
                body.append(f"{out} = {out} * {pvar[op.params[0]]}")
                if st is not None and len(op.params) > 1:
                    body += rounded(out, st[1])
            if len(op.params) > 1:
                body.append(f"{out} = {out} + {pvar[op.params[1]]}")
        elif op.kind == ir.OpKind.ROW_SOFTMAX:
            xm = x if wx == 1 else f"tl.where(cmask, {x}, -float('inf'))"
            body.append(f"{out}_x = {xm}")
            body.append(f"{out}_e = tl.exp({out}_x - tl.max({out}_x, axis=1)"
                        f"[:, None])")
            body.append(f"{out} = tl.div_rn({out}_e, tl.sum({out}_e, axis=1)"
                        f"[:, None])")
        else:
            raise ValueError(f"{program.name}: op kind {op.kind} is not a "
                             f"rows stack op")
        if st is not None:
            body += rounded(out, st[-1])
    return body


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def launch_config(features: int, max_rows: int) -> tuple[int, int, int]:
    """(BLOCK_F, R_SUB, num_warps) of one forward kernel, at most
    ``max_rows`` rows a sub-block."""
    block_f = _next_pow2(features)
    r_sub = 1
    while r_sub * 2 <= max_rows and r_sub * 2 * block_f <= SUB_ELEMS:
        r_sub *= 2
    elems = r_sub * block_f
    num_warps = 4 if elems <= 1024 else 8 if elems <= 8192 else 16
    return block_f, r_sub, num_warps


class LaunchPlan(NamedTuple):
    block_f: int        # features a program holds of a row (power of two)
    r_sub: int          # rows a sub-block
    num_warps: int
    n_sub: int          # sub-blocks, ceil(n_rows / r_sub)
    n_prog: int         # programs of the persistent grid
    loop_stages: int    # 2: the next sub-block's loads overlap this one


def launch_plan(n_rows: int, features: int, f_block: int, sm_count: int,
                row_bytes: int = 0,
                config: Callable[[int, int], tuple[int, int, int]]
                = launch_config,
                programs_per_sm: int = PROGRAMS_PER_SM) -> LaunchPlan:
    """The grid of a rows kernel, forward or backward, from the rows, the
    widths and the card.  Sub-blocks are as tall as ``config`` (the
    direction's :func:`launch_config`) allows, but no taller than leaves
    ``programs_per_sm`` sub-blocks an SM; the grid is that many programs
    an SM, or one a sub-block when there are fewer.  ``features``
    (F) only bounds the sub-block's width: ``f_block`` features of it are
    held at a time.  ``row_bytes`` is what one feature of a row loads: the
    loop is pipelined when two sub-blocks of it fit
    :data:`PIPELINE_BYTES`."""
    target = programs_per_sm * max(sm_count, 1)
    block_f, r_sub, num_warps = config(min(f_block, features),
                                       max(1, n_rows // target))
    n_sub = -(-n_rows // r_sub)
    stages = 2 if 2 * r_sub * block_f * row_bytes <= PIPELINE_BYTES else 1
    return LaunchPlan(block_f, r_sub, num_warps, n_sub,
                      max(1, min(n_sub, target)), stages)


#: Generated kernels by (signature, widths, F): the imported jit function.
_KERNELS: "OrderedDict[tuple, object]" = OrderedDict()
_KERNEL_LIMIT = 256


def _kernel(program: ir.StackProgram, in_widths: dict[str, int],
            param_widths: dict[str, int], features: int,
            dtypes: dict[str, torch.dtype],
            steps: dict[str, tuple[torch.dtype, ...]]):
    key = (program.signature(), tuple(sorted(in_widths.items())),
           tuple(sorted(param_widths.items())), features,
           tuple(sorted((k, str(v)) for k, v in dtypes.items())),
           tuple(sorted((k, str(v)) for k, v in steps.items())))
    fn = _KERNELS.get(key)
    if fn is None:
        src = emit_source(program, in_widths, param_widths, features, dtypes,
                          steps)
        fn = _build.import_generated("fused_rows", src).fused_rows_kernel
        _KERNELS[key] = fn
    _KERNELS.move_to_end(key)
    while len(_KERNELS) > _KERNEL_LIMIT:
        _KERNELS.popitem(last=False)
    return fn


def flatten_rows(prog_name: str, names: list[str],
                 values: Mapping[str, torch.Tensor]
                 ) -> tuple[list[torch.Tensor], tuple[int, ...], int]:
    """Flatten the named values to contiguous ``(rows, F_i)`` tensors.
    Returns (flat tensors, lead shape, rows).  Unlike the Pallas wrapper,
    nothing is padded to a tile multiple: the kernel masks the tail rows."""
    arrays = [values[n] for n in names]
    lead = tuple(arrays[0].shape[:-1])
    for n, a in zip(names, arrays):
        if tuple(a.shape[:-1]) != lead:
            raise ValueError(f"{prog_name}: value {n} leading shape "
                             f"{tuple(a.shape[:-1])} != {lead}")
    rows = 1
    for d in lead:
        rows *= d
    return ([a.reshape(rows, a.shape[-1]).contiguous() for a in arrays], lead,
            rows)


def prep_params(program: ir.StackProgram,
                params: Mapping[str, torch.Tensor]) -> list[torch.Tensor]:
    """Per-feature parameter vectors (or scalars) as flat contiguous
    tensors of F or 1 values."""
    return [params[p].reshape(-1).contiguous() for p in program.param_names]


def fused_rows(program: ir.StackProgram,
               inputs: Mapping[str, torch.Tensor],
               params: Mapping[str, torch.Tensor],
               *,
               tile_rows: int = 256) -> dict[str, torch.Tensor]:
    """Run a rows-layout sequence as one fused Triton kernel launch.

    Every input shares one leading shape ``(..., F_i)``, flattened to rows;
    each trailing width and each parameter size is 1 or F.  Inputs and
    parameters are float32 or bfloat16; each output has the dtype the
    interpreter gives it.  ``tile_rows`` is the plan's row tile, which no
    longer sets the launch (:func:`launch_plan` takes it from the rows and
    the card).  A CPU tensor runs the plain version; a CUDA tensor launches
    the kernel or raises."""
    device = inputs[program.inputs[0]].device
    if device.type == "cpu":
        return ref.fused_stack_ref(program, inputs, params)
    if device.type != "cuda":
        raise ValueError(f"fused_rows takes cpu or cuda tensors, got {device}")
    operands = [*((n, inputs[n]) for n in program.inputs),
                *((p, params[p]) for p in program.param_names)]
    for name, t in operands:
        if t.device != device or t.dtype not in DTYPES:
            raise TypeError(f"{program.name}: {name!r} must be float32 or "
                            f"bfloat16 on {device}, got {t.dtype} on "
                            f"{t.device}")
    dtypes = {name: t.dtype for name, t in operands}
    steps = value_dtypes(program, {n: inputs[n].dtype for n in program.inputs},
                         params)
    for v, st in steps.items():
        if any(dt not in DTYPES for dt in st):
            raise TypeError(f"{program.name}: value {v!r} would be {st[-1]}")
    flat, lead, rows = flatten_rows(program.name, list(program.inputs), inputs)
    pflat = prep_params(program, params)
    in_widths = {n: a.shape[-1] for n, a in zip(program.inputs, flat)}
    param_widths = {p: v.numel() for p, v in zip(program.param_names, pflat)}
    features = max([*in_widths.values(), *param_widths.values()])
    for name, w in {**in_widths, **param_widths}.items():
        if w not in (1, features):
            raise ValueError(f"{program.name}: {name!r} has width {w}, "
                             f"neither 1 nor {features}")
    widths = value_widths(program, in_widths, param_widths)
    out_dt = {**{n: inputs[n].dtype for n in program.inputs},
              **{v: st[-1] for v, st in steps.items()}}
    outs = [torch.empty((rows, widths[v]), device=device, dtype=out_dt[v])
            for v in program.outputs]
    kernel = _kernel(program, in_widths, param_widths, features, dtypes,
                     steps)
    sm = torch.cuda.get_device_properties(device).multi_processor_count
    row_bytes = sum(a.element_size() for a in flat if a.shape[-1] != 1)
    plan = launch_plan(rows, features, features, sm, row_bytes,
                       programs_per_sm=PROGRAMS_PER_SM)
    with torch.cuda.device(device):
        kernel[(plan.n_prog,)](
            *flat, *pflat, *outs, rows, plan.n_sub, plan.n_prog, F=features,
            R_SUB=plan.r_sub, BLOCK_F=plan.block_f,
            LOOP_STAGES=plan.loop_stages, num_warps=plan.num_warps)
    fused_rows.launches += 1
    return {v: o.reshape(*lead, o.shape[-1])
            for v, o in zip(program.outputs, outs)}


fused_rows.launches = 0
