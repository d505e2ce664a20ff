"""Per-op VJP rules for the BrainSlug IR, on torch tensors.

Ported from ``repro/core/autodiff.py``: one explicit VJP rule per
optimizable ``OpKind``, written in plain PyTorch.  The rules run on whole
tensors, which makes them the plain version of the two backward kernels
(:func:`repro_torch.kernels.fused_stack.rows_bwd.fused_rows_bwd_ref`,
:func:`repro_torch.kernels.fused_stack.nhwc_bwd.fused_nhwc_bwd_ref`) and
the formulas the kernels implement.  They are *not* ``torch.autograd`` of
the forward: the CPU tests hold them against the JAX package's rules, and
the card holds the kernels against them.

Max-pool tie convention: the **first** maximal element in row-major window
order takes the whole cotangent (XLA's ``select_and_scatter``).  Avg-pool
cotangents are spread uniformly at ``g / (kh * kw)`` (count-include-pad, as
the forward divides).  Binary max/min split exact ties 0.5 / 0.5.

``op_vjp`` consumes the recomputed forward environment (every value of the
program); parameter cotangents are reduced over the leading axes to the
parameter's own shape and cast to its dtype.
"""
from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F

from repro_torch.core import ir

Tensor = torch.Tensor

_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def _d_gelu_tanh(x: Tensor, y: Tensor) -> Tensor:
    del y
    u = _SQRT_2_OVER_PI * (x + 0.044715 * x * x * x)
    t = torch.tanh(u)
    du = _SQRT_2_OVER_PI * (1.0 + 3.0 * 0.044715 * x * x)
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * du


def _d_gelu_exact(x: Tensor, y: Tensor) -> Tensor:
    del y
    phi = torch.exp(-0.5 * x * x) * _INV_SQRT_2PI
    cdf = 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))
    return cdf + x * phi


def _d_silu(x: Tensor, y: Tensor) -> Tensor:
    del y
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


#: fn name -> d/dx as ``dfn(x, y)`` with ``y = f(x)``.
_UNARY_DERIVS = {
    "relu": lambda x, y: (x > 0).to(x.dtype),
    "relu6": lambda x, y: ((x > 0) & (x < 6)).to(x.dtype),
    "squared_relu": lambda x, y: 2.0 * torch.clamp_min(x, 0.0),
    "gelu": _d_gelu_tanh,
    "gelu_exact": _d_gelu_exact,
    "silu": _d_silu,
    "sigmoid": lambda x, y: y * (1.0 - y),
    "tanh": lambda x, y: 1.0 - y * y,
    "exp": lambda x, y: y,
    "abs": lambda x, y: torch.sign(x),
    "square": lambda x, y: 2.0 * x,
    "identity": lambda x, y: torch.ones_like(x),
    "neg": lambda x, y: -torch.ones_like(x),
    "softplus": lambda x, y: torch.sigmoid(x),
}

#: OpKinds these rules (and the generated backward kernels) differentiate.
DIFFERENTIABLE_KINDS = frozenset({
    ir.OpKind.EW_UNARY, ir.OpKind.EW_BINARY, ir.OpKind.AFFINE,
    ir.OpKind.ROW_NORM, ir.OpKind.ROW_SOFTMAX, ir.OpKind.POOL2D,
})

#: Binary fns :func:`_binary_vjp` has a rule for.
BINARY_VJP_FNS = frozenset({"add", "sub", "mul", "div", "max", "min"})


def supports(program: ir.StackProgram) -> bool:
    """True when every op of ``program`` has a VJP rule here (the generated
    backward kernels can take the program end to end)."""
    return all(op.kind in DIFFERENTIABLE_KINDS and
               (op.kind != ir.OpKind.EW_UNARY or op.fn in _UNARY_DERIVS) and
               (op.kind != ir.OpKind.EW_BINARY or op.fn in BINARY_VJP_FNS)
               for op in program.ops)


# ---------------------------------------------------------------------------
# Helpers.
# ---------------------------------------------------------------------------

def _reduce_to(grad: Tensor, target: Tensor,
               row_mask: Tensor | None = None) -> Tensor:
    """Sum-reduce ``grad`` down to ``target``'s shape (undo broadcasting)
    and cast to its dtype.  ``row_mask`` zeroes the contribution of rows
    (or tile positions) outside the data *before* the reduction, so a
    NaN/inf primal recomputed there cannot poison the sum (0 * nan)."""
    if row_mask is not None:
        grad = torch.where(row_mask, grad, 0.0)
    shape = tuple(target.shape)
    extra = grad.dim() - len(shape)
    if extra > 0:
        grad = grad.sum(dim=tuple(range(extra)))
    keep = tuple(i for i, d in enumerate(shape)
                 if d == 1 and grad.shape[i] != 1)
    if keep:
        grad = grad.sum(dim=keep, keepdim=True)
    return grad.to(target.dtype)


def _balanced_max_mask(a: Tensor, b: Tensor, bigger: bool) -> Tensor:
    """Sub-gradient split of max/min: the winner takes the cotangent, exact
    ties split it evenly."""
    win = (a > b) if bigger else (a < b)
    tie = a == b
    return torch.where(win, 1.0, torch.where(tie, 0.5, 0.0))


# ---------------------------------------------------------------------------
# Per-op rules.
# ---------------------------------------------------------------------------

def op_vjp(op: ir.OpNode, env: Mapping[str, Tensor],
           params: Mapping[str, Tensor], g: Tensor,
           row_mask: Tensor | None = None
           ) -> tuple[dict[str, Tensor], dict[str, Tensor]]:
    """Cotangents of one op: ``g`` is the cotangent of ``op.output``;
    returns (input-value cotangents, parameter cotangents), keyed by name
    and not yet accumulated across consumers."""
    ins = [env[v] for v in op.inputs]
    ps = [params[p] for p in op.params]

    if op.kind == ir.OpKind.EW_UNARY:
        x = ins[0]
        dx = g * _UNARY_DERIVS[op.fn](x, env[op.output])
        return {op.inputs[0]: dx.to(x.dtype)}, {}

    if op.kind == ir.OpKind.EW_BINARY:
        a = ins[0]
        b = ps[0] if ps else ins[1]
        da, db = _binary_vjp(op.fn, a, b, g)
        # the validity mask guards reduced (broadcast) value operands
        y_shape = tuple(env[op.output].shape)

        def _vmask(operand):
            return row_mask if tuple(operand.shape) != y_shape else None

        din = {op.inputs[0]: _reduce_to(da, a, _vmask(a))}
        dparams: dict[str, Tensor] = {}
        if ps:
            dparams[op.params[0]] = _reduce_to(db, b, row_mask)
        else:
            key = op.inputs[1]           # x + x accumulates both cotangents
            d = _reduce_to(db, b, _vmask(b))
            din[key] = din[key] + d if key in din else d
        return din, dparams

    if op.kind == ir.OpKind.AFFINE:
        x = ins[0]
        scale, bias = ps
        return ({op.inputs[0]: _reduce_to(g * scale, x)},
                {op.params[0]: _reduce_to(g * x, scale, row_mask),
                 op.params[1]: _reduce_to(g, bias, row_mask)})

    if op.kind == ir.OpKind.ROW_NORM:
        return _row_norm_vjp(op, ins[0], ps, g, row_mask)

    if op.kind == ir.OpKind.ROW_SOFTMAX:
        y = env[op.output]
        dot = torch.sum(g * y, dim=-1, keepdim=True)
        return {op.inputs[0]: (y * (g - dot)).to(ins[0].dtype)}, {}

    if op.kind == ir.OpKind.POOL2D:
        # whole tensors: pad with the neutral element, run the patch rule,
        # crop the padding back off
        x = ins[0]
        ph, pw = op.attrs["padding"]
        xp = F.pad(x, (0, 0, pw, pw, ph, ph),
                   value=pool_neutral(x.dtype, op.fn))
        dxp = pool2d_patch_vjp(op, xp, env[op.output], g)
        if ph or pw:
            h, w = x.shape[-3], x.shape[-2]
            dxp = dxp[..., ph: ph + h, pw: pw + w, :]
        return {op.inputs[0]: dxp}, {}

    raise NotImplementedError(
        f"no VJP rule for op kind {op.kind} (op {op.name!r})")


def _binary_vjp(fn: str, a: Tensor, b: Tensor, g: Tensor
                ) -> tuple[Tensor, Tensor]:
    if fn == "add":
        return g, g
    if fn == "sub":
        return g, -g
    if fn == "mul":
        return g * b, g * a
    if fn == "div":
        return g / b, -g * a / (b * b)
    if fn == "max":
        m = _balanced_max_mask(a, b, bigger=True)
        return g * m, g * (1.0 - m)
    if fn == "min":
        m = _balanced_max_mask(a, b, bigger=False)
        return g * m, g * (1.0 - m)
    raise NotImplementedError(f"no VJP rule for binary fn {fn!r}")


def pool_neutral(dtype: torch.dtype, fn: str) -> float:
    """The pool's padding value: what an out-of-image position holds so the
    windowed reduction reproduces the layer's own padding."""
    if fn == "max":
        return (torch.finfo(dtype).min if dtype.is_floating_point
                else torch.iinfo(dtype).min)
    return 0.0


def pool2d_patch_vjp(op: ir.OpNode, x: Tensor, y: Tensor, g: Tensor
                     ) -> Tensor:
    """VJP of one POOL2D over a *pre-padded* input ``x`` (out-of-image
    positions hold :func:`pool_neutral`), spatial axes at ``(-3, -2)``;
    ``y``/``g`` are the output and its cotangent.  Contributions of window
    offset ``(di, dj)`` are added in row-major offset order."""
    kh, kw = op.attrs["window"]
    sh, sw = op.attrs["stride"]
    oh, ow = g.shape[-3], g.shape[-2]
    dx = torch.zeros_like(x)

    def window(t: Tensor, di: int, dj: int) -> Tensor:
        return t[..., di: di + (oh - 1) * sh + 1: sh,
                 dj: dj + (ow - 1) * sw + 1: sw, :]

    if op.fn == "avg":
        c = (g / float(kh * kw)).to(x.dtype)
        for di in range(kh):
            for dj in range(kw):
                window(dx, di, dj).add_(c)
        return dx
    taken = torch.zeros(g.shape, dtype=torch.bool, device=g.device)
    for di in range(kh):
        for dj in range(kw):
            sel = (window(x, di, dj) == y) & ~taken
            taken = taken | sel
            window(dx, di, dj).add_(torch.where(sel, g, 0.0).to(x.dtype))
    return dx


def _row_norm_vjp(op: ir.OpNode, x: Tensor, ps: list[Tensor], g: Tensor,
                  row_mask: Tensor | None = None
                  ) -> tuple[dict[str, Tensor], dict[str, Tensor]]:
    """rms / layer norm backward, recomputing the float32 statistics as
    the forward does (same eps, same cast points)."""
    eps = op.attrs.get("eps", 1e-6)
    kind = op.attrs.get("norm", "rms")
    xf = x.float()
    if kind == "rms":
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        r = torch.rsqrt(var + eps)
        xhat_f = xf * r
    elif kind == "layer":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        r = torch.rsqrt(var + eps)
        xhat_f = (xf - mu) * r
    else:
        raise ValueError(f"unknown norm kind {kind!r}")
    xhat = xhat_f.to(x.dtype)

    dparams: dict[str, Tensor] = {}
    if ps:
        scale = ps[0]
        dparams[op.params[0]] = _reduce_to(g * xhat, scale, row_mask)
        if len(ps) > 1:
            dparams[op.params[1]] = _reduce_to(g, ps[1], row_mask)
        gy = (g * scale).float()
    else:
        gy = g.float()

    if kind == "rms":
        # y = x * r(x):  dx = r*gy - x * r^3 * mean(gy*x)
        dxf = r * gy - xf * (r * r * r) * torch.mean(gy * xf, dim=-1,
                                                     keepdim=True)
    else:
        m1 = torch.mean(gy, dim=-1, keepdim=True)
        m2 = torch.mean(gy * xhat_f, dim=-1, keepdim=True)
        dxf = r * (gy - m1 - xhat_f * m2)
    return {op.inputs[0]: dxf.to(x.dtype)}, dparams


# ---------------------------------------------------------------------------
# Whole-program reverse sweep.
# ---------------------------------------------------------------------------

def forward_env(program: ir.StackProgram, inputs: Mapping[str, Tensor],
                params: Mapping[str, Tensor]) -> dict[str, Tensor]:
    """Every value of ``program`` (inputs and all op outputs): the
    recomputed forward the reverse sweep consumes."""
    env = dict(inputs)
    for op in program.ops:
        env[op.output] = ir.apply_op(op, env, params)
    return env


def program_vjp(program: ir.StackProgram,
                env: Mapping[str, Tensor],
                params: Mapping[str, Tensor],
                gouts: Mapping[str, Tensor],
                row_mask: Tensor | None = None
                ) -> tuple[dict[str, Tensor], dict[str, Tensor]]:
    """Reverse-mode sweep over a whole program.  ``env`` holds every value
    (:func:`forward_env`), ``gouts`` the cotangent of each program output.
    Returns cotangents for ``program.inputs`` and ``program.param_names``."""
    cot: dict[str, Tensor] = dict(gouts)
    dparams: dict[str, Tensor] = {}
    for op in reversed(program.ops):
        g = cot.pop(op.output, None)
        if g is None:                       # output never used downstream
            continue
        din, dp = op_vjp(op, env, params, g, row_mask)
        for v, d in din.items():
            cot[v] = cot[v] + d if v in cot else d
        for p, d in dp.items():
            dparams[p] = dparams[p] + d if p in dparams else d

    dins: dict[str, Tensor] = {}
    for v in program.inputs:
        d = cot.get(v)
        dins[v] = torch.zeros_like(env[v]) if d is None else d
    for p in program.param_names:
        if p not in dparams:
            dparams[p] = torch.zeros_like(params[p])
    return dins, dparams
