"""BrainSlug op-level IR, on torch tensors.

A ``StackProgram`` is an ordered SSA list of :class:`OpNode` over named
values, in one of two layouts:

* ``rows`` — tensors are ``(..., features)``; every op is element-wise or
  row-local (reductions only over the trailing feature axis).
* ``nhwc`` — tensors are ``(N, H, W, C)``; pooling ops consume spatial
  neighbourhoods.

:func:`run_program` is the single interpreter of op semantics.  It is the
``barrier``/``xla`` schedule and the plain version every generated kernel is
held against.  Its numerics follow ``repro.core.ir`` exactly: ``gelu`` is the
tanh approximation, ``gelu_exact`` uses erf, ``softplus`` is
``logaddexp(x, 0)``, ``ROW_NORM`` computes in float32 and casts back, and
average pooling divides by the full window (``count_include_pad``).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Mapping

import torch
import torch.nn.functional as F


class OpKind(enum.Enum):
    # ---- optimizable (BrainSlug-collapsible) ----------------------------
    EW_UNARY = "ew_unary"        # y = f(x)
    EW_BINARY = "ew_binary"      # y = f(a, b)   (b may be a param or a value)
    AFFINE = "affine"            # y = x * scale + bias    (feature-wise)
    ROW_NORM = "row_norm"        # rmsnorm / layernorm over trailing axis
    ROW_SOFTMAX = "row_softmax"  # softmax over trailing axis
    POOL2D = "pool2d"            # max / avg spatial pooling   (nhwc layout)
    # ---- non-optimizable (left to the framework / dedicated kernels) ----
    MATMUL = "matmul"
    CONV2D = "conv2d"
    ATTENTION = "attention"
    SSD = "ssd"
    EMBED = "embed"
    KERNEL = "kernel"            # a traced region the kernel registry
    # (repro_torch.core.registry) rewrote onto a dedicated kernel; attrs
    # carry the kernel id, the operand slots and the static arguments
    OPAQUE = "opaque"            # anything else (kept as a black box)


#: OpKinds the analyzer pulls into a stack (paper step 1).
OPTIMIZABLE_KINDS = frozenset({
    OpKind.EW_UNARY, OpKind.EW_BINARY, OpKind.AFFINE, OpKind.ROW_NORM,
    OpKind.ROW_SOFTMAX, OpKind.POOL2D,
})

#: OpKinds that are element-wise in the paper's sense; everything
#: optimizable but not element-wise forces a new step (paper §4.1).
ELEMENTWISE_KINDS = frozenset({OpKind.EW_UNARY, OpKind.EW_BINARY, OpKind.AFFINE})


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


UNARY_FNS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": torch.relu,
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "squared_relu": lambda x: torch.square(torch.relu(x)),
    "gelu": _gelu_tanh,
    "gelu_exact": F.gelu,
    "silu": F.silu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "exp": torch.exp,
    "abs": torch.abs,
    "square": torch.square,
    "identity": lambda x: x,
    "neg": torch.neg,
    "softplus": _softplus,
}

BINARY_FNS: dict[str, Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
    "max": torch.maximum,
    "min": torch.minimum,
}


@dataclasses.dataclass(frozen=True)
class OpNode:
    """One operation in a stack program (SSA form)."""

    kind: OpKind
    name: str                       # unique within the program
    inputs: tuple[str, ...]         # value names consumed
    output: str                     # value name produced
    fn: str | None = None           # for EW_UNARY / EW_BINARY / POOL2D ('max'|'avg')
    params: tuple[str, ...] = ()    # parameter names consumed (broadcast over rows)
    attrs: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def is_optimizable(self) -> bool:
        return self.kind in OPTIMIZABLE_KINDS

    @property
    def is_elementwise(self) -> bool:
        return self.kind in ELEMENTWISE_KINDS

    def validate(self) -> None:
        if self.kind == OpKind.EW_UNARY and self.fn not in UNARY_FNS:
            raise ValueError(f"unknown unary fn {self.fn!r} in op {self.name!r}")
        if self.kind == OpKind.EW_BINARY and self.fn not in BINARY_FNS:
            raise ValueError(f"unknown binary fn {self.fn!r} in op {self.name!r}")
        if self.kind == OpKind.POOL2D:
            if self.fn not in ("max", "avg"):
                raise ValueError(f"pool2d fn must be max|avg, got {self.fn!r}")
            for key in ("window", "stride", "padding"):
                if key not in self.attrs:
                    raise ValueError(f"pool2d op {self.name!r} missing attr {key!r}")


@dataclasses.dataclass(frozen=True)
class StackProgram:
    """A chain of optimizable ops — the paper's *stack* abstraction.

    ``inputs`` are the externally supplied value names; ``params`` the
    parameter names; ``outputs`` the values that escape the stack.
    ``layout`` selects the resource/codegen model.
    """

    name: str
    inputs: tuple[str, ...]
    outputs: tuple[str, ...]
    ops: tuple[OpNode, ...]
    layout: str = "rows"            # 'rows' | 'nhwc'

    def __post_init__(self) -> None:
        if self.layout not in ("rows", "nhwc"):
            raise ValueError(f"bad layout {self.layout!r}")
        defined = set(self.inputs)
        for op in self.ops:
            op.validate()
            for v in op.inputs:
                if v not in defined:
                    raise ValueError(
                        f"{self.name}: op {op.name!r} reads undefined value {v!r}")
            if op.output in defined:
                raise ValueError(f"{self.name}: value {op.output!r} redefined")
            defined.add(op.output)
        for v in self.outputs:
            if v not in defined:
                raise ValueError(f"{self.name}: output {v!r} never defined")

    @property
    def param_names(self) -> tuple[str, ...]:
        seen: list[str] = []
        for op in self.ops:
            for p in op.params:
                if p not in seen:
                    seen.append(p)
        return tuple(seen)

    def signature(self) -> tuple:
        """Structural hash key: identical stacks share generated code
        ("If there are multiple equivalent stacks, BRAINSLUG only generates
        the code once")."""
        return (
            self.layout, self.inputs, self.outputs,
            tuple((o.kind.value, o.fn, o.inputs, o.output, o.params,
                   tuple(sorted((k, _freeze(v)) for k, v in o.attrs.items())))
                  for o in self.ops),
        )


def _freeze(v: Any) -> Any:
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    return v


@dataclasses.dataclass(frozen=True)
class NetGraph:
    """A linear network of ops; residual edges are saved-value inputs to
    later ops, which keeps the graph linear (paper Fig. 4/5)."""

    name: str
    input: str
    output: str
    ops: tuple[OpNode, ...]

    def __post_init__(self) -> None:
        defined = {self.input}
        for op in self.ops:
            for v in op.inputs:
                if v not in defined:
                    raise ValueError(
                        f"{self.name}: op {op.name!r} reads undefined value {v!r}")
            if op.output in defined:
                raise ValueError(
                    f"{self.name}: value {op.output!r} redefined by op "
                    f"{op.name!r}")
            defined.add(op.output)
        if self.output not in defined:
            raise ValueError(f"{self.name}: output {self.output!r} never defined")


# ---------------------------------------------------------------------------
# Interpreter — the single source of op semantics.
# ---------------------------------------------------------------------------

def apply_op(op: OpNode, env: Mapping[str, torch.Tensor],
             params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Execute one op given an environment of named values."""
    ins = [env[v] for v in op.inputs]
    ps = [params[p] for p in op.params]

    if op.kind == OpKind.EW_UNARY:
        return UNARY_FNS[op.fn](ins[0])

    if op.kind == OpKind.EW_BINARY:
        other = ps[0] if ps else ins[1]
        return BINARY_FNS[op.fn](ins[0], other)

    if op.kind == OpKind.AFFINE:
        scale, bias = ps
        return ins[0] * scale + bias

    if op.kind == OpKind.ROW_NORM:
        x = ins[0]
        xf = x.float()
        eps = op.attrs.get("eps", 1e-6)
        kind = op.attrs.get("norm", "rms")
        if kind == "rms":
            var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
            y = (xf * torch.rsqrt(var + eps)).to(x.dtype)
        elif kind == "layer":
            mu = torch.mean(xf, dim=-1, keepdim=True)
            var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
            y = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
        else:
            raise ValueError(f"unknown norm kind {kind!r}")
        if ps:                                   # optional scale (+ bias)
            y = y * ps[0]
            if len(ps) > 1:
                y = y + ps[1]
        return y

    if op.kind == OpKind.ROW_SOFTMAX:
        return torch.softmax(ins[0], dim=-1)

    if op.kind == OpKind.POOL2D:
        return _pool2d(ins[0], op)

    # ---- opaque (non-optimizable) kinds: executed breadth-first ----------
    if op.kind == OpKind.MATMUL:
        y = ins[0] @ ps[0]
        if len(ps) > 1:
            y = y + ps[1]
        return y

    if op.kind == OpKind.CONV2D:
        # The IR keeps NHWC activations and HWIO weights; F.conv2d reads
        # them through permuted views (channels_last memory), and the
        # result is permuted back to NHWC.
        w = ps[0].permute(3, 2, 0, 1)               # HWIO -> OIHW
        y = F.conv2d(ins[0].permute(0, 3, 1, 2), w,
                     stride=tuple(op.attrs.get("stride", (1, 1))),
                     padding=tuple(op.attrs.get("padding", (0, 0))))
        y = y.permute(0, 2, 3, 1)
        if len(ps) > 1:
            y = y + ps[1]
        return y.contiguous()

    if op.kind == OpKind.EMBED:
        return ps[0][ins[0]]

    if op.kind == OpKind.OPAQUE and "fn" in op.attrs:
        return op.attrs["fn"](*ins, *ps)

    if op.kind == OpKind.KERNEL:
        # the interpreter runs the registry entry's plain version; compiled
        # networks decide kernel or plain version once, in
        # repro_torch.core.codegen.compile_kernel_op
        from repro_torch.core import registry   # registry imports ir
        return registry.apply_ref(op, env, params)

    raise NotImplementedError(f"apply_op cannot execute kind {op.kind}")


def _pool2d(x: torch.Tensor, op: OpNode) -> torch.Tensor:
    """NHWC max/avg pooling with explicit padding (paper layer type 2):
    max pads with ``-inf``, avg pads with 0 and divides by the full window
    (``count_include_pad``); the output extent is floored."""
    kh, kw = op.attrs["window"]
    sh, sw = op.attrs["stride"]
    ph, pw = op.attrs["padding"]
    xc = x.permute(0, 3, 1, 2)                       # NCHW view
    if op.fn == "max":
        fill = (-torch.inf if x.dtype.is_floating_point
                else torch.iinfo(x.dtype).min)
        xc = F.pad(xc, (pw, pw, ph, ph), value=fill)
        y = F.max_pool2d(xc, (kh, kw), (sh, sw))
    else:
        xc = F.pad(xc, (pw, pw, ph, ph), value=0.0)
        y = F.avg_pool2d(xc, (kh, kw), (sh, sw))
    return y.permute(0, 2, 3, 1).contiguous()


def run_program(program: StackProgram,
                env: Mapping[str, torch.Tensor],
                params: Mapping[str, torch.Tensor],
                *,
                barrier: bool = False) -> dict[str, torch.Tensor]:
    """Interpret ``program``.  With ``barrier=True`` every op output is
    materialised as its own contiguous tensor before the next op reads it:
    the paper's breadth-first baseline (eager PyTorch already runs one
    kernel per op; the barrier also forces views into memory)."""
    env = dict(env)
    for op in program.ops:
        out = apply_op(op, env, params)
        if barrier:
            out = out.contiguous()
        env[op.output] = out
    return {v: env[v] for v in program.outputs}


# ---------------------------------------------------------------------------
# Shape inference (resource model + planning).
# ---------------------------------------------------------------------------

def pool_out_extent(extent: int, k: int, s: int, p: int) -> int:
    return (extent + 2 * p - k) // s + 1


def pool_in_extent(out_extent: int, k: int, s: int) -> int:
    """Input extent a depth-first tile needs to produce ``out_extent``
    outputs (receptive-field growth)."""
    return (out_extent - 1) * s + k


def infer_shapes(program: StackProgram,
                 input_shapes: Mapping[str, tuple[int, ...]]
                 ) -> dict[str, tuple[int, ...]]:
    """Propagate shapes through a program (params assumed broadcastable)."""
    shapes: dict[str, tuple[int, ...]] = dict(input_shapes)
    for op in program.ops:
        if op.kind == OpKind.POOL2D:
            n, h, w, c = shapes[op.inputs[0]]
            kh, kw = op.attrs["window"]
            sh, sw = op.attrs["stride"]
            ph, pw = op.attrs["padding"]
            shapes[op.output] = (n, pool_out_extent(h, kh, sh, ph),
                                 pool_out_extent(w, kw, sw, pw), c)
        elif op.kind == OpKind.EW_BINARY and not op.params:
            a, b = shapes[op.inputs[0]], shapes[op.inputs[1]]
            shapes[op.output] = tuple(
                max(x, y) for x, y in zip((1,) * (len(b) - len(a)) + tuple(a),
                                          (1,) * (len(a) - len(b)) + tuple(b)))
        else:
            shapes[op.output] = shapes[op.inputs[0]]
    return shapes
