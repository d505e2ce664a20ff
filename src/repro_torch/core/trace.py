"""Transparent frontend: lift plain PyTorch functions into the BrainSlug IR.

The paper's front ends parse unmodified framework networks (Listing 3,
``brainslug.optimize(model)`` on a stock network).  :func:`trace` takes a
plain PyTorch callable and example tensors, captures it with ``torch.fx``
(``make_fx`` on the real example tensors, at the pre-dispatch aten level:
Python control flow over dict keys and shapes read in Python run as they
do in the function, and ``matmul``, ``conv2d``, the pools and the norms
arrive as one aten op each), and lifts the aten ops it recognises into
:class:`~repro_torch.core.ir.OpNode`\\ s.  Whatever it does not recognise
stays an ``OPAQUE`` op carrying a replay closure (``attrs["fn"]``):
tracing never rejects a function, it captures less of it.

Lifting rules (a failed constraint leaves the op ``OPAQUE``):

* relu, relu6 / hardtanh(0, 6), gelu (erf and tanh), silu, sigmoid,
  softplus (beta 1), tanh, exp, abs, neg, square -> ``EW_UNARY``;
* add, sub, mul, div, maximum, minimum -> ``EW_BINARY``: a value with a
  value of the output's shape, or with a parameter-like operand (an input
  leaf, a constant or a Python scalar whose leading dims are all 1);
* a per-channel ``mul`` then ``add`` on parameter-like operands, and an
  eval ``batch_norm`` -> ``AFFINE`` (batch norm's scale and shift are
  *derived parameters*, recomputed from its four vectors at every call);
* max and avg pools -> ``POOL2D``; conv2d -> ``CONV2D`` (HWIO weight);
* ``x * rsqrt(mean(x^2) + eps)`` (rms), its layer-norm twin, ``rms_norm``
  and ``layer_norm`` over the trailing axis -> ``ROW_NORM``;
* a trailing-axis softmax -> ``ROW_SOFTMAX`` (any other axis stays opaque);
* ``matmul`` / ``mm`` / ``linear`` against a 2-D weight -> ``MATMUL``.

**Layout glue.**  The IR is NHWC; PyTorch's convolutions and pools are
NCHW.  A conv or pool reached through ``permute(0, 3, 1, 2)`` (and, for a
pool, a symmetric constant pad of ``-inf`` or 0) and read back through
``permute(0, 2, 3, 1)`` folds, glue included, into the one ``CONV2D`` or
``POOL2D`` it spells.  Any other layout stays opaque.

**Gradient fences.**  ``detach`` (PyTorch's ``stop_gradient``) stays an
``OPAQUE`` op, and no structural rule walks through it: a fenced
subgraph is never lifted into a differentiable op.  Ops under
``torch.no_grad()`` replay under it, opaque.  A user
``torch.autograd.Function`` (PyTorch's ``custom_vjp``) is captured as one
opaque call site, never inlined, so its own backward runs: while tracing,
``Function.apply`` is routed through the custom op
``repro_torch::autograd_function_call``, and the replay closure calls the
function's ``apply`` again.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import operator
from typing import Any, Callable, Sequence

import torch
import torch.fx
import torch.utils._pytree as pytree

from repro_torch.core import ir

__all__ = ["trace", "TraceResult"]


# ---------------------------------------------------------------------------
# Capture.
# ---------------------------------------------------------------------------

#: ``key -> [Function subclass, argument template, returns one tensor]``
#: for the ``autograd.Function`` calls of the trace in progress.
_AF_CALLS: dict[int, list] = {}
_AF_KEYS = itertools.count()
_AF_OP = None
_ORIG_APPLY = torch.autograd.Function.__dict__["apply"]


@dataclasses.dataclass(frozen=True)
class _Slot:
    """A placeholder in an argument template: the ``i``-th tensor of its
    kind (``"t"`` a captured tensor, ``"in"`` an env value, ``"p"`` a
    parameter)."""

    kind: str
    i: int


def _template(args: Any, tensors: list) -> Any:
    """``args`` with every tensor replaced by a :class:`_Slot` ("t") that
    indexes the tensors appended to ``tensors``."""
    if isinstance(args, torch.Tensor):
        tensors.append(args)
        return _Slot("t", len(tensors) - 1)
    if isinstance(args, (list, tuple)):
        return type(args)(_template(a, tensors) for a in args)
    if isinstance(args, dict):
        return {k: _template(v, tensors) for k, v in args.items()}
    return args


def _fill(template: Any, lookup: Callable[[_Slot], Any]) -> Any:
    """The inverse of :func:`_template`: every slot replaced by
    ``lookup(slot)``; lists and tuples (fx's immutable ones included) come
    back as plain lists and tuples."""
    if isinstance(template, _Slot):
        return lookup(template)
    if isinstance(template, tuple):
        return tuple(_fill(a, lookup) for a in template)
    if isinstance(template, list):
        return [_fill(a, lookup) for a in template]
    if isinstance(template, dict):
        return {k: _fill(v, lookup) for k, v in template.items()}
    return template


def _as_tuple(out: Any) -> tuple:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _af_op():
    """The custom op a traced ``Function.apply`` becomes, defined once on
    first use (defining it registers an operator process-wide)."""
    global _AF_OP
    if _AF_OP is None:
        @torch.library.custom_op("repro_torch::autograd_function_call",
                                 mutates_args=())
        def autograd_function_call(tensors: list[torch.Tensor],
                                   key: int) -> list[torch.Tensor]:
            call = _AF_CALLS[key]
            args = _fill(call[1], lambda s: tensors[s.i])
            with torch.no_grad():
                out = _ORIG_APPLY.__func__(call[0], *args)
            call[2] = isinstance(out, torch.Tensor)
            return [o.clone() for o in _as_tuple(out)]

        _AF_OP = autograd_function_call
    return _AF_OP


def _traced_apply(cls, *args, **kwargs):
    if kwargs:
        raise TypeError(f"{cls.__name__}.apply: keyword arguments are not "
                        f"traced")
    tensors: list = []
    template = _template(args, tensors)
    key = next(_AF_KEYS)
    _AF_CALLS[key] = [cls, template, False]
    outs = _af_op()(tensors, key)
    return outs[0] if _AF_CALLS[key][2] else tuple(outs)


def _capture(fn: Callable, leaves: list[torch.Tensor], in_tree):
    """(fx graph module, output tree spec, autograd.Function calls)."""
    from torch.fx.experimental.proxy_tensor import make_fx
    store: dict[str, Any] = {}

    def flat_fn(*flat):
        out = fn(*pytree.tree_unflatten(list(flat), in_tree))
        out_leaves, store["out_tree"] = pytree.tree_flatten(out)
        return out_leaves

    first = next(_AF_KEYS)
    torch.autograd.Function.apply = classmethod(_traced_apply)
    try:
        gm = make_fx(flat_fn, tracing_mode="real", pre_dispatch=True)(
            *leaves)
    finally:
        torch.autograd.Function.apply = _ORIG_APPLY
        calls = {k: _AF_CALLS.pop(k) for k in list(_AF_CALLS) if k > first}
    return gm, store["out_tree"], calls


# ---------------------------------------------------------------------------
# Trace result.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TraceResult:
    """A plain PyTorch callable lifted into the BrainSlug graph IR.

    ``graph`` is a :class:`~repro_torch.core.ir.NetGraph`.  The first
    flattened input leaf is the graph input (value ``arg0``); every leaf is
    also the runtime parameter ``arg{i}``; captured constants are bound in
    ``const_params``; ``derived_params`` maps a parameter name to
    ``(fn, source parameter names)``, computed from its sources at every
    call (batch norm's scale and shift, a linear layer's transposed
    weight).  ``out_refs`` says where each output leaf comes from:
    ``("env", value)``, ``("leaf", i)`` or ``("const", tensor)``."""

    graph: ir.NetGraph
    shapes: dict[str, tuple[int, ...]]        # value name -> shape
    dtypes: dict[str, torch.dtype]            # value name -> dtype
    param_shapes: dict[str, tuple[int, ...]]  # param name -> shape
    param_dtypes: dict[str, torch.dtype]      # param name -> dtype
    const_params: dict[str, torch.Tensor]
    derived_params: dict[str, tuple[Callable, tuple[str, ...]]]
    leaf_avals: tuple                         # (shape, dtype) per leaf
    in_tree: Any
    out_tree: Any
    out_refs: tuple
    input_name: str
    device: torch.device                      # the example tensors'

    def bind_params(self, leaves: Sequence[torch.Tensor]
                    ) -> dict[str, torch.Tensor]:
        """The parameter dict of one call on ``leaves``."""
        params = dict(self.const_params)
        for i, leaf in enumerate(leaves):
            params[f"arg{i}"] = leaf
        for name, (fn, srcs) in self.derived_params.items():
            params[name] = fn(*(params[s] for s in srcs))
        return params


# ---------------------------------------------------------------------------
# Lifting tables and shape rules.
# ---------------------------------------------------------------------------

_UNARY = {"relu": "relu", "relu6": "relu6", "silu": "silu",
          "sigmoid": "sigmoid", "tanh": "tanh", "exp": "exp", "abs": "abs",
          "neg": "neg", "square": "square"}
_BINARY = {"add": "add", "sub": "sub", "mul": "mul", "div": "div",
           "maximum": "max", "minimum": "min"}
_COMMUTATIVE = frozenset({"add", "mul", "max", "min"})
_NHWC_TO_NCHW = [0, 3, 1, 2]
_NCHW_TO_NHWC = [0, 2, 3, 1]


def _is_param_like(shape: Sequence[int]) -> bool:
    """Shapes the generated kernels accept as (1, C)-broadcast parameters."""
    shape = tuple(shape)
    return len(shape) <= 1 or all(d == 1 for d in shape[:-1])


def _liftable(shape: Sequence[int]) -> bool:
    """Shapes stacks can tile: rank >= 1 and non-empty."""
    shape = tuple(shape)
    return len(shape) >= 1 and 0 not in shape


def _opname(node: torch.fx.Node) -> str:
    t = node.target
    if isinstance(t, torch._ops.OpOverload):
        if t.namespace == "repro_torch":
            return "autograd_function"
        return t.overloadpacket.__name__
    if t is operator.getitem:
        return "getitem"
    return getattr(t, "__name__", str(t))


def _bind(node: torch.fx.Node) -> dict[str, Any]:
    """An aten node's arguments by schema name, defaults filled in."""
    out: dict[str, Any] = {}
    for i, a in enumerate(node.target._schema.arguments):
        if i < len(node.args):
            out[a.name] = node.args[i]
        elif a.name in node.kwargs:
            out[a.name] = node.kwargs[a.name]
        elif a.has_default_value():
            out[a.name] = a.default_value
        else:
            out[a.name] = None
    return out


def _pair(v: Any, default: Any = None) -> tuple[int, int] | None:
    if v is None or (isinstance(v, (list, tuple)) and len(v) == 0):
        return _pair(default) if default is not None else None
    if isinstance(v, int):
        return (v, v)
    v = tuple(v)
    if len(v) == 1:
        return (int(v[0]), int(v[0]))
    if len(v) == 2 and all(isinstance(e, int) for e in v):
        return (int(v[0]), int(v[1]))
    return None


def _trailing(dims: Any, ndim: int) -> bool:
    """``dims`` names exactly the trailing axis."""
    if isinstance(dims, int):
        dims = [dims]
    return (isinstance(dims, (list, tuple)) and len(dims) == 1
            and dims[0] % ndim == ndim - 1)


def _scalar(v: Any) -> float | None:
    if isinstance(v, bool):
        return None
    if isinstance(v, (int, float)):
        return float(v)
    return None


@dataclasses.dataclass
class _Group:
    """A multi-node idiom matched in the pre-pass: ``interior`` nodes are
    absorbed, ``build()`` emits the one op at ``root``'s position."""

    interior: set
    build: Callable[[], ir.OpNode]


# ---------------------------------------------------------------------------
# The builder: fx nodes -> OpNodes.
# ---------------------------------------------------------------------------

class _Builder:
    def __init__(self, gm: torch.fx.GraphModule, calls: dict) -> None:
        self.gm = gm
        self.nodes = list(gm.graph.nodes)
        self.calls = calls
        self.leaf_index: dict[torch.fx.Node, int] = {}
        self.const: dict[torch.fx.Node, Any] = {}
        self.grad_on: dict[torch.fx.Node, bool] = {}
        self.val_name: dict[torch.fx.Node, str] = {}
        self.holders: set = set()
        self.groups: dict[torch.fx.Node, _Group] = {}
        self.claimed: set = set()
        self.ops: list[ir.OpNode] = []
        self.shapes: dict[str, tuple[int, ...]] = {}
        self.dtypes: dict[str, torch.dtype] = {}
        self.const_params: dict[str, torch.Tensor] = {}
        self.param_shapes: dict[str, tuple[int, ...]] = {}
        self.param_dtypes: dict[str, torch.dtype] = {}
        self.derived: dict[str, tuple[Callable, tuple[str, ...]]] = {}
        self._const_names: dict[Any, str] = {}
        self._names = itertools.count()
        self.device = None

        grad = True
        for node in self.nodes:
            if node.op == "placeholder":
                i = len(self.leaf_index)
                self.leaf_index[node] = i
                val = node.meta["val"]
                self.param_shapes[f"arg{i}"] = tuple(val.shape)
                self.param_dtypes[f"arg{i}"] = val.dtype
                if i == 0:
                    self.val_name[node] = "arg0"
                    self.shapes["arg0"] = tuple(val.shape)
                    self.dtypes["arg0"] = val.dtype
            elif node.op == "get_attr":
                self.const[node] = getattr(gm, node.target)
            elif node.op == "call_function":
                if node.target is torch._C._set_grad_enabled:
                    grad = bool(node.args[0])
                    continue
                self.grad_on[node] = grad
                self._fold(node)

    # -- constants -----------------------------------------------------------

    def _fold(self, node: torch.fx.Node) -> None:
        """Evaluate a node whose inputs are all constants (an iota-built
        mask, ``torch.tensor`` literals), so it becomes a constant."""
        if "val" not in node.meta or node.meta["val"] is None:
            return
        if not all(n in self.const for n in node.all_input_nodes):
            return
        t = node.target
        if isinstance(t, torch._ops.OpOverload):
            if torch.Tag.nondeterministic_seeded in t.tags \
                    or t.namespace == "repro_torch":
                return
        elif t is not operator.getitem:
            return
        args = torch.fx.node.map_arg(node.args, lambda n: self.const[n])
        kwargs = torch.fx.node.map_arg(node.kwargs, lambda n: self.const[n])
        with torch.no_grad():
            self.const[node] = t(*args, **kwargs)

    def _const_param(self, key: Any, value: torch.Tensor) -> str:
        name = self._const_names.get(key)
        if name is None:
            name = f"c{next(self._names)}"
            self.const_params[name] = value
            self.param_shapes[name] = tuple(value.shape)
            self.param_dtypes[name] = value.dtype
            self._const_names[key] = name
        return name

    # -- node properties -----------------------------------------------------

    def aval(self, n: Any) -> tuple[tuple[int, ...], torch.dtype] | None:
        if isinstance(n, torch.fx.Node):
            v = self.const.get(n, n.meta.get("val"))
            if isinstance(v, torch.Tensor):
                return tuple(v.shape), v.dtype
        return None

    def is_tensor_value(self, n: Any) -> bool:
        """A non-constant tensor node: a leaf, or computed from one."""
        return (isinstance(n, torch.fx.Node) and n not in self.const
                and self.aval(n) is not None)

    def float_value(self, n: Any, shape: tuple | None = None,
                    dtype: torch.dtype | None = None) -> bool:
        if not self.is_tensor_value(n):
            return False
        s, d = self.aval(n)
        return (d.is_floating_point and _liftable(s)
                and (shape is None or s == tuple(shape))
                and (dtype is None or d == dtype))

    def sole(self, n: Any, user: torch.fx.Node) -> bool:
        """``n`` is a computed node consumed only by ``user``, outside any
        no-grad region and not yet absorbed: safe to absorb into a group."""
        return (isinstance(n, torch.fx.Node) and n.op == "call_function"
                and n not in self.const and n not in self.leaf_index
                and set(n.users) == {user} and self.grad_on.get(n, False)
                and n not in self.claimed and n not in self.groups)

    def is_op(self, n: Any, *names: str) -> bool:
        return (isinstance(n, torch.fx.Node) and n.op == "call_function"
                and isinstance(n.target, torch._ops.OpOverload)
                and _opname(n) in names)

    def permute_of(self, n: Any, dims: list[int]):
        """The input of ``n`` when ``n`` is ``permute(input, dims)``."""
        if self.is_op(n, "permute") and list(_bind(n)["dims"]) == dims:
            return _bind(n)["self"]
        return None

    def param_source(self, o: Any, like: bool = True) -> bool:
        """``o`` can ride as a parameter: an input leaf, a constant or a
        Python scalar (with ``like``, of a parameter-like shape)."""
        if _scalar(o) is not None:
            return True
        if not isinstance(o, torch.fx.Node) or self.aval(o) is None:
            return False
        if o not in self.leaf_index and o not in self.const:
            return False
        return not like or _is_param_like(self.aval(o)[0])

    def as_param(self, o: Any) -> str:
        if _scalar(o) is not None:
            value = torch.tensor(_scalar(o), device=self.device)
            return self._const_param(("scalar", _scalar(o)), value)
        if o in self.leaf_index:
            return f"arg{self.leaf_index[o]}"
        return self._const_param(o, self.const[o])

    def derived_param(self, fn: Callable, srcs: tuple[str, ...],
                      shape: tuple[int, ...], dtype: torch.dtype) -> str:
        name = f"d{next(self._names)}"
        self.derived[name] = (fn, srcs)
        self.param_shapes[name] = tuple(shape)
        self.param_dtypes[name] = dtype
        return name

    # -- emission helpers ----------------------------------------------------

    def _fresh(self, hint: str = "v") -> str:
        return f"{hint}{next(self._names)}"

    def _op_name(self, hint: str) -> str:
        return f"{hint}_{next(self._names)}"

    def _append(self, op: ir.OpNode, shape, dtype=None) -> None:
        self.ops.append(op)
        self.shapes[op.output] = tuple(shape)
        if dtype is not None:
            self.dtypes[op.output] = dtype

    def _emit_for(self, node: torch.fx.Node, op: ir.OpNode) -> None:
        shape, dtype = self.aval(node) or ((), None)   # () for a non-tensor
        self._append(op, shape, dtype)
        self.val_name[node] = op.output

    def ensure_value(self, n: torch.fx.Node) -> str:
        """Env-value name for ``n``, emitting a bind op for a leaf or a
        constant read as a value."""
        if n in self.val_name:
            return self.val_name[n]
        pname = self.as_param(n)
        shape, dtype = self.aval(n)
        vname = self._fresh()
        self._append(ir.OpNode(
            ir.OpKind.OPAQUE, self._op_name("bind"), (), vname,
            params=(pname,), attrs={"fn": _identity, "out_shape": shape,
                                    "synthetic": True}), shape, dtype)
        if n in self.leaf_index:
            self.val_name[n] = vname
        return vname

    def lifted(self, node: torch.fx.Node, kind: ir.OpKind, hint: str,
               inputs: Sequence[torch.fx.Node], params: Sequence[str] = (),
               fn: str | None = None, attrs: dict | None = None
               ) -> ir.OpNode:
        return ir.OpNode(kind, self._op_name(hint),
                         tuple(self.ensure_value(x) for x in inputs),
                         self._fresh(), fn=fn, params=tuple(params),
                         attrs=attrs or {})

    # -- pre-pass: multi-node idioms -----------------------------------------

    def match_groups(self) -> None:
        for node in self.nodes:
            if (node.op != "call_function" or node in self.const
                    or not self.grad_on.get(node, False)
                    or node in self.claimed):
                continue
            # a layer norm is an rms norm of the centred value: try it first
            for rule in (self._g_conv, self._g_pool, self._g_batch_norm,
                         self._g_affine, self._g_layer, self._g_rms):
                group = rule(node)
                if group is not None:
                    self.groups[node] = group
                    self.claimed |= group.interior
                    break

    def _g_conv(self, root):
        """permute(0,2,3,1) of conv2d(permute(0,3,1,2) of x, permute(3,2,
        0,1) of an HWIO weight) -> CONV2D."""
        c = self.permute_of(root, _NCHW_TO_NHWC)
        if not self.sole(c, root) or not self.is_op(c, "conv2d",
                                                     "convolution"):
            return None
        a = _bind(c)
        if self.is_op(c, "convolution") and (
                a["transposed"] or any(a["output_padding"])):
            return None
        xp, wp, bias = a["input"], a["weight"], a["bias"]
        x = self.permute_of(xp, _NHWC_TO_NCHW)
        w = self.permute_of(wp, [3, 2, 0, 1])
        out_shape, out_dtype = self.aval(root)
        if (x is None or w is None or not self.float_value(x, dtype=out_dtype)
                or len(self.aval(x)[0]) != 4
                or not self.param_source(w, like=False)
                or (bias is not None and not self.param_source(bias))):
            return None
        kh, kw, cin, cout = self.aval(w)[0]
        stride = _pair(a["stride"])
        padding = a["padding"]
        if padding == "valid":
            padding = (0, 0)
        elif padding == "same":
            if stride != (1, 1) or kh % 2 == 0 or kw % 2 == 0:
                return None
            padding = ((kh - 1) // 2, (kw - 1) // 2)
        padding = _pair(padding)
        if (stride is None or padding is None
                or _pair(a["dilation"]) != (1, 1) or a["groups"] != 1):
            return None
        interior = {c} | {p for p in (xp, wp) if self.sole(p, c)}

        def build():
            params = (self.as_param(w),) + (
                (self.as_param(bias),) if bias is not None else ())
            return self.lifted(root, ir.OpKind.CONV2D, "conv", (x,), params,
                               attrs={"kernel_shape": (kh, kw, cin, cout),
                                      "stride": stride, "padding": padding})
        return _Group(interior, build)

    def _g_pool(self, root):
        """permute(0,2,3,1) of a max/avg pool of (a symmetric constant pad
        of) permute(0,3,1,2) of x -> POOL2D."""
        po = self.permute_of(root, _NCHW_TO_NHWC)
        if not self.sole(po, root):
            return None
        interior = {po}
        if po.target is operator.getitem:
            core = po.args[0]
            # max_pool2d_with_indices: its indices must go unread
            if (po.args[1] != 0
                    or not self.is_op(core, "max_pool2d_with_indices")
                    or core in self.claimed or core in self.groups
                    or not self.grad_on.get(core, False)
                    or any(u is not po and u.users for u in core.users)):
                return None
            interior |= {core, *core.users}
            fn = "max"
        elif self.is_op(po, "max_pool2d", "avg_pool2d"):
            core = po
            fn = "max" if self.is_op(po, "max_pool2d") else "avg"
        else:
            return None
        a = _bind(core)
        window = _pair(a["kernel_size"])
        stride = _pair(a["stride"], a["kernel_size"])
        padding = _pair(a["padding"])
        if window is None or stride is None or padding is None \
                or a["ceil_mode"]:
            return None
        if fn == "max" and _pair(a["dilation"]) != (1, 1):
            return None
        if fn == "avg" and (not a["count_include_pad"]
                            or a["divisor_override"] is not None):
            return None
        ph, pw = padding
        pin, reader = a["self"], core
        if self.is_op(pin, "pad", "constant_pad_nd"):
            if not self.sole(pin, core):
                return None
            b = _bind(pin)
            pad = list(b["pad"])
            value = 0.0 if b["value"] is None else float(b["value"])
            if self.is_op(pin, "pad") and b["mode"] != "constant":
                return None
            want = float("-inf") if fn == "max" else 0.0
            if (len(pad) not in (4, 8) or any(pad[4:]) or pad[0] != pad[1]
                    or pad[2] != pad[3] or value != want):
                return None             # asymmetric, or another pad value
            ph, pw = ph + pad[2], pw + pad[0]
            interior.add(pin)
            pin, reader = b["self"], pin
        x = self.permute_of(pin, _NHWC_TO_NCHW)
        out_shape, out_dtype = self.aval(root)
        if x is None or not self.float_value(x, dtype=out_dtype) \
                or len(self.aval(x)[0]) != 4:
            return None
        n, h, w, ch = self.aval(x)[0]
        if out_shape != (n, ir.pool_out_extent(h, window[0], stride[0], ph),
                         ir.pool_out_extent(w, window[1], stride[1], pw), ch):
            return None
        if self.sole(pin, reader):
            interior.add(pin)

        def build():
            return self.lifted(root, ir.OpKind.POOL2D, f"{fn}pool", (x,),
                               fn=fn, attrs={"window": window,
                                             "stride": stride,
                                             "padding": (ph, pw)})
        return _Group(interior, build)

    def _g_batch_norm(self, root):
        """Eval ``batch_norm`` -> AFFINE: on NHWC through the permutes, or on
        (N, C) rows directly.  Scale and shift are derived parameters."""
        if self.is_op(root, "batch_norm"):
            bn, nhwc = root, False
        else:
            bn, nhwc = self.permute_of(root, _NCHW_TO_NHWC), True
            if not self.sole(bn, root) or not self.is_op(bn, "batch_norm"):
                return None
        a = _bind(bn)
        if a["training"]:
            return None
        out_shape, out_dtype = self.aval(root)
        xin = a["input"]
        x = self.permute_of(xin, _NHWC_TO_NCHW) if nhwc else xin
        if x is None or not self.float_value(x, out_shape, out_dtype) \
                or len(out_shape) != (4 if nhwc else 2):
            return None
        vecs = [a["weight"], a["bias"], a["running_mean"], a["running_var"]]
        c = out_shape[-1]
        if vecs[2] is None or vecs[3] is None or any(
                v is not None and (not self.param_source(v)
                                   or self.aval(v) != ((c,), out_dtype))
                for v in vecs):
            return None
        eps = float(a["eps"])
        has_w, has_b = vecs[0] is not None, vecs[1] is not None
        interior = {bn} if nhwc else set()
        if nhwc and self.sole(xin, bn):
            interior.add(xin)

        def build():
            srcs = tuple(self.as_param(v) for v in vecs if v is not None)
            s_srcs = tuple(self.as_param(v) for v in (vecs[0], vecs[3])
                           if v is not None)
            scale = self.derived_param(
                _bn_scale(eps, has_w), s_srcs, (c,), out_dtype)
            shift = self.derived_param(
                _bn_shift(eps, has_w, has_b), srcs, (c,), out_dtype)
            return self.lifted(root, ir.OpKind.AFFINE, "batchnorm", (x,),
                               (scale, shift))
        return _Group(interior, build)

    def _g_affine(self, root):
        """add(mul(x, s), b) with parameter-like s and b -> AFFINE."""
        if not self.is_op(root, "add") or _bind(root).get("alpha", 1) != 1:
            return None
        out_shape, out_dtype = self.aval(root)
        if not out_dtype.is_floating_point or not _liftable(out_shape):
            return None
        ops = [root.args[0], root.args[1]]
        for u, b in (ops, ops[::-1]):
            if not self.sole(u, root) or not self.is_op(u, "mul") \
                    or not self.param_source(b):
                continue
            for x, s in (u.args[:2], u.args[1::-1]):
                if self.float_value(x, out_shape, out_dtype) \
                        and self.param_source(s):
                    return _Group({u}, lambda x=x, s=s, b=b: self.lifted(
                        root, ir.OpKind.AFFINE, "affine", (x,),
                        (self.as_param(s), self.as_param(b))))
        return None

    def _rsqrt_var(self, r, user, features: int):
        """(t, eps, interior) of ``r = rsqrt(mean(t^2, -1, keepdim) + eps)``
        consumed only by ``user``."""
        if not self.sole(r, user) or not self.is_op(r, "rsqrt"):
            return None
        a = r.args[0]
        if not self.sole(a, r) or not self.is_op(a, "add") \
                or _bind(a).get("alpha", 1) != 1:
            return None
        for m, e in (a.args[:2], a.args[1::-1]):
            eps = _scalar(e)
            if eps is None or not self.sole(m, a):
                continue
            t_sq = self._mean_of(m, features)
            if t_sq is None or not self.sole(t_sq, m):
                continue
            t = self._square_of(t_sq)
            if t is not None:
                return t, eps, {r, a, m, t_sq}
        return None

    def _mean_of(self, m, features: int):
        """The input of ``m = mean(input, -1, keepdim=True)``."""
        if not self.is_op(m, "mean") or len(m.args) < 2:
            return None
        a = _bind(m)
        shape = self.aval(m)[0]
        if not a["keepdim"] or a.get("dtype") is not None \
                or not _trailing(a["dim"], len(shape)) \
                or shape[-1:] != (1,) or self.aval(a["self"])[0][-1] \
                != features:
            return None
        return a["self"]

    def _square_of(self, q):
        if self.is_op(q, "square"):
            return q.args[0]
        if self.is_op(q, "pow") and len(q.args) == 2 and _scalar(
                q.args[1]) == 2.0:
            return q.args[0]
        if self.is_op(q, "mul") and q.args[0] is q.args[1]:
            return q.args[0]
        return None

    def _g_rms(self, root):
        """mul(x, rsqrt(mean(x^2, -1, keepdim) + eps)) -> ROW_NORM rms."""
        if not self.is_op(root, "mul"):
            return None
        out_shape, out_dtype = self.aval(root)
        if not out_dtype.is_floating_point or not _liftable(out_shape):
            return None
        for x, r in (root.args[:2], root.args[1::-1]):
            got = self._rsqrt_var(r, root, out_shape[-1])
            if got is None or got[0] is not x \
                    or not self.float_value(x, out_shape, out_dtype):
                continue
            eps = got[1]
            return _Group(got[2], lambda x=x, eps=eps: self.lifted(
                root, ir.OpKind.ROW_NORM, "rmsnorm", (x,),
                attrs={"norm": "rms", "eps": eps}))
        return None

    def _g_layer(self, root):
        """mul(f, rsqrt(mean(f^2) + eps)) with f = x - mean(x, -1, keepdim)
        -> ROW_NORM layer."""
        if not self.is_op(root, "mul"):
            return None
        out_shape, out_dtype = self.aval(root)
        if not out_dtype.is_floating_point or not _liftable(out_shape):
            return None
        for f, r in (root.args[:2], root.args[1::-1]):
            got = self._rsqrt_var(r, root, out_shape[-1])
            if got is None or got[0] is not f or not self.is_op(f, "sub") \
                    or _bind(f).get("alpha", 1) != 1:
                continue
            t, eps, interior = got
            sq = next(n for n in interior if self._square_of(n) is f)
            if (set(f.users) != {sq, root} or f in self.claimed
                    or not self.grad_on.get(f, False)):
                continue
            x, mu = f.args[:2]
            if not self.sole(mu, f) or self._mean_of(mu, out_shape[-1]) \
                    is not x or not self.float_value(x, out_shape, out_dtype):
                continue
            return _Group(interior | {f, mu}, lambda x=x, eps=eps:
                          self.lifted(root, ir.OpKind.ROW_NORM, "layernorm",
                                      (x,), attrs={"norm": "layer",
                                                   "eps": eps}))
        return None

    # -- single nodes --------------------------------------------------------

    def lift_single(self, node: torch.fx.Node) -> ir.OpNode | None:
        if not isinstance(node.target, torch._ops.OpOverload):
            return None
        aval = self.aval(node)
        if aval is None:
            return None
        shape, dtype = aval
        if not dtype.is_floating_point or not _liftable(shape):
            return None
        name = _opname(node)
        a = _bind(node)
        x = a.get("self", a.get("input"))
        unary = _UNARY.get(name)
        if name == "hardtanh" and (_scalar(a["min_val"]),
                                   _scalar(a["max_val"])) == (0.0, 6.0):
            unary = "relu6"
        elif name == "gelu":
            unary = "gelu" if a["approximate"] == "tanh" else "gelu_exact"
        elif name == "softplus" and _scalar(a["beta"]) == 1.0:
            unary = "softplus"
        elif name == "pow" and len(node.args) == 2 \
                and _scalar(node.args[1]) == 2.0:
            unary = "square"
        if unary is not None and len(node.all_input_nodes) == 1:
            if not self.float_value(x, shape, dtype):
                return None
            return self.lifted(node, ir.OpKind.EW_UNARY, unary, (x,),
                               fn=unary)
        if name in _BINARY and a.get("alpha", 1) == 1 \
                and a.get("rounding_mode") is None and len(node.args) == 2:
            return self._lift_binary(node, _BINARY[name], shape, dtype)
        if name in ("softmax", "_softmax"):
            if (_trailing(a["dim"], len(shape)) and not a.get("half_to_float")
                    and a.get("dtype") in (None, dtype)
                    and self.float_value(x, shape, dtype)):
                return self.lifted(node, ir.OpKind.ROW_SOFTMAX, "softmax",
                                   (x,))
            return None
        if name in ("rms_norm", "layer_norm"):
            return self._lift_norm(node, name, a, shape, dtype)
        if name in ("matmul", "mm", "linear"):
            return self._lift_matmul(node, name, a, shape, dtype)
        return None

    def _lift_binary(self, node, fn, shape, dtype):
        x, y = node.args
        if self.float_value(x, shape, dtype) and \
                self.float_value(y, shape, dtype):
            return self.lifted(node, ir.OpKind.EW_BINARY, fn, (x, y), fn=fn)
        if self.float_value(x, shape, dtype) and self.param_source(y):
            return self.lifted(node, ir.OpKind.EW_BINARY, fn, (x,),
                               (self.as_param(y),), fn=fn)
        if fn in _COMMUTATIVE and self.float_value(y, shape, dtype) \
                and self.param_source(x):
            return self.lifted(node, ir.OpKind.EW_BINARY, fn, (y,),
                               (self.as_param(x),), fn=fn)
        return None

    def _lift_norm(self, node, name, a, shape, dtype):
        x = a["input"]
        if not self.float_value(x, shape, dtype) \
                or list(a["normalized_shape"]) != [shape[-1]]:
            return None
        vecs = [a["weight"]] + ([a["bias"]] if name == "layer_norm" else [])
        if vecs[-1] is not None and vecs[0] is None:
            return None
        vecs = [v for v in vecs if v is not None]
        if not all(self.param_source(v) and self.aval(v)[0][-1:]
                   == (shape[-1],) for v in vecs):
            return None
        eps = a["eps"]
        if eps is None:                  # rms_norm's default
            eps = torch.finfo(dtype).eps
        norm = "rms" if name == "rms_norm" else "layer"
        return self.lifted(node, ir.OpKind.ROW_NORM, f"{norm}norm", (x,),
                           tuple(self.as_param(v) for v in vecs),
                           attrs={"norm": norm, "eps": float(eps)})

    def _lift_matmul(self, node, name, a, shape, dtype):
        x = a.get("self", a.get("input"))
        w = a.get("other", a.get("mat2", a.get("weight")))
        if not self.float_value(x, dtype=dtype) \
                or not self.param_source(w, like=False):
            return None
        w_shape, w_dtype = self.aval(w)
        if len(w_shape) != 2 or w_dtype != dtype:
            return None
        if name != "linear":
            return self.lifted(node, ir.OpKind.MATMUL, "matmul", (x,),
                               (self.as_param(w),),
                               attrs={"features_out": w_shape[-1]})
        bias = a["bias"]
        if bias is not None and not (self.param_source(bias)
                                     and self.aval(bias)[1] == dtype):
            return None
        wt = self.derived_param(_transpose, (self.as_param(w),),
                                w_shape[::-1], dtype)
        params = (wt,) + ((self.as_param(bias),) if bias is not None else ())
        return self.lifted(node, ir.OpKind.MATMUL, "linear", (x,), params,
                           attrs={"features_out": w_shape[0]})

    # -- OPAQUE fallback -----------------------------------------------------

    def emit_opaque(self, node: torch.fx.Node) -> None:
        in_names: list[str] = []
        p_names: list[str] = []
        slots: list[tuple] = []

        def slot(n: torch.fx.Node) -> _Slot:
            if n in self.val_name:
                in_names.append(self.val_name[n])
                slots.append(("in", in_names[-1]))
                return _Slot("in", len(in_names) - 1)
            if n in self.holders:
                raise AssertionError(f"{node.name} reads holder {n.name}")
            p_names.append(self.as_param(n))
            slots.append(("p", p_names[-1], None))
            return _Slot("p", len(p_names) - 1)

        args = torch.fx.node.map_arg(node.args, slot)
        kwargs = torch.fx.node.map_arg(node.kwargs, slot)
        name = _opname(node)
        grad = self.grad_on.get(node, True)
        target = node.target
        if name == "autograd_function":
            cls, template, _ = self.calls[node.args[1]]
            tensors = args[0]
            target = _af_replay(cls, template)
            args, kwargs = (tensors,), {}
        val = node.meta.get("val")
        multi = isinstance(val, (tuple, list))
        fn = _replay(target, args, kwargs, len(in_names), grad, multi)
        attrs = {"fn": fn, "prim": name, "prim_args": args,
                 "prim_kwargs": dict(kwargs), "operand_slots": tuple(slots)}
        if not multi:
            self._emit_for(node, ir.OpNode(
                ir.OpKind.OPAQUE, self._op_name(name), tuple(in_names),
                self._fresh(), params=tuple(p_names),
                attrs={**attrs, "out_shape": (self.aval(node) or ((),))[0]}))
            return
        # several results: a holder whose value is the tuple of results, and
        # one projection a result; the holder's recorded shape only feeds
        # byte accounting, so it counts the elements of every result
        holder = self._fresh("t")
        numel = sum(math.prod(v.shape) for v in val
                    if isinstance(v, torch.Tensor))
        self._append(ir.OpNode(
            ir.OpKind.OPAQUE, self._op_name(name), tuple(in_names), holder,
            params=tuple(p_names), attrs={**attrs, "out_shape": (numel,)}),
            (numel,))
        self.val_name[node] = holder
        self.holders.add(node)

    def emit_projection(self, node: torch.fx.Node) -> None:
        src, k = node.args
        self._emit_for(node, ir.OpNode(
            ir.OpKind.OPAQUE, self._op_name("proj"), (self.val_name[src],),
            self._fresh(), attrs={"fn": _Projection(k),
                                  "out_shape": (self.aval(node) or ((),))[0],
                                  "synthetic": True}))

    # -- main loop -----------------------------------------------------------

    def build(self) -> None:
        self.match_groups()
        for node in self.nodes:
            if (node.op != "call_function" or node in self.const
                    or node in self.claimed or node not in self.grad_on):
                continue
            val = node.meta.get("val")
            if val is None and node.target is not operator.getitem:
                continue                  # no result (a side effect only)
            if node in self.groups:
                self._emit_for(node, self.groups[node].build())
            elif node.target is operator.getitem \
                    and node.args[0] in self.holders:
                self.emit_projection(node)
            elif self.grad_on[node] and (op := self.lift_single(node)):
                self._emit_for(node, op)
            else:
                self.emit_opaque(node)


def _identity(p: torch.Tensor) -> torch.Tensor:
    return p


def _transpose(w: torch.Tensor) -> torch.Tensor:
    return w.t()


def _bn_scale(eps: float, has_w: bool) -> Callable:
    """``(weight?, running_var) -> weight / sqrt(running_var + eps)``."""
    def scale(*p):
        s = torch.rsqrt(p[-1] + eps)
        return p[0] * s if has_w else s
    return scale


def _bn_shift(eps: float, has_w: bool, has_b: bool) -> Callable:
    """``(weight?, bias?, running_mean, running_var) -> bias - running_mean
    * scale``."""
    def shift(*p):
        w = p[:1] if has_w else ()
        shift = -p[-2] * _bn_scale(eps, has_w)(*w, p[-1])
        return shift + p[int(has_w)] if has_b else shift
    return shift


@dataclasses.dataclass(frozen=True)
class _Projection:
    """One result of a several-result op's holder tuple."""

    k: int

    def __call__(self, t):
        return t[self.k]


def _af_replay(cls: type, template: Any) -> Callable:
    """Replays a captured ``autograd.Function`` call: its own ``apply``, so
    its own backward runs."""
    def call(tensors):
        return _ORIG_APPLY.__func__(cls, *_fill(template,
                                                 lambda s: tensors[s.i]))
    call.__qualname__ = f"{cls.__qualname__}.apply"
    return call


def _replay(target: Callable, args: Any, kwargs: Any, n_in: int,
            grad: bool, multi: bool) -> Callable:
    """The replay closure of an OPAQUE op: ``fn(*ins, *params)``."""
    def fn(*tensors):
        def lookup(s: _Slot):
            return tensors[s.i] if s.kind == "in" else tensors[n_in + s.i]
        a, k = _fill(args, lookup), _fill(kwargs, lookup)
        if grad:
            out = target(*a, **k)
        else:
            with torch.no_grad():
                out = target(*a, **k)
        return _as_tuple(out) if multi else out
    fn.__qualname__ = f"replay[{getattr(target, '__name__', target)}]"
    return fn


# ---------------------------------------------------------------------------
# Public entry point.
# ---------------------------------------------------------------------------

def trace(fn: Callable, *example_args) -> TraceResult:
    """Capture ``fn`` on ``example_args`` and lift it into a NetGraph.

    ``example_args`` may be any pytree of tensors; the graph is specialised
    to their shapes and dtypes.  Tracing never fails on an unrecognised op:
    it becomes OPAQUE."""
    leaves, in_tree = pytree.tree_flatten(example_args)
    if not leaves:
        raise ValueError("trace() needs at least one tensor argument")
    for i, leaf in enumerate(leaves):
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"trace(): argument leaf {i} is a "
                            f"{type(leaf).__name__}, not a tensor; pass "
                            f"static values by closure or keyword")
    gm, out_tree, calls = _capture(fn, [t.detach() for t in leaves], in_tree)
    builder = _Builder(gm, calls)
    builder.device = leaves[0].device
    builder.build()

    out_node = next(n for n in gm.graph.nodes if n.op == "output")
    out_refs: list[tuple] = []
    for o in out_node.args[0]:
        if not isinstance(o, torch.fx.Node):
            out_refs.append(("const", o))
        elif o in builder.const:
            out_refs.append(("const", builder.const[o]))
        elif o in builder.leaf_index:
            out_refs.append(("leaf", builder.leaf_index[o]))
        else:
            out_refs.append(("env", builder.val_name[o]))
    out_name = next((r for kind, r in out_refs if kind == "env"), "arg0")
    # drop ops whose values nothing reads (to a fixpoint: pruning one op
    # can orphan its producers)
    keep = {r for kind, r in out_refs if kind == "env"}
    ops = list(builder.ops)
    while True:
        consumed = {v for op in ops for v in op.inputs}
        live = [op for op in ops if op.output in consumed
                or op.output in keep]
        if len(live) == len(ops):
            break
        ops = live
    name = getattr(fn, "__name__", None) or "traced"
    graph = ir.NetGraph(name=f"traced_{name}", input="arg0",
                        output=out_name, ops=tuple(ops))
    used = {p for op in ops for p in op.params}
    derived = {k: v for k, v in builder.derived.items() if k in used}
    used |= {s for _, srcs in derived.values() for s in srcs}
    const_params = {k: v for k, v in builder.const_params.items()
                    if k in used}
    keep_params = set(const_params) | set(derived) | {
        f"arg{i}" for i in range(len(leaves))}
    return TraceResult(
        graph=graph, shapes=builder.shapes, dtypes=builder.dtypes,
        param_shapes={k: v for k, v in builder.param_shapes.items()
                      if k in keep_params},
        param_dtypes={k: v for k, v in builder.param_dtypes.items()
                      if k in keep_params},
        const_params=const_params, derived_params=derived,
        leaf_avals=tuple((tuple(t.shape), t.dtype) for t in leaves),
        in_tree=in_tree, out_tree=out_tree, out_refs=tuple(out_refs),
        input_name="arg0", device=leaves[0].device)
