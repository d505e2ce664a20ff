"""Kernel registry: traced backbone regions dispatch to dedicated kernels.

The depth-first stacks absorb element-wise, norm and pool chains; the port
also has hand-written Hopper kernels for whole backbone *regions* a stack
cannot express: flash attention (``softmax(q·kᵀ·s)·v``), fused RMSNorm, the
GLU gate and the vocab cross-entropy.  Without this module the traced
frontend would replay those regions as OPAQUE aten ops.

The registry sits between the tracer and codegen: structural matchers walk
the traced :class:`~repro_torch.core.ir.NetGraph`, recognise those regions
and replace each matched cluster with one ``OpKind.KERNEL`` op, which
:func:`repro_torch.core.codegen.compile_kernel_op` dispatches to the
kernel's wrapper in ``kernels/*/ops.py``.  Every entry has two backends:

* :attr:`KernelType.HOPPER`: the hand-written kernel (mode ``brainslug``);
  its wrapper's ``autograd.Function`` carries the backward, and
* :attr:`KernelType.REF`: the plain PyTorch version, taken when the
  kernel's own constraints fail (the reason is recorded and shown by
  ``report()``; a fallback is never silent) or in ``xla`` / ``barrier``
  mode; autograd differentiates it natively.

Entries whose cluster the stacks could absorb instead (rmsnorm, swiglu) are
claimed only when the kernel will run: a REF dispatch would replace a fused
stack with a plain call.  Attention and vocab-CE clusters are opaque ops
either way.

Every structural match is probe-verified: the claimed cluster runs,
forward and VJP with a non-uniform cotangent, on random float32 inputs of
the traced shapes, against the entry's plain version.  A ``detach`` or a
user ``autograd.Function`` is an opaque op no matcher walks through, and a
fence the walk did pass would fail the gradient probe.  A probe that
disagrees vetoes the rewrite and records a :class:`KernelVeto` with its
reason, which ``report()`` lists beside the dispatches; an error of the
device (out of memory, a failed launch) propagates.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable, Mapping

import torch

from repro_torch.core import ir
from repro_torch.kernels.attention import flash as flash_mod
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention import ref as attn_ref
from repro_torch.kernels.fused_stack.ops import DispatchStats
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm import ref as rms_ref
from repro_torch.kernels.rmsnorm import rmsnorm as rms_kernel
from repro_torch.kernels.swiglu import ops as swiglu_ops
from repro_torch.kernels.swiglu import ref as swiglu_ref
from repro_torch.kernels.swiglu import swiglu as swiglu_kernel
from repro_torch.kernels.vocab_ce import ce as ce_kernel
from repro_torch.kernels.vocab_ce import ops as ce_ops
from repro_torch.kernels.vocab_ce import ref as ce_ref

__all__ = ["KernelType", "KernelDispatch", "KernelEntry", "KernelMatch",
           "KernelVeto", "REGISTRY", "STATS", "rewrite", "plan_dispatch",
           "expected_out_shape"]


class KernelType(enum.Enum):
    """Which backend a KERNEL op runs."""

    HOPPER = "hopper"
    REF = "ref"


@dataclasses.dataclass(frozen=True)
class KernelDispatch:
    """The compile-time backend decision for one KERNEL op."""

    kernel: str
    backend: KernelType
    reason: str | None = None      # why REF runs, else None


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    """One registry row.  ``hopper(args, attrs)`` and ``ref(args, attrs)``
    take the operand tensors in the slot order the matcher recorded;
    ``constraints(arg_shapes, arg_dtypes, attrs)`` returns why the kernel
    cannot take these operands, or None.  ``vjp`` says where the backward
    comes from: ``"custom"``, the kernel wrapper's own
    ``autograd.Function`` (every entry here), or ``"ref"``, autograd of the
    plain version (``autodiff.with_ref_vjp``)."""

    name: str
    hopper: Callable[[list, Mapping], torch.Tensor]
    ref: Callable[[list, Mapping], torch.Tensor]
    constraints: Callable[[tuple, tuple, Mapping], str | None]
    stack_absorbable: bool = False
    vjp: str | None = "custom"


@dataclasses.dataclass(frozen=True)
class KernelMatch:
    """One rewrite: which ops were claimed, and what replaced them."""

    kernel: str
    root: int
    claimed: tuple[int, ...]
    op: ir.OpNode


@dataclasses.dataclass(frozen=True)
class KernelVeto:
    """A structural match the probe rejected: its ops stay as traced."""

    kernel: str
    op_name: str                # the cluster's root op
    reason: str


# ---------------------------------------------------------------------------
# Registry entries.
# ---------------------------------------------------------------------------

def _as_bhsd(x: torch.Tensor) -> torch.Tensor:
    """Lift a (B, S, D) single-head operand to the kernels' (B, H, S, D)."""
    return x if x.dim() == 4 else x[:, None]


def _attention_hopper(args: list, attrs: Mapping) -> torch.Tensor:
    q, k, v = args
    out = attn_ops.flash_attention(_as_bhsd(q), _as_bhsd(k), _as_bhsd(v),
                                   attrs["causal"], 128, 128, attrs["scale"])
    return out[:, 0] if q.dim() == 3 else out


def _attention_ref(args: list, attrs: Mapping) -> torch.Tensor:
    q, k, v = args
    out = attn_ref.attention_ref(_as_bhsd(q), _as_bhsd(k), _as_bhsd(v),
                                 causal=attrs["causal"], scale=attrs["scale"])
    return out[:, 0] if q.dim() == 3 else out


def _float_dtypes(dtypes: tuple, allowed) -> str | None:
    names = {str(d) for d in allowed}
    if len(set(dtypes)) != 1 or dtypes[0] not in names:
        return (f"operand dtypes {', '.join(dtypes)} are not one of "
                f"{sorted(names)}")
    return None


def _attention_constraints(shapes: tuple, dtypes: tuple,
                           attrs: Mapping) -> str | None:
    q, k, v = shapes
    if not flash_mod.supports_head_dim(q[-1]):
        return (f"head_dim {q[-1]} is not one of the kernel's "
                f"{flash_mod.HEAD_DIMS}")
    if k != v:
        return f"k {k} and v {v} differ"
    if len(q) == 4 and q[1] % k[1]:
        return f"q heads {q[1]} not a multiple of kv heads {k[1]}"
    return _float_dtypes(dtypes, flash_mod.DTYPE_IDS)


def _rmsnorm_hopper(args: list, attrs: Mapping) -> torch.Tensor:
    x, g = args
    return rms_ops.rmsnorm(x, g.reshape(-1), None, attrs["eps"])[0]


def _rmsnorm_ref(args: list, attrs: Mapping) -> torch.Tensor:
    x, g = args
    return rms_ref.rmsnorm_ref(x, g.reshape(-1), None, eps=attrs["eps"])[0]


def _rmsnorm_constraints(shapes: tuple, dtypes: tuple,
                         attrs: Mapping) -> str | None:
    if math.prod(shapes[1]) != shapes[0][-1]:
        return f"scale {shapes[1]} is not ({shapes[0][-1]},)"
    return _float_dtypes(dtypes[:1], rms_kernel.DTYPES)


def _swiglu_hopper(args: list, attrs: Mapping) -> torch.Tensor:
    return swiglu_ops.swiglu(args[0], args[1], attrs["act"])


def _swiglu_ref(args: list, attrs: Mapping) -> torch.Tensor:
    return swiglu_ref.swiglu_ref(args[0], args[1], act=attrs["act"])


def _swiglu_constraints(shapes: tuple, dtypes: tuple,
                        attrs: Mapping) -> str | None:
    if shapes[0] != shapes[1]:
        return f"gate {shapes[0]} and up {shapes[1]} differ"
    return _float_dtypes(dtypes, swiglu_kernel.DTYPES)


def _vocab_ce_hopper(args: list, attrs: Mapping) -> torch.Tensor:
    h, w, labels = args
    return ce_ops.fused_gold_logp(h, w, labels.reshape(-1))


def _vocab_ce_ref(args: list, attrs: Mapping) -> torch.Tensor:
    h, w, labels = args
    return ce_ref.gold_logp_ref(h, w, labels.reshape(-1))


def _vocab_ce_constraints(shapes: tuple, dtypes: tuple,
                          attrs: Mapping) -> str | None:
    return _float_dtypes(dtypes[:2], ce_kernel.DTYPE_IDS)


REGISTRY: dict[str, KernelEntry] = {
    "attention": KernelEntry("attention", _attention_hopper, _attention_ref,
                             _attention_constraints),
    "rmsnorm": KernelEntry("rmsnorm", _rmsnorm_hopper, _rmsnorm_ref,
                           _rmsnorm_constraints, stack_absorbable=True),
    "swiglu": KernelEntry("swiglu", _swiglu_hopper, _swiglu_ref,
                          _swiglu_constraints, stack_absorbable=True),
    "vocab_ce": KernelEntry("vocab_ce", _vocab_ce_hopper, _vocab_ce_ref,
                            _vocab_ce_constraints),
}

#: Per call of a compiled KERNEL op: ``<kernel>_hopper`` (the kernel on a
#: CUDA tensor), ``<kernel>_plain`` (a HOPPER dispatch on a CPU tensor: the
#: wrapper runs the kernel's plain version) or ``<kernel>_ref``.
STATS = DispatchStats(keys=tuple(
    f"{name}_{kind}" for name in REGISTRY
    for kind in ("hopper", "plain", "ref")))


def expected_out_shape(kernel: str, arg_shapes: tuple) -> tuple | None:
    """Each kernel's output-shape contract, re-derived from its argument
    shapes: the static verifier's independent check on a KERNEL op's
    recorded ``out_shape``.  None means the contract fixes only the element
    count (vocab_ce emits one loss per gathered index; the traced gather
    decides the layout)."""
    if kernel in ("rmsnorm", "swiglu") and arg_shapes:
        return tuple(arg_shapes[0])
    if kernel == "attention" and len(arg_shapes) == 3:
        # softmax(q k^T) v: q's leading and sequence dims, v's head dim
        return tuple(arg_shapes[0][:-1]) + (arg_shapes[2][-1],)
    return None


def get(name: str) -> KernelEntry:
    return REGISTRY[name]


def plan_dispatch(op: ir.OpNode, mode: str) -> KernelDispatch:
    """The compile-time backend decision for one KERNEL op."""
    entry = REGISTRY[op.attrs["kernel"]]
    if mode != "brainslug":
        return KernelDispatch(entry.name, KernelType.REF,
                              f"mode={mode} runs the plain version")
    reason = entry.constraints(op.attrs["arg_shapes"], op.attrs["arg_dtypes"],
                               op.attrs)
    if reason is not None:
        return KernelDispatch(entry.name, KernelType.REF, reason)
    return KernelDispatch(entry.name, KernelType.HOPPER, None)


def slot_tensors(op: ir.OpNode, env: Mapping[str, torch.Tensor],
                 params: Mapping[str, torch.Tensor]) -> list[torch.Tensor]:
    """A KERNEL op's operands in slot order."""
    return [env[s[1]] if s[0] == "in" else params[s[1]]
            for s in op.attrs["slots"]]


def apply_ref(op: ir.OpNode, env: Mapping[str, torch.Tensor],
              params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The interpreter's semantics of a KERNEL op: the entry's plain
    version (:func:`repro_torch.core.ir.apply_op` calls this)."""
    entry = REGISTRY[op.attrs["kernel"]]
    out = entry.ref(slot_tensors(op, env, params), op.attrs)
    return out.reshape(op.attrs["out_shape"]).to(op.attrs["out_dtype"])


# ---------------------------------------------------------------------------
# Matching context over a traced NetGraph.
# ---------------------------------------------------------------------------

class _Ctx:
    def __init__(self, tr, mode: str) -> None:
        self.tr = tr
        self.mode = mode
        self.ops: list[ir.OpNode] = list(tr.graph.ops)
        self.shapes = tr.shapes
        self.const_params = tr.const_params
        self.claimed: set[int] = set()
        self.vetoes: dict[tuple[str, int], KernelVeto] = {}
        self.producer: dict[str, int] = {}
        self.consumers: dict[str, set[int]] = {}
        for i, op in enumerate(self.ops):
            self.producer[op.output] = i
            for v in op.inputs:
                self.consumers.setdefault(v, set()).add(i)
        self.keep = frozenset(ref for kind, ref in tr.out_refs
                              if kind == "env")

    def value_aval(self, name: str) -> tuple[tuple[int, ...], torch.dtype]:
        return tuple(self.shapes[name]), self.tr.dtypes.get(name,
                                                            torch.float32)

    def param_aval(self, pname: str):
        if pname not in self.tr.param_shapes:
            return None
        return (tuple(self.tr.param_shapes[pname]),
                self.tr.param_dtypes[pname])

    def slot_aval(self, slot: tuple):
        return (self.value_aval(slot[1]) if slot[0] == "in"
                else self.param_aval(slot[1]))

    def sole_producer(self, name: str, from_idx: int):
        """(op, index) producing ``name`` when only ``from_idx`` reads it
        and it is no traced output."""
        i = self.producer.get(name)
        if (i is None or i in self.claimed or name in self.keep
                or self.consumers.get(name, set()) != {from_idx}):
            return None
        return self.ops[i], i

    def producer_op(self, name: str) -> ir.OpNode | None:
        i = self.producer.get(name)
        return None if i is None else self.ops[i]

    def cluster_closed(self, claimed: set[int], root: int) -> bool:
        """No interior value of the cluster is read outside it."""
        for i in claimed - {root}:
            out = self.ops[i].output
            if out in self.keep or not self.consumers.get(out, set()) \
                    <= claimed:
                return False
        return True


def _prim(op: ir.OpNode) -> str | None:
    return op.attrs.get("prim") if op.kind == ir.OpKind.OPAQUE else None


def _plain_call(op: ir.OpNode) -> bool:
    """An opaque op called with its operand slots and no keyword other
    than ``alpha=1``."""
    kwargs = op.attrs.get("prim_kwargs", {})
    return all(k == "alpha" and v == 1 for k, v in kwargs.items())


def _causal_mask_kind(mask: torch.Tensor, sq: int, sk: int) -> str | None:
    """'causal' for a lower-triangular 0 / very negative additive mask,
    'none' for an all-zero one, None for anything else."""
    m = mask.detach().double().cpu()
    while m.dim() > 2 and m.shape[0] == 1:
        m = m[0]
    if m.dim() != 2 or tuple(m.shape) != (sq, sk) or sq != sk:
        return None
    if bool((m == 0).all()):
        return "none"
    lower = torch.tril(torch.ones(sq, sk, dtype=torch.bool))
    if bool((m[lower] == 0).all()) and bool((m[~lower] <= -1e9).all()):
        return "causal"
    return None


# ---------------------------------------------------------------------------
# Probe verification (forward and gradient).
# ---------------------------------------------------------------------------

def _cluster_fn(ctx: _Ctx, claimed: set[int], root_out: str,
                slots: tuple) -> Callable:
    cluster_ops = [ctx.ops[i] for i in sorted(claimed)]

    def f(*tensors):
        env: dict[str, torch.Tensor] = {}
        params: dict[str, torch.Tensor] = dict(ctx.const_params)
        for slot, t in zip(slots, tensors):
            (env if slot[0] == "in" else params)[slot[1]] = t
        for op in cluster_ops:
            env[op.output] = ir.apply_op(op, env, params)
        return env[root_out]

    return f


def _close(a: torch.Tensor, b: torch.Tensor, tol: float) -> bool:
    return a.shape == b.shape and bool(torch.allclose(
        a.float(), b.float(), rtol=tol, atol=tol))


#: What a probe may raise where the cluster does not compute what the
#: entry's plain version does (an operand it cannot take); every other
#: error, and any error of the device, propagates.
_MISMATCH_ERRORS = (RuntimeError, TypeError, ValueError, IndexError)
_DEVICE_ERRORS = (torch.cuda.OutOfMemoryError, torch.AcceleratorError)


def _probe_verify(ctx: _Ctx, claimed: set[int], root_out: str,
                  slots: tuple, entry: KernelEntry, attrs: Mapping,
                  tensors: list[torch.Tensor]) -> str | None:
    """Does the cluster compute, and differentiate, what the entry's plain
    version does on these probe inputs?  None where it does, else why not.
    The gradient probe's cotangent is not uniform, so a fence that zeroes
    part of the backward shows."""
    f = _cluster_fn(ctx, claimed, root_out, slots)
    diff = [i for i, t in enumerate(tensors) if t.is_floating_point()]
    leaves = [t.requires_grad_() if i in diff else t
              for i, t in enumerate(tensors)]
    try:
        with torch.enable_grad():
            got = f(*leaves)
            want = entry.ref(list(leaves), attrs)
            if got.numel() != want.numel():
                return (f"the cluster gives {tuple(got.shape)}, the plain "
                        f"version {tuple(want.shape)}")
            want = want.reshape(got.shape)
            if not _close(got.detach(), want.detach(), 1e-3):
                return "the forward probe differs from the plain version"
            if not diff:
                return None
            if not got.requires_grad:
                return "no gradient flows through the cluster"
            ct = torch.linspace(0.5, 1.5, got.numel(), device=got.device,
                                dtype=torch.float32).reshape(got.shape)
            wrt = [leaves[i] for i in diff]
            g1 = torch.autograd.grad(got, wrt, ct.to(got.dtype),
                                     allow_unused=True)
            g2 = torch.autograd.grad(want, wrt, ct.to(want.dtype),
                                     allow_unused=True)
    except _DEVICE_ERRORS:
        raise
    except _MISMATCH_ERRORS as e:
        first = (str(e).strip().splitlines() or [""])[0]
        return f"the probe raised {type(e).__name__}: {first}"
    for a, b, x in zip(g1, g2, wrt):
        a = torch.zeros_like(x) if a is None else a
        b = torch.zeros_like(x) if b is None else b
        if not _close(a, b, 5e-3):
            return "the gradient probe differs from the plain version's"
    return None


def _probe_tensors(ctx: _Ctx, slots: tuple, special: Mapping[int, Callable]
                   | None = None) -> list[torch.Tensor] | None:
    """Random probe operands of the traced shapes, float32 for every
    floating operand; ``special[i](shape, generator)`` overrides slot i."""
    g = torch.Generator(device=ctx.tr.device).manual_seed(0)
    out = []
    for i, slot in enumerate(slots):
        aval = ctx.slot_aval(slot)
        if aval is None:
            return None
        shape, dtype = aval
        if special and i in special:
            out.append(special[i](shape, g))
        elif dtype.is_floating_point:
            out.append(torch.randn(shape, generator=g, device=ctx.tr.device))
        else:
            out.append(torch.randint(0, 2, shape, generator=g,
                                     device=ctx.tr.device, dtype=dtype))
    return out


# ---------------------------------------------------------------------------
# Matchers.
# ---------------------------------------------------------------------------

def _kernel_op(ctx: _Ctx, kernel: str, root: int, slots: tuple,
               extra_attrs: dict) -> ir.OpNode | None:
    avals = [ctx.slot_aval(s) for s in slots]
    if any(a is None for a in avals):
        return None
    root_op = ctx.ops[root]
    out_shape, out_dtype = ctx.value_aval(root_op.output)
    return ir.OpNode(
        ir.OpKind.KERNEL, f"{kernel}[{root_op.name}]",
        tuple(s[1] for s in slots if s[0] == "in"), root_op.output,
        params=tuple(s[1] for s in slots if s[0] == "p"),
        attrs={"kernel": kernel, "slots": tuple(slots),
               "arg_shapes": tuple(a[0] for a in avals),
               "arg_dtypes": tuple(str(a[1]) for a in avals),
               "out_shape": out_shape, "out_dtype": out_dtype,
               **extra_attrs})


def _finish(ctx: _Ctx, kernel: str, root: int, claimed: set[int],
            slots: tuple, extra_attrs: dict,
            special: Mapping[int, Callable] | None = None
            ) -> KernelMatch | None:
    if not ctx.cluster_closed(claimed, root):
        return None
    op = _kernel_op(ctx, kernel, root, slots, extra_attrs)
    if op is None:
        return None
    entry = REGISTRY[kernel]
    if entry.stack_absorbable and (
            ctx.mode != "brainslug" or entry.constraints(
                op.attrs["arg_shapes"], op.attrs["arg_dtypes"],
                op.attrs) is not None):
        return None          # the kernel will not run: leave it to a stack
    tensors = _probe_tensors(ctx, slots, special)
    if tensors is None:
        return None
    reason = _probe_verify(ctx, claimed, ctx.ops[root].output, slots, entry,
                           op.attrs, tensors)
    if reason is not None:
        ctx.vetoes[kernel, root] = KernelVeto(kernel, ctx.ops[root].name,
                                              reason)
        return None
    return KernelMatch(kernel=kernel, root=root,
                       claimed=tuple(sorted(claimed)), op=op)


def _swapped_last_two(op: ir.OpNode, nd: int) -> bool:
    """A transpose (or permute) that swaps exactly the last two axes."""
    args = op.attrs.get("prim_args", ())
    if _prim(op) == "transpose" and len(args) == 3:
        return {args[1] % nd, args[2] % nd} == {nd - 2, nd - 1}
    if _prim(op) == "permute" and len(args) == 2:
        want = list(range(nd - 2)) + [nd - 1, nd - 2]
        return [d % nd for d in args[1]] == want
    return False


def _match_attention(ctx: _Ctx, ri: int) -> KernelMatch | None:
    """``softmax(q @ kᵀ [* scale] [+ causal mask]) @ v`` -> flash attention.
    Rooted at the probabilities' matmul; the scale is an EW_BINARY mul by a
    constant scalar, the mask a constant with causal structure."""
    root = ctx.ops[ri]
    if _prim(root) != "matmul" or not _plain_call(root):
        return None
    rslots = root.attrs["operand_slots"]
    if len(rslots) != 2 or rslots[0][0] != "in":
        return None
    nd = len(ctx.shapes[root.output])
    if nd not in (3, 4):
        return None
    got = ctx.sole_producer(rslots[0][1], ri)
    if got is None or got[0].kind != ir.OpKind.ROW_SOFTMAX:
        return None
    claimed = {ri, got[1]}
    s_name, from_idx = got[0].inputs[0], got[1]
    causal = False
    got = ctx.sole_producer(s_name, from_idx)
    if got is not None and _prim(got[0]) == "add" and _plain_call(got[0]):
        aslots = got[0].attrs["operand_slots"]
        for a_slot, m_slot in (aslots, aslots[::-1]):
            if (len(aslots) != 2 or a_slot[0] != "in" or m_slot[0] != "p"
                    or m_slot[1] not in ctx.const_params):
                continue
            sq, sk = ctx.shapes[got[0].output][-2:]
            kind = _causal_mask_kind(ctx.const_params[m_slot[1]], sq, sk)
            if kind is None:
                continue
            causal = kind == "causal"
            claimed.add(got[1])
            s_name, from_idx = a_slot[1], got[1]
            break
    scale = 1.0
    got = ctx.sole_producer(s_name, from_idx)
    if (got is not None and got[0].kind == ir.OpKind.EW_BINARY
            and got[0].fn == "mul" and len(got[0].params) == 1
            and got[0].params[0] in ctx.const_params
            and ctx.const_params[got[0].params[0]].numel() == 1):
        scale = float(ctx.const_params[got[0].params[0]])
        claimed.add(got[1])
        s_name, from_idx = got[0].inputs[0], got[1]
    got = ctx.sole_producer(s_name, from_idx)
    if got is None or _prim(got[0]) != "matmul" or not _plain_call(got[0]):
        return None
    qk, qki = got
    qslots = qk.attrs["operand_slots"]
    if len(qslots) != 2 or qslots[1][0] != "in":
        return None
    claimed.add(qki)
    got = ctx.sole_producer(qslots[1][1], qki)
    if got is None or not _swapped_last_two(got[0], nd):
        return None
    claimed.add(got[1])
    q_slot, k_slot, v_slot = qslots[0], got[0].attrs["operand_slots"][0], \
        rslots[1]
    shapes = [ctx.slot_aval(s) for s in (q_slot, k_slot, v_slot)]
    if any(s is None or len(s[0]) != nd for s in shapes):
        return None
    (q, _), (k, _), (v, _) = shapes
    if q[:-2] != k[:-2] or k[:-1] != v[:-1] or q[-1] != k[-1]:
        return None
    if causal and q[-2] != k[-2]:
        return None
    return _finish(ctx, "attention", ri, claimed, (q_slot, k_slot, v_slot),
                   {"causal": causal, "scale": scale})


def _match_vocab_ce(ctx: _Ctx, ri: int) -> KernelMatch | None:
    """``gather(log_softmax(h @ W), idx)`` loss tails -> fused vocab-CE.
    Rooted at the gather; the value side must be a closed cluster of
    constant-only ops over exactly one MATMUL(h, W).  The gather index (one
    vocab id a row, whatever the user's code did to the labels) becomes a
    kernel operand.  The (T, V) logits never materialise."""
    root = ctx.ops[ri]
    if _prim(root) != "gather" or root.attrs.get("prim_kwargs"):
        return None
    rslots = root.attrs["operand_slots"]
    args = root.attrs["prim_args"]
    if len(rslots) != 2 or rslots[0][0] != "in" or len(args) != 3 \
            or args[1] not in (-1, 1):
        return None
    idx_slot = rslots[1]
    idx_aval = ctx.slot_aval(idx_slot)
    if idx_aval is None or idx_aval[1].is_floating_point \
            or idx_aval[1] == torch.bool:
        return None
    mm = None
    lse_set: set[int] = set()
    stack = [rslots[0][1]]
    while stack:
        i = ctx.producer.get(stack.pop())
        if i is None or i in ctx.claimed:
            return None
        if i in lse_set or i == mm:
            continue
        op = ctx.ops[i]
        if op.kind == ir.OpKind.MATMUL:
            if mm is not None:
                return None
            mm = i
            continue
        lse_set.add(i)
        if len(lse_set) > 24 or any(p not in ctx.const_params
                                    for p in op.params):
            return None
        stack.extend(op.inputs)
    if mm is None:
        return None
    mm_op = ctx.ops[mm]
    if len(mm_op.inputs) != 1 or len(mm_op.params) != 1:
        return None
    h, w = mm_op.inputs[0], mm_op.params[0]
    h_shape = ctx.value_aval(h)[0]
    w_aval = ctx.param_aval(w)
    if (w_aval is None or len(h_shape) != 2 or len(w_aval[0]) != 2
            or math.prod(idx_aval[0]) != h_shape[0]
            or ctx.shapes[root.output] != (h_shape[0], 1)):
        return None
    v_dim = w_aval[0][1]
    special = {1: lambda shape, g: 0.3 * torch.randn(
                   shape, generator=g, device=ctx.tr.device),
               2: lambda shape, g: torch.randint(
                   0, v_dim, shape, generator=g, device=ctx.tr.device,
                   dtype=idx_aval[1])}
    return _finish(ctx, "vocab_ce", ri, lse_set | {mm, ri},
                   (("in", h), ("p", w), idx_slot), {}, special)


def _match_swiglu(ctx: _Ctx, ri: int) -> KernelMatch | None:
    """``act(x @ W1) * (x @ W2)`` (the GLU MLP) -> the fused gate."""
    root = ctx.ops[ri]
    if (root.kind != ir.OpKind.EW_BINARY or root.fn != "mul" or root.params
            or len(root.inputs) != 2):
        return None
    for a, b in (root.inputs, root.inputs[::-1]):
        got = ctx.sole_producer(a, ri)
        if got is None or got[0].kind != ir.OpKind.EW_UNARY \
                or got[0].fn not in swiglu_ops.ACTS:
            continue
        act, ai = got
        gate = act.inputs[0]
        gate_p, up_p = ctx.producer_op(gate), ctx.producer_op(b)
        if (gate_p is None or gate_p.kind != ir.OpKind.MATMUL
                or up_p is None or up_p.kind != ir.OpKind.MATMUL
                or ctx.shapes[gate] != ctx.shapes[b]):
            continue
        match = _finish(ctx, "swiglu", ri, {ri, ai},
                        (("in", gate), ("in", b)), {"act": act.fn})
        if match is not None:
            return match
    return None


def _match_rmsnorm(ctx: _Ctx, ri: int) -> KernelMatch | None:
    """``rmsnorm(x) * g`` (or ``rms_norm(x, g)``) feeding a matmul -> the
    fused rmsnorm kernel.  A norm that feeds no matmul stays in its stack,
    where it fuses with its element-wise neighbours."""
    root = ctx.ops[ri]
    out_shape = tuple(ctx.shapes[root.output])
    if (root.kind == ir.OpKind.ROW_NORM and root.attrs.get("norm") == "rms"
            and len(root.params) == 1):
        norm, claimed = root, {ri}
    elif (root.kind == ir.OpKind.EW_BINARY and root.fn == "mul"
          and len(root.params) == 1 and len(root.inputs) == 1):
        got = ctx.sole_producer(root.inputs[0], ri)
        if got is None or got[0].kind != ir.OpKind.ROW_NORM \
                or got[0].attrs.get("norm") != "rms" or got[0].params:
            return None
        norm, claimed = got[0], {ri, got[1]}
    else:
        return None
    g = root.params[0]
    g_aval = ctx.param_aval(g)
    if g_aval is None or math.prod(g_aval[0]) != out_shape[-1] \
            or g_aval[0][-1:] != out_shape[-1:]:
        return None
    if not any(ctx.ops[c].kind == ir.OpKind.MATMUL
               for c in ctx.consumers.get(root.output, set())):
        return None
    x = norm.inputs[0]
    if tuple(ctx.shapes[x]) != out_shape:
        return None
    return _finish(ctx, "rmsnorm", ri, claimed, (("in", x), ("p", g)),
                   {"eps": float(norm.attrs.get("eps", 1e-6))})


_MATCHERS: tuple[tuple[str, Callable], ...] = (
    ("attention", _match_attention),
    ("vocab_ce", _match_vocab_ce),
    ("swiglu", _match_swiglu),
    ("rmsnorm", _match_rmsnorm),
)


# ---------------------------------------------------------------------------
# The rewrite pass.
# ---------------------------------------------------------------------------

def rewrite(tr, *, mode: str = "brainslug"):
    """Replace matched clusters of a
    :class:`~repro_torch.core.trace.TraceResult` with KERNEL ops.

    Returns ``(new_trace_result, matches, vetoes)``; with no match the
    TraceResult comes back unchanged.  A cluster is claimed only when it is
    closed (no interior value read outside it), its structural walk
    succeeds and the forward and gradient probes agree with the entry's
    plain version; ``vetoes`` lists the structural matches whose probe did
    not, with the reason.  ``mode`` gates the stack-absorbable entries
    (rmsnorm, swiglu): outside ``brainslug``, or where the kernel's
    constraints fail, they stay with the stacks."""
    ctx = _Ctx(tr, mode)
    matches: list[KernelMatch] = []
    for ri in range(len(ctx.ops)):
        if ri in ctx.claimed:
            continue
        for _, matcher in _MATCHERS:
            got = matcher(ctx, ri)
            if got is not None:
                matches.append(got)
                ctx.claimed |= set(got.claimed)
                break
    # a root another matcher (or the other operand order) claimed is no veto
    vetoes = tuple(v for (_, r), v in ctx.vetoes.items()
                   if r not in ctx.claimed)
    if not matches:
        return tr, (), vetoes
    root_ops = {m.root: m.op for m in matches}
    drop = set().union(*(set(m.claimed) for m in matches)) - set(root_ops)
    new_ops = [root_ops.get(i, op) for i, op in enumerate(ctx.ops)
               if i not in drop]
    graph = ir.NetGraph(name=tr.graph.name, input=tr.graph.input,
                        output=tr.graph.output, ops=tuple(new_ops))
    return dataclasses.replace(tr, graph=graph), tuple(matches), vetoes
