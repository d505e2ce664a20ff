"""Parameter substrate: nested dicts of tensors, initialised with the JAX
package's scales (``repro/layers/base.py:boxed``).

``normal`` draws ``randn(shape) * scale`` in the parameter dtype with
``scale = 1 / sqrt(shape[0])`` unless given, as ``boxed`` does.  Draws come
from a ``torch.Generator`` on the parameters' device, so a seed gives the
same weights on one device type, not the JAX package's weights (carry
those over with :func:`repro_torch.convert.lm_params_from_numpy`).

Logical axes, the JAX package's sharding annotations: each layer module
declares, beside its ``init``, a ``param_axes`` tree of the same
structure whose leaves are the logical axis names of the matching
parameter's dims (the JAX ``Box.axes`` of that leaf); the values and the
axes travel as two trees, as the JAX ``split`` returns them, so no wrapper
stays in the parameter tree.  :func:`stack_axes` prefixes ``"layers"`` to
every leaf of a per-layer axes tree (``stack_layer_trees``'s counterpart),
and :func:`check_axes` holds an axes tree against a value tree (``Box``'s
rank check).  ``repro_torch.distributed.sharding`` maps the names onto a
mesh's axes:

    "fsdp"     dim sharded over the data axis (ZeRO-3 style)
    "heads", "kv_heads", "ffn", "vocab"
               dims sharded over the model (tensor-parallel) axis
    "experts"  dim sharded over the data axis (expert parallelism)
    "layers"   the stacked layer axis, replicated
    None       replicated

:func:`promote` and :func:`matmul` carry jnp's type promotion over to the
places where an activation meets a parameter: a float32 activation against
bf16 weights (hubert's float32 frames over a bf16 model) computes in
float32, as ``jnp.einsum`` and jnp's arithmetic do, where ``torch.matmul``
and the kernels refuse mixed dtypes.  Operands of one dtype pass through
untouched, and autograd returns each gradient in its own operand's dtype.
"""
from __future__ import annotations

import functools
from typing import Any, Callable

import torch

Tree = Any


def device(name: str | torch.device) -> torch.device:
    """``name`` as a device; ``cuda`` without a GPU is an error, never a
    quiet move to the CPU."""
    dev = torch.device(name)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {name!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} asked for, but no CUDA device "
                           f"is available; ask for 'cpu' to run the plain "
                           f"versions on the CPU")
    return dev


def generator(seed: int, dev: torch.device) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def normal(g: torch.Generator, shape: tuple[int, ...], *,
           fan_in: int | None = None, scale: float | None = None,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``randn(shape) * scale`` in ``dtype``; ``scale`` defaults to
    ``1 / sqrt(fan_in)``, and ``fan_in`` to ``shape[0]`` (``boxed``'s
    rule; a layer-stacked leaf passes its per-layer first dim)."""
    if scale is None:
        scale = 1.0 / ((fan_in if fan_in is not None else shape[0]) ** 0.5)
    x = torch.randn(shape, generator=g, dtype=dtype, device=g.device)
    return x * torch.tensor(scale, dtype=dtype, device=g.device)


def promote(*ts: torch.Tensor | None) -> tuple[torch.Tensor | None, ...]:
    """The tensors in ``torch.promote_types`` of their dtypes (None passes
    through), as jnp promotes mixed operands."""
    dt = functools.reduce(torch.promote_types,
                          [t.dtype for t in ts if t is not None])
    return tuple(t if t is None else t.to(dt) for t in ts)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two."""
    x, w = promote(x, w)
    return x @ w


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Tree) -> Tree:
    """``fn`` over every tensor leaf of a nested dict, in sorted-key order
    (``jax.tree_util``'s, as :func:`tree_leaves`)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_leaves(tree: Tree) -> list[torch.Tensor]:
    """The tensor leaves of a nested dict in sorted-key order, so two trees
    of one structure pair up leaf by leaf whatever order their dicts were
    built in."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def stack_layer_trees(trees: list[Tree]) -> Tree:
    """Stack per-layer trees along a new leading layer axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_layer_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def is_axes(x: Any) -> bool:
    """Whether ``x`` is one leaf's logical axes (a tuple of names and
    Nones), as ``jax.tree_util`` walks an axes tree."""
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def axes_map(fn: Callable[[tuple], Any], tree: Tree) -> Tree:
    """``fn`` over every axes leaf of a nested dict (sorted keys)."""
    if isinstance(tree, dict):
        return {k: axes_map(fn, tree[k]) for k in sorted(tree)}
    if not is_axes(tree):
        raise TypeError(f"not an axes leaf: {tree!r}")
    return fn(tree)


def stack_axes(tree: Tree) -> Tree:
    """A per-layer axes tree with the leading ``"layers"`` axis of its
    layer-stacked values."""
    return axes_map(lambda a: ("layers",) + a, tree)


def check_axes(values: Tree, axes: Tree, path: str = "") -> None:
    """Raise unless ``axes`` has ``values``' structure and every leaf one
    name per dim of its value."""
    if isinstance(values, dict) or isinstance(axes, dict):
        if not (isinstance(values, dict) and isinstance(axes, dict)
                and set(values) == set(axes)):
            raise ValueError(f"{path or '/'}: the values and the axes "
                             f"differ in structure")
        for k in values:
            check_axes(values[k], axes[k], f"{path}/{k}")
        return
    if not is_axes(axes) or len(axes) != values.dim():
        raise ValueError(f"{path}: axes {axes} rank != value rank "
                         f"{tuple(values.shape)}")


def cast_tree(tree: Tree, dtype: torch.dtype) -> Tree:
    return tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a,
                    tree)


def param_count(tree: Tree) -> int:
    return sum(a.numel() for a in tree_leaves(tree))
