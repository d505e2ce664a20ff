"""Collectives over a :class:`~repro_torch.launch.mesh.Mesh`'s axis groups,
ported from ``repro/distributed/collectives.py``.

The JAX package's helpers run inside ``shard_map`` and name a mesh axis;
here each names one of the mesh's per-axis process groups.  They serve
three purposes:

* the sharded call of :mod:`repro_torch.core.codegen` (slice a rank's
  shard by its spec, gather outputs along their sharded dims, sum a
  replicated operand's partial cotangents over the axes the outputs
  shard);
* hierarchical gradient reduction (within a pod first, then across pods):
  :func:`psum_hierarchical`;
* reduce-scatter reductions that keep gradient shards distributed (ZeRO-2
  style): :func:`reduce_scatter_mean`, :func:`all_gather_params`;
* the conjugate tensor-parallel operators of the sharded train step
  (Megatron's f and g): :func:`copy_to_model`, the identity forward and an
  all-reduce of the cotangent backward, and :func:`reduce_from_model`, an
  all-reduce forward and the identity backward.  Layers name only the
  axis (``RuntimeConfig.tp_axis``); the mesh comes from the enclosing
  :func:`region`, as a ``shard_map`` body's axis names resolve against
  its mesh;
* point-to-point hops and a broadcast along one axis, for the pipeline
  schedule (:mod:`repro_torch.distributed.pipeline_parallel`).

Under gloo the ranks' CUDA tensors go to the collectives as they are
(torch 2.11's gloo takes them for all three the port issues: it copies
through the host itself).  A collective the backend refuses raises, naming
the collective, the backend and the device; gloo's point-to-point
operations take host tensors only, so :func:`send_recv` stages a CUDA
tensor through the host under gloo.  ``STATS`` counts the collectives by
name, those given CUDA tensors, and the bytes each rank handed to each,
so a run shows what went over the wire from the card.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Iterable

import torch
import torch.distributed as dist


@dataclasses.dataclass
class CollectiveStats:
    """Per-process counts of each collective's calls, all of them and
    those given CUDA tensors, and the bytes this rank handed to each."""

    calls: dict = dataclasses.field(default_factory=dict)
    cuda_calls: dict = dataclasses.field(default_factory=dict)
    bytes: dict = dataclasses.field(default_factory=dict)

    def reset(self) -> None:
        self.calls, self.cuda_calls, self.bytes = {}, {}, {}

    def snapshot(self) -> dict:
        return {"calls": dict(self.calls),
                "cuda_calls": dict(self.cuda_calls),
                "bytes": dict(self.bytes)}


STATS = CollectiveStats()

# torch 2.13 renamed the tensor-in, tensor-out collectives; older releases
# (the card machine's) have only the old names.
_all_gather_single = getattr(dist, "all_gather_single",
                             dist.all_gather_into_tensor)
_reduce_scatter_single = getattr(dist, "reduce_scatter_single",
                                 dist.reduce_scatter_tensor)


def _run(name: str, mesh, out: torch.Tensor, run: Callable[[], Any],
         payload: torch.Tensor | None = None) -> None:
    """Run the collective ``name`` (writing ``out``; this rank hands it
    ``payload``, by default ``out``), counted; a refusal raises naming the
    backend and the device."""
    sent = out if payload is None else payload
    STATS.calls[name] = STATS.calls.get(name, 0) + 1
    STATS.bytes[name] = (STATS.bytes.get(name, 0)
                         + sent.numel() * sent.element_size())
    if out.is_cuda:
        STATS.cuda_calls[name] = STATS.cuda_calls.get(name, 0) + 1
    try:
        run()
    except RuntimeError as e:
        raise RuntimeError(f"{name} over {mesh.backend} on a "
                           f"{out.device.type} tensor failed: {e}") from e


def all_reduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis`` (in place; returns ``x``).
    An axis of extent 1 is a no-op."""
    if mesh.extent(axis) == 1:
        return x
    _run("all_reduce", mesh, x,
         lambda: dist.all_reduce(x, group=mesh.groups[axis]))
    return x


def all_reduce_axes(x: torch.Tensor, mesh, axes: Iterable[str]
                    ) -> torch.Tensor:
    """Sum of ``x`` over every axis in ``axes``, one group after another."""
    for axis in sorted(axes):
        all_reduce(x, mesh, axis)
    return x


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0
               ) -> torch.Tensor:
    """The ``axis`` ranks' ``x`` concatenated along ``dim``, in rank order
    along the axis."""
    n = mesh.extent(axis)
    if n == 1:
        return x
    moved = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * moved.shape[0], *moved.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _run("all_gather_into_tensor", mesh, out,
         lambda: _all_gather_single(out, moved, group=mesh.groups[axis]),
         payload=moved)
    return out.movedim(0, dim)


def reduce_scatter_mean(x: torch.Tensor, mesh, axis: str,
                        split_dim: int = 0) -> torch.Tensor:
    """This rank's ``1/n`` slice along ``split_dim`` of the mean of ``x``
    over ``axis`` (ZeRO-2 gradient shards)."""
    n = mesh.extent(axis)
    if n == 1:
        return x.clone()
    moved = x.movedim(split_dim, 0).contiguous()
    out = torch.empty((moved.shape[0] // n, *moved.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _run("reduce_scatter_tensor", mesh, out,
         lambda: _reduce_scatter_single(out, moved,
                                        group=mesh.groups[axis]),
         payload=moved)
    return (out / n).movedim(0, split_dim)


def psum_hierarchical(x: torch.Tensor, mesh, *, pod_axis: str = "pod",
                      data_axis: str = "data") -> torch.Tensor:
    """All-reduce over (pod, data) as two stages: within a pod first, then
    across pods (in place; returns ``x``)."""
    all_reduce(x, mesh, data_axis)
    return all_reduce(x, mesh, pod_axis)


def all_gather_params(tree: Any, mesh, axis: str, split_dim: int = 0) -> Any:
    """Gather sharded leaves of a nested dict back to full size."""
    if isinstance(tree, dict):
        return {k: all_gather_params(v, mesh, axis, split_dim)
                for k, v in tree.items()}
    return all_gather(tree, mesh, axis, split_dim)


def tree_psum(tree: Any, mesh, axis: str) -> Any:
    """Sum every leaf of a nested dict over ``axis`` (in place)."""
    if isinstance(tree, dict):
        return {k: tree_psum(v, mesh, axis) for k, v in tree.items()}
    return all_reduce(tree, mesh, axis)


# ---------------------------------------------------------------------------
# Spec-driven slicing and gathering (the sharded call's boundary).
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def spec_mesh_axes(spec) -> set[str]:
    """Mesh axis names a partition spec shards over."""
    return {a for entry in tuple(spec) for a in _entry_axes(entry)}


def shard(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the global ``x`` under ``spec`` (contiguous)."""
    out = x
    for dim, entry in enumerate(tuple(spec)):
        axes = _entry_axes(entry)
        if not axes:
            continue
        n, idx = 1, 0
        for a in axes:                  # row-major over the listed axes
            idx = idx * mesh.extent(a) + mesh.coords.get(a, 0)
            n *= mesh.extent(a)
        if n == 1:
            continue
        size = out.shape[dim] // n
        out = out.narrow(dim, idx * size, size)
    return out.contiguous()


def gather(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The global tensor of a rank's block ``x`` under ``spec``: each
    sharded dim all-gathered over its axes (the innermost axis first)."""
    out = x
    for dim, entry in enumerate(tuple(spec)):
        for a in reversed(_entry_axes(entry)):
            out = all_gather(out, mesh, a, dim)
    return out.contiguous()


# ---------------------------------------------------------------------------
# Tensor-parallel operators (the sharded train step's region).
# ---------------------------------------------------------------------------

_REGION: list = []


@contextlib.contextmanager
def region(mesh, batch_axes: tuple[str, ...] = ()):
    """Resolve the tensor-parallel operators' axis names against ``mesh``
    while the block runs (a ``shard_map`` region's axis environment);
    ``batch_axes`` names the axes the global batch is split over in it,
    whose statistics :func:`batch_mean` and :func:`batch_sum` complete."""
    _REGION.append((mesh, tuple(batch_axes)))
    try:
        yield mesh
    finally:
        _REGION.pop()


def _region_mesh(axis: str):
    if not _REGION:
        raise RuntimeError(
            f"a tensor-parallel operator over {axis!r} ran outside a "
            f"sharded region (collectives.region(mesh))")
    return _REGION[-1][0]


def region_batch_axes() -> tuple[str, ...]:
    """The batch axes of the enclosing :func:`region` (``()`` outside
    one, or where the batch is whole in every rank)."""
    return _REGION[-1][1] if _REGION else ()


def region_batch_shards() -> int:
    """How many shards the enclosing :func:`region` splits the batch
    into (1 outside one)."""
    if not _REGION:
        return 1
    mesh, axes = _REGION[-1]
    n = 1
    for a in axes:
        n *= mesh.extent(a)
    return n


class _BatchMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        out = x.clone(memory_format=torch.contiguous_format)
        n = 1
        for a in axes:
            all_reduce(out, mesh, a)
            n *= mesh.extent(a)
        return out.div_(n)

    @staticmethod
    def backward(ctx, g):
        # every rank's loss holds the same global statistic, and the step
        # averages the ranks' gradients over the batch axes: the identity
        # here makes that average the global statistic's gradient
        return g, None, None


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the region's batch axes of a per-shard mean ``x`` (a
    statistic of the global batch, as the JAX package's GSPMD step
    computes it); backward, the identity."""
    mesh, axes = _REGION[-1]
    return _BatchMean.apply(x, mesh, axes)


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the region's batch axes of a per-shard count ``x`` (no
    gradient)."""
    mesh, axes = _REGION[-1]
    out = x.detach().clone(memory_format=torch.contiguous_format)
    for a in axes:
        all_reduce(out, mesh, a)
    return out


def _copy_backward(g: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The cotangent of :func:`copy_to_model`'s input: the sum of the
    ranks' partial cotangents over ``axis``."""
    return all_reduce(g.clone(memory_format=torch.contiguous_format), mesh,
                      axis)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _copy_backward(g, ctx.mesh, ctx.axis), None, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x.clone(memory_format=torch.contiguous_format),
                          mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to_model(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``x``, replicated over ``axis``, entering a computation each rank
    runs on its own slice of the weights: the identity forward; backward,
    the ranks' partial cotangents summed over ``axis``."""
    STATS.calls["copy_to_model"] = STATS.calls.get("copy_to_model", 0) + 1
    return _CopyToModel.apply(x, _region_mesh(axis), axis)


def reduce_from_model(x: torch.Tensor, axis: str) -> torch.Tensor:
    """The ranks' partial ``x`` summed over ``axis`` (an all-reduce
    forward); backward, the identity (every rank holds the whole
    cotangent)."""
    STATS.calls["reduce_from_model"] = (STATS.calls.get("reduce_from_model",
                                                        0) + 1)
    return _ReduceFromModel.apply(x, _region_mesh(axis), axis)


# ---------------------------------------------------------------------------
# Point-to-point hops and a broadcast along one axis (the pipeline).
# ---------------------------------------------------------------------------

def send_recv(x: torch.Tensor | None, mesh, axis: str, *, to: int | None,
              frm: int | None, like: torch.Tensor) -> torch.Tensor | None:
    """Send ``x`` to the rank at coordinate ``to`` of ``axis`` and receive
    a tensor shaped as ``like`` from coordinate ``frm`` (either may be
    None), both posted at once; returns what was received (None when
    ``frm`` is None).  Under gloo a CUDA tensor goes through the host."""
    staged = mesh.backend == "gloo" and like.is_cuda
    reqs, buf = [], None
    if to is not None:
        src = x.contiguous()
        if staged:
            src = src.cpu()
        STATS.calls["send"] = STATS.calls.get("send", 0) + 1
        STATS.bytes["send"] = (STATS.bytes.get("send", 0)
                               + src.numel() * src.element_size())
        if x.is_cuda:
            STATS.cuda_calls["send"] = STATS.cuda_calls.get("send", 0) + 1
        reqs.append(dist.isend(src, mesh.rank_at({**mesh.coords, axis: to})))
    if frm is not None:
        buf = torch.empty_like(like, device="cpu" if staged else like.device)
        reqs.append(dist.irecv(buf,
                               mesh.rank_at({**mesh.coords, axis: frm})))
    for req in reqs:
        req.wait()
    if buf is not None and staged:
        buf = buf.to(like.device)
    return buf


def broadcast(x: torch.Tensor, mesh, axis: str, src: int) -> torch.Tensor:
    """``x`` of the rank at coordinate ``src`` of ``axis``, on every rank
    of the axis (in place; returns ``x``)."""
    if mesh.extent(axis) == 1:
        return x
    root = mesh.rank_at({**mesh.coords, axis: src})
    _run("broadcast", mesh, x,
         lambda: dist.broadcast(x, src=root, group=mesh.groups[axis]))
    return x
