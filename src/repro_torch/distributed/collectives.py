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
  style): :func:`reduce_scatter_mean`, :func:`all_gather_params`.

Under gloo the ranks' CUDA tensors go to the collectives as they are
(torch 2.11's gloo takes them for all three the port issues: it copies
through the host itself).  A collective the backend refuses raises, naming
the collective, the backend and the device.  ``STATS`` counts the
collectives by name, and those given CUDA tensors, so a run shows what
went over the wire from the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable

import torch
import torch.distributed as dist


@dataclasses.dataclass
class CollectiveStats:
    """Per-process counts of each collective's calls, all of them and
    those given CUDA tensors."""

    calls: dict = dataclasses.field(default_factory=dict)
    cuda_calls: dict = dataclasses.field(default_factory=dict)

    def reset(self) -> None:
        self.calls, self.cuda_calls = {}, {}

    def snapshot(self) -> dict:
        return {"calls": dict(self.calls),
                "cuda_calls": dict(self.cuda_calls)}


STATS = CollectiveStats()

# torch 2.13 renamed the tensor-in, tensor-out collectives; older releases
# (the card machine's) have only the old names.
_all_gather_single = getattr(dist, "all_gather_single",
                             dist.all_gather_into_tensor)
_reduce_scatter_single = getattr(dist, "reduce_scatter_single",
                                 dist.reduce_scatter_tensor)


def _run(name: str, mesh, out: torch.Tensor, run: Callable[[], Any]
         ) -> None:
    """Run the collective ``name`` (writing ``out``), counted; a refusal
    raises naming the backend and the device."""
    STATS.calls[name] = STATS.calls.get(name, 0) + 1
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
         lambda: _all_gather_single(out, moved, group=mesh.groups[axis]))
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
                                        group=mesh.groups[axis]))
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
