"""Meshes over ``torch.distributed``, ported from ``repro/launch/mesh.py``.

The JAX package's mesh is a grid of devices one process drives.  Here a
mesh is a grid of *ranks*: one process per position, each with its own
device, joined by one initialised ``torch.distributed`` group.
:class:`Mesh` wraps that group with the axis names the partition planner
and the data-parallel driver speak (``("data", "model")`` or
``("pod", "data", "model")``): a ``DeviceMesh``, the per-axis process
groups, this rank's coordinate on every axis, the device and the backend.

Backend choice (:func:`choose_backend`): ``nccl`` when every rank has a
card of its own, ``gloo`` otherwise, the CPU tests and ranks that share
one card alike.  NCCL refuses two ranks on one GPU, so on a one-card
machine the ranks share ``cuda:0`` over ``gloo``: the kernels run on the
card in every rank and the collectives go through the host (gloo
copies the ranks' CUDA tensors itself; a collective it refuses raises in
:mod:`repro_torch.distributed.collectives`).  The choice is printed, never silent; asking for
``nccl`` where it cannot run raises.

:func:`spawn` starts ``n`` ranks on this host (the ``spawn`` start method,
a free ``localhost`` port, a timeout on every rank), runs an importable
function in each after initialising the group, re-raises the first rank
failure in the caller with the rank named, and returns rank 0's result.
Under ``torchrun`` the group comes from the environment instead
(:func:`init_from_env`).

The device is ``cuda`` unless the caller asks for ``cpu``; without a GPU
``cuda`` is an error, never a quiet move to the CPU.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist

#: Axis names of a single-pod mesh and of a multi-pod one.
AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")

#: Seconds a rank may run before :func:`spawn` stops every rank.
DEFAULT_TIMEOUT = 600.0


def _device_type(device: str | torch.device) -> str:
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for, but no CUDA device is available; "
            f"ask for 'cpu' to run the ranks on the CPU")
    return kind


def choose_backend(world_size: int, device: str | torch.device = "cuda",
                   backend: str | None = None) -> tuple[str, str]:
    """``(backend, reason)`` for ``world_size`` ranks on ``device``.

    ``nccl`` when every rank has a card of its own, ``gloo`` otherwise.
    An explicit ``backend`` is checked: ``nccl`` with fewer cards than
    ranks (or on the CPU) raises, since NCCL refuses two ranks on one
    GPU."""
    kind = _device_type(device)
    cards = torch.cuda.device_count() if kind == "cuda" else 0
    if kind == "cpu":
        reason = f"{world_size} CPU rank(s): gloo"
        auto = "gloo"
    elif cards >= world_size:
        reason = f"{world_size} rank(s), {cards} card(s): a card each, nccl"
        auto = "nccl"
    else:
        reason = (f"{world_size} ranks share {cards} card(s): gloo, the "
                  f"collectives go through the host")
        auto = "gloo"
    if backend is None:
        return auto, reason
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be nccl or gloo, got {backend!r}")
    if backend == "nccl" and auto != "nccl":
        raise RuntimeError(
            f"backend='nccl' asked for, but {reason.split(':')[0]}; NCCL "
            f"needs a card for every rank")
    return backend, f"{reason.split(':')[0]}: {backend} (asked for)"


def rank_device(device: str | torch.device = "cuda") -> torch.device:
    """This rank's device: ``cpu``, or ``cuda:<local rank mod cards>``
    (ranks beyond the card count share the cards)."""
    kind = _device_type(device)
    if kind == "cpu":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                               if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def free_port() -> int:
    """A free TCP port on ``localhost``."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_group(rank: int, world_size: int, *, port: int,
               device: str | torch.device = "cuda",
               backend: str | None = None,
               timeout: float = DEFAULT_TIMEOUT) -> str:
    """Initialise the default group of ``world_size`` ranks at
    ``tcp://localhost:<port>``; returns the backend chosen."""
    chosen, _ = choose_backend(world_size, device, backend)
    if _device_type(device) == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        chosen, init_method=f"tcp://localhost:{port}",
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout))
    return chosen


def init_from_env(device: str | torch.device = "cuda",
                  backend: str | None = None) -> str:
    """Initialise the default group from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); returns
    the backend chosen.  A no-op returning the current backend when the
    group is already up."""
    if dist.is_initialized():
        return dist.get_backend()
    world = int(os.environ["WORLD_SIZE"])
    chosen, reason = choose_backend(world, device, backend)
    if _device_type(device) == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
    dist.init_process_group(chosen, init_method="env://")
    if dist.get_rank() == 0:
        print(f"[mesh] backend {chosen} ({reason})", flush=True)
    return chosen


@dataclasses.dataclass(eq=False)
class Mesh:
    """A grid of ranks over the initialised default group.

    ``axis_names`` / ``shape`` name the grid (rank ``r`` sits at the
    row-major coordinate of ``r``); ``groups[name]`` is the process group
    of the ranks that differ from this one only along ``name``;
    ``coords[name]`` this rank's position on it.  ``device_mesh`` is the
    same grid as a ``torch.distributed.device_mesh.DeviceMesh``."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    device: torch.device
    backend: str
    reason: str
    groups: dict[str, Any]
    coords: dict[str, int]
    device_mesh: Any = None

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def rank(self) -> int:
        return dist.get_rank()

    def extent(self, name: str) -> int:
        """Extent of axis ``name``; 1 when the mesh has no such axis."""
        try:
            return self.shape[self.axis_names.index(name)]
        except ValueError:
            return 1

    def rank_at(self, coords: dict[str, int]) -> int:
        """The global rank at ``coords`` (row-major over the axes)."""
        r = 0
        for name, extent in zip(self.axis_names, self.shape):
            r = r * extent + coords[name]
        return r

    def describe(self) -> str:
        dims = " x ".join(f"{n}={e}" for n, e in zip(self.axis_names,
                                                      self.shape))
        return (f"mesh {dims} on {self.device} over {self.backend} "
                f"({self.reason})")


def _axis_groups(names: tuple[str, ...], shape: tuple[int, ...],
                 backend: str) -> tuple[dict, dict, list]:
    """Every rank's per-axis groups (``new_group`` is collective: each
    rank creates every group, in the same order) and this rank's
    coordinates."""
    rank = dist.get_rank()
    grid = torch.arange(dist.get_world_size()).reshape(shape)
    coords = {n: int(c) for n, c in zip(
        names, [int(i) for i in (grid == rank).nonzero()[0]])}
    groups: dict[str, Any] = {}
    mine: list = []
    for d, name in enumerate(names):
        lines = grid.movedim(d, -1).reshape(-1, shape[d])
        for line in lines.tolist():
            g = dist.new_group(ranks=line, backend=backend)
            if rank in line:
                groups[name] = g
        mine.append(groups[name])
    return groups, coords, mine


def make_mesh(shape: tuple[int, ...], names: tuple[str, ...],
              device: str | torch.device = "cuda") -> Mesh:
    """A mesh of ``shape`` named ``names`` over the whole initialised group
    (the product of ``shape`` must be its size).  Collective: every rank
    calls it, in the same order as every other mesh it builds."""
    if not dist.is_initialized():
        raise RuntimeError(
            "a Mesh needs an initialised torch.distributed group: start "
            "the ranks with repro_torch.launch.mesh.spawn or torchrun")
    world = dist.get_world_size()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"mesh {dict(zip(names, shape))} holds {n} ranks, "
                         f"the group has {world}")
    backend = dist.get_backend()
    dev = rank_device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    reason = (f"{world} CPU rank(s)" if dev.type == "cpu" else
              f"{world} rank(s) on {cards} card(s)" + (
                  ", sharing" if cards < world else ", a card each"))
    groups, coords, mine = _axis_groups(names, shape, backend)
    device_mesh = None
    try:
        from torch.distributed.device_mesh import DeviceMesh
        device_mesh = DeviceMesh.from_group(
            mine, dev.type, mesh=torch.arange(world).reshape(shape),
            mesh_dim_names=names)
    except (ImportError, RuntimeError, ValueError, TypeError) as e:
        reason += f"; no DeviceMesh ({type(e).__name__}: {e})"
    return Mesh(axis_names=tuple(names), shape=tuple(shape), device=dev,
                backend=backend, reason=reason, groups=groups,
                coords=coords, device_mesh=device_mesh)


def make_test_mesh(n: int | None = None, *, model_parallel: int = 1,
                   device: str | torch.device = "cuda") -> Mesh:
    """A ``("data", "model")`` mesh over the ``n`` ranks of the group
    (default: all of them).  ``model_parallel`` splits the trailing
    ``"model"`` axis: ``make_test_mesh(4, model_parallel=2)`` is a (2, 2)
    data x model mesh.  Unlike the JAX package's, it does not shrink to the
    devices that exist: ``n`` must be the group's size."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n is None else n
    if model_parallel > 1 and n % model_parallel == 0:
        shape = (n // model_parallel, model_parallel)
    else:
        shape = (n, 1)
    return make_mesh(shape, AXES, device)


def make_host_mesh(device: str | torch.device = "cuda") -> Mesh:
    """A ``(world, 1)`` ``("data", "model")`` mesh over the whole group."""
    return make_test_mesh(None, device=device)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device = "cuda") -> Mesh:
    """Single pod: (16, 16) = ("data", "model"), 256 ranks.  Multi-pod:
    (2, 16, 16) = ("pod", "data", "model"), 512 ranks."""
    if multi_pod:
        return make_mesh((2, 16, 16), POD_AXES, device)
    return make_mesh((16, 16), AXES, device)


def axis_extents(mesh: Mesh | None) -> dict[str, int]:
    """``{axis name: extent}`` of a mesh, ``{}`` for ``None``."""
    if mesh is None:
        return {}
    return {str(n): int(e) for n, e in zip(mesh.axis_names, mesh.shape)}


# ---------------------------------------------------------------------------
# Launching ranks on this host.
# ---------------------------------------------------------------------------

def _rank_main(rank: int, world: int, port: int, device: str,
               backend: str | None, timeout: float, fn: Callable,
               args: tuple, results) -> None:
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        init_group(rank, world, port=port, device=device, backend=backend,
                   timeout=timeout)
        out = fn(*args)
        results.put((rank, "ok", out if rank == 0 else None))
    except Exception:  # noqa: BLE001 (reported to the caller)
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            try:
                dist.destroy_process_group()
            except Exception:  # noqa: BLE001 (teardown after a failure)
                pass


class RankError(RuntimeError):
    """A rank of :func:`spawn` failed; the message names it and holds its
    traceback."""


def spawn(fn: Callable, n: int, *args: Any,
          device: str | torch.device = "cuda", backend: str | None = None,
          timeout: float = DEFAULT_TIMEOUT) -> Any:
    """Run ``fn(*args)`` in ``n`` ranks on this host and return rank 0's
    result.

    ``fn`` must be importable by a fresh interpreter (a module-level
    function, not one of ``__main__`` run as a script).  Each rank
    initialises the default group (backend from :func:`choose_backend`,
    printed here) before calling ``fn``.  The first rank to fail raises
    :class:`RankError` here naming the rank, with its traceback; a run
    still going after ``timeout`` seconds raises ``TimeoutError``.  Every
    rank process is stopped before this returns."""
    import multiprocessing as mp

    chosen, reason = choose_backend(n, device, backend)
    print(f"[mesh] spawn {n} rank(s) on {torch.device(device).type}: "
          f"backend {chosen} ({reason})", flush=True)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, port, str(device), chosen, timeout, fn,
                               args, results), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    done: dict[int, Any] = {}
    try:
        while len(done) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"spawn: ranks {sorted(set(range(n)) - set(done))} still "
                    f"running after {timeout:.0f} s")
            try:
                rank, status, payload = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode is not None]
                if dead:
                    # a rank killed before it could report (signal, OOM)
                    time.sleep(1.0)
                    if results.empty():
                        raise RankError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} without a result")
                continue
            if status == "error":
                raise RankError(f"rank {rank} of {n} failed:\n{payload}")
            done[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=10.0 if len(done) == n else 0.5)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return done[0]
