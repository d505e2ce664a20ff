"""Atomic, async, restart-safe checkpointing, ported from
``repro/checkpoint/checkpointer.py`` with the same on-disk layout, so the
two packages read each other's checkpoints.

Layout: ``<dir>/step_<N>/`` holding one ``.npy`` per tree leaf (named by the
``/``-joined key path, sorted-key order, with ``__`` in place of ``/``) plus
``manifest.json`` (step, leaf dtypes and shapes, ``extra``, the completion
marker).  Writes go to ``step_<N>.tmp`` and are renamed only after the
manifest's fsync, so a killed process never leaves a half-readable
"latest" checkpoint: the invariant the auto-resume trainer relies on.

Leaves are tensors (or numpy arrays), moved to the host on the caller's
thread.  A bfloat16 leaf is written as its bits, a ``uint16`` array, with
``"bfloat16"`` as its dtype in the manifest, and read back as the same
bits: it round-trips exactly (numpy has no bfloat16 of its own).  The JAX
package's ``np.save`` writes its bfloat16 leaves as two-byte void records
(``|V2``) under the same manifest dtype; those are read as the same bits
too.  The other direction waits on the JAX package's ``restore``, which
takes a ``uint16`` leaf for a dtype mismatch.

``AsyncCheckpointer`` runs the writes on a worker thread (serialisation
and IO overlap training).
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any

import numpy as np
import torch

BF16 = "bfloat16"
#: How a bfloat16 leaf lies on disk: the port writes its bits as ``uint16``,
#: the JAX package as two-byte void records (``|V2``).
_BF16_DISK = (np.dtype(np.uint16), np.dtype("V2"))


def _host(leaf: Any) -> tuple[np.ndarray, str]:
    """A leaf as a host array of its own (not a view of a tensor that
    training updates in place) and the dtype name the manifest records."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        return t.numpy(), str(t.numpy().dtype)
    arr = np.array(leaf)
    return arr, str(arr.dtype)


def _paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``(key path, leaf)`` of a nested dict, in sorted-key order (the JAX
    package's ``tree_flatten_with_path`` order and names)."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _paths(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _unflatten(like: Any, leaves: dict[str, Any], prefix: str = "") -> Any:
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, f"{prefix}{k}/")
                for k, v in like.items()}
    return leaves[prefix[:-1]]


def _flatten(tree: Any) -> dict[str, tuple[np.ndarray, str]]:
    return {name: _host(leaf) for name, leaf in _paths(tree)}


def _write(directory: str, step: int,
           flat: dict[str, tuple[np.ndarray, str]], extra: dict | None,
           keep_last: int) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {
        "step": step,
        "leaves": {name: {"shape": list(a.shape), "dtype": dt}
                   for name, (a, dt) in flat.items()},
        "extra": extra or {},
        "complete": True,
    }
    for name, (arr, _) in flat.items():
        np.save(os.path.join(tmp, name.replace("/", "__") + ".npy"), arr)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(directory, keep_last)
    return final


def save(directory: str, step: int, tree: Any, *, extra: dict | None = None,
         keep_last: int = 3) -> str:
    """Blocking atomic save.  Returns the final checkpoint path."""
    return _write(directory, step, _flatten(tree), extra, keep_last)


def _gc(directory: str, keep_last: int) -> None:
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


class CheckpointError(Exception):
    """A checkpoint directory failed validation (missing or incomplete
    manifest, truncated or unreadable leaf, shape or dtype mismatch).  The
    robust restore path catches this and falls back to the previous
    complete checkpoint instead of crashing the resume."""


def cleanup_orphans(directory: str) -> list[str]:
    """Remove ``step_*.tmp`` dirs left behind by a crash mid-save (never a
    valid restore source: the rename happens only after the manifest's
    fsync).  Returns the removed paths."""
    removed = []
    if not os.path.isdir(directory):
        return removed
    for d in sorted(os.listdir(directory)):
        if d.startswith("step_") and d.endswith(".tmp"):
            path = os.path.join(directory, d)
            shutil.rmtree(path, ignore_errors=True)
            removed.append(path)
    return removed


def available_steps(directory: str) -> list[int]:
    """Steps with a manifest present, ascending (``.tmp`` orphans are never
    counted)."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, d, "manifest.json")):
                try:
                    steps.append(int(d.split("_")[1]))
                except ValueError:
                    continue
    return sorted(steps)


def latest_step(directory: str) -> int | None:
    steps = available_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: int, like: Any) -> tuple[Any, dict]:
    """Restore into the structure of ``like`` (a tree of tensors): each
    leaf with its ``like`` leaf's dtype and device.  Returns (tree, extra).

    Validates before trusting: the manifest must exist, parse and carry the
    ``complete`` marker, and every leaf must match the manifest's shape and
    dtype and the shape of ``like``; anything else raises
    :class:`CheckpointError`."""
    path = os.path.join(directory, f"step_{step:08d}")
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointError(
            f"checkpoint {path}: unreadable manifest ({e})") from e
    if not manifest.get("complete"):
        raise CheckpointError(f"checkpoint {path} incomplete "
                              f"(no completion marker)")
    recorded = manifest.get("leaves", {})
    leaves = {}
    for name, leaf in _paths(like):
        spec = recorded.get(name)
        if spec is None:
            raise CheckpointError(
                f"checkpoint {path}: leaf {name!r} missing from manifest")
        try:
            arr = np.load(os.path.join(path, name.replace("/", "__")
                                       + ".npy"))
        except (OSError, ValueError, EOFError) as e:
            raise CheckpointError(f"checkpoint {path}: leaf {name!r} "
                                  f"unreadable or truncated ({e})") from e
        bf16 = spec.get("dtype") == BF16 and arr.dtype in _BF16_DISK
        disk = BF16 if bf16 else str(arr.dtype)
        if tuple(arr.shape) != tuple(spec.get("shape", ())) \
                or disk != spec.get("dtype"):
            raise CheckpointError(
                f"checkpoint {path}: leaf {name!r} is {disk}"
                f"{list(arr.shape)} on disk but the manifest recorded "
                f"{spec.get('dtype')}{spec.get('shape')}")
        if tuple(arr.shape) != tuple(leaf.shape):
            raise CheckpointError(
                f"checkpoint {path}: shape mismatch for {name}: "
                f"{arr.shape} vs {tuple(leaf.shape)}")
        t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
             if bf16 else torch.from_numpy(arr))
        leaves[name] = t.to(device=leaf.device, dtype=leaf.dtype)
    return _unflatten(like, leaves), manifest["extra"]


def restore_latest(directory: str, like: Any
                   ) -> tuple[Any, dict, int] | None:
    """Restore the newest checkpoint that validates, sweeping crash orphans
    first and falling back step by step when the latest is corrupt or
    truncated.  Returns ``(tree, extra, step)``, or None when no complete
    checkpoint survives validation."""
    cleanup_orphans(directory)
    for step in reversed(available_steps(directory)):
        try:
            tree, extra = restore(directory, step, like)
            return tree, extra, step
        except CheckpointError:
            continue
    return None


class AsyncCheckpointer:
    """Fire-and-forget saves on a worker thread; ``wait()`` drains.  The
    leaves are copied to the host by :meth:`submit`, on the caller's
    thread, so training may update them in place right after."""

    def __init__(self, directory: str, keep_last: int = 3):
        self.directory = directory
        self.keep_last = keep_last
        self._q: queue.Queue = queue.Queue()
        self._err: list[Exception] = []
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            step, flat, extra = item
            try:
                _write(self.directory, step, flat, extra, self.keep_last)
            except Exception as e:              # surfaced by wait()
                self._err.append(e)
            finally:
                self._q.task_done()

    def submit(self, step: int, tree: Any, extra: dict | None = None) -> None:
        self._q.put((step, _flatten(tree), extra))

    def wait(self) -> None:
        self._q.join()
        if self._err:
            raise self._err[0]

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._thread.join()
