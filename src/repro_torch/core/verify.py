"""Static soundness checks, ported from ``repro/core/verify.py``: the
serving block-table family (``kv.*``) and the policy around it.

:func:`check_block_tables` re-derives, independently of the allocator that
produced them, the invariants of the serve engine's paged-KV bookkeeping at
one scheduler tick, and reports each violation as a :class:`Finding`.
:func:`enforce` applies the mode: ``"strict"`` raises
:class:`VerifyError`, ``"warn"`` warns, ``"off"`` does nothing.  The
invariant names and the findings are the JAX package's; the graph, plan,
grid, registry and mesh families come with the guardrails slice of the
port.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Iterable, Sequence

#: Verification modes the engine accepts.
VERIFY_MODES = ("off", "warn", "strict")

_ENGINE = "src/repro_torch/launch/engine.py"

#: invariant id -> (source module the artifact came from, description).
INVARIANTS: dict[str, tuple[str, str]] = {
    "kv.block-out-of-bounds": (
        _ENGINE,
        "every block id a slot table, the free list or the prefix cache "
        "holds lies inside the physical pool"),
    "kv.length-uncovered": (
        _ENGINE,
        "every slot's mapped blocks cover its logical KV length"),
    "kv.refcount-mismatch": (
        _ENGINE,
        "every block's refcount equals the number of slot tables mapping "
        "it plus its prefix-cache reference, and free blocks hold none"),
    "kv.shared-writable": (
        _ENGINE,
        "no block a dispatch is about to write is mapped by more than one "
        "owner (copy-on-write must have forked it first)"),
    "kv.freed-reachable": (
        _ENGINE,
        "no block on the free list is still reachable from a slot table "
        "or the prefix cache"),
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One invariant check result.

    ``invariant`` is a key of :data:`INVARIANTS`; ``severity`` is
    ``"error"`` (soundness at stake: raises under ``"strict"``) or
    ``"warning"`` (recorded, never raised); ``subject`` names the offending
    slot, block or structure; ``source`` the module that produced it."""

    invariant: str
    severity: str
    subject: str
    detail: str
    source: str = ""

    def __post_init__(self) -> None:
        if not self.source and self.invariant in INVARIANTS:
            object.__setattr__(self, "source", INVARIANTS[self.invariant][0])

    def __str__(self) -> str:
        return (f"[{self.severity}] {self.invariant} @ {self.subject}: "
                f"{self.detail} (source: {self.source or 'unknown'})")

    def to_json(self) -> dict[str, str]:
        return {"invariant": self.invariant, "severity": self.severity,
                "subject": self.subject, "detail": self.detail,
                "source": self.source}


class VerifyError(Exception):
    """Verification failed under ``"strict"``.  Carries every error
    finding; the message names the first."""

    def __init__(self, findings: Sequence[Finding]) -> None:
        self.findings = tuple(findings)
        first = self.findings[0] if self.findings else None
        head = (f"static verification found {len(self.findings)} invariant "
                f"violation(s)")
        if first is not None:
            head += f"; first: {first}"
        super().__init__(head)


def errors(findings: Iterable[Finding]) -> list[Finding]:
    return [f for f in findings if f.severity == "error"]


def enforce(findings: Sequence[Finding], mode: str, subject: str = "") -> None:
    """Apply the mode to a batch of findings: ``strict`` raises
    :class:`VerifyError` on any error finding, ``warn`` emits one
    :class:`UserWarning` summarising the waived errors, ``off`` does
    nothing."""
    if mode not in VERIFY_MODES:
        raise ValueError(f"unknown verify mode {mode!r}; allowed: "
                         f"{VERIFY_MODES}")
    if mode == "off":
        return
    errs = errors(findings)
    if not errs:
        return
    if mode == "strict":
        raise VerifyError(errs)
    warnings.warn(
        f"repro_torch.verify: waived {len(errs)} invariant violation(s) "
        f"(verify='warn'){' in ' + subject if subject else ''}; first: "
        f"{errs[0]}", UserWarning, stacklevel=3)


@dataclasses.dataclass(frozen=True)
class BlockTableState:
    """Snapshot of the serve engine's paged-KV bookkeeping at one scheduler
    tick, in plain tuples so the checker re-derives soundness independently
    of the allocator that produced it.

    ``tables``/``lengths`` are per live slot (one row each); ``cached`` is
    the set of blocks the prefix cache holds a reference to; ``writers`` is
    the set of physical blocks the imminent dispatch will write into."""

    num_blocks: int
    block_size: int
    refcounts: tuple[int, ...]          # per physical block
    free: tuple[int, ...]               # allocator free list
    tables: tuple[tuple[int, ...], ...]  # live slots' mapped blocks
    lengths: tuple[int, ...]            # live slots' logical KV lengths
    cached: tuple[int, ...] = ()
    writers: tuple[int, ...] = ()


def check_block_tables(state: BlockTableState) -> list[Finding]:
    """Block-table soundness for the paged serving cache: in-bounds ids,
    length coverage, refcounts re-derived from the mapping tables and the
    prefix cache, copy-on-write discipline for the blocks about to be
    written, and free-list unreachability."""
    fs: list[Finding] = []
    n, bs = state.num_blocks, state.block_size

    def in_bounds(b: int) -> bool:
        return 0 <= b < n

    for where, ids in (("free list", state.free),
                       ("prefix cache", state.cached),
                       ("write set", state.writers)):
        for b in ids:
            if not in_bounds(b):
                fs.append(Finding(
                    "kv.block-out-of-bounds", "error", where,
                    f"block id {b} outside the {n}-block pool"))

    derived = [0] * n
    cached = set(state.cached)
    for b in cached:
        if in_bounds(b):
            derived[b] += 1
    for s_i, (row, length) in enumerate(zip(state.tables, state.lengths)):
        subj = f"slot[{s_i}]"
        for b in row:
            if not in_bounds(b):
                fs.append(Finding(
                    "kv.block-out-of-bounds", "error", subj,
                    f"mapped block id {b} outside the {n}-block pool"))
            else:
                derived[b] += 1
        if len(row) * bs < length:
            fs.append(Finding(
                "kv.length-uncovered", "error", subj,
                f"{len(row)} mapped blocks of {bs} tokens cover "
                f"{len(row) * bs} positions < logical length {length}"))

    if len(state.refcounts) != n:
        fs.append(Finding(
            "kv.refcount-mismatch", "error", "allocator",
            f"{len(state.refcounts)} refcounts recorded for a {n}-block "
            f"pool"))
        return fs
    free = set(state.free)
    for b in range(n):
        want = derived[b]
        got = state.refcounts[b]
        if b in free:
            if want:
                continue            # reported as kv.freed-reachable below
            if got != 0:
                fs.append(Finding(
                    "kv.refcount-mismatch", "error", f"block[{b}]",
                    f"free block carries refcount {got}"))
        elif got != want:
            fs.append(Finding(
                "kv.refcount-mismatch", "error", f"block[{b}]",
                f"recorded refcount {got} != {want} derived from "
                f"{derived[b]} table/cache reference(s)"))

    for b in state.writers:
        if in_bounds(b) and derived[b] > 1:
            fs.append(Finding(
                "kv.shared-writable", "error", f"block[{b}]",
                f"dispatch writes a block held by {derived[b]} owners; "
                f"copy-on-write must fork before the write"))

    for b in free:
        if in_bounds(b) and derived[b] > 0:
            fs.append(Finding(
                "kv.freed-reachable", "error", f"block[{b}]",
                f"freed block still reachable from {derived[b]} "
                f"table/cache reference(s)"))
    return fs
