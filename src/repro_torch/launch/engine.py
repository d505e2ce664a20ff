"""Continuous-batching serve engine, ported from ``repro/launch/engine.py``:
slot-managed KV cache, one mixed prefill/decode step per scheduler tick.

The static driver (``launch/serve.py``) is breadth-first serving: a batch
marches in lock-step and finished requests cycle pad tokens until the
longest stops.  This engine keeps the set of live requests resident:

* **Slots.**  The KV cache has ``slots`` batch rows.  A request is admitted
  into a free slot, generates, and on completion the slot is reset
  (``lm.reset_slots``) and refilled from the queue.
* **One mixed step.**  Every tick runs the same step over a ``(slots,
  chunk)`` token window: a prefilling slot consumes up to ``chunk`` prompt
  tokens, a decoding slot the one token it sampled last tick, an empty slot
  rides along inert.  The step is a host loop of ``lm.decode_step`` over
  ``t < max(counts)`` with ``active = t < counts``, keeping each slot's
  last active logits.  ``counts`` lives on the host, so the trip count
  needs no device read; the tick reads the device once, for the sampled
  tokens.
* **Per-request sampling.**  Temperature, stop length and the random
  stream travel with the request: request ``r`` samples its ``i``-th token
  from a ``torch.Generator`` seeded from ``(seed, run counter,
  r.request_id, i)``, so a sampled generation is reproducible whatever
  slot it lands in and whatever traffic shares its batch.  The JAX engine
  folds the same indices into a ``jax.random`` key; the two draw different
  numbers, so only greedy tokens are comparable with it.

KV memory comes in two layouts (``RuntimeConfig.kv_layout``):

* ``"dense"`` — each slot owns a contiguous ``max_len`` reservation;
* ``"paged"`` — attention KV lives in a pool of ``kv_block_size``-token
  blocks.  A host-side :class:`BlockAllocator` (free list and per-block
  refcounts) hands blocks out on demand; each slot's logical-to-physical
  mapping is a row of a block table passed into every step.  Admission is
  gated on blocks: a request is admitted only when its worst-case need is
  covered by the free pool minus what live slots may still claim.
  Requests with a common token prefix map the same immutable blocks
  (:class:`PrefixCache`, a content-hash chain); a shared block is
  copy-on-write: the write barrier forks it (``lm.copy_blocks``) before
  any step may write it.

The port's cache is updated in place (the JAX engine rebinds a donated
cache).  A fork's copy, a slot reset and the step are queued in that order
on one stream, so the step reads the forked block.  Host arrays handed to
the device (tokens, masks, tables) are copied first: the host mutates them
on the next tick.

Under ``mode="brainslug"`` every decode attention of every sub-step is a
launch of the paged (or dense) flash-decode kernel; ``report()`` names the
path the last run took.  ``Engine(mesh=...)`` belongs to the multi-device
slice of the port and raises.

Dispatch accounting: ``STATS`` (snapshot/delta protocol) and the per-run
:class:`~repro_torch.core.scheduler.ServeStats` in
:attr:`Engine.last_stats`.
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
import time
from typing import Any, Callable, Iterator, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RuntimeConfig
from repro_torch.core import verify
from repro_torch.core.scheduler import ServeStats
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.fused_stack.ops import DispatchStats
from repro_torch.models import lm

STATS = DispatchStats(keys=(
    "mixed_step",          # mixed-step invocations
    "slot_reset",          # slot-reset invocations
    "prefill_tokens",      # prompt tokens ingested by live slots
    "decode_slot_steps",   # slot-units of decode dispatch work
    "idle_slot_steps",     # lane-evaluation units that consumed no token
    "cow_fork",            # copy-on-write block forks (paged layout)
))


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request.  ``request_id`` seeds the random stream
    (reuse an id and you reuse its stream); ``max_new_tokens`` is the stop
    length; ``temperature <= 0`` is greedy.  ``deadline_ms`` bounds the
    queue wait: a request still waiting for a slot past it completes with
    status ``'timeout'``.  ``priority`` orders admission: higher pops first,
    ties in submission order.  ``on_token`` is an optional per-request
    streaming callback, fired with each of this request's
    :class:`TokenEvent`\\ s as the scheduler commits them (identity only:
    it never changes what a request is)."""
    request_id: int
    prompt: Sequence[int]
    max_new_tokens: int
    temperature: float = 0.0
    deadline_ms: float | None = None
    priority: int = 0
    on_token: Callable[["TokenEvent"], None] | None = dataclasses.field(
        default=None, compare=False, repr=False)


@dataclasses.dataclass(frozen=True)
class Completion:
    """``status`` is ``'ok'`` for a served generation; a request that
    failed validation (``'invalid'``), timed out in the queue
    (``'timeout'``) or hit a per-request error (``'error'``) still gets its
    Completion, with the detail in ``reason``: one bad request never aborts
    the other slots' work."""
    request_id: int
    prompt_len: int
    tokens: np.ndarray          # (max_new_tokens,) int32
    status: str = "ok"          # 'ok' | 'invalid' | 'timeout' | 'error'
    reason: str | None = None


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One streamed serving event (``Engine.stream`` / ``run(on_token=)``).

    Token events (``done=False``) carry the ``index``-th generated token of
    their request, in the order the scheduler committed them.  The terminal
    event (``done=True``, ``token=None``) carries the request's
    :class:`Completion`; every request gets exactly one."""
    request_id: int
    token: int | None
    index: int
    done: bool = False
    completion: Completion | None = None


@dataclasses.dataclass
class _Slot:
    """Host-side per-slot request state."""
    idx: int                    # position in the submitted request list
    req: Request
    prompt: np.ndarray          # validated (P,) int32
    pos: int = 0                # prompt tokens consumed so far
    gen: list[int] = dataclasses.field(default_factory=list)
    last: int = 0               # decode input: the token sampled last step
    kv_len: int = 0             # KV positions written (both layouts)
    # paged-layout state
    blocks: list[int] = dataclasses.field(default_factory=list)
    reserve: int = 0            # worst-case blocks still claimable
    chain_key: bytes = b""      # prefix-hash chain after n_reg full blocks
    n_reg: int = 0              # prompt blocks registered with the cache


class BlockAllocator:
    """Host-side physical-block bookkeeping for the paged KV pool.

    A free list hands out block ids; per-block ``refcount`` counts the
    owners (slot tables and the prefix cache), ``filled`` the valid token
    positions (for the utilisation metric).  ``release`` returns a block to
    the free list only when its last owner lets go."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.refcount = [0] * num_blocks
        self.filled = [0] * num_blocks
        # pop() hands out ascending ids
        self._free = list(range(num_blocks - 1, -1, -1))
        self.stored = 0             # sum(filled) over in-use blocks
        self.peak_in_use = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_blocks - len(self._free)

    def free_blocks(self) -> tuple[int, ...]:
        return tuple(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError(
                "KV block pool exhausted — the admission reservation "
                "should have gated this request; this is an engine bug")
        b = self._free.pop()
        self.refcount[b] = 1
        self.filled[b] = 0
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return b

    def share(self, b: int) -> None:
        self.refcount[b] += 1

    def release(self, b: int) -> None:
        self.refcount[b] -= 1
        assert self.refcount[b] >= 0, f"double release of block {b}"
        if self.refcount[b] == 0:
            self.stored -= self.filled[b]
            self.filled[b] = 0
            self._free.append(b)

    def note_fill(self, b: int, upto: int) -> None:
        """Record that block ``b`` now holds ``upto`` valid tokens."""
        if upto > self.filled[b]:
            self.stored += upto - self.filled[b]
            self.filled[b] = upto

    def note_fork(self, src: int, dst: int) -> None:
        """``dst`` inherited ``src``'s contents via the device copy."""
        self.stored += self.filled[src] - self.filled[dst]
        self.filled[dst] = self.filled[src]


_CHAIN_ROOT = b"\x00" * 16


class PrefixCache:
    """Content-addressed map from token prefixes to immutable KV blocks.

    Keys are a hash chain: block ``i`` of a prompt is keyed by
    ``h(parent_key, tokens_i)``, so two prompts share exactly their common
    block-aligned prefix.  Full blocks are registered as soon as a slot's
    prefill completes them; the sub-block tail of a prompt is registered
    only when its request completes (tagged ``b"P"`` so a partial never
    satisfies a full-block walk).  The cache holds one allocator reference
    per registered block; ``evict`` drops cache-only blocks (refcount 1)
    newest first when admission runs short, and ``clear`` releases
    everything at run end."""

    def __init__(self, alloc: BlockAllocator):
        self.alloc = alloc
        self.bs = alloc.block_size
        self._full: dict[bytes, int] = {}
        self._partial: dict[bytes, tuple[int, int]] = {}   # key -> (blk, t)
        self._order: list[tuple[bytes, bool]] = []          # (key, partial)
        self.hits = 0

    @staticmethod
    def _h(parent: bytes, tokens: np.ndarray, tag: bytes = b"F") -> bytes:
        payload = parent + tag + np.asarray(tokens, np.int32).tobytes()
        return hashlib.sha256(payload).digest()[:16]

    def lookup(self, prompt: np.ndarray
               ) -> tuple[list[int], bytes, tuple[int, int] | None]:
        """Longest cached cover of ``prompt``: the full-block chain, the
        chain key after it, and an optional ``(block, t)`` partial tail."""
        key = _CHAIN_ROOT
        blocks: list[int] = []
        pos = 0
        while pos + self.bs <= len(prompt):
            nk = self._h(key, prompt[pos:pos + self.bs])
            blk = self._full.get(nk)
            if blk is None:
                break
            blocks.append(blk)
            key = nk
            pos += self.bs
        rem = len(prompt) - pos
        for t in range(min(rem, self.bs - 1), 0, -1):
            hit = self._partial.get(self._h(key, prompt[pos:pos + t], b"P"))
            if hit is not None:
                return blocks, key, hit
        return blocks, key, None

    def register_full(self, parent: bytes, tokens: np.ndarray,
                      block: int) -> bytes:
        nk = self._h(parent, tokens)
        if nk not in self._full:
            self.alloc.share(block)
            self._full[nk] = block
            self._order.append((nk, False))
        return nk

    def register_partial(self, parent: bytes, tokens: np.ndarray,
                         block: int) -> None:
        if len(tokens) == 0 or len(tokens) >= self.bs:
            return
        pk = self._h(parent, tokens, b"P")
        if pk not in self._partial:
            self.alloc.share(block)
            self._partial[pk] = (block, len(tokens))
            self._order.append((pk, True))

    def cached_blocks(self) -> tuple[int, ...]:
        return tuple([*self._full.values()]
                     + [b for b, _ in self._partial.values()])

    def evict(self, n_needed: int) -> int:
        """Free up to ``n_needed`` cache-only blocks (no live slot maps
        them).  Newest entries go first and partials before fulls: the
        long-lived interior of a popular prefix chain is dropped last."""
        freed = 0
        for partial_pass in (True, False):
            for i in range(len(self._order) - 1, -1, -1):
                if freed >= n_needed:
                    return freed
                k, isp = self._order[i]
                if isp != partial_pass:
                    continue
                blk = self._partial[k][0] if isp else self._full[k]
                if self.alloc.refcount[blk] != 1:
                    continue        # a live slot still maps it
                self.alloc.release(blk)
                (self._partial if isp else self._full).pop(k)
                del self._order[i]
                freed += 1
        return freed

    def clear(self) -> None:
        for k, isp in self._order:
            self.alloc.release(self._partial[k][0] if isp
                               else self._full[k])
        self._full.clear()
        self._partial.clear()
        self._order.clear()


def lane_seed(run_seed: int, request_id: int, index: int) -> int:
    """The seed of request ``request_id``'s ``index``-th sample in a run:
    a hash of the three, so streams never depend on slot or traffic."""
    digest = hashlib.sha256(
        f"{run_seed}/{request_id}/{index}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


class Engine:
    """Continuous-batching generation over a fixed slot pool.

    ``Engine.run(requests)`` admits the queue into ``slots`` cache rows and
    drives the mixed step until every request has completed; it returns
    one :class:`Completion` per request, in submission order.  The engine
    runs on the device that holds ``params``.

    With ``rt.kv_layout == "paged"`` the attention KV lives in a pool of
    ``kv_num_blocks`` blocks (default ``slots * ceil(max_len /
    kv_block_size)``, the dense footprint; size it smaller to
    oversubscribe).  ``prefix_sharing`` maps common block-aligned prompt
    prefixes onto shared immutable blocks.  ``verify_mode`` runs the
    ``kv.*`` block-table invariants
    (:func:`repro_torch.core.verify.check_block_tables`) every tick:
    ``"warn"`` (default) warns, ``"strict"`` raises, ``"off"`` skips."""

    def __init__(self, cfg: ModelConfig, params: dict, rt: RuntimeConfig, *,
                 slots: int, max_len: int, prefill_chunk: int = 8,
                 seed: int = 0, kv_num_blocks: int | None = None,
                 prefix_sharing: bool = True, verify_mode: str = "warn",
                 mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "Engine(mesh=...): mesh serving comes with the multi-device "
                "slice of the port")
        if not cfg.supports_decode:
            raise ValueError(f"{cfg.name} is encoder-only; no decode path")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if rt.kv_layout not in ("dense", "paged"):
            raise ValueError(f"unknown kv_layout {rt.kv_layout!r}; "
                             f"allowed: 'dense' | 'paged'")
        if verify_mode not in verify.VERIFY_MODES:
            raise ValueError(f"unknown verify_mode {verify_mode!r}; "
                             f"allowed: {verify.VERIFY_MODES}")
        self.cfg = cfg
        self.params = params
        self.rt = rt
        self.device = params["embed"].device
        self.slots = slots
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.seed = seed
        self.kv_layout = rt.kv_layout
        self.block_size = rt.kv_block_size
        self.max_blocks = -(-max_len // self.block_size)
        if self.kv_layout == "paged":
            if kv_num_blocks is None:
                kv_num_blocks = slots * self.max_blocks
            if kv_num_blocks < self.max_blocks:
                raise ValueError(
                    f"kv_num_blocks = {kv_num_blocks} cannot cover even "
                    f"one worst-case request ({self.max_blocks} blocks of "
                    f"{self.block_size} for max_len = {max_len})")
        self.kv_num_blocks = kv_num_blocks or 0
        # recurrent families carry per-slot state that a prefix hit would
        # skip building, so sharing is attention-family only
        self.prefix_sharing = (prefix_sharing
                               and self.kv_layout == "paged"
                               and cfg.family not in ("ssm", "hybrid"))
        self.verify_mode = verify_mode
        self.mesh = None
        self.last_stats: ServeStats | None = None
        self.last_dispatch: dict[str, int] | None = None
        self.last_allocator: BlockAllocator | None = None
        self.last_prefix_cache: PrefixCache | None = None
        self.last_admission_order: list[int] = []
        self.last_attn_dispatch: dict[str, int] | None = None
        self._n_runs = 0

    def report(self) -> dict:
        """Dispatch summary of the last run: which decode path ran (the
        CUDA kernel, its plain version on the CPU, the reference, or for an
        attention-free model the recurrent SSM step), with
        the reason where it is not the kernel, and the engine and
        attention dispatch deltas.  ``mesh_axes`` and ``serve_partition``
        stay empty until the multi-device slice."""
        attn = dict(self.last_attn_dispatch or {})
        pre = "paged_" if self.kv_layout == "paged" else ""
        name = "paged-decode" if pre else "flash-decode"
        if attn.get(f"{pre}decode_kernel"):
            path, fallback = f"cuda-{name}", None
        elif attn.get(f"{pre}decode_plain"):
            path = f"plain-{name}"
            fallback = ("CPU tensors run the kernel's plain version; the "
                        "CUDA kernel runs on the card")
        elif self.cfg.family == "ssm":
            path = "ssm-recurrent"
            fallback = "no attention layers: nothing to flash-decode"
        elif attn.get(f"{pre}decode_ref") or self.rt.mode != "brainslug":
            path = f"ref-{name}" if pre else "ref-decode"
            fallback = (f"mode={self.rt.mode!r} runs the reference decode; "
                        f"the kernel is the mode='brainslug' fast path")
        else:
            path = f"cuda-{name}" if self.device.type == "cuda" \
                else f"plain-{name}"
            fallback = "no run yet: inferred from mode and device"
        return {
            "mode": self.rt.mode,
            "kv_layout": self.kv_layout,
            "decode_path": path,
            "decode_fallback": fallback,
            "mesh_axes": {},
            "serve_partition": {},
            "dispatch": dict(self.last_dispatch or {}),
            "attn_dispatch": attn,
        }

    # -- admission ----------------------------------------------------------

    def _validate(self, r: Request) -> np.ndarray:
        prompt = np.asarray(r.prompt, np.int32)
        if prompt.ndim > 1:
            raise ValueError(
                f"request {r.request_id}: prompt must be a 1-D token "
                f"sequence, got shape {tuple(prompt.shape)} (one Request "
                f"per row — the engine batches across requests itself)")
        prompt = prompt.reshape(-1)
        if r.max_new_tokens < 0:
            raise ValueError(
                f"request {r.request_id}: max_new_tokens must be >= 0")
        total = len(prompt) + r.max_new_tokens
        if total > self.max_len:
            raise ValueError(
                f"request {r.request_id}: prompt_len + max_new_tokens = "
                f"{len(prompt)} + {r.max_new_tokens} = {total} exceeds the "
                f"cache max_len = {self.max_len}; the generation would "
                f"write past the end of its KV-cache slot")
        return prompt

    def _first_token_from_zero_logits(self, req: Request,
                                      run_seed: int) -> int:
        """Empty prompt: no last-prompt-position logit, so the first token
        is sampled from all-zero logits (greedy decodes the pad token 0;
        temperature samples the uniform distribution), the static
        driver's empty-prompt convention."""
        if req.temperature <= 0.0:
            return 0
        g = torch.Generator().manual_seed(
            lane_seed(run_seed, req.request_id, 0))
        return int(torch.multinomial(torch.ones(self.cfg.vocab_size), 1,
                                     generator=g))

    @staticmethod
    def _worst_blocks(prompt_len: int, max_new: int, bs: int) -> int:
        """Total block columns a request can ever touch: the last KV write
        lands at position ``prompt_len + max_new - 2`` (the final sampled
        token is never written back)."""
        return (prompt_len + max_new - 2) // bs + 1

    # -- device work --------------------------------------------------------

    def _to_device(self, a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        """A fresh device copy of a host array (the host mutates its
        arrays on the next tick)."""
        return torch.tensor(np.asarray(a), dtype=dtype, device=self.device)

    @torch.inference_mode()
    def _new_cache(self) -> dict:
        # float32 pools and caches, as the JAX engine builds them
        if self.kv_layout == "paged":
            return lm.init_decode_cache(
                self.cfg, self.slots, self.max_len, dtype=torch.float32,
                kv_layout="paged", kv_num_blocks=self.kv_num_blocks,
                kv_block_size=self.block_size, device=self.device)
        return lm.init_decode_cache(self.cfg, self.slots, self.max_len,
                                    dtype=torch.float32, device=self.device)

    @torch.inference_mode()
    def _reset(self, cache: dict, mask: list[bool],
               lengths: list[int] | None) -> dict:
        m = self._to_device(mask, torch.bool)
        ln = None if lengths is None else self._to_device(lengths,
                                                          torch.int32)
        return lm.reset_slots(cache, m, ln)

    @torch.inference_mode()
    def _copy(self, cache: dict, src: int, dst: int) -> dict:
        return lm.copy_blocks(cache, src, dst)

    @torch.inference_mode()
    def _step(self, cache: dict, tables: np.ndarray | None,
              tokens: np.ndarray, counts: np.ndarray, rids: np.ndarray,
              tidx: np.ndarray, temps: np.ndarray, run_seed: int
              ) -> tuple[np.ndarray, dict]:
        """The mixed prefill/decode step.  Slot b consumes
        ``tokens[b, :counts[b]]`` (0 = idle lane); returns the token each
        slot samples from its last consumed position.  ``max(counts)``
        model evaluations: in decode-only steady state one, not C."""
        window = int(counts.max())
        tok = self._to_device(tokens, torch.int64)
        act = self._to_device(np.arange(window)[:, None] < counts[None, :],
                              torch.bool)                     # (window, B)
        tbl = None if tables is None else self._to_device(tables,
                                                          torch.int32)
        logits_last = torch.zeros((tokens.shape[0], self.cfg.vocab_size),
                                  dtype=torch.float32, device=self.device)
        for t in range(window):
            logits, cache = lm.decode_step(self.params, cache,
                                           tok[:, t:t + 1], self.cfg,
                                           self.rt, act[t],
                                           block_tables=tbl)
            logits_last = torch.where(act[t][:, None],
                                      logits[:, 0].float(), logits_last)
        nxt = torch.argmax(logits_last, dim=-1)
        for b in np.flatnonzero(temps > 0.0):
            g = torch.Generator(device=self.device).manual_seed(
                lane_seed(run_seed, int(rids[b]), int(tidx[b])))
            probs = torch.softmax(logits_last[b] / max(float(temps[b]), 1e-6),
                                  dim=-1)
            nxt[b] = torch.multinomial(probs, 1, generator=g)[0]
        return nxt.cpu().numpy().astype(np.int32), cache

    # -- main loop ----------------------------------------------------------

    def run(self, requests: Sequence[Request], key: int | None = None, *,
            on_token: Callable[[TokenEvent], None] | None = None
            ) -> list[Completion]:
        """Serve every request to completion; returns completions in
        submission order.  ``key`` overrides the run's sampling seed
        (default: a hash of ``seed`` and the run counter, so repeated runs
        with temperature sampling draw fresh streams).

        ``on_token`` streams the run: it fires with every
        :class:`TokenEvent` as the scheduler commits it (after any
        per-request ``Request.on_token``).  A validation failure yields a
        ``status='invalid'`` Completion for that request and the rest of
        the queue is served: ``run()`` raises only for engine faults."""
        it = self._serve(requests, key)
        while True:
            try:
                ev = next(it)
            except StopIteration as stop:
                return stop.value
            if on_token is not None:
                on_token(ev)

    def stream(self, requests: Sequence[Request],
               key: int | None = None) -> Iterator[TokenEvent]:
        """Generator form of :meth:`run`: yields every :class:`TokenEvent`
        in commit order.  Each request's terminal event carries its
        :class:`Completion`; per-run stats land on :attr:`last_stats` once
        the generator is exhausted."""
        yield from self._serve(requests, key)

    def _serve(self, requests: Sequence[Request], key: int | None) -> Any:
        """The scheduler loop as a generator: yields TokenEvents at every
        commit point, returns the submission-ordered completions."""
        run_seed = (lane_seed(self.seed, -1, self._n_runs) if key is None
                    else int(key))
        self._n_runs += 1
        stats_before = STATS.snapshot()
        attn_before = attn_ops.STATS.snapshot()

        B, C, bs = self.slots, self.prefill_chunk, self.block_size
        paged = self.kv_layout == "paged"
        completions: list[Completion | None] = [None] * len(requests)
        stats = ServeStats(n_requests=len(requests), n_slots=B)
        events: list[TokenEvent] = []

        def emit(req: Request, ev: TokenEvent) -> None:
            # per-request callbacks fire at commit, before the global
            # stream sees the event
            if req.on_token is not None:
                req.on_token(ev)
            events.append(ev)

        # admission order: highest priority first, FIFO within a priority
        # (the submission index breaks ties, so Requests never compare)
        heap: list[tuple[int, int, Request, np.ndarray]] = []
        for i, r in enumerate(requests):
            try:
                heapq.heappush(heap, (-r.priority, i, r, self._validate(r)))
            except ValueError as e:
                completions[i] = Completion(
                    request_id=r.request_id,
                    prompt_len=int(np.size(np.asarray(r.prompt))),
                    tokens=np.zeros(0, np.int32), status="invalid",
                    reason=str(e))
                stats.failed += 1
                emit(r, TokenEvent(r.request_id, None, 0, True,
                                   completions[i]))
        for ev in events:
            yield ev
        events.clear()
        slot: list[_Slot | None] = [None] * B
        dirty = [False] * B             # slot held a previous request
        pending_reset = [False] * B
        pending_len = [0] * B           # paged: restart length (prefix hit)
        alloc = BlockAllocator(self.kv_num_blocks, bs) if paged else None
        prefix = (PrefixCache(alloc)
                  if paged and self.prefix_sharing else None)
        self.last_allocator = alloc
        self.last_prefix_cache = prefix
        self.last_admission_order = []
        tables = np.zeros((B, self.max_blocks), np.int32)
        outstanding = 0         # worst-case blocks live slots may claim
        util_acc, util_n = 0.0, 0
        latencies: list[float] = []
        n_latency_pending = 0   # ok-completions awaiting the next tick's
        # clock read (one timestamp per tick)
        ttfts: list[float] = []
        n_ttft_pending = 0      # first-token commits awaiting that read
        cache = self._new_cache()
        t0 = time.perf_counter()

        def complete(s_idx: int, req: Request, prompt, gen) -> None:
            nonlocal n_latency_pending
            completions[s_idx] = Completion(
                request_id=req.request_id, prompt_len=len(prompt),
                tokens=np.asarray(gen, np.int32))
            stats.completed += 1
            n_latency_pending += 1
            emit(req, TokenEvent(req.request_id, None, len(gen), True,
                                 completions[s_idx]))

        def try_map(prompt: np.ndarray, max_new: int):
            """Prefix-map and block-gate one request.  Returns ``(blocks,
            cached_len, chain_key, n_full, reserve)`` after taking the
            reservation, or None when the pool (minus what live slots may
            still claim) cannot cover the worst case; the caller keeps the
            request queued (head of line)."""
            nonlocal outstanding
            worst_total = self._worst_blocks(len(prompt), max_new, bs)
            blocks: list[int] = []
            chain_key = _CHAIN_ROOT
            cached_len = 0
            n_full = 0
            if prefix is not None and len(prompt) > 0:
                fulls, chain_key, partial = prefix.lookup(prompt)
                # take the references now: a hit block must not be evicted
                # before the slot's table points at it
                for pb in fulls:
                    alloc.share(pb)
                blocks = list(fulls)
                n_full = len(fulls)
                cached_len = n_full * bs
                if partial is not None:
                    pb, t = partial
                    alloc.share(pb)
                    blocks.append(pb)
                    cached_len += t
                # the last prompt position is recomputed so the slot has a
                # logit to sample its first token from
                cached_len = min(cached_len, len(prompt) - 1)
            # at most one mapped block is ever written (the boundary column
            # at cached_len // bs): at most one fork; the rest of the worst
            # case is fresh extension blocks
            reserve = worst_total - len(blocks) + (1 if blocks else 0)
            avail = alloc.n_free - outstanding
            if reserve > avail and prefix is not None:
                prefix.evict(reserve - avail)
                avail = alloc.n_free - outstanding
            if reserve > avail:
                for pb in reversed(blocks):
                    alloc.release(pb)
                return None
            outstanding += reserve
            if prefix is not None:
                prefix.hits += cached_len
            return blocks, cached_len, chain_key, n_full, reserve

        def unmap(mapping) -> None:
            """Roll back a ``try_map`` reservation."""
            nonlocal outstanding
            blocks, _, _, _, reserve = mapping
            for pb in reversed(blocks):
                alloc.release(pb)
            outstanding -= reserve

        def release_slot(b: int, s: _Slot) -> None:
            """Return a completed slot's blocks (registering the prompt's
            sub-block tail with the prefix cache first: it is immutable
            from here on) and its unused reservation."""
            nonlocal outstanding
            plen = len(s.prompt)
            if prefix is not None and plen % bs and s.kv_len >= plen:
                pcol = plen // bs
                prefix.register_partial(s.chain_key, s.prompt[pcol * bs:],
                                        s.blocks[pcol])
            for blk in s.blocks:
                alloc.release(blk)
            s.blocks = []
            outstanding -= s.reserve
            s.reserve = 0
            tables[b, :] = 0

        def admit(now: float) -> None:
            nonlocal n_ttft_pending
            for b in range(B):
                while slot[b] is None and heap:
                    entry = heapq.heappop(heap)
                    _, idx, req, prompt = entry
                    waited_ms = (now - t0) * 1e3
                    if req.deadline_ms is not None \
                            and waited_ms > req.deadline_ms:
                        completions[idx] = Completion(
                            request_id=req.request_id,
                            prompt_len=len(prompt),
                            tokens=np.zeros(0, np.int32),
                            status="timeout",
                            reason=(f"queued {waited_ms:.1f}ms, past the "
                                    f"{req.deadline_ms:.1f}ms deadline"))
                        stats.timed_out += 1
                        emit(req, TokenEvent(req.request_id, None, 0, True,
                                             completions[idx]))
                        continue
                    # max_new == 0 completes at admission without touching
                    # KV; everything else gates on its worst-case blocks
                    mapping = None
                    if paged and req.max_new_tokens > 0 \
                            and self._worst_blocks(
                                len(prompt), req.max_new_tokens, bs) > 0:
                        mapping = try_map(prompt, req.max_new_tokens)
                        if mapping is None:
                            # the request waits for completions to free
                            # blocks
                            heapq.heappush(heap, entry)
                            return
                    stats.admitted += 1
                    self.last_admission_order.append(idx)
                    if req.max_new_tokens == 0:
                        complete(idx, req, prompt, [])
                        continue
                    gen: list[int] = []
                    last = 0
                    if len(prompt) == 0:
                        try:
                            tok0 = self._first_token_from_zero_logits(
                                req, run_seed)
                        except Exception as e:   # isolate the one request
                            completions[idx] = Completion(
                                request_id=req.request_id, prompt_len=0,
                                tokens=np.zeros(0, np.int32),
                                status="error",
                                reason=f"{type(e).__name__}: {e}")
                            stats.failed += 1
                            emit(req, TokenEvent(req.request_id, None, 0,
                                                 True, completions[idx]))
                            if mapping is not None:
                                unmap(mapping)
                            continue
                        gen = [tok0]
                        stats.generated_tokens += 1
                        n_ttft_pending += 1
                        emit(req, TokenEvent(req.request_id, tok0, 0))
                        if req.max_new_tokens == 1:
                            complete(idx, req, prompt, gen)
                            continue
                        last = tok0
                    cached_len = 0
                    s = _Slot(idx=idx, req=req, prompt=prompt, gen=gen,
                              last=last)
                    if mapping is not None:
                        blocks, cached_len, chain_key, n_full, rsv = \
                            mapping
                        s.blocks = blocks
                        s.reserve = rsv
                        s.chain_key = chain_key
                        s.n_reg = n_full
                        s.pos = cached_len
                        s.kv_len = cached_len
                        tables[b, :] = 0
                        tables[b, :len(blocks)] = blocks
                        stats.prefix_hit_tokens += cached_len
                    if dirty[b] or cached_len:
                        # freed slots restart at length 0; a prefix hit
                        # restarts mid-prompt at cached_len
                        pending_reset[b] = True
                        pending_len[b] = cached_len
                        dirty[b] = False
                    slot[b] = s

        while True:
            # one clock read per tick: every deadline check of this tick
            # and every latency stamped since the last tick sees it
            now = time.perf_counter()
            if n_latency_pending:
                latencies.extend([(now - t0) * 1e3] * n_latency_pending)
                n_latency_pending = 0
            if n_ttft_pending:
                ttfts.extend([(now - t0) * 1e3] * n_ttft_pending)
                n_ttft_pending = 0
            admit(now)
            for ev in events:
                yield ev
            events.clear()
            if any(pending_reset):
                # freed slots restart at length 0 (or a prefix hit's
                # length) before their new request's first prefill chunk
                cache = self._reset(cache, pending_reset,
                                    pending_len if paged else None)
                STATS.record("slot_reset")
                pending_reset = [False] * B
                pending_len = [0] * B
            if all(s is None for s in slot):
                break

            tokens = np.zeros((B, C), np.int32)
            counts = np.zeros((B,), np.int32)
            rids = np.zeros((B,), np.int64)
            tidx = np.zeros((B,), np.int32)
            temps = np.zeros((B,), np.float32)
            was_prefill = [False] * B
            copies: list[tuple[int, int]] = []
            writers: set[int] = set()
            for b, s in enumerate(slot):
                if s is None:
                    continue
                rids[b] = s.req.request_id
                temps[b] = s.req.temperature
                tidx[b] = len(s.gen)
                if s.pos < len(s.prompt):
                    n = min(C, len(s.prompt) - s.pos)
                    tokens[b, :n] = s.prompt[s.pos: s.pos + n]
                    counts[b] = n
                    was_prefill[b] = True
                else:
                    tokens[b, 0] = s.last
                    counts[b] = 1
                    n = 1
                if paged:
                    # write barrier: every block column this step writes
                    # is mapped, and mapped privately: extension columns
                    # get fresh blocks, shared columns are forked
                    # copy-on-write before the step runs
                    lo, hi = s.kv_len, s.kv_len + n
                    for col in range(lo // bs, (hi - 1) // bs + 1):
                        if col >= len(s.blocks):
                            s.blocks.append(alloc.alloc())
                            s.reserve -= 1
                            outstanding -= 1
                        elif alloc.refcount[s.blocks[col]] > 1:
                            nb = alloc.alloc()
                            s.reserve -= 1
                            outstanding -= 1
                            copies.append((s.blocks[col], nb))
                            alloc.note_fork(s.blocks[col], nb)
                            alloc.release(s.blocks[col])
                            s.blocks[col] = nb
                            stats.cow_forks += 1
                            STATS.record("cow_fork")
                        tables[b, col] = s.blocks[col]
                        writers.add(s.blocks[col])
            for src, dst in copies:
                cache = self._copy(cache, src, dst)
            if paged and self.verify_mode != "off":
                rows = [(tuple(s.blocks), s.kv_len + int(counts[b]))
                        for b, s in enumerate(slot) if s is not None]
                state = verify.BlockTableState(
                    num_blocks=self.kv_num_blocks, block_size=bs,
                    refcounts=tuple(alloc.refcount),
                    free=alloc.free_blocks(),
                    tables=tuple(r[0] for r in rows),
                    lengths=tuple(r[1] for r in rows),
                    cached=(prefix.cached_blocks() if prefix is not None
                            else ()),
                    writers=tuple(sorted(writers)))
                verify.enforce(verify.check_block_tables(state),
                               self.verify_mode, subject="engine tick")

            nxt, cache = self._step(cache, tables if paged else None, tokens,
                                    counts, rids, tidx, temps, run_seed)
            stats.step_dispatches += 1
            STATS.record("mixed_step")

            # idle accounting in model-evaluation units: the step runs
            # max(counts) sub-steps over every lane, so an empty lane rides
            # the whole window and a live lane the sub-steps past its own
            # count
            window = int(counts.max())
            for b in range(B):
                s = slot[b]
                if s is None:
                    stats.idle_slot_steps += window
                    STATS.record("idle_slot_steps", window)
                    continue
                n = int(counts[b])
                if was_prefill[b]:
                    s.pos += n
                    stats.prefill_tokens += n
                    STATS.record("prefill_tokens", n)
                    stats.idle_slot_steps += window - n
                    STATS.record("idle_slot_steps", window - n)
                else:
                    stats.decode_slot_steps += 1
                    STATS.record("decode_slot_steps")
                    stats.idle_slot_steps += window - 1
                    STATS.record("idle_slot_steps", window - 1)
                lo = s.kv_len
                s.kv_len = lo + n
                if paged:
                    for col in range(lo // bs, (s.kv_len - 1) // bs + 1):
                        alloc.note_fill(s.blocks[col],
                                        min(s.kv_len - col * bs, bs))
                    if prefix is not None:
                        # a prompt block is immutable once fully written:
                        # publish it so later prompts can share it
                        n_full_now = min(s.kv_len, len(s.prompt)) // bs
                        for col in range(s.n_reg, n_full_now):
                            s.chain_key = prefix.register_full(
                                s.chain_key,
                                s.prompt[col * bs:(col + 1) * bs],
                                s.blocks[col])
                        s.n_reg = n_full_now
                if was_prefill[b] and s.pos < len(s.prompt):
                    continue        # mid-prefill: the sample is discarded
                tok = int(nxt[b])
                s.gen.append(tok)
                s.last = tok
                stats.generated_tokens += 1
                if len(s.gen) == 1:
                    n_ttft_pending += 1
                emit(s.req, TokenEvent(s.req.request_id, tok,
                                       len(s.gen) - 1))
                if len(s.gen) >= s.req.max_new_tokens:
                    complete(s.idx, s.req, s.prompt, s.gen)
                    if paged:
                        release_slot(b, s)
                    slot[b] = None
                    dirty[b] = True

            if paged:
                if alloc.in_use:
                    util_acc += alloc.stored / (alloc.in_use * bs)
                    util_n += 1
            else:
                live = sum(s.kv_len for s in slot if s is not None)
                util_acc += live / (B * self.max_len)
                util_n += 1

            # the tick's commits are final: stream them before the next
            # step so a consumer never waits on future batch-mates
            for ev in events:
                yield ev
            events.clear()

        end = time.perf_counter()
        for ev in events:
            yield ev
        events.clear()
        if n_latency_pending:
            latencies.extend([(end - t0) * 1e3] * n_latency_pending)
        if n_ttft_pending:
            ttfts.extend([(end - t0) * 1e3] * n_ttft_pending)
        stats.wall_s = end - t0
        if latencies:
            stats.p50_latency_ms = float(np.percentile(latencies, 50))
            stats.p99_latency_ms = float(np.percentile(latencies, 99))
        if ttfts:
            stats.ttft_p50_ms = float(np.percentile(ttfts, 50))
            stats.ttft_p99_ms = float(np.percentile(ttfts, 99))
        stats.kv_block_utilization = (util_acc / util_n) if util_n else 0.0
        if paged:
            if prefix is not None:
                # drop the cache's block references: after a run the free
                # list holds the whole pool again (leak check)
                prefix.clear()
            stats.blocks_in_use = alloc.peak_in_use
        self.last_stats = stats
        self.last_dispatch = STATS.delta(stats_before)
        self.last_attn_dispatch = attn_ops.STATS.delta(attn_before)
        return completions  # type: ignore[return-value]
