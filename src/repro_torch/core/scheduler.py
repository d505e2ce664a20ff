"""Execution statistics of the serving drivers, ported from
``repro/core/scheduler.py`` (``ServeStats`` only: the graph scheduler's
role is played by :mod:`repro_torch.core.api` in eager PyTorch)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ServeStats:
    """Serving-driver execution counters (the serving analogue of
    :class:`StackStats`): how many step dispatches a generation run
    issued and how much of the dispatched slot-token work was useful.

    ``decode_slot_steps`` is the headline continuous-batching metric — one
    unit is one batch slot pushed through one decode dispatch.  The static
    driver dispatches *every* slot every step (finished requests cycle pad
    tokens), the engine only counts slots holding a live decoding request,
    so at equal traffic the engine's number is strictly smaller whenever
    stop lengths are ragged."""

    n_requests: int = 0
    n_slots: int = 0
    step_dispatches: int = 0        # step invocations (all phases)
    prefill_tokens: int = 0         # prompt tokens ingested (live slots)
    generated_tokens: int = 0       # tokens actually emitted to requests
    decode_slot_steps: int = 0      # slot-units of decode dispatch work
    padded_decode_slot_steps: int = 0  # subset of decode_slot_steps that
    # only cycled a pad token for an already-finished request (the static
    # loop's waste; 0 for the engine, whose finished slots go idle/refill)
    idle_slot_steps: int = 0        # lane-evaluation units that consumed no
    # token: empty lanes, plus the dead sub-steps live lanes ride in a
    # mixed window (the engine's step runs max(counts) model evaluations
    # over every lane)
    admitted: int = 0
    completed: int = 0
    failed: int = 0                 # requests completed with an error
    # status ('invalid' / 'error') instead of aborting the whole run
    timed_out: int = 0              # requests whose queue wait exceeded
    # their deadline before a slot freed up
    wall_s: float = 0.0
    # --- KV memory (paged layout; see launch/engine.py) -------------------
    kv_block_utilization: float = 0.0  # time-averaged stored-token fraction
    # of the mapped KV blocks (dense layout reports the live-column
    # fraction of its slots x max_len reservation instead)
    prefix_hit_tokens: int = 0      # prompt tokens served from shared
    # prefix blocks instead of being prefilled again
    blocks_in_use: int = 0          # peak pool blocks simultaneously mapped
    cow_forks: int = 0              # copy-on-write block forks (a shared
    # block was about to be written and was copied first)
    # --- request latency (queue wait + service, ok completions) -----------
    p50_latency_ms: float = 0.0
    p99_latency_ms: float = 0.0
    # --- time to first token (admission wait + prefill, streaming) --------
    # Stamped from the same one-timestamp-per-tick clock as the latency
    # percentiles: a request's first generated token commits in some tick,
    # and the next tick's shared timestamp (or the final clock read at run
    # end) closes its TTFT window.
    ttft_p50_ms: float = 0.0
    ttft_p99_ms: float = 0.0

    @property
    def total_tokens(self) -> int:
        return self.prefill_tokens + self.generated_tokens

    @property
    def generated_tokens_per_s(self) -> float:
        return self.generated_tokens / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def slot_utilization(self) -> float:
        """Useful fraction of the dispatched slot-token work: pad-cycling
        decode units and empty lanes both count as waste."""
        total = (self.prefill_tokens + self.decode_slot_steps
                 + self.idle_slot_steps)
        useful = (self.prefill_tokens + self.decode_slot_steps
                  - self.padded_decode_slot_steps)
        return useful / max(total, 1)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["generated_tokens_per_s"] = self.generated_tokens_per_s
        d["slot_utilization"] = self.slot_utilization
        return d
