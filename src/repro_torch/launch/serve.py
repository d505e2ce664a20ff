"""The static serving driver, ported from ``repro/launch/serve.py``.

``Server.generate`` is the static two-phase loop: a rectangular batch is
prefilled (the prompt rolled through ``lm.decode_step`` one position at a
time, as the JAX driver's single jitted dispatch does), then decoded in
lock-step.  It keeps every fix and validation of the JAX driver: the loop
stops once every request has passed its stop length (and dispatches
nothing when ``stops.max() == 0``), the prompt shape is checked against
``ServeConfig`` and the cache ``max_len``, and each call draws a fresh
random stream.  Temperature sampling draws from a ``torch.Generator``, so
only greedy decoding is comparable with the JAX driver.

Dispatch accounting: ``STATS`` counts ``prefill`` / ``decode`` dispatches,
``decode_slot_steps`` and ``generated_tokens``; ``Server.last_stats`` is a
per-run :class:`~repro_torch.core.scheduler.ServeStats`.
``Server.engine`` builds the continuous-batching
:class:`~repro_torch.launch.engine.Engine` over the same parameters.

Usage (full width on the card; ``--reduced`` for the small config,
``--device cpu`` for the plain versions on the CPU):

  python -m repro_torch.launch.serve --arch deepseek-7b --mode brainslug
  python -m repro_torch.launch.serve --arch mamba2-2.7b --mode brainslug
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Any

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, RuntimeConfig
from repro_torch.core.scheduler import ServeStats
from repro_torch.kernels.fused_stack.ops import DispatchStats
from repro_torch.launch import engine as engine_mod
from repro_torch.layers import base
from repro_torch.models import lm

STATS = DispatchStats(keys=("prefill", "decode", "decode_slot_steps",
                            "generated_tokens"))


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    arch: str = "qwen2.5-14b"
    reduced: bool = True
    mode: str = "xla"
    batch: int = 4
    prompt_len: int = 16
    new_tokens: int = 16
    max_len: int = 64
    temperature: float = 0.0           # 0 = greedy
    seed: int = 0
    torch_device: str = "cuda"


class Server:
    """Holds the parameters and drives prefill and decode.

    ``params`` (a tree as :func:`repro_torch.models.lm.init` makes, for
    example the JAX package's carried over by
    :func:`repro_torch.convert.lm_params_from_numpy`) replaces the seeded
    random initialisation; ``cfg`` replaces the arch's config (for example
    one cut in depth)."""

    def __init__(self, sc: ServeConfig, params: dict | None = None,
                 cfg: ModelConfig | None = None):
        if cfg is None:
            cfg = get_config(sc.arch)
            if sc.reduced:
                cfg = cfg.reduced()
        if not cfg.supports_decode:
            raise ValueError(f"{sc.arch} is encoder-only; no decode path")
        if cfg.frontend == "vision_patches":
            cfg = dataclasses.replace(cfg, frontend=None, n_prefix_tokens=0)
        self.cfg = cfg
        self.sc = sc
        self.device = base.device(sc.torch_device)
        self.rt = RuntimeConfig(mode=sc.mode)
        self.params = (lm.init(sc.seed, cfg, device=self.device)
                       if params is None else params)
        self.last_stats: ServeStats | None = None
        self.last_dispatch: dict[str, int] | None = None
        self._n_calls = 0

    def engine(self, *, slots: int | None = None, prefill_chunk: int = 8,
               seed: int | None = None, kv_layout: str | None = None,
               kv_block_size: int | None = None,
               kv_num_blocks: int | None = None,
               prefix_sharing: bool = True,
               verify_mode: str = "warn") -> engine_mod.Engine:
        """A continuous-batching :class:`~repro_torch.launch.engine.Engine`
        over this server's parameters and config, on its device
        (``slots`` defaults to the static batch width; the cache budget is
        the same ``max_len``).

        ``kv_layout``/``kv_block_size`` override the runtime config's KV
        layout for this engine (``"paged"`` swaps the dense per-slot
        reservation for the block pool); the other knobs pass through.
        The JAX signature's ``mesh``/``serve_partition`` come with the
        multi-device slice."""
        rt = self.rt
        if kv_layout is not None or kv_block_size is not None:
            rt = dataclasses.replace(
                rt,
                kv_layout=rt.kv_layout if kv_layout is None else kv_layout,
                kv_block_size=(rt.kv_block_size if kv_block_size is None
                               else kv_block_size))
        return engine_mod.Engine(
            self.cfg, self.params, rt,
            slots=self.sc.batch if slots is None else slots,
            max_len=self.sc.max_len, prefill_chunk=prefill_chunk,
            seed=self.sc.seed if seed is None else seed,
            kv_num_blocks=kv_num_blocks, prefix_sharing=prefix_sharing,
            verify_mode=verify_mode)

    def _decode(self, cache: dict, tokens_t: torch.Tensor
                ) -> tuple[torch.Tensor, dict]:
        return lm.decode_step(self.params, cache, tokens_t, self.cfg,
                              self.rt)

    @torch.inference_mode()
    def prefill(self, tokens: np.ndarray | torch.Tensor
                ) -> tuple[Any, torch.Tensor]:
        """Ingest the prompt (cache-building prefill).  Returns (cache,
        last-token logits)."""
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                                 device=self.device)
        b, s = tokens.shape
        if s > self.sc.max_len:
            raise ValueError(
                f"prompt length {s} exceeds cache max_len = "
                f"{self.sc.max_len}; the prefill would write past the end "
                f"of the KV cache")
        cache = lm.init_decode_cache(self.cfg, b, self.sc.max_len,
                                     dtype=torch.float32, device=self.device)
        if s == 0:
            # zero-length prompts have no last-token logits; generation
            # starts from all-zero logits (greedy decodes the pad token 0)
            return cache, torch.zeros((b, self.cfg.vocab_size),
                                      dtype=torch.float32, device=self.device)
        STATS.record("prefill")
        for t in range(s):
            logits, cache = self._decode(cache, tokens[:, t:t + 1])
        return cache, logits[:, 0]

    def _sample(self, logits: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
        if self.sc.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / self.sc.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32)

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray,
                 stop_lengths: np.ndarray | None = None,
                 generator: torch.Generator | None = None) -> np.ndarray:
        """prompts: (B, P) int32.  Returns (B, new_tokens) generations;
        rows are zero-padded past their stop length.

        ``generator`` overrides the sampling stream of this call; by
        default each call seeds a fresh one from ``seed + 1`` and a call
        counter."""
        sc = self.sc
        prompts = np.asarray(prompts)
        if prompts.ndim != 2 or prompts.shape != (sc.batch, sc.prompt_len):
            raise ValueError(
                f"prompts shape {tuple(prompts.shape)} does not match "
                f"ServeConfig(batch={sc.batch}, prompt_len={sc.prompt_len})")
        if sc.prompt_len + sc.new_tokens > sc.max_len:
            raise ValueError(
                f"prompt_len + new_tokens = {sc.prompt_len} + "
                f"{sc.new_tokens} exceeds cache max_len = {sc.max_len}; "
                f"the generation would write past the end of the KV cache")
        b = sc.batch
        stops = (np.full((b,), sc.new_tokens)
                 if stop_lengths is None else np.asarray(stop_lengths))
        if stops.shape != (b,):
            raise ValueError(
                f"stop_lengths shape {tuple(stops.shape)} does not match "
                f"the batch: expected ({b},)")
        stops = np.clip(stops, 0, sc.new_tokens)
        out = np.zeros((b, sc.new_tokens), np.int32)
        stats = ServeStats(n_requests=b, n_slots=b)
        stats_before = STATS.snapshot()
        t0 = time.perf_counter()

        live_steps = int(stops.max()) if b else 0
        if live_steps == 0:
            self.last_stats = stats
            self.last_dispatch = STATS.delta(stats_before)
            return out

        cache, logits = self.prefill(prompts.astype(np.int32))
        if sc.prompt_len > 0:
            stats.step_dispatches += 1
            stats.prefill_tokens += b * sc.prompt_len
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                (sc.seed + 1) * 1_000_003 + self._n_calls)
        self._n_calls += 1
        for i in range(live_steps):
            nxt = self._sample(logits, generator)
            done = torch.as_tensor(i >= stops, device=self.device)
            nxt = torch.where(done, 0, nxt)                  # pad finished
            out[:, i] = nxt.cpu().numpy()
            n_live = int((i < stops).sum())
            stats.generated_tokens += n_live
            STATS.record("generated_tokens", n_live)
            # the last sampled step needs no further logits
            if i + 1 < live_steps:
                STATS.record("decode")
                STATS.record("decode_slot_steps", b)
                stats.step_dispatches += 1
                stats.decode_slot_steps += b
                stats.padded_decode_slot_steps += b - int((i + 1 < stops).sum())
                logits_full, cache = self._decode(
                    cache, nxt[:, None].to(torch.int64))
                logits = logits_full[:, 0]
        stats.completed = b
        stats.admitted = b
        stats.wall_s = time.perf_counter() - t0
        self.last_stats = stats
        self.last_dispatch = STATS.delta(stats_before)
        return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--mode", default="xla",
                    choices=["brainslug", "xla", "barrier"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--reduced", action="store_true",
                    help="the config's small CPU-smoke variant")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    sc = ServeConfig(arch=args.arch, reduced=args.reduced, mode=args.mode,
                     batch=args.batch, prompt_len=args.prompt_len,
                     new_tokens=args.new_tokens,
                     max_len=args.prompt_len + args.new_tokens + 1,
                     temperature=args.temperature, torch_device=args.device)
    server = Server(sc)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, server.cfg.vocab_size,
                           (sc.batch, sc.prompt_len)).astype(np.int32)
    t0 = time.time()
    gen = server.generate(prompts)
    dt = time.time() - t0
    tput = sc.batch * sc.new_tokens / dt
    print(f"[serve] {sc.arch} {sc.mode} on {server.device}: {sc.batch} "
          f"requests x {sc.new_tokens} tokens in {dt:.2f}s "
          f"({tput:.1f} tok/s)")
    print("[serve] first generation:", gen[0].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
