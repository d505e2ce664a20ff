"""Deterministic synthetic data pipeline, a copy of the JAX package's
``repro/data/pipeline.py`` (numpy only), so its batches are bit for bit
the JAX package's.

Production posture without external data dependencies: batches are a pure
function of ``(seed, step)`` — restart-deterministic, so checkpoint-resume
training is bitwise reproducible, and every host in a multi-host job can
generate its own shard without coordination (each host slices the global
batch by its process index).

A background prefetch thread keeps ``prefetch_depth`` batches ready, which
models the host-side input pipeline overlapping device compute.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    prefetch_depth: int = 2


def _rng_for_step(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def synth_batch(cfg: ModelConfig, shape: ShapeConfig, step: int,
                seed: int = 1234, *, batch_override: int | None = None
                ) -> dict[str, np.ndarray]:
    """One global batch.  LM batches follow a Markov-ish token process so
    the loss actually decreases during the example training runs."""
    rng = _rng_for_step(seed, step)
    b = batch_override or shape.global_batch
    s = shape.seq_len
    out: dict[str, np.ndarray] = {}
    if cfg.frontend == "audio_frames":
        out["frames"] = rng.standard_normal(
            (b, s, cfg.frontend_dim), dtype=np.float32)
        out["labels"] = rng.integers(0, cfg.vocab_size, (b, s),
                                     dtype=np.int32)
        return out
    # learnable structure: tokens follow x_{t+1} = (a*x_t + b + noise) % V
    v = cfg.vocab_size
    a, c = 31, 17
    x0 = rng.integers(0, v, (b, 1), dtype=np.int64)
    noise = (rng.random((b, s)) < 0.1).astype(np.int64) \
        * rng.integers(0, v, (b, s))
    toks = np.empty((b, s), np.int64)
    cur = x0[:, 0]
    for t in range(s):
        toks[:, t] = cur
        cur = (a * cur + c + noise[:, t]) % v
    tokens = toks.astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], cur[:, None].astype(np.int32)],
                            axis=1)
    out["tokens"] = tokens
    out["labels"] = labels
    if cfg.frontend == "vision_patches":
        out["patches"] = rng.standard_normal(
            (b, cfg.n_prefix_tokens, cfg.frontend_dim), dtype=np.float32)
        # no loss on image positions is handled by the model (text slice)
    return out


class Pipeline:
    """Prefetching iterator over synthetic batches."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 data_cfg: DataConfig = DataConfig(),
                 start_step: int = 0, batch_override: int | None = None):
        self.cfg = cfg
        self.shape = shape
        self.data_cfg = data_cfg
        self.step = start_step
        self.batch_override = batch_override
        self._q: queue.Queue = queue.Queue(maxsize=data_cfg.prefetch_depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        step = self.step
        while not self._stop.is_set():
            batch = synth_batch(self.cfg, self.shape, step,
                                self.data_cfg.seed,
                                batch_override=self.batch_override)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        return self

    def __next__(self) -> tuple[int, dict]:
        return self._q.get()

    def close(self) -> None:
        self._stop.set()
