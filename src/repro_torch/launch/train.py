"""End-to-end training driver, ported from ``repro/launch/train.py`` for
one device: the train step, deterministic data, atomic checkpoints with
auto-resume, the straggler watchdog and failure injection.

On the card it trains the configs at full width (depth cut with
``config_overrides``); ``--device cpu --reduced`` runs the reduced config
on the kernels' plain versions.  The data-parallel and compression drivers
and test meshes come with the multi-device slice of the port.

Usage:
  python -m repro_torch.launch.train --arch deepseek-7b --reduced \\
      --device cpu --steps 100
  python -m repro_torch.launch.train --arch mamba2-2.7b --device cpu \\
      --steps 6
  python -m repro_torch.launch.train --arch granite-moe-3b-a800m \\
      --device cpu --steps 6
  python -m repro_torch.launch.train --arch hubert-xlarge --device cpu \\
      --steps 6

A frontend's batch (hubert's frames, paligemma's patches) reaches the
device as the pipeline gives it, float32, as the JAX package's does: over
bf16 weights hubert's stream then runs in float32 (jnp's promotion), and
paligemma casts its projected patches to the token embeddings' dtype.

For an MoE config each logged step carries the router's load-balance loss
(``aux``, summed over the MoE layers) and the share of (token, choice)
assignments dropped at capacity (``drop``, summed likewise).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Any, Callable

import torch

from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs import LM_SHAPES, get_config
from repro_torch.configs.base import ModelConfig, RuntimeConfig, ShapeConfig
from repro_torch.data import pipeline as data_mod
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.launch import steps as steps_mod
from repro_torch.layers import base
from repro_torch.models import lm
from repro_torch.optim import adamw


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    arch: str = "deepseek-7b"
    shape: str = "train_4k"
    reduced: bool = True               # CPU-runnable variant
    steps: int = 100
    mode: str = "xla"                  # 'brainslug' | 'xla' | 'barrier'
    remat: str = "none"
    ckpt_dir: str = ""
    ckpt_every: int = 25
    log_every: int = 10
    seed: int = 0
    batch_override: int | None = None
    seq_override: int | None = None
    lr: float = 3e-3
    # the JAX driver's multi-device options; they come with the
    # multi-device slice of the port and raise until then
    data_parallel: bool = False
    compress: bool = False
    mesh_devices: int | None = None
    # arbitrary ModelConfig field overrides (applied after reduction)
    config_overrides: tuple = ()       # of (field, value) pairs
    device: str = "cuda"


@dataclasses.dataclass
class Trainer:
    tc: TrainerConfig
    cfg: ModelConfig
    shape: ShapeConfig
    device: torch.device
    step_fn: Callable
    params: Any
    opt_state: Any
    start_step: int
    watchdog: ft.StragglerWatchdog
    checkpointer: ckpt.AsyncCheckpointer | None
    history: list

    def run(self, failure_hook: Callable[[int], None] | None = None
            ) -> list[dict]:
        pipe = data_mod.Pipeline(
            self.cfg, self.shape,
            data_mod.DataConfig(seed=self.tc.seed),
            start_step=self.start_step,
            batch_override=self.shape.global_batch)
        try:
            for step, batch in pipe:
                if step >= self.tc.steps:
                    break
                if failure_hook is not None:
                    failure_hook(step)
                self.watchdog.start()
                dev_batch = {k: torch.from_numpy(v).to(self.device)
                             for k, v in batch.items()}
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, dev_batch)
                loss = float(metrics["loss"])
                slow = self.watchdog.stop()
                rec = {"step": step, "loss": loss,
                       "grad_norm": float(metrics["grad_norm"]),
                       "router_aux_loss": float(metrics["router_aux_loss"]),
                       # the loss's aux sums over the MoE layers (as the
                       # JAX package's); a fraction is read a layer
                       "drop_fraction_per_moe_layer":
                           float(metrics["drop_fraction"])
                           / max(1, lm.n_moe_layers(self.cfg)),
                       "slow": bool(slow)}
                self.history.append(rec)
                if step % self.tc.log_every == 0:
                    moe = (f" aux={rec['router_aux_loss']:.4f} drop/layer="
                           f"{rec['drop_fraction_per_moe_layer']:.4f}"
                           if self.cfg.n_experts else "")
                    print(f"[train] step={step} loss={loss:.4f} "
                          f"gnorm={rec['grad_norm']:.3f}{moe}", flush=True)
                if (self.checkpointer is not None and step > 0
                        and step % self.tc.ckpt_every == 0):
                    self.checkpointer.submit(
                        step, {"params": self.params,
                               "opt": self.opt_state},
                        extra={"next_step": step + 1, "loss": loss})
            if self.checkpointer is not None:
                self.checkpointer.submit(
                    self.tc.steps,
                    {"params": self.params, "opt": self.opt_state},
                    extra={"next_step": self.tc.steps,
                           "loss": self.history[-1]["loss"]
                           if self.history else float("nan")})
                self.checkpointer.wait()
        finally:
            pipe.close()
        return self.history


def build_trainer(tc: TrainerConfig, *,
                  init_params: Callable[[ModelConfig, torch.device], Any]
                  | None = None,
                  opt_cfg: adamw.AdamWConfig | None = None) -> Trainer:
    """A trainer of ``tc``.  ``init_params(cfg, device)`` replaces the
    seeded random initialisation (for example with the JAX package's
    weights carried over by ``convert.lm_params_from_numpy``: ``lm.init``
    draws other numbers than ``jax.random``); ``opt_cfg`` replaces the
    optimizer config (by default: ``tc.lr`` constant for a reduced config,
    the warmup-cosine schedule of ``default_opt_config`` otherwise)."""
    for flag in ("data_parallel", "compress", "mesh_devices"):
        if getattr(tc, flag):
            raise NotImplementedError(
                f"{flag}: the data-parallel and compression drivers and test "
                f"meshes come with the multi-device slice of the port")
    cfg = get_config(tc.arch)
    shape = LM_SHAPES[tc.shape]
    if tc.reduced:
        cfg = cfg.reduced()
        shape = shape.reduced()
    if tc.config_overrides:
        cfg = dataclasses.replace(cfg, **dict(tc.config_overrides))
    if tc.batch_override:
        shape = dataclasses.replace(shape, global_batch=tc.batch_override)
    if tc.seq_override:
        shape = dataclasses.replace(shape, seq_len=tc.seq_override)

    dev = base.device(tc.device)
    rt = RuntimeConfig(mode=tc.mode, remat=tc.remat)
    params = (lm.init(tc.seed, cfg, device=dev) if init_params is None
              else init_params(cfg, dev))
    if opt_cfg is None:
        opt_cfg = adamw.AdamWConfig(
            lr=tc.lr if tc.reduced else steps_mod.default_opt_config().lr)
    opt_state = adamw.init(params)
    step_fn = steps_mod.make_train_step(cfg, rt, opt_cfg)

    # ---- auto-resume -------------------------------------------------------
    start_step = 0
    checkpointer = None
    if tc.ckpt_dir:
        # robust resume: crash orphans are swept, a truncated latest
        # checkpoint falls back to the previous complete one
        restored = ckpt.restore_latest(tc.ckpt_dir,
                                       {"params": params, "opt": opt_state})
        if restored is not None:
            tree, extra, latest = restored
            params, opt_state = tree["params"], tree["opt"]
            start_step = int(extra.get("next_step", latest))
            print(f"[train] resumed from step {latest} "
                  f"(next_step={start_step})", flush=True)
        checkpointer = ckpt.AsyncCheckpointer(tc.ckpt_dir)

    return Trainer(tc=tc, cfg=cfg, shape=shape, device=dev, step_fn=step_fn,
                   params=params, opt_state=opt_state, start_step=start_step,
                   watchdog=ft.StragglerWatchdog(),
                   checkpointer=checkpointer, history=[])


def train(tc: TrainerConfig,
          failure_hook: Callable[[int], None] | None = None, **kw
          ) -> list[dict]:
    """Build a trainer (``kw`` as :func:`build_trainer` takes) and run it."""
    trainer = build_trainer(tc, **kw)
    try:
        return trainer.run(failure_hook)
    finally:
        if trainer.checkpointer is not None:
            trainer.checkpointer.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--mode", default="xla",
                    choices=["brainslug", "xla", "barrier"])
    ap.add_argument("--remat", default="none")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--metrics-out", default="")
    args = ap.parse_args(argv)

    tc = TrainerConfig(arch=args.arch, shape=args.shape, steps=args.steps,
                       mode=args.mode, remat=args.remat,
                       reduced=args.reduced, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every,
                       batch_override=args.batch, seq_override=args.seq,
                       lr=args.lr, device=args.device)
    t0 = time.time()
    history = train(tc)
    dt = time.time() - t0
    if history:
        print(f"[train] done: {len(history)} steps in {dt:.1f}s, "
              f"loss {history[0]['loss']:.4f} -> {history[-1]['loss']:.4f}",
              flush=True)
    if args.metrics_out:
        os.makedirs(os.path.dirname(args.metrics_out) or ".", exist_ok=True)
        with open(args.metrics_out, "w") as f:
            json.dump(history, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
