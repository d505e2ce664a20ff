"""End-to-end training driver, ported from ``repro/launch/train.py``: the
train step, deterministic data, atomic checkpoints with auto-resume, the
straggler watchdog and failure injection.

On the card it trains the configs at full width (depth cut with
``config_overrides``); ``--device cpu --reduced`` runs the reduced config
on the kernels' plain versions.

``TrainerConfig(data_parallel=True)`` runs the explicit data-parallel step
(:mod:`repro_torch.distributed.data_parallel`) inside an initialised
``torch.distributed`` group (``torchrun``, or
:func:`repro_torch.launch.mesh.spawn`): every rank takes its contiguous
slice of the global batch, reduces the gradients by hand (int8 with error
feedback under ``compress``) and applies AdamW; rank 0 logs and writes the
checkpoints, and a restore zeroes the error-feedback state.
``mesh_devices`` names the rank count the run expects.  Without
``data_parallel`` it runs the port of the JAX package's GSPMD-sharded
step (:func:`repro_torch.launch.steps.make_sharded_train_step`) over a
``(mesh_devices, 1)`` ``("data", "model")`` mesh: every rank keeps only
its shards of the parameters and AdamW's moments under
``repair_specs(param_specs(lm.param_axes(cfg), ShardingRules(), mesh))``.
Each layer's parameters are gathered just before the layer runs and its
gradients reduced to the shards as the backward makes them, so a rank
holds one layer's whole parameters at a time besides its shards; the
parameters are initialised (or restored) whole on every rank before
they are sliced, which bounds the model size by one rank's memory at
start-up.  Checkpoints hold global tensors in the one-device format
(gathered a leaf at a time to rank 0's host memory, which writes them;
on restore every rank reads and slices its shard), so a checkpoint
written on one mesh restores on another or on one device.

Usage:
  python -m repro_torch.launch.train --arch deepseek-7b --reduced \\
      --device cpu --steps 100
  python -m repro_torch.launch.train --arch mamba2-2.7b --device cpu \\
      --steps 6
  python -m repro_torch.launch.train --arch granite-moe-3b-a800m \\
      --device cpu --steps 6
  python -m repro_torch.launch.train --arch hubert-xlarge --device cpu \\
      --steps 6
  torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu \\
      --data-parallel --mesh-devices 2 --compress --batch 4 --steps 6
  torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu \\
      --mesh-devices 2 --batch 4 --steps 6

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
import torch.distributed as dist

from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs import LM_SHAPES, get_config
from repro_torch.configs.base import ModelConfig, RuntimeConfig, ShapeConfig
from repro_torch.data import pipeline as data_mod
from repro_torch.distributed import compression
from repro_torch.distributed import data_parallel as dp_mod
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_mod
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
    # explicit data-parallel step over the mesh's "data" axis, with a
    # hand-written gradient reduction (repro_torch.distributed.
    # data_parallel), inside an initialised torch.distributed group
    data_parallel: bool = False
    compress: bool = False             # int8 error-feedback grad payload
    mesh_devices: int | None = None    # the rank count the run expects
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
    #: The mesh of a data-parallel or sharded run (None on one device);
    #: only its rank 0 logs and writes checkpoints.
    mesh: Any = None
    #: The sharded run's gather of its state to global tensors for a
    #: checkpoint (collective: every rank calls it; rank 0 gets them in
    #: host memory, the others None); None where the state is whole.
    to_global: Callable[[Any], Any] | None = None

    def _checkpoint(self, step: int, extra: dict) -> None:
        """Submit the state to rank 0's checkpointer (every rank takes
        part in a sharded run's gather)."""
        tree = {"params": self.params, "opt": self.opt_state}
        if self.to_global is not None:
            tree = self.to_global(tree)
        if self.checkpointer is not None:
            self.checkpointer.submit(step, tree, extra=extra)

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
                if step % self.tc.log_every == 0 and (
                        self.mesh is None or self.mesh.rank == 0):
                    moe = (f" aux={rec['router_aux_loss']:.4f} drop/layer="
                           f"{rec['drop_fraction_per_moe_layer']:.4f}"
                           if self.cfg.n_experts else "")
                    print(f"[train] step={step} loss={loss:.4f} "
                          f"gnorm={rec['grad_norm']:.3f}{moe}", flush=True)
                if (self.tc.ckpt_dir and step > 0
                        and step % self.tc.ckpt_every == 0):
                    self._checkpoint(step, {"next_step": step + 1,
                                            "loss": loss})
            if self.tc.ckpt_dir:
                self._checkpoint(self.tc.steps, {
                    "next_step": self.tc.steps,
                    "loss": self.history[-1]["loss"]
                    if self.history else float("nan")})
            if self.checkpointer is not None:
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
    the warmup-cosine schedule of ``default_opt_config`` otherwise).

    With ``tc.data_parallel`` or ``tc.mesh_devices`` every rank of the
    initialised group calls this with the same ``tc``, and each rank's
    ``init_params`` gives the same global parameters."""
    if tc.compress and not tc.data_parallel:
        raise ValueError("compress needs data_parallel: it compresses the "
                         "data-parallel gradient reduction")
    mesh = None
    if tc.data_parallel or tc.mesh_devices:
        if not dist.is_initialized():
            what = ("data_parallel" if tc.data_parallel
                    else "mesh_devices (the sharded step)")
            raise RuntimeError(
                f"{what} needs an initialised torch.distributed group: run "
                f"under torchrun, or start the ranks with "
                f"repro_torch.launch.mesh.spawn")
        mesh = mesh_mod.make_test_mesh(tc.mesh_devices, device=tc.device)
    sharded = mesh is not None and not tc.data_parallel
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

    dev = base.device(tc.device) if mesh is None else mesh.device
    rt = RuntimeConfig(mode=tc.mode, remat=tc.remat)
    params = (lm.init(tc.seed, cfg, device=dev) if init_params is None
              else init_params(cfg, dev))
    if opt_cfg is None:
        opt_cfg = adamw.AdamWConfig(
            lr=tc.lr if tc.reduced else steps_mod.default_opt_config().lr)
    to_global = None
    if mesh is None:
        opt_state = adamw.init(params)
        step_fn = steps_mod.make_train_step(cfg, rt, opt_cfg)
    elif tc.data_parallel:
        step_fn, opt_state = _dp_step(tc, cfg, rt, opt_cfg, mesh, params,
                                      adamw.init(params))
    else:
        pspecs = shd.repair_specs(params, shd.param_specs(
            lm.param_axes(cfg), shd.ShardingRules(), mesh), mesh)
        specs = {"params": pspecs, "opt": shd.opt_state_specs(pspecs, mesh)}
        # built on the shards below, unless a checkpoint restores it whole
        opt_state = None
        step_fn = steps_mod.make_sharded_train_step(cfg, rt, opt_cfg, mesh,
                                                    pspecs)

        def to_global(tree):
            return steps_mod.gather_tree(tree, specs, mesh)
    rank0 = mesh is None or mesh.rank == 0

    # ---- auto-resume -------------------------------------------------------
    start_step = 0
    checkpointer = None
    if tc.ckpt_dir:
        # robust resume: crash orphans are swept, a truncated latest
        # checkpoint falls back to the previous complete one.  Under a
        # mesh rank 0 sweeps and reads first, the others after it.  A
        # sharded run restores the global tensors, then slices its shards.
        if not rank0:
            dist.barrier()
        restored = ckpt.restore_latest(tc.ckpt_dir, {
            "params": params,
            "opt": adamw.init(params) if opt_state is None else opt_state})
        if mesh is not None and rank0:
            dist.barrier()
        if restored is not None:
            tree, extra, latest = restored
            params, opt_state = tree["params"], tree["opt"]
            if "err" in opt_state:
                # the saved residual compensated a quantisation the saved
                # params already absorbed: replaying it would apply that
                # correction twice, so resume restarts the feedback loop
                opt_state = {**opt_state, "err": compression.
                             reset_error_state(opt_state["err"])}
            start_step = int(extra.get("next_step", latest))
            if rank0:
                print(f"[train] resumed from step {latest} "
                      f"(next_step={start_step})", flush=True)
        if rank0:
            checkpointer = ckpt.AsyncCheckpointer(tc.ckpt_dir)
    if sharded:
        params = steps_mod.shard_tree(params, specs["params"], mesh)
        opt_state = (adamw.init(params) if opt_state is None else
                     steps_mod.shard_tree(opt_state, specs["opt"], mesh))

    return Trainer(tc=tc, cfg=cfg, shape=shape, device=dev, step_fn=step_fn,
                   params=params, opt_state=opt_state, start_step=start_step,
                   watchdog=ft.StragglerWatchdog(),
                   checkpointer=checkpointer, history=[], mesh=mesh,
                   to_global=to_global)


def _dp_step(tc: TrainerConfig, cfg: ModelConfig, rt: RuntimeConfig,
             opt_cfg: adamw.AdamWConfig, mesh, params: Any, opt_state: Any
             ) -> tuple[Callable, dict]:
    """The data-parallel step in the single-device step's signature
    ``(params, opt, batch) -> (params, opt, metrics)``: ``opt`` wraps the
    AdamW state and, under ``compress``, the error-feedback state
    (``{"opt": ..., "err": ...}``), so both ride the checkpoints."""
    raw = dp_mod.make_dp_train_step(
        lambda p, b: lm.loss_fn(p, b, cfg, rt), opt_cfg, mesh,
        dp_mod.DPConfig(compress=tc.compress))
    state = dp_mod.init_state(params, opt_state, compress=tc.compress)
    wrapped = {k: v for k, v in state.items() if k != "params"}

    def step(p, opt_wrap, batch):
        state, metrics = raw({"params": p, **opt_wrap}, batch)
        return state["params"], {k: state[k] for k in opt_wrap}, metrics

    return step, wrapped


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
    ap.add_argument("--data-parallel", action="store_true",
                    help="explicit data-parallel step (hand-written "
                         "gradient all-reduce); run under torchrun")
    ap.add_argument("--compress", action="store_true",
                    help="int8 error-feedback gradient compression "
                         "(requires --data-parallel)")
    ap.add_argument("--mesh-devices", type=int, default=None,
                    help="the rank count the run expects: with "
                         "--data-parallel the data-parallel step, without "
                         "it the sharded (GSPMD) step over a (n, 1) "
                         "data x model mesh; run under torchrun")
    ap.add_argument("--metrics-out", default="")
    args = ap.parse_args(argv)

    tc = TrainerConfig(arch=args.arch, shape=args.shape, steps=args.steps,
                       mode=args.mode, remat=args.remat,
                       reduced=args.reduced, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every,
                       batch_override=args.batch, seq_override=args.seq,
                       lr=args.lr, device=args.device,
                       data_parallel=args.data_parallel,
                       compress=args.compress,
                       mesh_devices=args.mesh_devices)
    rank0 = True
    distributed = tc.data_parallel or bool(tc.mesh_devices)
    if distributed and "WORLD_SIZE" in os.environ:
        mesh_mod.init_from_env(tc.device)
        rank0 = dist.get_rank() == 0
    t0 = time.time()
    history = train(tc)
    dt = time.time() - t0
    if distributed and dist.is_initialized():
        dist.destroy_process_group()
    if not rank0:
        return 0
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
