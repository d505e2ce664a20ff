"""Mesh execution checks, one function per path, each run in every rank of
a group that :func:`repro_torch.launch.mesh.spawn` (or ``torchrun``)
started: the optimized callable under ``OptimizeConfig(mesh=...,
partition=...)`` against the single-device compile of the whole batch on
the same inputs, and the sharded and pipelined LM paths against one
device, with every rank's dispatch and launch counters.

* :func:`loss_grads`: ``api.optimize`` of a row-chain loss (a matmul,
  an rms norm, a tanh) under a mesh; gradients against one device.
* :func:`block_forward`: a registry block (rmsnorm and swiglu kernel
  sites, or deepseek-7b's transformer block) under ``tensor``.
* :func:`vgg_step`: ``optimize_graph`` of a VGG, differentiable, under
  ``data``: the forward and the gradients of a cross-entropy step.  With
  ``planted=True`` the sharded call's backward leaves out the all-reduce
  of a replicated operand's cotangent (the batch-norm scales' partial
  sums), a defect the gradient check must catch.
* :func:`block_fn_train`: ``api.optimize`` of ``cnn.block_fn``, a few
  SGD steps through the mesh-compiled net against one device.
* :func:`dp_train`: the data-parallel ``Trainer``; :func:`gspmd_train`
  the sharded one (``TrainerConfig(mesh_devices=n)`` without
  ``data_parallel``).
* :func:`sharded_steps`: ``steps.make_sharded_train_step`` over a
  ``("data", "model")`` mesh of any shape, from the same weights and
  batches as :func:`one_device_steps` (its single-device twin), with a
  checkpoint written or restored; ``planted`` drops the backward
  all-reduce of ``copy_to_model`` (``"copy_backward"``) or counts a
  replicated leaf once a rank in the gradient norm (``"norm_replicas"``),
  defects the checks must flag.
* :func:`pipeline_block`: ``pipeline_apply`` of one block a stage over a
  ``("stage",)`` mesh against the stages applied in turn on one rank.
* :func:`serve_engine`: ``Server.engine(mesh=...)`` (slots over
  ``"data"``, attention heads over ``"model"``) on a queue of
  :func:`serve_queue`, against the single-device engine on the same
  requests in the same rank: tokens, and the last-position logits of
  every tick; ``planted="no_wo_reduce"`` leaves out the all-reduce after
  the attention out-projection, a defect the parity must catch.

Each returns rank 0's numbers (and, where asked, its arrays as numpy) and
``ranks``: every rank's counters.  Run on its own, at small sizes on
the CPU::

    python -m repro_torch.examples.mesh_checks --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import sys
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch import mesh as mesh_mod
from repro_torch.layers import base

#: The rmsnorm + swiglu block of the tensor-parallel check, as widths
#: (rows, d_model, d_ff).
TP_BLOCK = (64, 32, 64)


def counts(zero: bool = False) -> dict:
    """This process's dispatch and launch counters: the fused-stack
    dispatches (``fwd_generated`` ...), each kernel's launches, the
    registry's dispatches and the collectives (``zero`` sets all to 0)."""
    from repro_torch.core import registry
    from repro_torch.distributed import collectives
    from repro_torch.kernels.attention import decode, flash
    from repro_torch.kernels.attention import ops as aops
    from repro_torch.kernels.fused_stack import nhwc, nhwc_bwd, ops, rows, \
        rows_bwd
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.swiglu import ops as sops
    from repro_torch.kernels.swiglu import swiglu
    from repro_torch.kernels.vocab_ce import ce
    from repro_torch.kernels.vocab_ce import ops as cops
    fns = {"fused_nhwc": nhwc.fused_nhwc, "fused_rows": rows.fused_rows,
           "fused_nhwc_bwd": nhwc_bwd.fused_nhwc_bwd,
           "fused_rows_bwd": rows_bwd.fused_rows_bwd,
           "rmsnorm": rmsnorm.rmsnorm_fwd, "swiglu": swiglu.swiglu_fwd,
           "flash_attention": flash.flash_attention_fwd,
           "flash_decode": decode.flash_decode,
           "paged_flash_decode": decode.paged_flash_decode,
           "fused_ce": ce.fused_ce_fwd,
           "ssd_intra_chunk": ssd.ssd_intra_chunk}
    wrappers = (rops.STATS, sops.STATS, cops.STATS, aops.STATS)
    if zero:
        for fn in fns.values():
            fn.launches = 0
        for st in (ops.STATS, registry.STATS, collectives.STATS) + wrappers:
            st.reset()
    return {**ops.STATS.snapshot(),
            "launches": {k: fn.launches for k, fn in fns.items()},
            # the LM kernels' wrappers that ran their plain versions
            "plain": sum(v for st in wrappers for k, v in st.counts.items()
                         if k.endswith(("plain", "_ref"))),
            "registry": {k: v for k, v in registry.STATS.counts.items()
                         if v},
            "collectives": collectives.STATS.snapshot()}


def _all(obj: Any) -> list:
    """``obj`` of every rank, in rank order."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a - b| / max|b|."""
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


@dataclasses.dataclass
class _Planted:
    """The sharded call's backward without the all-reduce of replicated
    operands' cotangents (a control the gradient check must flag)."""

    on: bool

    def __enter__(self):
        from repro_torch.core import codegen
        self.saved = codegen._reduce_replicated
        if self.on:
            codegen._reduce_replicated = lambda ct, axes, mesh: ct
        return self

    def __exit__(self, *exc):
        from repro_torch.core import codegen
        codegen._reduce_replicated = self.saved


# ---------------------------------------------------------------------------
# The row-chain loss (data) and the registry block (tensor).
# ---------------------------------------------------------------------------

def mesh_loss(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    h = x @ w + x
    h = h / torch.sqrt(torch.mean(h * h, dim=-1, keepdim=True) + 1e-6)
    return torch.mean(torch.tanh(h) * h)


def loss_grads(device: str, x: np.ndarray, w: np.ndarray, *,
               partition: str = "data", model_parallel: int = 1) -> dict:
    """Gradients of :func:`mesh_loss` through ``api.optimize`` under the
    mesh against the single-device compile; ``explain()`` of the mesh
    net and the per-shard budget it names."""
    from repro_torch import api
    from repro_torch.core import resource
    mesh = mesh_mod.make_test_mesh(model_parallel=model_parallel,
                                   device=device)
    dev = mesh.device
    xt = torch.tensor(x, device=dev)
    wt = torch.tensor(w, device=dev)
    kw = dict(mode="brainslug", differentiable=True, torch_device=dev.type)
    nets = {"mesh": api.optimize(mesh_loss, xt, wt, config=api.OptimizeConfig(
        mesh=mesh, partition=partition, **kw)),
        "one": api.optimize(mesh_loss, xt, wt,
                            config=api.OptimizeConfig(**kw))}
    grads = {}
    for tag, net in nets.items():
        counts(zero=True)
        a, b = xt.clone().requires_grad_(), wt.clone().requires_grad_()
        grads[tag] = torch.autograd.grad(net(a, b), (a, b))
        _sync(dev)
        if tag == "mesh":
            mesh_counts = counts()
    err = max(float((g - o).abs().max())
              for g, o in zip(grads["mesh"], grads["one"]))
    budget = resource.shard_device(api.OptimizeConfig().device,
                                   mesh.size).resource_limit
    return {"max_abs_err": err, "explain": nets["mesh"].explain(),
            "budget": budget, "n_sequences": nets["mesh"].n_sequences,
            "grads": [_np(g) for g in grads["mesh"]],
            "mesh": mesh.describe(), "ranks": _all(mesh_counts)}


def rms_swiglu_block(x, g, wg, wu, wd):
    """The tensor-parallel block of ``tests/test_mesh_parity.py``, its gate
    written ``F.silu(gate)`` (the JAX test's ``gate * sigmoid(gate)``)."""
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    h = x * torch.rsqrt(var + 1e-6) * g
    gate, up = h @ wg, h @ wu
    return x + (torch.nn.functional.silu(gate) * up) @ wd


def block_forward(device: str, arrays: dict | None = None, *,
                  widths: tuple | None = None, dtype: str = "float32",
                  model_parallel: int = 2, seed: int = 29) -> dict:
    """A registry block under ``tensor`` against the single-device compile.
    ``arrays`` (numpy) runs :func:`rms_swiglu_block`; ``widths`` =
    (seq, d_model, heads, d_ff) runs ``lm.transformer_block_fn`` on
    weights drawn from ``seed`` on the device, the same in every rank."""
    from repro_torch import api
    from repro_torch.core import registry
    from repro_torch.models import lm
    mesh = mesh_mod.make_test_mesh(model_parallel=model_parallel,
                                   device=device)
    dev = mesh.device
    dt = getattr(torch, dtype)
    if arrays is not None:
        fn = rms_swiglu_block
        args = tuple(torch.tensor(arrays[k], device=dev, dtype=dt)
                     for k in ("x", "g", "wg", "wu", "wd"))
    else:
        seq, d_model, heads, d_ff = widths
        gen = torch.Generator(device=dev).manual_seed(seed)
        p = lm.transformer_block_params(d_model, heads, d_ff, generator=gen,
                                        dtype=dt, device=dev)
        x = torch.randn((1, seq, d_model), generator=gen, device=dev).to(dt)

        def fn(x, p):
            return lm.transformer_block_fn(x, p, n_heads=heads)
        args = (x, p)
    cfg = dict(mode="brainslug", torch_device=dev.type)
    nets = {"mesh": api.optimize(fn, *args, config=api.OptimizeConfig(
        mesh=mesh, partition="tensor", **cfg)),
        "one": api.optimize(fn, *args, config=api.OptimizeConfig(**cfg))}
    out = {}
    with torch.no_grad():
        for tag in ("one", "mesh"):
            counts(zero=True)
            t = time.perf_counter()
            out[tag] = nets[tag](*args)
            _sync(dev)
            wall = time.perf_counter() - t
    mesh_counts = counts()
    rep = nets["mesh"].report()
    registry_ok = all(k.endswith("_hopper") or (dev.type == "cpu"
                                                and k.endswith("_plain"))
                      for k in mesh_counts["registry"])
    return {"max_abs_err": float((out["mesh"].float()
                                  - out["one"].float()).abs().max()),
            "rel": _rel(out["mesh"], out["one"]),
            "finite": bool(torch.isfinite(out["mesh"]).all()),
            "kernel_hits": rep.kernel_hits,
            "kernel_fallbacks": rep.kernel_fallbacks,
            "dist": [(d.kind, d.name, d.active) for d in rep.dist],
            "registry_all_kernels": registry_ok, "wall_s": wall,
            "y": _np(out["mesh"]) if arrays is not None else None,
            "mesh": mesh.describe(), "ranks": _all(mesh_counts)}


# ---------------------------------------------------------------------------
# The main path: a VGG under ``data`` and block_fn training.
# ---------------------------------------------------------------------------

def _train_tol_ok(g: torch.Tensor, w: torch.Tensor, rtol: float) -> bool:
    """The training check's rule: ``|g - w| <= rtol (|w| + max|w|)``."""
    g, w = g.float(), w.float()
    scale = float(w.abs().max())
    return bool(torch.isfinite(g).all()) and bool(
        ((g - w).abs() <= rtol * (w.abs() + scale)).all())


def vgg_step(device: str, *, stages: tuple, input_shape: tuple,
             partition: str = "data", model_parallel: int = 1,
             rtol: float = 1e-4, seed: int = 7, planted: bool = False
             ) -> dict:
    """``optimize_graph`` of ``cnn.vgg_net(stages)``, differentiable, under
    the mesh: the forward and the gradients of one cross-entropy step
    (every parameter and the input) against the single-device compile of
    the whole batch, which rank 0 alone runs.  ``rtol`` is the training
    check's rule; peak memory per rank where on a card."""
    import torch.nn.functional as F

    from repro_torch.core import api
    from repro_torch.models import cnn
    mesh = mesh_mod.make_test_mesh(model_parallel=model_parallel,
                                   device=device)
    dev = mesh.device
    graph, params = cnn.vgg_net(stages, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(input_shape, generator=gen, device=dev)
    labels = torch.randint(0, 10, (input_shape[0],), generator=gen,
                           device=dev)
    pshapes = {k: tuple(v.shape) for k, v in params.items()}

    def step(net):
        leaves = {"x": x.clone().requires_grad_(),
                  **{k: v.clone().requires_grad_() for k, v in
                     params.items()}}
        y = net(leaves["x"], {k: leaves[k] for k in params})
        loss = F.cross_entropy(y, labels)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return y.detach(), float(loss.detach()), dict(zip(leaves, grads))

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cfg = dict(mode="brainslug", differentiable=True, torch_device=dev.type)
    net = api.optimize_graph(graph, input_shape, api.OptimizeConfig(
        mesh=mesh, partition=partition, **cfg), param_shapes=pshapes)
    counts(zero=True)
    t = time.perf_counter()
    with _Planted(planted):
        y, loss, grads = step(net)
    _sync(dev)
    wall = time.perf_counter() - t
    mesh_counts = counts()
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)
    out = {"n_sequences": net.n_sequences, "loss": loss, "wall_s": wall,
           "dist": [(d.kind, d.name, d.active) for d in net.report().dist],
           "explain": net.explain(), "mesh": mesh.describe()}
    if mesh.rank == 0:
        one = api.optimize_graph(graph, input_shape, api.OptimizeConfig(
            **cfg))
        y1, loss1, grads1 = step(one)
        out.update(
            loss_one=loss1, forward_rel=_rel(y, y1),
            forward_ok=_train_tol_ok(y, y1, rtol),
            grad_rel={k: _rel(g, grads1[k]) for k, g in grads.items()},
            grads_ok=all(_train_tol_ok(g, grads1[k], rtol)
                         for k, g in grads.items()))
        del one, y1, grads1
    del net, grads, y
    dist.barrier()
    out["ranks"] = _all({**mesh_counts, "peak_gib": peak})
    return out


def block_fn_train(device: str, *, n_blocks: int = 3, channels: int = 32,
                   input_shape: tuple = (8, 16, 16, 32),
                   partition: str = "both", model_parallel: int = 2,
                   steps: int = 3, lr: float = 1e-3, seed: int = 9) -> dict:
    """``api.optimize(cnn.block_fn)`` with ``differentiable=True`` under
    the mesh: ``steps`` SGD steps of a squared-error loss over the input
    and every parameter, against the single-device compile."""
    from repro_torch import api
    from repro_torch.models import cnn
    mesh = mesh_mod.make_test_mesh(model_parallel=model_parallel,
                                   device=device)
    dev = mesh.device
    _, params = cnn.block_net(n_blocks, channels, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(input_shape, generator=gen, device=dev)
    target = torch.randn(input_shape, generator=gen, device=dev)
    cfg = dict(mode="brainslug", differentiable=True, torch_device=dev.type)
    nets = {"mesh": api.optimize(cnn.block_fn, x, params,
                                 config=api.OptimizeConfig(
                                     mesh=mesh, partition=partition, **cfg)),
            "one": api.optimize(cnn.block_fn, x, params,
                                config=api.OptimizeConfig(**cfg))}
    runs = {}
    for tag, net in nets.items():
        leaves = {"x": x, **params}
        losses, first = [], None
        counts(zero=True)
        for _ in range(steps):
            req = {k: v.detach().clone().requires_grad_()
                   for k, v in leaves.items()}
            y = net(req["x"], {k: req[k] for k in params})
            loss = 0.5 * torch.square(y - target).mean()
            grads = torch.autograd.grad(loss, list(req.values()))
            with torch.no_grad():
                leaves = {k: v - lr * g for (k, v), g in zip(req.items(),
                                                            grads)}
            losses.append(float(loss))
            first = first or dict(zip(req, grads))
        _sync(dev)
        runs[tag] = (losses, first, counts())
    (lm_, gm, cm), (lo, go, _) = runs["mesh"], runs["one"]
    return {"losses": lm_, "losses_one": lo,
            "grad_rel": {k: _rel(g, go[k]) for k, g in gm.items()},
            "max_abs_err": max(float((g - go[k]).abs().max())
                               for k, g in gm.items()),
            "n_sequences": nets["mesh"].n_sequences,
            "dist": [(d.kind, d.name, d.active)
                     for d in nets["mesh"].report().dist],
            "mesh": mesh.describe(), "ranks": _all(cm)}


def stack_checks(device: str, *, rows: int = 64, features: int = 256
                 ) -> dict:
    """``optimize_stack`` of the rms norm program under ``data``: outputs
    and gradients of the input and the gain against one device."""
    from repro_torch.core import api
    from repro_torch.layers import stacks
    mesh = mesh_mod.make_test_mesh(device=device)
    dev = mesh.device
    program = stacks.norm_program("rms", 1e-6, False)
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((rows, features), generator=gen, device=dev)
    params = {p: 1.0 + 0.1 * torch.randn((features,), generator=gen,
                                         device=dev)
              for p in program.param_names}
    cfg = dict(mode="brainslug", differentiable=True, torch_device=dev.type)
    exes = {"mesh": api.optimize_stack(
        program, {"x": (rows, features)}, api.OptimizeConfig(
            mesh=mesh, partition="data", **cfg),
        param_shapes={p: (features,) for p in params}),
        "one": api.optimize_stack(program, {"x": (rows, features)},
                                  api.OptimizeConfig(**cfg))}
    res = {}
    for tag, exe in exes.items():
        leaves = {"x": x.clone().requires_grad_(),
                  **{k: v.clone().requires_grad_() for k, v in
                     params.items()}}
        out = exe({"x": leaves["x"]}, {k: leaves[k] for k in params})
        y = out[program.outputs[0]]
        res[tag] = (y, torch.autograd.grad(y.square().sum(),
                                           list(leaves.values())))
    (ym, gm), (yo, go) = res["mesh"], res["one"]
    return {"out_rel": _rel(ym, yo),
            "grad_rel": [_rel(a, b) for a, b in zip(gm, go)]}


# ---------------------------------------------------------------------------
# The data-parallel trainer.
# ---------------------------------------------------------------------------

def dp_train(runs: list[dict], *, np_params: dict | None = None,
             common: dict | None = None, lr: float | None = None,
             data_parallel: bool = True) -> dict:
    """Run each ``TrainerConfig`` override dict of ``runs`` (over
    ``common``) through the data-parallel ``Trainer`` (with
    ``data_parallel=False``, the sharded one), from ``np_params``
    (numpy, carried over with ``convert.lm_params_from_numpy``) or the
    seeded init; ``lr`` fixes a constant learning rate (by default the
    trainer's: ``tc.lr`` for a reduced config, the warmup-cosine schedule
    otherwise).  A run with ``"fail_at"`` is killed there by the
    failure-injection hook and resumed from its checkpoints.  Returns each
    run's history, the error-feedback state's largest entry just after a
    restore, per-rank counters and peak memory."""
    from repro_torch import convert
    from repro_torch.distributed import data_parallel as dp_mod
    from repro_torch.distributed import fault_tolerance as ft
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import adamw
    opt = {} if lr is None else {"opt_cfg": adamw.AdamWConfig(lr=lr)}
    out = []
    for run in runs:
        kw = {**(common or {}), **run}
        fail_at = kw.pop("fail_at", None)
        tc = train_mod.TrainerConfig(data_parallel=data_parallel, **kw)
        init = (None if np_params is None else
                lambda cfg, dev: convert.lm_params_from_numpy(np_params, dev))
        dev = torch.device(tc.device)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        rec: dict = {"config": kw}
        if fail_at is not None:
            try:
                train_mod.train(tc, failure_hook=ft.failure_injector(
                    {fail_at}), init_params=init, **opt)
            except ft.SimulatedFailure:
                rec["killed_at"] = fail_at
        counts(zero=True)
        trainer = train_mod.build_trainer(tc, init_params=init, **opt)
        err = trainer.opt_state.get("err") if tc.compress else None
        rec["err_after_build"] = (None if err is None else max(
            float(e.abs().max()) for e in base.tree_leaves(err)))
        del err
        t = time.perf_counter()
        try:
            rec["history"] = trainer.run()
        finally:
            if trainer.checkpointer is not None:
                trainer.checkpointer.close()
        _sync(trainer.device)
        rec["wall_s"] = time.perf_counter() - t
        rec["ranks"] = _all({**counts(), "peak_gib": (
            torch.cuda.max_memory_allocated() / 2 ** 30
            if trainer.device.type == "cuda" else None)})
        rec["mesh"] = trainer.mesh.describe()
        if data_parallel:
            rec["wire_bytes"] = dp_mod.wire_bytes(trainer.params,
                                                  compress=tc.compress)
        else:
            rec["shard"] = _all({
                "param_numel": sum(x.numel() for x in
                                   base.tree_leaves(trainer.params)),
                "param_bytes": _state_bytes(trainer.params),
                "opt_bytes": _state_bytes({k: trainer.opt_state[k]
                                           for k in ("mu", "nu")})})
        del trainer
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out.append(rec)
    return {"runs": out}


def gspmd_train(runs: list[dict], **kw) -> dict:
    """:func:`dp_train` through the sharded ``Trainer`` (``mesh_devices``
    without ``data_parallel``); each run also reports this rank's shard
    bytes (parameters and AdamW moments) and element counts."""
    return dp_train(runs, data_parallel=False, **kw)


def _state_bytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in base.tree_leaves(tree))


# ---------------------------------------------------------------------------
# The sharded step, its one-device twin, and the pipeline.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _PlantedShard:
    """A defect in the sharded step: ``"copy_backward"`` (the cotangent of
    ``copy_to_model`` left unreduced) or ``"norm_replicas"`` (every leaf
    counted once a rank in the gradient norm)."""

    what: str | None

    def __enter__(self):
        from repro_torch.distributed import collectives
        from repro_torch.launch import steps
        self.saved = (collectives._copy_backward, steps._replicas)
        if self.what == "copy_backward":
            collectives._copy_backward = lambda g, mesh, axis: g
        elif self.what == "norm_replicas":
            steps._replicas = lambda spec, mesh: 1
        elif self.what is not None:
            raise ValueError(f"unknown planted defect {self.what!r}")
        return self

    def __exit__(self, *exc):
        from repro_torch.distributed import collectives
        from repro_torch.launch import steps
        collectives._copy_backward, steps._replicas = self.saved


@contextlib.contextmanager
def shape_records():
    """The shapes the flash attention and swiglu wrappers are called with
    while the block runs (``{"flash_attention": [q shape, ...], "swiglu":
    [gate shape, ...]}``): on the card, the shapes their kernels launch
    at."""
    from repro_torch.kernels.attention import ops as aops
    from repro_torch.kernels.swiglu import ops as sops
    rec: dict = {"flash_attention": [], "swiglu": []}
    flash, glu = aops.flash_attention, sops.swiglu

    def flash_rec(q, *a, **kw):
        rec["flash_attention"].append(tuple(q.shape))
        return flash(q, *a, **kw)

    def glu_rec(gate, *a, **kw):
        rec["swiglu"].append(tuple(gate.shape))
        return glu(gate, *a, **kw)

    aops.flash_attention, sops.swiglu = flash_rec, glu_rec
    try:
        yield rec
    finally:
        aops.flash_attention, sops.swiglu = flash, glu


def _lm_setup(arch: str, dev: torch.device, *, reduced: bool,
              overrides: tuple, seq: int, batch: int, np_params: Any,
              seed: int):
    """Config, shape and global parameters (numpy carried over, or the
    seeded init on ``dev``)."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import lm
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if overrides:
        cfg = dataclasses.replace(cfg, **dict(overrides))
    shape = ShapeConfig("t", seq, batch, "train")
    params = (lm.init(seed, cfg, device=dev) if np_params is None
              else convert.lm_params_from_numpy(np_params, dev))
    return cfg, shape, params


def mask_unevenly(batch: dict) -> dict:
    """``batch`` (numpy) with every label of its first row but the first 4
    masked (-1): the batch's halves then hold different label counts."""
    labels = batch["labels"].copy()
    labels[0, 4:] = -1
    return {**batch, "labels": labels}


def _batch(cfg, shape, step: int, seed: int, dev: torch.device,
           uneven: bool = False) -> dict:
    from repro_torch.data import pipeline as data_mod
    b = data_mod.synth_batch(cfg, shape, step, seed)
    if uneven:
        b = mask_unevenly(b)
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def one_device_steps(arch: str, *, device: str, steps: int = 3,
                     lr: float = 1e-3, seq: int = 32, batch: int = 4,
                     reduced: bool = True, overrides: tuple = (),
                     mode: str = "brainslug", np_params: Any = None,
                     seed: int = 0, data_seed: int = 7,
                     uneven: bool = False) -> dict:
    """``steps`` single-device AdamW steps (``steps.make_train_step``) of
    :func:`sharded_steps`' weights and batches: losses and grad norms."""
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.launch import steps as steps_mod
    from repro_torch.optim import adamw
    dev = base.device(device)
    cfg, shape, params = _lm_setup(arch, dev, reduced=reduced,
                                   overrides=overrides, seq=seq, batch=batch,
                                   np_params=np_params, seed=seed)
    step = steps_mod.make_train_step(cfg, RuntimeConfig(mode=mode),
                                     adamw.AdamWConfig(lr=lr))
    opt = adamw.init(params)
    losses, norms = [], []
    for i in range(steps):
        params, opt, m = step(params, opt, _batch(cfg, shape, i, data_seed,
                                                  dev, uneven))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "grad_norms": norms}


def sharded_steps(arch: str, *, device: str, model_parallel: int = 1,
                  steps: int = 3, start: int = 0, lr: float = 1e-3,
                  seq: int = 32, batch: int = 4, reduced: bool = True,
                  overrides: tuple = (), mode: str = "brainslug",
                  np_params: Any = None, seed: int = 0, data_seed: int = 7,
                  planted: str | None = None, save_at: int | None = None,
                  ckpt_dir: str | None = None, uneven: bool = False,
                  first_grads: bool = False) -> dict:
    """Steps ``start .. start + steps - 1`` of the sharded step over a
    ``make_test_mesh(model_parallel=...)`` mesh of the whole group, from
    :func:`one_device_steps`' weights and batches (``start > 0`` restores
    the global state ``ckpt_dir`` holds at step ``start`` and slices this
    rank's shards; ``save_at`` gathers the state after that many steps
    and rank 0 writes it to ``ckpt_dir``; ``uneven`` masks the batches
    with :func:`mask_unevenly`).  Returns the losses and grad norms, the
    mesh, how many leaves keep a ``"model"`` split, and every rank's
    counters, shard element counts and bytes, collective bytes a step and
    peak memory; with ``first_grads``, also (rank 0's) the global
    gradient of the first step's batch at the starting weights (``steps.
    make_sharded_grad_fn``, gathered; numpy leaves by ``/``-joined
    path)."""
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    mesh = mesh_mod.make_test_mesh(model_parallel=model_parallel,
                                   device=device)
    dev = mesh.device
    cfg, shape, params = _lm_setup(arch, dev, reduced=reduced,
                                   overrides=overrides, seq=seq, batch=batch,
                                   np_params=np_params, seed=seed)
    pspecs = shd.repair_specs(params, shd.param_specs(
        lm.param_axes(cfg), shd.ShardingRules(), mesh), mesh)
    specs = {"params": pspecs, "opt": shd.opt_state_specs(pspecs, mesh)}
    global_numel = sum(t.numel() for t in base.tree_leaves(params))
    if start:
        tree, _ = ckpt.restore(ckpt_dir, start, {
            "params": params, "opt": adamw.init(params)})
        params, opt = (steps_mod.shard_tree(tree["params"], pspecs, mesh),
                       steps_mod.shard_tree(tree["opt"], specs["opt"], mesh))
        del tree
    else:
        params = steps_mod.shard_tree(params, pspecs, mesh)
        opt = adamw.init(params)
    gc.collect()
    step = steps_mod.make_sharded_train_step(
        cfg, RuntimeConfig(mode=mode), adamw.AdamWConfig(lr=lr), mesh,
        pspecs)
    kept = sum(base.tree_leaves(lm.tp_kept(cfg, pspecs,
                                                  mesh.extent("model"))))
    grads0 = None
    if first_grads:
        g, _ = steps_mod.make_sharded_grad_fn(
            cfg, RuntimeConfig(mode=mode), mesh, pspecs)(
            params, _batch(cfg, shape, start, data_seed, dev, uneven))
        g = steps_mod.gather_tree(g, pspecs, mesh)
        if g is not None:                       # rank 0
            grads0 = {"/".join(k): _np(v) for k, v in _paths(g)}
        del g
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, norms, per_step = [], [], []
    counts(zero=True)
    t = time.perf_counter()
    with _PlantedShard(planted), shape_records() as shapes:
        for i in range(start, start + steps):
            before = dict(collectives.STATS.bytes)
            params, opt, m = step(params, opt, _batch(
                cfg, shape, i, data_seed, dev, uneven))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            per_step.append({k: v - before.get(k, 0) for k, v in
                             collectives.STATS.bytes.items()})
            if save_at is not None and i + 1 == save_at:
                tree = steps_mod.gather_tree({"params": params, "opt": opt},
                                             specs, mesh)
                if tree is not None:
                    ckpt.save(ckpt_dir, save_at, tree)
                del tree
                dist.barrier()
    _sync(dev)
    wall = time.perf_counter() - t
    mine = {**counts(), "bytes_per_step": per_step,
            "shapes": {k: sorted(set(v)) for k, v in shapes.items()},
            "param_numel": sum(x.numel() for x in base.tree_leaves(params)),
            "param_bytes": _state_bytes(params),
            "opt_bytes": _state_bytes({k: opt[k] for k in ("mu", "nu")}),
            "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                         if dev.type == "cuda" else None)}
    return {"losses": losses, "grad_norms": norms, "mesh": mesh.describe(),
            "shape": dict(zip(mesh.axis_names, mesh.shape)), "kept": kept,
            "global_numel": global_numel, "wall_s": wall,
            "first_grads": grads0, "ranks": _all(mine)}


def _paths(tree: Any, prefix: tuple = ()) -> list:
    """``(path, leaf)`` of every leaf of a nested dict."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _paths(tree[k],
                                                          prefix + (k,))]
    return [(prefix, tree)]


def pipeline_block(device: str, *, arch: str = "deepseek-7b",
                   reduced: bool = False, seq: int = 2048,
                   n_microbatches: int = 4, dtype: str = "bfloat16",
                   seed: int = 30) -> dict:
    """``pipeline_apply`` over a ``("stage",)`` mesh of the whole group,
    one of ``arch``'s dense blocks a stage (``lm``'s block: rmsnorm, flash
    attention and the swiglu MLP in ``brainslug`` mode), on
    ``n_microbatches`` microbatches of (1, ``seq``, ``d_model``): the
    result against the stages' blocks applied in turn on rank 0 to the
    same microbatches, and every rank's counters."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.distributed import pipeline_parallel as pp
    from repro_torch.models import lm
    n = dist.get_world_size()
    mesh = mesh_mod.make_mesh((n,), ("stage",), device)
    dev = mesh.device
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    # the vocab is never read: a small one keeps the init cheap
    cfg = dataclasses.replace(cfg, n_layers=n, vocab_size=256, dtype=dtype)
    rt = RuntimeConfig(mode="brainslug")
    # every rank draws the whole stack from one seed, then keeps its slice
    stack = lm.init(seed, cfg, device=dev)["blocks"]["sub0"]
    stage = mesh.coords["stage"]
    mine = base.tree_map(lambda a: a[stage:stage + 1].clone(), stack)
    if mesh.rank != 0:
        del stack
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.randn((n_microbatches, seq, cfg.d_model), generator=gen,
                    device=dev).to(getattr(torch, dtype))

    def block_fn(p, h):
        resid, pending, _ = lm._apply_sub("attn_dense", p, h,
                                          torch.zeros_like(h), cfg, rt)
        return resid + pending

    counts(zero=True)
    t = time.perf_counter()
    with torch.no_grad():
        y = pp.pipeline_apply(block_fn, mine, x, mesh=mesh, axis="stage",
                              n_microbatches=n_microbatches)
    _sync(dev)
    wall = time.perf_counter() - t
    mesh_counts = counts()
    out = {"mesh": mesh.describe(), "wall_s": wall,
           "bubble": pp.bubble_fraction(n, n_microbatches),
           "finite": bool(torch.isfinite(y).all())}
    if mesh.rank == 0:
        with torch.no_grad():
            want = []
            for mb in x.split(1):
                h = mb
                for s_ in range(n):
                    h = block_fn(base.tree_map(lambda a: a[s_], stack), h)
                want.append(h)
            want = torch.cat(want)
        out.update(bitwise=bool(torch.equal(y, want)),
                   max_abs_err=float((y.float() - want.float()).abs().max()))
        del stack
    out["ranks"] = _all({**mesh_counts, "y_sum": float(y.float().sum())})
    return out


def pipeline_tanh(device: str, x: np.ndarray, w: np.ndarray, *,
                  n_microbatches: int = 4, cot: np.ndarray | None = None
                  ) -> dict:
    """``pipeline_apply`` of ``tanh(x @ w[stage])`` over a ``("stage",)``
    mesh of the whole group (``w``: one (D, D) matrix a stage, each rank
    handed only its own), as ``tests/test_multidevice.py``'s pipeline
    case: the output (numpy) and every rank's counters.  With ``cot``, the
    gradients of ``sum(y * cot)`` too: ``x``'s and every stage's ``w``'s
    (``grad_w``, one a rank)."""
    from repro_torch.distributed import pipeline_parallel as pp
    n = dist.get_world_size()
    mesh = mesh_mod.make_mesh((n,), ("stage",), device)
    stage = mesh.coords["stage"]
    grad = cot is not None
    params = {"w": torch.tensor(w[stage:stage + 1], device=mesh.device,
                                requires_grad=grad)}
    xt = torch.tensor(x, device=mesh.device, requires_grad=grad)
    counts(zero=True)
    y = pp.pipeline_apply(lambda p, h: torch.tanh(h @ p["w"]), params, xt,
                          mesh=mesh, n_microbatches=n_microbatches)
    out = {"y": _np(y.detach()), "mesh": mesh.describe()}
    if grad:
        torch.sum(y * torch.tensor(cot, device=mesh.device)).backward()
        out.update(grad_x=_np(xt.grad),
                   grad_w=_all(_np(params["w"].grad[0])))
    out["ranks"] = _all(counts())
    return out


# ---------------------------------------------------------------------------
# Mesh serving.
# ---------------------------------------------------------------------------

def serve_queue(vocab: int, *, n: int = 10, prefix_len: int = 6,
                max_tail: int = 6, max_new: int = 6, seed: int = 0
                ) -> list[dict]:
    """``tests/test_serve_mesh.py``'s queue as ``Request`` keyword dicts:
    a shared ``prefix_len``-token prefix on every odd request, tails of 1
    to ``max_tail`` tokens, 2 to ``max_new`` new tokens each (the defaults
    draw the JAX test's requests)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, (prefix_len,)).astype(np.int32)
    out = []
    for i in range(n):
        tail = rng.integers(0, vocab, (int(rng.integers(1, max_tail + 1)),)
                            ).astype(np.int32)
        prompt = np.concatenate([prefix, tail]) if i % 2 else tail
        out.append(dict(request_id=i, prompt=prompt.tolist(),
                        max_new_tokens=int(rng.integers(2, max_new + 1))))
    return out


def _record_ticks(eng) -> list:
    """Every tick's ``(counts, logits)`` of ``eng``'s rows, as it runs."""
    ticks: list = []
    inner = eng._mixed_logits

    def rec(cache, tables, tokens, counts, max_keys):
        logits, cache = inner(cache, tables, tokens, counts, max_keys)
        ticks.append((counts.copy(), logits.clone()))
        return logits, cache

    eng._mixed_logits = rec
    return ticks


def _evaluations(ticks: list) -> int:
    """Model evaluations of the recorded ticks: each tick runs the largest
    count of the rank's slots."""
    return sum(int(c.max(initial=0)) for c, _ in ticks)


def tick_gaps(ticks: list, ref_ticks: list, lo: int, n: int) -> dict:
    """A rank's ticks (its ``n`` slots from ``lo``) against the
    single-device engine's: whether every live row's logits are equal bit
    for bit, max|d| / max|ref| over the ticks up to the first flipped
    argmax (``compared`` of them), and each flip as (tick, slot, the
    reference's top-2 gap / max|ref|)."""
    rel, bitwise, flips, compared = 0.0, True, [], 0
    if len(ticks) != len(ref_ticks):
        return {"ticks": len(ticks), "ref_ticks": len(ref_ticks),
                "bitwise": False, "rel": float("inf"), "flips": []}
    for t, ((c, got), (rc, want)) in enumerate(zip(ticks, ref_ticks)):
        rc, want = rc[lo:lo + n], want[lo:lo + n]
        if not np.array_equal(c, rc):
            return {"ticks": len(ticks), "ref_ticks": len(ref_ticks),
                    "bitwise": False, "rel": float("inf"), "flips": [],
                    "counts_differ_at": t}
        compared += not flips
        live = torch.from_numpy(c > 0).to(got.device)
        if not bool(live.any()):
            continue
        g, w = got[live], want[live]
        bitwise = bitwise and bool(torch.equal(g, w))
        scale = max(float(w.abs().max()), 1e-30)
        if not flips:
            rel = max(rel, float((g - w).abs().max()) / scale)
        for i in (g.argmax(-1) != w.argmax(-1)).nonzero().flatten().tolist():
            top = w[i].topk(2).values
            flips.append((t, lo + int(np.flatnonzero(c > 0)[i]),
                          float(top[0] - top[1]) / scale))
    return {"ticks": len(ticks), "compared": compared, "bitwise": bitwise,
            "rel": rel, "flips": flips}


@dataclasses.dataclass
class _PlantedServe:
    """A defect in the mesh engine's decode: ``"no_wo_reduce"`` (each
    model rank keeps its partial out-projection, no all-reduce)."""

    what: str | None

    def __enter__(self):
        from repro_torch.layers import attention
        self.saved = attention._out_projection
        if self.what == "no_wo_reduce":
            attention._out_projection = (
                lambda o, params, rt: base.matmul(o, params["wo"]))
        elif self.what is not None:
            raise ValueError(f"unknown planted defect {self.what!r}")
        return self

    def __exit__(self, *exc):
        from repro_torch.layers import attention
        attention._out_projection = self.saved


def serve_engine(device: str, requests: list[dict], *,
                 arch: str = "qwen2.5-32b", reduced: bool = True,
                 overrides: tuple = (), np_params: Any = None, seed: int = 0,
                 mode: str = "xla", slots: int = 8, max_len: int = 20,
                 prefill_chunk: int = 4, kv_layout: str = "dense",
                 kv_block_size: int = 4, model_parallel: int = 1,
                 planted: str | None = None, stream: bool = False) -> dict:
    """``Server.engine(mesh=...)`` over a ``make_test_mesh(model_parallel=
    ...)`` mesh of the whole group on ``requests`` (``Request`` keyword
    dicts), after the single-device engine on the same requests in this
    rank, both ``verify_mode="strict"`` and each warmed up on the first
    request first.  Parameters: the JAX package's (``np_params``, numpy by
    path) or the seeded init.  With
    ``stream`` the mesh run streams through ``Request.on_token`` and
    ``Engine.stream`` too, each held against the completions.

    Returns rank 0's tokens and report, and every rank's: report, the
    cache bytes it holds, its counters (launches, plain dispatches,
    collectives), :func:`tick_gaps` against the reference, and ms a tick
    of both engines (ranks sharing a card: no multi-card number)."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.launch.engine import Request
    from repro_torch.launch.serve import ServeConfig, Server
    from repro_torch.models import lm
    mesh = mesh_mod.make_test_mesh(model_parallel=model_parallel,
                                   device=device)
    dev = mesh.device
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if overrides:
        cfg = dataclasses.replace(cfg, **dict(overrides))
    params = (lm.init(seed, cfg, device=dev) if np_params is None
              else convert.lm_params_from_numpy(np_params, dev))
    server = Server(ServeConfig(arch=arch, reduced=reduced, mode=mode,
                                batch=slots, max_len=max_len,
                                torch_device=dev.type),
                    params=params, cfg=cfg)
    kw = dict(slots=slots, prefill_chunk=prefill_chunk, kv_layout=kv_layout,
              kv_block_size=kv_block_size, verify_mode="strict")
    reqs = [Request(**r) for r in requests]

    def tick_ms(eng) -> float:
        st = eng.last_stats
        return st.wall_s * 1e3 / max(st.step_dispatches, 1)

    ref = server.engine(**kw)
    ref.run(reqs[:1])                   # warm-up: the kernels' first calls
    ref_ticks = _record_ticks(ref)
    ref_tokens = [c.tokens.tolist() for c in ref.run(reqs)]
    mine = {"ref_tick_ms": tick_ms(ref),
            "ref_cache_bytes": ref.last_cache_bytes,
            "ref_evaluations": _evaluations(ref_ticks)}
    del ref
    eng = server.engine(mesh=mesh, **kw)
    eng.run(reqs[:1])                   # warm-up at the rank's shapes
    ticks = _record_ticks(eng)
    events: dict = {}
    plain_reqs = reqs
    if stream:
        reqs = [dataclasses.replace(r, on_token=lambda ev: events.setdefault(
            ev.request_id, []).append(ev)) for r in reqs]
    counts(zero=True)
    with _PlantedServe(planted):
        comps = eng.run(reqs)
        _sync(dev)
        mine.update(counts())
        gaps = tick_gaps(ticks, ref_ticks, eng._slot_lo, eng.local_slots)
        if stream:
            streamed = list(eng.stream(plain_reqs))
    tokens = [c.tokens.tolist() for c in comps]
    out: dict = {"mesh": mesh.describe(), "tokens": tokens,
                 "ref_tokens": ref_tokens, "report": eng.report(),
                 "statuses": [c.status for c in comps]}
    if stream:
        # every request's callback events are its tokens then its
        # completion; the generator yields the same tokens in commit order
        per = [[e.token for e in events[c.request_id][:-1]] == c.tokens
               .tolist() and events[c.request_id][-1].completion is c
               for c in comps]
        gen = {}
        for ev in streamed:
            if not ev.done:
                gen.setdefault(ev.request_id, []).append(ev.token)
        out["stream_ok"] = all(per) and all(
            gen.get(c.request_id, []) == c.tokens.tolist() for c in comps)
    mine.update(report=eng.report(), cache_bytes=eng.last_cache_bytes,
                evaluations=_evaluations(ticks),
                local_slots=eng.local_slots,
                local_heads=(eng.local_cfg.n_heads,
                             eng.local_cfg.n_kv_heads),
                tick_ms=tick_ms(eng), tokens_equal=tokens == ref_tokens,
                gaps=gaps, attn_dispatch=dict(eng.last_attn_dispatch or {}))
    del ticks, ref_ticks
    out["ranks"] = _all(mine)
    return out


def run_checks(checks: list[tuple[str, str, dict]]) -> dict:
    """``(label, function, kwargs)``: each named function of this module
    in turn, in this rank, with the device's cache emptied between them;
    ``{label: result}`` and each check's seconds under ``"seconds"``."""
    out: dict = {"seconds": {}}
    for label, name, kw in checks:
        t = time.perf_counter()
        out[label] = globals()[name](**kw)
        out["seconds"][label] = round(time.perf_counter() - t, 1)
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        dist.barrier()
    return out


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.mesh_checks",
        description="Mesh checks at small sizes: two ranks (data, then "
                    "tensor) and four (both).")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 128)).astype(np.float32)
    w = rng.normal(size=(128, 128)).astype(np.float32)
    got = mesh_mod.spawn(loss_grads, 2, args.device, x, w,
                         device=args.device)
    print(f"[mesh] {got['mesh']}: gradients max|d| {got['max_abs_err']:.3e}"
          f" against one device")
    got = mesh_mod.spawn(block_fn_train, 4, args.device, device=args.device)
    print(f"[mesh] {got['mesh']}: block_fn training losses {got['losses']}"
          f" (one device {got['losses_one']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
