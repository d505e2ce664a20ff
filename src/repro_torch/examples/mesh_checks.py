"""Mesh execution checks, one function per path, each run in every rank of
a group that :func:`repro_torch.launch.mesh.spawn` (or ``torchrun``)
started: the optimized callable under ``OptimizeConfig(mesh=...,
partition=...)`` against the single-device compile of the whole batch on
the same inputs, with every rank's dispatch and launch counters.

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
* :func:`dp_train`: the data-parallel ``Trainer``.

Each returns rank 0's numbers (and, where asked, its arrays as numpy) and
``ranks``: every rank's counters.  Run on its own, at small sizes on
the CPU::

    python -m repro_torch.examples.mesh_checks --device cpu
"""
from __future__ import annotations

import argparse
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
    from repro_torch.kernels.fused_stack import nhwc, nhwc_bwd, ops, rows, \
        rows_bwd
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.swiglu import swiglu
    from repro_torch.kernels.vocab_ce import ce
    fns = {"fused_nhwc": nhwc.fused_nhwc, "fused_rows": rows.fused_rows,
           "fused_nhwc_bwd": nhwc_bwd.fused_nhwc_bwd,
           "fused_rows_bwd": rows_bwd.fused_rows_bwd,
           "rmsnorm": rmsnorm.rmsnorm_fwd, "swiglu": swiglu.swiglu_fwd,
           "flash_attention": flash.flash_attention_fwd,
           "flash_decode": decode.flash_decode,
           "paged_flash_decode": decode.paged_flash_decode,
           "fused_ce": ce.fused_ce_fwd,
           "ssd_intra_chunk": ssd.ssd_intra_chunk}
    if zero:
        for fn in fns.values():
            fn.launches = 0
        ops.STATS.reset()
        registry.STATS.reset()
        collectives.STATS.reset()
    return {**ops.STATS.snapshot(),
            "launches": {k: fn.launches for k, fn in fns.items()},
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
             common: dict | None = None, lr: float | None = None) -> dict:
    """Run each ``TrainerConfig`` override dict of ``runs`` (over
    ``common``) through the data-parallel ``Trainer``, from ``np_params``
    (numpy, carried over with ``convert.lm_params_from_numpy``) or the
    seeded init; ``lr`` fixes a constant learning rate (by default the
    trainer's: ``tc.lr`` for a reduced config, the warmup-cosine schedule
    otherwise).  A run with ``"fail_at"`` is killed there by the
    failure-injection hook and resumed from its checkpoints.  Returns each
    run's history, the error-feedback state's largest entry just after a
    restore, per-rank counters and peak memory."""
    from repro_torch import convert
    from repro_torch.distributed import data_parallel
    from repro_torch.distributed import fault_tolerance as ft
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import adamw
    opt = {} if lr is None else {"opt_cfg": adamw.AdamWConfig(lr=lr)}
    out = []
    for run in runs:
        kw = {**(common or {}), **run}
        fail_at = kw.pop("fail_at", None)
        tc = train_mod.TrainerConfig(data_parallel=True, **kw)
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
        rec["wire_bytes"] = data_parallel.wire_bytes(trainer.params,
                                                     compress=tc.compress)
        del trainer
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out.append(rec)
    return {"runs": out}


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
