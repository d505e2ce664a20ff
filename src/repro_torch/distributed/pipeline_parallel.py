"""GPipe-style pipeline parallelism over a mesh axis (opt-in), ported from
``repro/distributed/pipeline_parallel.py``.

The JAX package runs the classic collective-permute schedule under
``shard_map``: the layer stack is split into ``n_stages`` groups,
microbatches stream through the stages, and activations hop stage to
stage by ``ppermute``.  Here every rank of the mesh's ``axis`` is one
stage: it holds its slice of the stage parameters, runs the same tick
schedule, and hands each tick's output to the next stage by a
point-to-point send inside the axis (:func:`repro_torch.distributed.
collectives.send_recv`; under gloo a CUDA tensor goes through the host).
The last stage banks the outputs, which reach every stage by a broadcast
from it (JAX: a masked ``psum``).  A stage computes nothing on the ticks
where no microbatch is in flight to it (JAX's stages run a block on zeros
there and discard it): the same schedule and result.  The bubble fraction
is (S-1)/(M+S-1), reported by :func:`bubble_fraction` so configs can size
microbatches.

The schedule is differentiable, as the JAX one is through the transposes
of ``ppermute`` and ``psum``: the backward runs the ticks in reverse, each
stage recomputing its block on the input it kept for the microbatch (the
GPipe paper's rematerialisation) and sending the input's cotangent to the
stage before it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.distributed import collectives
from repro_torch.layers import base


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


@dataclasses.dataclass(frozen=True)
class _Schedule:
    block_fn: Callable[[Any, torch.Tensor], torch.Tensor]
    like: Any                     # the stage parameters' tree
    mesh: Any
    axis: str
    n_microbatches: int

    @property
    def n_stages(self) -> int:
        return self.mesh.extent(self.axis)

    @property
    def stage(self) -> int:
        return self.mesh.coords[self.axis]

    def params(self, flat: list) -> Any:
        it = iter(flat)
        return base.tree_map(lambda _: next(it)[0], self.like)

    def hop(self, y: torch.Tensor | None, to: int | None, frm: int | None,
            like: torch.Tensor) -> torch.Tensor | None:
        return collectives.send_recv(y, self.mesh, self.axis, to=to,
                                     frm=frm, like=like)

    def forward(self, micro: torch.Tensor, flat: list,
                keep_inputs: bool) -> tuple[torch.Tensor, list]:
        """The outputs of every microbatch (on every stage), and this
        stage's input of each where ``keep_inputs``."""
        s, n, m = self.stage, self.n_stages, self.n_microbatches
        params = self.params(flat)
        outputs = torch.zeros_like(micro)
        inputs: list = [None] * m
        buf = None
        for t in range(m + n - 1):
            # stage 0 ingests microbatch t; a later stage what its
            # predecessor sent last tick.  A stage idles (the bubble) where
            # its input is not in flight yet, or no longer.
            mb = t - s
            out = None
            if 0 <= mb < m:
                inp = micro[mb] if s == 0 else buf
                if keep_inputs:
                    inputs[mb] = inp
                out = self.block_fn(params, inp)
                if s == n - 1:
                    outputs[mb] = out
            sends = s < n - 1 and out is not None
            recvs = s > 0 and 0 <= t + 1 - s < m
            buf = self.hop(out if sends else None, s + 1 if sends else None,
                           s - 1 if recvs else None, micro[0])
        collectives.broadcast(outputs, self.mesh, self.axis, n - 1)
        return outputs, inputs

    def backward(self, g_out: torch.Tensor, inputs: list, flat: list,
                 want_x: bool) -> tuple[torch.Tensor | None, list]:
        """The ticks in reverse: the cotangents of this stage's parameters
        (summed over the microbatches) and, on stage 0, of the
        microbatches (None elsewhere, or where ``want_x`` is False)."""
        s, n, m = self.stage, self.n_stages, self.n_microbatches
        live = [p.detach().requires_grad_(p.requires_grad) for p in flat]
        wanted = [p for p in live if p.requires_grad]
        g_params: list = [None] * len(wanted)
        g_micro = torch.zeros_like(g_out) if s == 0 and want_x else None
        buf = None
        for t in reversed(range(m + n - 1)):
            mb = t - s
            g_in = None
            if 0 <= mb < m:
                g_o = g_out[mb] if s == n - 1 else buf
                with torch.enable_grad():
                    inp = inputs[mb].detach().requires_grad_(
                        s > 0 or want_x)
                    out = self.block_fn(self.params(live), inp)
                    srcs = ([inp] if inp.requires_grad else []) + wanted
                    grads = list(torch.autograd.grad(
                        out, srcs, g_o, allow_unused=True))
                if inp.requires_grad:
                    g_in = grads.pop(0)
                    if g_in is None:
                        g_in = torch.zeros_like(inp)
                for i, g in enumerate(grads):
                    if g is not None:
                        g_params[i] = g if g_params[i] is None \
                            else g_params[i] + g
                if g_micro is not None:
                    g_micro[mb] = g_in
            # the forward's hop transposed: this tick's input cotangent
            # goes back a stage, and the next (earlier) tick's output
            # cotangent comes from the stage after
            sends = s > 0 and g_in is not None
            recvs = s < n - 1 and 0 <= t - 1 - s < m
            buf = self.hop(g_in if sends else None, s - 1 if sends else None,
                           s + 1 if recvs else None, g_out[0])
        it = iter(g_params)
        return g_micro, [next(it) if p.requires_grad else None
                         for p in live]


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched: _Schedule, micro: torch.Tensor, *flat):
        outputs, inputs = sched.forward(micro, list(flat), keep_inputs=True)
        ctx.sched = sched
        ctx.save_for_backward(*flat, *inputs)
        return outputs

    @staticmethod
    def backward(ctx, g_out):
        sched = ctx.sched
        saved = ctx.saved_tensors
        k = len(saved) - sched.n_microbatches
        flat, inputs = list(saved[:k]), list(saved[k:])
        # every rank holds the same cotangent of the replicated output (a
        # loss of the whole output computed in every rank): the last
        # stage starts from its own, the transpose of the broadcast
        g_micro, g_params = sched.backward(
            g_out.contiguous(), inputs, flat, ctx.needs_input_grad[1])
        if g_micro is None and ctx.needs_input_grad[1]:
            g_micro = torch.empty_like(g_out)
        if ctx.needs_input_grad[1]:
            # every stage reads x; only stage 0's use has a cotangent
            collectives.broadcast(g_micro, sched.mesh, sched.axis, 0)
        return (None, g_micro, *g_params)


def pipeline_apply(block_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, *, mesh: Any,
                   axis: str = "stage", n_microbatches: int = 4
                   ) -> torch.Tensor:
    """Run ``x`` through the ``n_stages`` ranks of ``axis``.

    ``stage_params`` holds this rank's stage: every leaf has a leading dim
    of 1 (a stage's shard of the JAX package's ``(n_stages, ...)`` leaves
    sharded over ``axis``); ``block_fn(params_slice, x)`` applies one
    stage's layers and keeps ``x``'s shape.  ``x``: (B, ...) with B
    divisible by ``n_microbatches``, the same on every rank (stage 0 reads
    it).  Every rank returns the whole (B, ...) output.

    Under autograd (grad enabled and ``x`` or a parameter requiring it)
    the backward gives each stage the gradient of its own parameters and
    every rank ``x``'s, taking every rank's cotangent of the output to be
    the same (one loss of the whole output, computed in every rank)."""
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} % microbatches {n_microbatches} != 0")
    flat = base.tree_leaves(stage_params)
    for a in flat:
        if a.shape[0] != 1:
            raise ValueError(f"stage parameter of leading dim {a.shape[0]}:"
                             f" want 1 (this rank's stage)")
    micro = x.reshape(n_microbatches, b // n_microbatches, *x.shape[1:])
    sched = _Schedule(block_fn, stage_params, mesh, axis, n_microbatches)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in [x, *flat]):
        outputs = _Pipeline.apply(sched, micro, *flat)
    else:
        outputs, _ = sched.forward(micro, flat, keep_inputs=False)
    return outputs.reshape(b, *x.shape[1:])
