"""Token-choice top-k MoE with static capacity (sort-based dispatch), ported
from ``repro/layers/moe.py``.

Dispatch is the JAX package's sort-based static-capacity scheme: flatten the
(token, choice) assignments, rank each within its expert by one stable
argsort, drop ranks at or past the capacity ``C = ceil8(T k / E x
capacity_factor)`` (``dropless``: ``C = ceil8(T)``, the decode semantic),
and gather tokens into a ``(G, E, C, D)`` expert batch.  No ``(T, E, C)``
one-hot tensor is built.

The JAX package leaves routing, the sort and the gathers and scatters to
XLA, and so they stay ordinary tensor code here; the gated expert FFN runs
through :func:`repro_torch.layers.stacks.glu`, so ``brainslug`` reaches the
swiglu kernel.  The expert products are ``torch.einsum`` over the expert
axis (batched matmuls).

Determinism.  The combine is the JAX package's ``zeros.at[table].add(ye)``,
which the CPU runs slot by slot in slot order (expert-major), rounding each
add in the output dtype.  A scatter-add on the card (``index_add_``, the
backward of ``gather`` or of advanced indexing) adds by atomics in no fixed
order, so two runs could differ in bits.  Here each token's ``k`` slots are
sorted and their rows gathered and added in that order, from zeros, in the
output dtype: the sequential scatter-add's bits, on any device.  The gather
into the expert batch and the combine are each other's transposes, so each
one's backward is the other (:class:`_Dispatch`, :class:`_Combine`): the
forward and the backward hold no atomic.  Rows are indexed through
``(group, row)`` index pairs, never through an index as wide as ``D``.

Ties in the router's top-k: ``jax.lax.top_k`` takes the lower expert index,
``torch.topk`` promises no order among equal values.  Float32 router
probabilities of random weights tie with probability near zero; equal
inputs on one device give equal choices.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, RuntimeConfig
from repro_torch.distributed import collectives
from repro_torch.layers import base, dense, stacks


def init(g: torch.Generator, cfg: ModelConfig, n_layers: int,
         dtype: torch.dtype) -> dict:
    """The MoE parameters of ``n_layers`` layers, stacked on a leading
    layer axis, with the JAX package's scales: the router and the expert
    products ``1 / sqrt(fan_in)``; the optional shared expert is a dense
    gated block of ``shared_expert_ff``."""
    d, f, e, L = cfg.d_model, cfg.d_ff, cfg.n_experts, n_layers
    p = {
        "router": base.normal(g, (L, d, e), fan_in=d, dtype=dtype),
        "wg": base.normal(g, (L, e, d, f), fan_in=d, dtype=dtype),
        "wu": base.normal(g, (L, e, d, f), fan_in=d, dtype=dtype),
        "wd": base.normal(g, (L, e, f, d), fan_in=f, dtype=dtype),
    }
    if cfg.shared_expert_ff:
        p["shared"] = dense.init(g, cfg, L, dtype, d_ff=cfg.shared_expert_ff)
    return p


def param_axes(cfg: ModelConfig) -> dict:
    """Logical axes of one layer's :func:`init` leaves (the JAX package's
    ``boxed`` annotations): the experts over ``experts``, their hidden dim
    over ``ffn``; the shared expert a dense block's."""
    p = {"router": ("fsdp", None), "wg": ("experts", None, "ffn"),
         "wu": ("experts", None, "ffn"), "wd": ("experts", "ffn", None)}
    if cfg.shared_expert_ff:
        p["shared"] = dense.param_axes(cfg)
    return p


def capacity(cfg: ModelConfig, n_tokens: int, *,
             dropless: bool = False) -> int:
    """Static expert capacity, rounded up to a multiple of 8.
    ``dropless=True`` sizes the slots for the worst case (every token on
    one expert): the decode and serving semantic."""
    if dropless:
        c = n_tokens
    else:
        c = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
          rt: RuntimeConfig, *, dropless: bool = False, with_aux: bool = True
          ) -> tuple[torch.Tensor, dict]:
    """``x`` (B, S, D) -> (y (B, S, D), aux).  ``rt.moe_dispatch``:
    ``grouped`` (default) takes a group per batch row when ``S > 1`` and
    enforces capacity per group; ``global`` one flat sort over all
    assignments.  ``aux`` holds ``router_aux_loss`` (the switch
    load-balance loss) and ``drop_fraction``, float32 scalars; a caller
    that drops them (decode) passes ``with_aux=False`` and gets ``{}``, so
    an eager step launches nothing for them."""
    b, s, _ = x.shape
    if rt.moe_dispatch == "global" and collectives.region_batch_axes():
        # one sort over a shard's tokens would set the capacity, and so
        # the dropped tokens, per shard: not the global program's
        raise ValueError("moe_dispatch='global' under a batch split over "
                         "ranks (the sharded step): use 'grouped'")
    n_groups = b if rt.moe_dispatch == "grouped" and s > 1 else 1
    return _apply_dispatch(params, x, cfg, rt, dropless=dropless,
                           n_groups=n_groups, with_aux=with_aux)


def route(router: torch.Tensor, xf: torch.Tensor, k: int
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Float32 routing of ``xf`` (G, Tg, D): the router's softmax
    probabilities (G, Tg, E), the top-``k`` experts of each token (G, Tg,
    k, descending) and their gate weights renormalised to sum to one
    (with a 1e-9 floor on the sum)."""
    logits = xf.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gate_w, expert_idx = torch.topk(probs, k, dim=-1)
    gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)
    return probs, gate_w, expert_idx


def assign(expert_idx: torch.Tensor, n_experts: int, cap: int
           ) -> tuple[torch.Tensor, ...]:
    """Slots of the (token, choice) assignments ``expert_idx`` (G, Tg, k)
    in a (G, E x cap) expert batch, as the JAX package ranks them: by one
    stable argsort of the flattened assignments a group, the rank of each
    within its expert, kept below ``cap``.  Returns ``keep`` (G, Tg k),
    ``slot`` (G, Tg k; the sentinel ``E cap`` where dropped), ``table``
    (G, E cap: the token of each slot, ``Tg`` where empty) and
    ``token_slots`` (G, Tg, k: each token's slots in ascending order)."""
    g, tg, k = expert_idx.shape
    e, dev = n_experts, expert_idx.device
    flat_e = expert_idx.reshape(g, tg * k)
    sort_idx = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, sort_idx)
    # group_start[g, e]: the assignments of group g on an expert below e
    group_start = torch.searchsorted(
        sorted_e, torch.arange(e, device=dev).expand(g, e).contiguous())
    ranks_sorted = (torch.arange(tg * k, device=dev)
                    - torch.gather(group_start, 1, sorted_e))
    ranks = torch.empty_like(flat_e).scatter_(1, sort_idx, ranks_sorted)
    keep = ranks < cap
    slot = torch.where(keep, flat_e * cap + ranks, e * cap)
    token_of_flat = (torch.arange(tg * k, device=dev) // k).expand(g, -1)
    # the sentinel column takes every dropped assignment and is cut off
    table = torch.full((g, e * cap + 1), tg, dtype=torch.int64,
                       device=dev).scatter_(1, slot, token_of_flat)[:, :-1]
    token_slots = torch.sort(slot.reshape(g, tg, k), dim=-1).values
    return keep, slot, table, token_slots


def _padded(src: torch.Tensor) -> torch.Tensor:
    """(G, N, D) rows and a row of zeros at index ``N``."""
    return torch.cat([src, src.new_zeros(src.shape[0], 1, src.shape[2])], 1)


def _take(pad: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``pad[g, idx[g, ...]]``: whole rows by (group, row) index pairs."""
    gi = torch.arange(pad.shape[0], device=pad.device).view(
        -1, *([1] * (idx.dim() - 1)))
    return pad[gi, idx]


def _rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[g, idx[g, ...]]`` over (G, N, D) rows, an index of ``N``
    reading a row of zeros."""
    return _take(_padded(src), idx)


def _sum_slots(src: torch.Tensor, token_slots: torch.Tensor
               ) -> torch.Tensor:
    """Per token ``t`` of each group, the rows ``src[g, token_slots[g, t,
    j]]`` added in ``j`` order to zeros, each add rounded in ``src``'s
    dtype (the sentinel slot ``N`` adds a row of zeros)."""
    rows = _take(_padded(src), token_slots)            # (G, Tg, k, D)
    out = src.new_zeros(rows.shape[:2] + rows.shape[3:])
    for j in range(rows.shape[2]):
        out = out + rows[:, :, j]
    return out


class _Dispatch(torch.autograd.Function):
    """xe[g, s] = xf[g, table[g, s]] (zeros at an empty slot); the backward
    adds each token's slot gradients in slot order (:func:`_sum_slots`)."""

    @staticmethod
    def forward(ctx, xf, table, token_slots):
        ctx.save_for_backward(token_slots)
        return _rows(xf, table)

    @staticmethod
    def backward(ctx, grad):
        token_slots, = ctx.saved_tensors
        return _sum_slots(grad, token_slots), None, None


class _Combine(torch.autograd.Function):
    """y[g, t] = the rows of token t's slots added in slot order; the
    backward reads each slot's token gradient (:func:`_rows`)."""

    @staticmethod
    def forward(ctx, ye_flat, token_slots, table):
        ctx.save_for_backward(table)
        return _sum_slots(ye_flat, token_slots)

    @staticmethod
    def backward(ctx, grad):
        table, = ctx.saved_tensors
        return _rows(grad, table), None, None


def _apply_dispatch(params: dict, x: torch.Tensor, cfg: ModelConfig,
                    rt: RuntimeConfig, *, dropless: bool, n_groups: int,
                    with_aux: bool = True) -> tuple[torch.Tensor, dict]:
    b, s, d = x.shape
    e, k, g = cfg.n_experts, cfg.top_k, n_groups
    tg = b * s // g                                        # tokens a group
    c = capacity(cfg, tg, dropless=dropless)
    dev = x.device
    xf = x.reshape(g, tg, d)
    record = torch.profiler.record_function

    with record("moe.routing"):
        probs, gate_w, expert_idx = route(params["router"], xf, k)
        keep, slot, table, token_slots = assign(expert_idx, e, c)
        # a slot's gate weight (the scatter's backward is a gather)
        gates = torch.zeros((g, e * c + 1), dtype=torch.float32,
                            device=dev).scatter(
            1, slot, gate_w.reshape(g, tg * k))[:, :-1]

    with record("moe.experts"):
        xe = _Dispatch.apply(xf, table, token_slots).reshape(g, e, c, d)
        ge = torch.einsum("gecd,edf->gecf", xe, params["wg"])
        ue = torch.einsum("gecd,edf->gecf", xe, params["wu"])
        he = stacks.glu(ge, ue, act=cfg.act, mode=rt.mode)
        ye = torch.einsum("gecf,efd->gecd", he, params["wd"])

    with record("moe.combine"):
        ye_flat = ye.reshape(g, e * c, d) * gates[..., None].to(ye.dtype)
        y = _Combine.apply(ye_flat, token_slots, table)
        y = y.reshape(b, s, d).to(x.dtype)

    if cfg.shared_expert_ff:
        y = y + dense.apply(params["shared"], x, cfg, rt)
    if not with_aux:
        return y, {}

    # switch load-balance loss and drop statistics (float32); the counts
    # are sums of 0 / 1, exact in float32 in any order
    me = probs.mean(dim=(0, 1))
    kept = torch.zeros(e, dtype=torch.float32, device=dev).index_add_(
        0, expert_idx.reshape(-1), keep.reshape(-1).float())
    n_kept = keep.sum().float()
    drop = 1.0 - keep.float().mean()
    if collectives.region_batch_axes():
        # the batch is split over ranks (the sharded step): the statistics
        # of the global batch, as the JAX package's GSPMD step has them
        # (the shards hold equal token counts)
        me = collectives.batch_mean(me)
        kept = collectives.batch_sum(kept)
        n_kept = collectives.batch_sum(n_kept)
        drop = collectives.batch_mean(drop)
    ce_frac = kept / torch.clamp_min(n_kept, 1.0)
    aux = {"router_aux_loss": e * torch.sum(me * ce_frac),
           "drop_fraction": drop}
    return y, aux
