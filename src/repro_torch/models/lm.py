"""Language-model assembly, ported from ``repro/models/lm.py`` for the dense
family (attention + MLP blocks), the MoE family (attention + top-k expert
blocks, with dense blocks between them where ``moe_layer_period > 1``), the
SSM family (mamba2 blocks) and the hybrid family (zamba2: mamba blocks with
one shared attention block):
embedding, a stack of super-blocks over the layer-stacked parameters, fused
BrainSlug norm and activation chains, the final norm and the vocab head;
prefill, decode and the training loss.

* Parameters are the JAX package's nested tree.  :func:`layer_plan` gives
  the kinds of one super-block and their count; ``blocks/sub{j}/...``
  holds the parameters of the super-block's ``j``-th kind, each leaf
  carrying a leading axis over the super-blocks (``jax.lax.scan`` over
  that axis becomes a loop over it).  A dense block is ``{norm1, attn,
  norm2, mlp}``, an MoE block ``{norm1, attn, norm2, moe}``, a mamba block
  ``{norm1, mixer}``.  The hybrid's
  ``shared_attn`` (a dense block) is stored once, with no layer axis, and
  applied at the last position of every super-block, so its gradient is
  the sum over its applications; its remainder layers, ``tail/sub0``, are
  mamba blocks stacked over the tail.
* The residual stream uses a (resid, pending) carry so every residual add
  fuses with the next norm.
* MoE blocks drop tokens at capacity in the forward (``hidden``,
  ``prefill``, ``loss_fn``), whose aux (``router_aux_loss``,
  ``drop_fraction``) is the sum over the MoE layers, and run dropless in
  ``decode_step`` (serving drops no live request's token).
* Decode caches mirror the parameters: ``blocks/sub{j}`` stacked over the
  super-blocks (for the shared attention one KV cache per application) and
  ``tail/sub0``, updated in place: a KV cache (dense or paged) per
  attention layer, a :class:`~repro_torch.layers.mamba2.MambaCache` (conv
  window and SSM state) per mamba layer.
* The training loss (:func:`loss_fn`) runs the fused vocab cross-entropy
  kernel in ``brainslug`` mode for an untied head (a tied head, as mamba2's,
  takes the plain loss in every mode, as the JAX package does);
  ``remat="full"`` recomputes each super-block and each tail layer in the
  backward (``torch.utils.checkpoint``), as ``jax.checkpoint`` does;
  ``remat="dots"`` keeps their unbatched products' outputs and recomputes
  the rest (selective checkpointing), as JAX's
  ``dots_with_no_batch_dims_saveable`` policy does.

* Logical axes (:func:`param_axes`, ``init(..., with_axes=True)``): the
  JAX package's sharding annotations of every leaf, for
  :mod:`repro_torch.distributed.sharding`.  Inside a tensor-parallel
  region (``rt.tp_axis``: the sharded train step's, and the mesh engine's
  ``decode_step``) an attention layer whose projections hold a slice of
  the heads runs :func:`tp_local_config`'s head counts, and an MLP
  holding a slice of its ``d_ff`` columns runs on them; every other layer
  computes whole.  The engine's slice is :func:`tp_shard_params`'s
  (attention only, as the JAX package's serving splits).

Plain twins for the traced frontend (:func:`repro_torch.api.optimize`):
:func:`transformer_block_fn` and :func:`ce_loss_fn`, ordinary tensor code
whose traced graph the kernel registry rewrites onto the dedicated kernels.

The frontends are the JAX package's stubs: ``audio_frames`` (hubert: an
encoder over frame embeddings, ``frames @ frontend_proj``, no causal mask,
no decode path) and ``vision_patches`` (paligemma: image patches projected
by ``frontend_proj`` and put in front of the text tokens under the plain
causal mask; the loss reads the text positions).  Float32 frames over bf16
weights run the stream in float32, as jnp promotes
(:func:`repro_torch.layers.base.promote`).  Entry points run on ``cuda``
unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig, RuntimeConfig
from repro_torch.distributed import collectives
from repro_torch.kernels.vocab_ce import ops as ce_ops
from repro_torch.layers import attention, base, dense, mamba2, moe, stacks

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ---------------------------------------------------------------------------
# Layer plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerPlan:
    superblock: tuple[str, ...]     # kinds within one super-block
    n_super: int
    tail: tuple[str, ...]           # remainder (hybrid only)

    @property
    def uses_shared_attn(self) -> bool:
        return "shared_attn" in self.superblock or "shared_attn" in self.tail


def layer_plan(cfg: ModelConfig) -> LayerPlan:
    if cfg.family == "ssm":
        return LayerPlan(("mamba",), cfg.n_layers, ())
    if cfg.family == "hybrid":
        q = cfg.attn_layer_period
        n_super = cfg.n_layers // q
        tail = ("mamba",) * (cfg.n_layers % q)
        return LayerPlan(("mamba",) * (q - 1) + ("shared_attn",),
                         n_super, tail)
    if cfg.n_experts:
        p = cfg.moe_layer_period
        if cfg.n_layers % p:
            raise ValueError(f"{cfg.name}: n_layers % moe_layer_period != 0")
        return LayerPlan(("attn_dense",) * (p - 1) + ("attn_moe",),
                         cfg.n_layers // p, ())
    return LayerPlan(("attn_dense",), cfg.n_layers, ())


def n_moe_layers(cfg: ModelConfig) -> int:
    """How many MoE layers ``hidden``'s aux sums over."""
    plan = layer_plan(cfg)
    return plan.n_super * plan.superblock.count("attn_moe")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init(seed: int, cfg: ModelConfig, *,
         device: str | torch.device = "cuda", with_axes: bool = False
         ) -> dict | tuple[dict, dict]:
    """Random parameters from ``seed`` with the JAX package's tree, shapes
    and scales (not its values: carry those over with
    :func:`repro_torch.convert.lm_params_from_numpy`).  ``with_axes``
    returns ``(params, param_axes(cfg))``, the pair the JAX ``lm.init``
    returns."""
    if with_axes:
        params = init(seed, cfg, device=device)
        axes = param_axes(cfg)
        base.check_axes(params, axes)
        return params, axes
    plan = layer_plan(cfg)
    dev = base.device(device)
    dtype = DTYPES[cfg.dtype]
    g = base.generator(seed, dev)
    L = plan.n_super
    tree: dict[str, Any] = {
        "embed": base.normal(g, (cfg.vocab_size, cfg.d_model),
                             scale=0.02 if cfg.tie_embeddings else None,
                             dtype=dtype)}
    if not cfg.tie_embeddings:
        tree["out_head"] = base.normal(g, (cfg.d_model, cfg.vocab_size),
                                       dtype=dtype)
    if cfg.frontend:
        tree["frontend_proj"] = base.normal(
            g, (cfg.frontend_dim, cfg.d_model), dtype=dtype)
    tree["final_norm"] = dense.norm_init(cfg, None, dtype, dev)
    blocks = {f"sub{j}": _init_sub(g, kind, cfg, L, dtype, dev)
              for j, kind in enumerate(plan.superblock)
              if kind != "shared_attn" and L}
    if blocks:
        tree["blocks"] = blocks
    if plan.uses_shared_attn:
        # stored once: the parameters of one layer, no layer axis
        one = _init_sub(g, "shared_attn", cfg, 1, dtype, dev)
        tree["shared_attn"] = base.tree_map(lambda a: a[0], one)
    if plan.tail:           # the hybrid's remainder: mamba blocks
        tree["tail"] = {"sub0": _init_sub(g, "mamba", cfg, len(plan.tail),
                                          dtype, dev)}
    return tree


def _init_sub(g: torch.Generator, kind: str, cfg: ModelConfig, n: int,
              dtype: torch.dtype, dev: torch.device) -> dict:
    """A block of ``kind`` for ``n`` layers, stacked on a leading axis."""
    sub = {"norm1": dense.norm_init(cfg, n, dtype, dev)}
    if kind == "mamba":
        sub["mixer"] = mamba2.init(g, cfg, n, dtype)
        return sub
    sub["attn"] = attention.init(g, cfg, n, dtype)
    sub["norm2"] = dense.norm_init(cfg, n, dtype, dev)
    if kind == "attn_moe":
        sub["moe"] = moe.init(g, cfg, n, dtype)
    else:                               # attn_dense / shared_attn
        sub["mlp"] = dense.init(g, cfg, n, dtype)
    return sub


def _sub_axes(kind: str, cfg: ModelConfig) -> dict:
    """The logical axes of one layer of a block of ``kind``."""
    sub = {"norm1": dense.norm_axes(cfg)}
    if kind == "mamba":
        sub["mixer"] = mamba2.param_axes(cfg)
        return sub
    sub.update(attn=attention.param_axes(cfg), norm2=dense.norm_axes(cfg))
    if kind == "attn_moe":
        sub["moe"] = moe.param_axes(cfg)
    else:
        sub["mlp"] = dense.param_axes(cfg)
    return sub


def param_axes(cfg: ModelConfig) -> dict:
    """The logical axes of :func:`init`'s tree, leaf for leaf the JAX
    ``lm.init(key, cfg)[1]``: the embedding ``("vocab", None)``, the head
    ``(None, "vocab")``, the frontend projection replicated, layer-stacked
    blocks and tail under a leading ``"layers"``, the hybrid's shared
    attention without one."""
    plan = layer_plan(cfg)
    tree: dict[str, Any] = {"embed": ("vocab", None)}
    if not cfg.tie_embeddings:
        tree["out_head"] = (None, "vocab")
    if cfg.frontend:
        tree["frontend_proj"] = (None, None)
    tree["final_norm"] = dense.norm_axes(cfg)
    blocks = {f"sub{j}": base.stack_axes(_sub_axes(kind, cfg))
              for j, kind in enumerate(plan.superblock)
              if kind != "shared_attn" and plan.n_super}
    if blocks:
        tree["blocks"] = blocks
    if plan.uses_shared_attn:
        tree["shared_attn"] = _sub_axes("shared_attn", cfg)
    if plan.tail:
        tree["tail"] = {"sub0": base.stack_axes(_sub_axes("mamba", cfg))}
    return tree


def _layer(tree: Any, i: int) -> Any:
    return base.tree_map(lambda a: a[i], tree)


def _unstack(tree: Any, n: int) -> list:
    """The ``n`` per-layer trees of a layer-stacked tree, each leaf taken
    apart once (``torch.unbind``).  Under autograd the backward then stacks
    each leaf's gradient once; indexing a layer (``a[i]``) would add a zero
    tensor the size of the whole stacked leaf for every layer."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return list(torch.unbind(tree))


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _apply_sub(kind: str, p: dict | None, resid: torch.Tensor,
               pending: torch.Tensor, cfg: ModelConfig, rt: RuntimeConfig,
               shared_params: dict | None = None
               ) -> tuple[torch.Tensor, torch.Tensor, dict | None]:
    """One block of ``kind``: (resid, pending, the MoE aux or None); a
    ``shared_attn`` block applies ``shared_params`` (``p`` is None
    there)."""
    if kind == "shared_attn":
        p = shared_params
    norm_kw = dict(norm=cfg.norm, mode=rt.mode)
    h1, resid = stacks.add_norm(pending, resid, p["norm1"]["scale"],
                                p["norm1"].get("bias"), **norm_kw)
    if kind == "mamba":
        return resid, mamba2.apply(p["mixer"], h1, cfg, _whole(rt)), None
    attn_cfg, attn_rt = _tp_attention(p["attn"], cfg, rt)
    attn_out = attention.apply(p["attn"], h1, attn_cfg, attn_rt)
    h2, resid = stacks.add_norm(attn_out, resid, p["norm2"]["scale"],
                                p["norm2"].get("bias"), **norm_kw)
    if "moe" in p:
        out, aux = moe.apply(p["moe"], h2, cfg, _whole(rt))
        return resid, out, aux
    return resid, dense.apply(p["mlp"], h2, cfg, _tp_mlp(p["mlp"], cfg,
                                                         rt)), None


def _whole(rt: RuntimeConfig) -> RuntimeConfig:
    """``rt`` for a layer that computes whole in every model rank."""
    return rt if rt.tp_axis is None else dataclasses.replace(rt,
                                                             tp_axis=None)


def _tp_attention(p: dict, cfg: ModelConfig, rt: RuntimeConfig
                  ) -> tuple[ModelConfig, RuntimeConfig]:
    """The config and runtime one attention layer runs under: inside a
    tensor-parallel region (``rt.tp_axis``) a layer whose ``wq`` holds a
    slice of the heads runs :func:`tp_local_config`'s head counts and
    keeps ``tp_axis``; a whole ``wq`` computes whole."""
    if rt.tp_axis is None:
        return cfg, rt
    m = cfg.n_heads * cfg.head_dim // p["wq"].shape[-1]
    if m == 1:
        return cfg, _whole(rt)
    local = tp_local_config(cfg, m)
    # a contiguous slice of wq's columns holds whole query-head groups, and
    # wk / wv's slice their KV heads
    if p["wk"].shape[-1] != local.n_kv_heads * local.head_dim \
            or p["wq"].shape[-1] != local.n_heads * local.head_dim:
        raise ValueError(f"{cfg.name}: tensor-parallel slices wq "
                         f"{tuple(p['wq'].shape)}, wk {tuple(p['wk'].shape)}"
                         f" do not hold {local.n_heads} query and "
                         f"{local.n_kv_heads} KV heads")
    return local, rt


def _tp_mlp(p: dict, cfg: ModelConfig, rt: RuntimeConfig) -> RuntimeConfig:
    """The runtime an MLP runs under: ``tp_axis`` kept where its ``wu``
    holds a slice of the ``d_ff`` columns."""
    if rt.tp_axis is None or p["wu"].shape[-1] == cfg.d_ff:
        return _whole(rt)
    return rt


#: The unbatched products ``remat="dots"`` keeps: what ``x @ w`` and
#: ``F.linear`` reach with a 2-D weight, at any number of leading dims.
#: Batched products (``bmm``: the plain attention's QK^T and PV, the MoE
#: expert products batched over experts) carry batch dims, as their
#: ``einsum``s do in the JAX package, and are recomputed.
DOTS_SAVED = frozenset({torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` as a
    selective-checkpoint policy.  The hand-written kernels are not
    dispatcher ops (a cpp extension or a Triton launch), so the policy
    never sees them and they are recomputed, as the JAX package recomputes
    its ``pallas_call``s.  On the CPU the wrappers run their plain
    versions, whose ops the policy treats as any other."""
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in DOTS_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return create_selective_checkpoint_contexts(_dots_policy)


def _remat(fn, rt: RuntimeConfig):
    """``fn`` as the backward should see it (``torch.utils.checkpoint``,
    non-reentrant): ``remat="full"`` recomputes it from its inputs instead
    of saving what it makes; ``remat="dots"`` keeps the outputs of its
    unbatched products (:data:`DOTS_SAVED`) and recomputes the rest, as
    ``jax.checkpoint`` with ``dots_with_no_batch_dims_saveable`` does.
    ``xla`` stacks under ``dots`` run compiled
    (:func:`repro_torch.kernels.fused_stack.ops.run_xla`)."""
    if rt.remat == "none":
        return fn
    kw = {"context_fn": _dots_context} if rt.remat == "dots" else {}

    def recomputed(*args):
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False, **kw)
    return recomputed


def embed_inputs(params: dict, batch: dict, cfg: ModelConfig
                 ) -> torch.Tensor:
    """The stream's input: ``frames @ frontend_proj`` (audio, in the
    promoted dtype of the two), or the token embeddings (scaled by
    ``sqrt(d_model)`` where tied) with the projected patches cast to their
    dtype in front (vision)."""
    if cfg.frontend == "audio_frames":
        return base.matmul(batch["frames"], params["frontend_proj"])
    x = params["embed"][batch["tokens"]]
    if cfg.tie_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    if cfg.frontend == "vision_patches":
        pre = base.matmul(batch["patches"], params["frontend_proj"])
        x = torch.cat([pre.to(x.dtype), x], dim=1)
    return x


def _final_norm(params: dict, h: torch.Tensor, cfg: ModelConfig,
                rt: RuntimeConfig) -> torch.Tensor:
    return stacks.apply_norm(h, params["final_norm"]["scale"],
                             params["final_norm"].get("bias"),
                             norm=cfg.norm, mode=rt.mode)


def _superblocks(params: dict, plan: LayerPlan) -> list[list]:
    """Per super-block, the parameters of each of its blocks (None where
    the block is the shared attention), each stacked leaf taken apart once
    (:func:`_unstack`); none for a hybrid cut below its period (no
    ``blocks``, only the tail), as the JAX package skips the scan."""
    if not plan.n_super:
        return []
    subs = {j: _unstack(params["blocks"][f"sub{j}"], plan.n_super)
            for j, kind in enumerate(plan.superblock)
            if kind != "shared_attn"}
    return [[subs[j][i] if j in subs else None
             for j in range(len(plan.superblock))]
            for i in range(plan.n_super)]


def _held(path: tuple, tree: Any) -> Any:
    return tree


def hidden(params: dict, batch: dict, cfg: ModelConfig, rt: RuntimeConfig,
           fetch: Callable[[tuple, Any], Any] = _held
           ) -> tuple[torch.Tensor, dict]:
    """Backbone only: returns (final-normed hidden states, aux).

    ``fetch(path, tree)`` turns the parameters of one layer, as
    ``params`` holds them under ``path`` (``("blocks", "sub<j>")`` and
    ``("tail", "sub0")`` one layer of the stack at a time,
    ``("shared_attn",)`` at each of its uses), into those the layer
    computes with, inside the layer's (rematerialised) body: the sharded
    step's gather of a rank's shards (``launch.steps``).  By default the
    parameters are used as held."""
    plan = layer_plan(cfg)
    x = embed_inputs(params, batch, cfg)
    resid, pending = x, torch.zeros_like(x)
    shared = params.get("shared_attn")
    zero = torch.zeros((), dtype=torch.float32, device=x.device)

    def superblock(blk, shared, resid, pending, aux_loss, drop):
        if shared is not None:
            shared = fetch(("shared_attn",), shared)
        blk = [None if p is None else fetch(("blocks", f"sub{j}"), p)
               for j, p in enumerate(blk)]
        for kind, p in zip(plan.superblock, blk):
            resid, pending, aux = _apply_sub(kind, p, resid, pending, cfg,
                                             rt, shared)
            if aux is not None:         # summed over the MoE layers
                aux_loss = aux_loss + aux["router_aux_loss"]
                drop = drop + aux["drop_fraction"]
        return resid, pending, aux_loss, drop

    def tail_layer(p, resid, pending):
        return _apply_sub("mamba", fetch(("tail", "sub0"), p), resid,
                          pending, cfg, rt)[:2]

    body = _remat(superblock, rt)
    aux_loss = drop = zero
    for blk in _superblocks(params, plan):
        resid, pending, aux_loss, drop = body(blk, shared, resid, pending,
                                              aux_loss, drop)
    if plan.tail:
        tail = _remat(tail_layer, rt)
        for p in _unstack(params["tail"]["sub0"], len(plan.tail)):
            resid, pending = tail(p, resid, pending)
    h = _final_norm(params, resid + pending, cfg, rt)
    return h, {"router_aux_loss": aux_loss, "drop_fraction": drop}


def forward(params: dict, batch: dict, cfg: ModelConfig, rt: RuntimeConfig
            ) -> tuple[torch.Tensor, dict]:
    """Returns (logits, aux)."""
    h, aux = hidden(params, batch, cfg, rt)
    return _logits(params, h, cfg), aux


def prefill(params: dict, batch: dict, cfg: ModelConfig, rt: RuntimeConfig
            ) -> torch.Tensor:
    """Inference prefill: the backbone over the full prompt, logits of the
    last position only."""
    h, _ = hidden(params, batch, cfg, rt)
    return _logits(params, h[:, -1:], cfg)


def _logits(params: dict, h: torch.Tensor, cfg: ModelConfig
            ) -> torch.Tensor:
    if cfg.tie_embeddings:
        return base.matmul(h, params["embed"].T)
    return base.matmul(h, params["out_head"])


def _nll_from_hidden(params: dict, h: torch.Tensor, labels: torch.Tensor,
                     cfg: ModelConfig, chunk: int) -> torch.Tensor:
    """Masked next-token NLL.  ``chunk > 0`` (dividing the sequence)
    computes the vocab projection and log-sum-exp in sequence chunks, each
    under ``torch.utils.checkpoint``, bounding the (B, S, V) float32 logits
    working set."""
    def chunk_nll(h_c, labels_c):
        lf = _logits(params, h_c, cfg).float()
        logz = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, torch.clamp_min(labels_c, 0).long()
                            [..., None])[..., 0]
        mask = (labels_c >= 0).float()
        return torch.sum((logz - gold) * mask), torch.sum(mask)

    s = h.shape[1]
    if chunk <= 0 or s <= chunk or s % chunk:
        total, count = chunk_nll(h, labels)
        return total / torch.clamp_min(count, 1.0)
    total = count = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, chunk):
        t, c = torch.utils.checkpoint.checkpoint(
            chunk_nll, h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
            use_reentrant=False)
        total, count = total + t, count + c
    return total / torch.clamp_min(count, 1.0)


def _global_mean(nll: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Inside a sharded region whose batch is split over ranks
    (:func:`repro_torch.distributed.collectives.region`): the shard's
    masked mean ``nll`` rescaled by its share of the global label count,
    so that the mean over the batch axes (the sharded step's reduction of
    losses and gradients) is the global masked mean, as the JAX package's
    GSPMD step computes it.  With equal counts the factor is exactly 1."""
    if not collectives.region_batch_axes():
        return nll
    count = torch.sum(labels >= 0).float()
    share = count * collectives.region_batch_shards() / torch.clamp_min(
        collectives.batch_sum(count), 1.0)
    return nll * share


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, rt: RuntimeConfig,
            fetch: Callable[[tuple, Any], Any] = _held
            ) -> tuple[torch.Tensor, dict]:
    """Next-token (or frame-label) cross entropy; labels < 0 are masked;
    a vision model's loss reads the text positions only.  Returns
    ``(loss, {"loss", "nll", "router_aux_loss", "drop_fraction"})``;
    ``fetch`` as :func:`hidden` takes it."""
    h, aux = hidden(params, batch, cfg, rt, fetch)
    labels = batch["labels"]
    if cfg.frontend == "vision_patches":
        h = h[:, -labels.shape[1]:]             # text positions only
    if rt.mode == "brainslug" and not cfg.tie_embeddings:
        # the fused CE kernel: the (T, V) logits never reach device memory
        nll = ce_ops.fused_nll(h.reshape(-1, h.shape[-1]), params["out_head"],
                               labels.reshape(-1))
    else:
        nll = _nll_from_hidden(params, h, labels, cfg, rt.fused_loss_chunk)
    nll = _global_mean(nll, labels)
    loss = nll + cfg.router_aux_weight * aux["router_aux_loss"]
    return loss, {"loss": loss, "nll": nll, **aux}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      dtype: torch.dtype = torch.bfloat16, *,
                      kv_layout: str = "dense", kv_num_blocks: int = 0,
                      kv_block_size: int = 16,
                      device: str | torch.device = "cuda") -> dict:
    """Decode cache for every layer, as the parameters lie:
    ``{"blocks": {"sub{j}": cache}}`` with a cache per block of the
    super-block (the shared attention's holds one cache per application),
    stacked over the super-blocks, and the hybrid's ``{"tail": {"sub0":
    cache}}`` stacked over the tail.

    Attention layers: ``kv_layout="dense"`` gives a
    :class:`~repro_torch.layers.attention.KVCache` with k/v ``(L, B, G,
    max_len, hd)``; ``kv_layout="paged"`` a
    :class:`~repro_torch.layers.attention.PagedKVCache` of ``kv_num_blocks``
    blocks of ``kv_block_size`` tokens, pools ``(L, N, G, bs, hd)``; one
    block id addresses the same pool row in every layer, so one host-side
    block table serves the whole model.  Mamba layers keep their dense
    per-slot :class:`~repro_torch.layers.mamba2.MambaCache` either way (conv
    ``(L, B, cw-1, di+2n)`` in ``dtype``, state ``(L, B, H, N, P)`` in
    float32): a recurrent state has no block structure to share."""
    plan = layer_plan(cfg)
    if kv_layout not in ("dense", "paged"):
        raise ValueError(f"unknown kv_layout {kv_layout!r}; "
                         f"allowed: 'dense' | 'paged'")
    if kv_layout == "paged" and kv_num_blocks < 1:
        raise ValueError("paged kv_layout requires kv_num_blocks >= 1")
    # "meta": shapes only, as the JAX package's eval_shape of this function
    dev = (torch.device("meta") if str(device) == "meta"
           else base.device(device))

    def sub_cache(kind: str, n: int):
        if kind == "mamba":
            return mamba2.init_cache(cfg, batch, dtype, n_layers=n, dev=dev)
        if kv_layout == "paged":
            return attention.init_paged_cache(cfg, batch, kv_num_blocks,
                                              kv_block_size, dtype,
                                              n_layers=n, dev=dev)
        return attention.init_cache(cfg, batch, max_len, dtype, n_layers=n,
                                    dev=dev)

    cache: dict[str, Any] = {}
    if plan.n_super:
        cache["blocks"] = {f"sub{j}": sub_cache(kind, plan.n_super)
                           for j, kind in enumerate(plan.superblock)}
    if plan.tail:
        cache["tail"] = {"sub0": sub_cache("mamba", len(plan.tail))}
    return cache


def _caches(cache: dict) -> list:
    """Every layer-stacked cache of a decode cache (each sub of
    ``blocks`` and ``tail``)."""
    return [c for group in cache.values() for c in group.values()]


def reset_slots(cache: dict, mask: torch.Tensor,
                lengths: torch.Tensor | None = None) -> dict:
    """Reset the decode state of the batch slots where ``mask`` is True, in
    place (the engine's slot-admission primitive); every leaf is
    layer-stacked, so batch is axis 1.

    Dense leaves (K/V contents and length, the mamba conv window and SSM
    state) are zeroed.  Paged KV state is block-mapped: the pool is shared,
    so a freed slot returns its blocks on the host and only its logical
    ``length`` is rewritten, to 0 or to ``lengths[b]`` when prefix sharing
    admits the slot mid-prompt (the shared blocks already hold its first
    ``lengths[b]`` positions)."""
    for c in _caches(cache):
        if isinstance(c, attention.PagedKVCache):
            new_len = (torch.zeros_like(c.length[0]) if lengths is None
                       else lengths.to(c.length.dtype))
            c.length.copy_(torch.where(mask[None, :], new_len[None, :],
                                       c.length))
            continue
        leaves = ((c.conv, c.state) if isinstance(c, mamba2.MambaCache)
                  else (c.k, c.v, c.length))
        for leaf in leaves:
            m = mask.reshape((1, -1) + (1,) * (leaf.dim() - 2))
            leaf.masked_fill_(m, 0)
    return cache


def copy_blocks(cache: dict, src: int, dst: int) -> dict:
    """Copy physical KV block ``src`` to ``dst`` in every layer's pool, in
    place (the copy-on-write fork: the engine allocates ``dst``, copies,
    and remaps the writing slot's table before the dispatch that would
    have written into the shared ``src``).  A dense KV cache and the mamba
    caches are untouched.  The copy is queued on the current stream, so
    the next dispatch, on the same stream, reads the forked block."""
    for c in _caches(cache):
        if isinstance(c, attention.PagedKVCache):
            c.k_pool[:, dst] = c.k_pool[:, src]
            c.v_pool[:, dst] = c.v_pool[:, src]
    return cache


def _layer_cache(c: Any, i: int) -> Any:
    """Layer ``i``'s view of a layer-stacked cache (writes go through)."""
    if isinstance(c, mamba2.MambaCache):
        return mamba2.MambaCache(conv=c.conv[i], state=c.state[i])
    if isinstance(c, attention.PagedKVCache):
        return attention.PagedKVCache(k_pool=c.k_pool[i], v_pool=c.v_pool[i],
                                      length=c.length[i])
    return attention.KVCache(k=c.k[i], v=c.v[i], length=c.length[i])


def tp_local_config(cfg: ModelConfig, model_extent: int) -> ModelConfig:
    """The config a tensor-parallel rank's attention runs against.

    Inside the region every rank holds ``n_heads / m`` query heads and
    ``n_kv_heads / m`` KV heads, and the attention projections reshape by
    ``cfg.n_heads``, so the body runs a localised config.  ``d_head`` is
    pinned to the global head size first: for configs that derive it as
    ``d_model // n_heads``, halving ``n_heads`` must not change the
    per-head width."""
    if model_extent <= 1:
        return cfg
    if cfg.n_heads % model_extent or cfg.n_kv_heads % model_extent:
        raise ValueError(
            f"{cfg.name}: heads ({cfg.n_heads}, kv {cfg.n_kv_heads}) not "
            f"divisible by model={model_extent}")
    return dataclasses.replace(
        cfg, d_head=cfg.head_dim,
        n_heads=cfg.n_heads // model_extent,
        n_kv_heads=cfg.n_kv_heads // model_extent)


#: The leaves tensor parallelism splits over "model", by subtree, as
#: (column leaves, row leaves): a column leaf splits its last dim, a row
#: leaf the dim before.  Attention's q/k/v projections (and their biases)
#: split their output columns per head group and wo its input rows, closed
#: by one all-reduce after the out-projection (see layers.attention); the
#: MLP's up / gate projections (and the plain MLP's bias ``bu``) split
#: their ``d_ff`` columns and ``wd`` its rows (``bd`` replicated, added
#: once after the reduction; see layers.dense).  The JAX package's
#: ``tp_param_specs`` splits attention only.
_TP_COL_LEAVES = frozenset({"wq", "wk", "wv", "bq", "bk", "bv"})
_TP_ROW_LEAVES = frozenset({"wo"})
TP_LEAVES = {"attn": (_TP_COL_LEAVES, _TP_ROW_LEAVES),
             "mlp": (frozenset({"wg", "wu", "bu"}), frozenset({"wd"}))}


def tp_kept(cfg: ModelConfig, pspecs: Any, model_extent: int) -> Any:
    """Per leaf of ``pspecs`` (repaired specs of the parameters): whether
    the sharded step keeps its ``"model"`` split for compute, the layer
    then running on its slice under ``RuntimeConfig.tp_axis``.  An
    ``attn`` subtree keeps it where :func:`tp_local_config` accepts the
    head counts and every :data:`TP_LEAVES` leaf's spec still splits its
    dim over ``"model"``; an ``mlp`` subtree (not an MoE's shared expert)
    where every such spec splits ``d_ff``.  Every other leaf is gathered
    whole, and its layer computes whole."""
    m = model_extent
    # with both head counts divisible, a contiguous column slice holds
    # g/m whole query-head groups and their KV heads (_tp_attention
    # checks the slices it is handed)
    heads_ok = (m > 1 and cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0)

    def split(name: str, spec: Any, kind: str) -> bool:
        cols, rows = TP_LEAVES[kind]
        dim = -1 if name in cols else (-2 if name in rows else None)
        return dim is not None and len(spec) >= -dim and spec[dim] == "model"

    def walk(node: Any) -> Any:
        if not isinstance(node, dict):
            return False
        out = {}
        for k, v in node.items():
            if k in TP_LEAVES and isinstance(v, dict):
                cols, rows = TP_LEAVES[k]
                want = [n for n in v if n in cols or n in rows]
                ok = (heads_ok if k == "attn" else m > 1) and all(
                    split(n, v[n], k) for n in want)
                out[k] = {n: ok and n in want for n in v}
            else:
                out[k] = walk(v)
        return out

    return walk(pspecs)


def tp_param_specs(params: Any, model_extent: int) -> Any:
    """PartitionSpec tree (congruent with ``params``) for attention-only
    tensor parallelism: projection leaves under an ``"attn"`` subtree
    shard over "model"; everything else (norms, MLP / MoE, mamba mixers,
    embeddings, the vocab head) replicates (the mamba gated norm reduces
    over the full d_inner, so its state must stay whole per shard)."""
    from repro_torch.core.partition import PartitionSpec as P

    def walk(node: Any, in_attn: bool, name: str) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, in_attn or k == "attn", k)
                    for k, v in node.items()}
        parts: list = [None] * len(node.shape)
        if in_attn and model_extent > 1:
            if name in _TP_COL_LEAVES:
                parts[-1] = "model"
            elif name in _TP_ROW_LEAVES:
                parts[-2] = "model"
        return P(*parts)

    return walk(params, False, "")


def tp_shard_params(params: dict, model_extent: int, index: int) -> dict:
    """Model rank ``index``'s slice of the whole ``params`` under
    :func:`tp_param_specs`: each leaf split over "model" narrowed to the
    rank's contiguous block of that dim (a copy), every other leaf the
    whole tensor itself (no copy)."""
    if not 0 <= index < model_extent:
        raise ValueError(f"model rank {index} outside 0..{model_extent - 1}")

    def walk(node: Any, spec: Any) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if "model" not in spec:
            return node
        dim = spec.index("model")
        size = node.shape[dim] // model_extent
        return node.narrow(dim, index * size, size).contiguous()

    return walk(params, tp_param_specs(params, model_extent))


def decode_step(params: dict, cache: dict, tokens_t: torch.Tensor,
                cfg: ModelConfig, rt: RuntimeConfig,
                active: torch.Tensor | None = None,
                block_tables: torch.Tensor | None = None,
                max_keys: int | None = None
                ) -> tuple[torch.Tensor, dict]:
    """One serving step: tokens_t (B, 1) -> (logits (B, 1, V), cache).

    ``active`` is an optional (B,) bool slot mask: inactive slots compute
    but their cache state (KV write and length, mamba conv window and SSM
    state) is frozen.  ``block_tables`` (B, MB) is required for (and only
    read by) a paged KV cache: one table addresses every layer's pool.
    ``max_keys``: a host bound on every slot's KV length after this step,
    where the caller knows one (the Server's step, the Engine's slots); it
    picks the dense decode kernel's plan and changes no result.  The cache
    is updated in place and returned."""
    plan = layer_plan(cfg)
    x = params["embed"][tokens_t]
    if cfg.tie_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    shared = params.get("shared_attn")
    kw = dict(active=active, block_tables=block_tables, max_keys=max_keys)
    resid, pending = x, torch.zeros_like(x)
    for i in range(plan.n_super):
        for j, kind in enumerate(plan.superblock):
            p = (None if kind == "shared_attn"
                 else _layer(params["blocks"][f"sub{j}"], i))
            resid, pending = _decode_sub(
                kind, p, _layer_cache(cache["blocks"][f"sub{j}"], i), resid,
                pending, cfg, rt, shared, **kw)
    for i in range(len(plan.tail)):
        resid, pending = _decode_sub(
            "mamba", _layer(params["tail"]["sub0"], i),
            _layer_cache(cache["tail"]["sub0"], i), resid, pending, cfg, rt,
            **kw)
    h = _final_norm(params, resid + pending, cfg, rt)
    return _logits(params, h, cfg), cache


def _decode_sub(kind: str, p: dict | None, layer_cache: Any,
                resid: torch.Tensor, pending: torch.Tensor,
                cfg: ModelConfig, rt: RuntimeConfig,
                shared_params: dict | None = None, *,
                active: torch.Tensor | None,
                block_tables: torch.Tensor | None,
                max_keys: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One block's decode step on its layer's cache (updated in place); a
    ``shared_attn`` block applies ``shared_params``."""
    if kind == "shared_attn":
        p = shared_params
    norm_kw = dict(norm=cfg.norm, mode=rt.mode)
    h1, resid = stacks.add_norm(pending, resid, p["norm1"]["scale"],
                                p["norm1"].get("bias"), **norm_kw)
    if kind == "mamba":
        out, _ = mamba2.decode(p["mixer"], h1, layer_cache, cfg, _whole(rt),
                               active=active)
        return resid, out
    attn_cfg, attn_rt = _tp_attention(p["attn"], cfg, rt)
    attn_out, _ = attention.decode(p["attn"], h1, layer_cache, attn_cfg,
                                   attn_rt, active=active,
                                   block_table=block_tables,
                                   max_keys=max_keys)
    h2, resid = stacks.add_norm(attn_out, resid, p["norm2"]["scale"],
                                p["norm2"].get("bias"), **norm_kw)
    if "moe" in p:
        # serving is dropless: dropping a live request's token to a
        # capacity limit is a training-only trade-off
        return resid, moe.apply(p["moe"], h2, cfg, _whole(rt), dropless=True,
                                with_aux=False)[0]
    return resid, dense.apply(p["mlp"], h2, cfg, _tp_mlp(p["mlp"], cfg, rt))


# ---------------------------------------------------------------------------
# Plain twins for the traced frontend (repro_torch.api.optimize): the LM
# analogue of models/cnn.py's vgg_fn, ordinary tensor code whose traced
# graph the kernel registry rewrites onto the dedicated kernels (softmax·V
# -> flash attention, rmsnorm·g -> fused rmsnorm, the GLU gate -> fused
# swiglu, the log_softmax / gather loss tail -> fused vocab-CE).
# ---------------------------------------------------------------------------

def transformer_block_params(d_model: int, n_heads: int, d_ff: int, *,
                             generator: torch.Generator | None = None,
                             dtype: torch.dtype = torch.float32,
                             device: torch.device | str = "cuda"
                             ) -> dict[str, torch.Tensor]:
    """Parameters of :func:`transformer_block_fn` (pre-norm attention and a
    SwiGLU MLP, rms scales near 1), drawn from ``generator`` (a seeded CPU
    one by default; a CUDA generator draws on its card) and moved to
    ``device`` in ``dtype``.  The dict is flat, so weights from numpy (the
    JAX package's ``transformer_block_params``) carry over with
    ``convert.params_from_numpy(np_params, device, like=..., dtype=...)``."""
    del n_heads                     # the layout is head-count agnostic
    g = generator if generator is not None \
        else torch.Generator().manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=g.device)

    def dk(i, o):
        return normal(i, o) / i ** 0.5

    params = {
        "norm1_g": 1.0 + 0.1 * normal(d_model),
        "wq": dk(d_model, d_model), "wk": dk(d_model, d_model),
        "wv": dk(d_model, d_model), "wo": dk(d_model, d_model),
        "norm2_g": 1.0 + 0.1 * normal(d_model),
        "w_gate": dk(d_model, d_ff), "w_up": dk(d_model, d_ff),
        "w_down": dk(d_ff, d_model),
    }
    return {k: v.to(device=device, dtype=dtype) for k, v in params.items()}


def transformer_block_fn(x: torch.Tensor, params: dict, *, n_heads: int = 4,
                         causal: bool = True,
                         eps: float = 1e-6) -> torch.Tensor:
    """Plain pre-norm transformer block, what a user would write; ``x`` is
    (B, S, D).  Multi-head attention with an additive causal mask, then a
    SwiGLU MLP; the twin of ``repro.models.lm.transformer_block_fn``."""
    b, s, d = x.shape
    dh = d // n_heads

    def rms(v, g):
        var = torch.mean(torch.square(v), dim=-1, keepdim=True)
        return v * torch.rsqrt(var + eps) * g

    def heads(t):                               # (B,S,D) -> (B,H,S,dh)
        return t.reshape(b, s, n_heads, dh).transpose(1, 2)

    h = rms(x, params["norm1_g"])
    q, k, v = (heads(h @ params[w]) for w in ("wq", "wk", "wv"))
    scores = (q @ k.transpose(-2, -1)) * (1.0 / dh ** 0.5)
    if causal:
        idx = torch.arange(s, device=x.device)
        mask = torch.where(idx[:, None] >= idx[None, :], 0.0, -1e30)
        scores = scores + mask.to(scores.dtype)
    probs = torch.softmax(scores, dim=-1)
    o = (probs @ v).transpose(1, 2).reshape(b, s, d)
    x = x + o @ params["wo"]
    h2 = rms(x, params["norm2_g"])
    y = F.silu(h2 @ params["w_gate"]) * (h2 @ params["w_up"])
    return x + y @ params["w_down"]


def ce_loss_fn(h: torch.Tensor, w: torch.Tensor,
               labels: torch.Tensor) -> torch.Tensor:
    """Plain masked-mean cross-entropy over (T, D) hidden states and a
    (D, V) head, labels < 0 masked; the twin of
    ``repro.models.lm.ce_loss_fn``.  The registry rewrites the logits ->
    log_softmax -> gather core onto the fused vocab-CE kernel; the mask
    and the mean stay ordinary traced ops."""
    logp = torch.log_softmax(h @ w, dim=-1)
    gold = torch.gather(logp, -1, torch.clamp_min(labels, 0)[:, None])[:, 0]
    mask = (labels >= 0).float()
    return torch.sum(-gold * mask) / torch.clamp_min(torch.sum(mask), 1.0)
