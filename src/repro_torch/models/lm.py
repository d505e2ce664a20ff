"""Language-model assembly, ported from ``repro/models/lm.py`` for the dense
family (attention + MLP blocks) and the SSM family (mamba2 blocks):
embedding, a stack of blocks over the layer-stacked parameters, fused
BrainSlug norm and activation chains, the final norm and the vocab head;
prefill, decode and the training loss.

* Parameters are the JAX package's nested tree, ``blocks/sub0/...`` leaves
  carrying a leading layer axis; ``jax.lax.scan`` over that axis becomes a
  loop over it.  A dense block is ``{norm1, attn, norm2, mlp}``, a mamba
  block ``{norm1, mixer}``.
* The residual stream uses a (resid, pending) carry so every residual add
  fuses with the next norm.
* Decode caches are stacked along the same layer axis and updated in place:
  a KV cache (dense or paged) per attention layer, a :class:`~repro_torch.
  layers.mamba2.MambaCache` (conv window and SSM state) per mamba layer.
* The training loss (:func:`loss_fn`) runs the fused vocab cross-entropy
  kernel in ``brainslug`` mode for an untied head (a tied head, as mamba2's,
  takes the plain loss in every mode, as the JAX package does);
  ``remat="full"`` recomputes each block in the backward
  (``torch.utils.checkpoint``), as ``jax.checkpoint`` does.

Plain twins for the traced frontend (:func:`repro_torch.api.optimize`):
:func:`transformer_block_fn` and :func:`ce_loss_fn`, ordinary tensor code
whose traced graph the kernel registry rewrites onto the dedicated kernels.

MoE, the hybrid family (zamba2: mamba blocks with a shared attention block)
and the audio / vision frontends raise and name the slice of the port that
brings them.  Entry points run on ``cuda`` unless the caller asks for the
CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig, RuntimeConfig
from repro_torch.kernels.vocab_ce import ops as ce_ops
from repro_torch.layers import attention, base, dense, mamba2, stacks

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


def _check_ported(cfg: ModelConfig) -> LayerPlan:
    """The plan of a config the port runs: dense or mamba blocks, token
    inputs."""
    plan = layer_plan(cfg)
    kinds = set(plan.superblock) | set(plan.tail)
    if "shared_attn" in kinds:
        raise NotImplementedError(
            f"{cfg.name}: the hybrid family (mamba blocks with a shared "
            f"attention block) comes with the hybrid slice of the port; its "
            f"attention head dim {cfg.head_dim} needs the flash and decode "
            f"kernels beyond their head dim of 128")
    if "attn_moe" in kinds:
        raise NotImplementedError(f"{cfg.name}: MoE layers come with the "
                                  f"MoE slice of the port")
    if cfg.frontend:
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend} frontend "
                                  f"comes with the multimodal slice of the "
                                  f"port")
    return plan


def _kind(plan: LayerPlan) -> str:
    """The one block kind of a ported plan (``attn_dense`` or ``mamba``)."""
    (kind,) = plan.superblock
    return kind


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init(seed: int, cfg: ModelConfig, *,
         device: str | torch.device = "cuda") -> dict:
    """Random parameters from ``seed`` with the JAX package's tree, shapes
    and scales (not its values: carry those over with
    :func:`repro_torch.convert.lm_params_from_numpy`)."""
    plan = _check_ported(cfg)
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
    tree["final_norm"] = dense.norm_init(cfg, None, dtype, dev)
    sub = {"norm1": dense.norm_init(cfg, L, dtype, dev)}
    if _kind(plan) == "mamba":
        sub["mixer"] = mamba2.init(g, cfg, L, dtype)
    else:
        sub["attn"] = attention.init(g, cfg, L, dtype)
        sub["norm2"] = dense.norm_init(cfg, L, dtype, dev)
        sub["mlp"] = dense.init(g, cfg, L, dtype)
    tree["blocks"] = {"sub0": sub}
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

def _apply_sub(kind: str, p: dict, resid: torch.Tensor,
               pending: torch.Tensor, cfg: ModelConfig, rt: RuntimeConfig
               ) -> tuple[torch.Tensor, torch.Tensor]:
    norm_kw = dict(norm=cfg.norm, mode=rt.mode)
    h1, resid = stacks.add_norm(pending, resid, p["norm1"]["scale"],
                                p["norm1"].get("bias"), **norm_kw)
    if kind == "mamba":
        return resid, mamba2.apply(p["mixer"], h1, cfg, rt)
    attn_out = attention.apply(p["attn"], h1, cfg, rt)
    h2, resid = stacks.add_norm(attn_out, resid, p["norm2"]["scale"],
                                p["norm2"].get("bias"), **norm_kw)
    return resid, dense.apply(p["mlp"], h2, cfg, rt)


def _remat(fn, rt: RuntimeConfig):
    """``fn`` as the backward should see it: ``remat="full"`` recomputes
    it from its inputs (``torch.utils.checkpoint``, non-reentrant) instead
    of saving what it makes."""
    if rt.remat == "full":
        def recomputed(*args):
            return torch.utils.checkpoint.checkpoint(fn, *args,
                                                     use_reentrant=False)
        return recomputed
    if rt.remat == "dots":
        raise NotImplementedError(
            "remat='dots' (keep only the matmul outputs) has no PyTorch "
            "counterpart yet; it comes with a later slice of the port "
            "(ROADMAP.md, queue 1)")
    return fn


def embed_inputs(params: dict, batch: dict, cfg: ModelConfig
                 ) -> torch.Tensor:
    _check_ported(cfg)
    x = params["embed"][batch["tokens"]]
    if cfg.tie_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def _final_norm(params: dict, h: torch.Tensor, cfg: ModelConfig,
                rt: RuntimeConfig) -> torch.Tensor:
    return stacks.apply_norm(h, params["final_norm"]["scale"],
                             params["final_norm"].get("bias"),
                             norm=cfg.norm, mode=rt.mode)


def hidden(params: dict, batch: dict, cfg: ModelConfig, rt: RuntimeConfig
           ) -> tuple[torch.Tensor, dict]:
    """Backbone only: returns (final-normed hidden states, aux)."""
    plan = _check_ported(cfg)
    x = embed_inputs(params, batch, cfg)
    resid, pending = x, torch.zeros_like(x)
    kind = _kind(plan)

    def block(p, resid, pending):
        return _apply_sub(kind, p, resid, pending, cfg, rt)

    body = _remat(block, rt)
    for p in _unstack(params["blocks"]["sub0"], plan.n_super):
        resid, pending = body(p, resid, pending)
    h = _final_norm(params, resid + pending, cfg, rt)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return h, {"router_aux_loss": zero, "drop_fraction": zero}


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
        return h @ params["embed"].T
    return h @ params["out_head"]


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


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, rt: RuntimeConfig
            ) -> tuple[torch.Tensor, dict]:
    """Next-token cross entropy; labels < 0 are masked.  Returns ``(loss,
    {"loss", "nll", "router_aux_loss", "drop_fraction"})``."""
    h, aux = hidden(params, batch, cfg, rt)
    labels = batch["labels"]
    if rt.mode == "brainslug" and not cfg.tie_embeddings:
        # the fused CE kernel: the (T, V) logits never reach device memory
        nll = ce_ops.fused_nll(h.reshape(-1, h.shape[-1]), params["out_head"],
                               labels.reshape(-1))
    else:
        nll = _nll_from_hidden(params, h, labels, cfg, rt.fused_loss_chunk)
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
    """Decode cache for every layer, stacked along the layer axis:
    ``{"blocks": {"sub0": cache}}``.

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
    plan = _check_ported(cfg)
    if kv_layout not in ("dense", "paged"):
        raise ValueError(f"unknown kv_layout {kv_layout!r}; "
                         f"allowed: 'dense' | 'paged'")
    if kv_layout == "paged" and kv_num_blocks < 1:
        raise ValueError("paged kv_layout requires kv_num_blocks >= 1")
    dev = base.device(device)
    if _kind(plan) == "mamba":
        sub = mamba2.init_cache(cfg, batch, dtype, n_layers=plan.n_super,
                                dev=dev)
    elif kv_layout == "paged":
        sub = attention.init_paged_cache(cfg, batch, kv_num_blocks,
                                         kv_block_size, dtype,
                                         n_layers=plan.n_super, dev=dev)
    else:
        sub = attention.init_cache(cfg, batch, max_len, dtype,
                                   n_layers=plan.n_super, dev=dev)
    return {"blocks": {"sub0": sub}}


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
    c = cache["blocks"]["sub0"]
    if isinstance(c, attention.PagedKVCache):
        new_len = (torch.zeros_like(c.length[0]) if lengths is None
                   else lengths.to(c.length.dtype))
        c.length.copy_(torch.where(mask[None, :], new_len[None, :],
                                   c.length))
        return cache
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
    c = cache["blocks"]["sub0"]
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


def decode_step(params: dict, cache: dict, tokens_t: torch.Tensor,
                cfg: ModelConfig, rt: RuntimeConfig,
                active: torch.Tensor | None = None,
                block_tables: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, dict]:
    """One serving step: tokens_t (B, 1) -> (logits (B, 1, V), cache).

    ``active`` is an optional (B,) bool slot mask: inactive slots compute
    but their cache state (KV write and length, mamba conv window and SSM
    state) is frozen.  ``block_tables`` (B, MB) is required for (and only
    read by) a paged KV cache: one table addresses every layer's pool.  The
    cache is updated in place and returned."""
    plan = _check_ported(cfg)
    kind = _kind(plan)
    x = params["embed"][tokens_t]
    if cfg.tie_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    norm_kw = dict(norm=cfg.norm, mode=rt.mode)
    c = cache["blocks"]["sub0"]
    blocks = params["blocks"]["sub0"]
    resid, pending = x, torch.zeros_like(x)
    for i in range(plan.n_super):
        p = _layer(blocks, i)
        layer_cache = _layer_cache(c, i)
        h1, resid = stacks.add_norm(pending, resid, p["norm1"]["scale"],
                                    p["norm1"].get("bias"), **norm_kw)
        if kind == "mamba":
            pending, _ = mamba2.decode(p["mixer"], h1, layer_cache, cfg, rt,
                                       active=active)
            continue
        attn_out, _ = attention.decode(p["attn"], h1, layer_cache, cfg, rt,
                                       active=active,
                                       block_table=block_tables)
        h2, resid = stacks.add_norm(attn_out, resid, p["norm2"]["scale"],
                                    p["norm2"].get("bias"), **norm_kw)
        pending = dense.apply(p["mlp"], h2, cfg, rt)
    h = _final_norm(params, resid + pending, cfg, rt)
    return _logits(params, h, cfg), cache


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
