"""GQA attention with RoPE: prefill (flash / chunked / full) and decode,
ported from ``repro/layers/attention.py``.

Schedules:

* ``brainslug`` — the depth-first flash kernel (scores never reach device
  memory), and the flash-decode kernel for decode;
* ``xla``       — an online softmax over 512-key chunks above
  ``FULL_SCORE_MAX_SEQ``, full scores below;
* ``barrier``   — full scores, every stage materialised.  PyTorch runs
  eagerly, so every stage of :func:`_full_attention` is materialised in
  either mode: ``barrier`` and short-sequence ``xla`` run the same kernels.

The score products cast their operands to float32 (the JAX package asks
for float32 accumulation of native-dtype operands; a PyTorch product of
bf16 tensors rounds its result to bf16).

Decode writes the new K/V into the cache **in place**, one position per
active slot (the JAX package's where-select over the whole cache gives the
same values, as a full copy per layer per step when run eagerly), and
returns the same cache object.  The paged cache (:class:`PagedKVCache`)
writes one ``(G, hd)`` row per active slot into a shared pool of blocks,
through the block table the serving engine threads into each dispatch.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, RuntimeConfig
from repro_torch.distributed import collectives
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention import ref as attn_ref
from repro_torch.layers import base

FULL_SCORE_MAX_SEQ = 2048          # above this, xla mode uses the chunked loop
NEG_INF = -1e30


def init(g: torch.Generator, cfg: ModelConfig, n_layers: int,
         dtype: torch.dtype) -> dict:
    """The attention parameters of ``n_layers`` layers, stacked on a
    leading layer axis, with the JAX package's scales."""
    d, h, kv, hd, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, n_layers)
    p = {
        "wq": base.normal(g, (L, d, h * hd), fan_in=d, dtype=dtype),
        "wk": base.normal(g, (L, d, kv * hd), fan_in=d, dtype=dtype),
        "wv": base.normal(g, (L, d, kv * hd), fan_in=d, dtype=dtype),
        "wo": base.normal(g, (L, h * hd, d), scale=1.0 / (h * hd) ** 0.5,
                          dtype=dtype),
    }
    if cfg.qkv_bias:
        zeros = dict(dtype=dtype, device=g.device)
        p["bq"] = torch.zeros((L, h * hd), **zeros)
        p["bk"] = torch.zeros((L, kv * hd), **zeros)
        p["bv"] = torch.zeros((L, kv * hd), **zeros)
    return p


def param_axes(cfg: ModelConfig) -> dict:
    """Logical axes of one layer's :func:`init` leaves (the JAX package's
    ``boxed`` annotations): the projections' ``d_model`` rows over
    ``fsdp``, their head columns over ``heads`` / ``kv_heads``."""
    p = {"wq": ("fsdp", "heads"), "wk": ("fsdp", "kv_heads"),
         "wv": ("fsdp", "kv_heads"), "wo": ("heads", "fsdp")}
    if cfg.qkv_bias:
        p.update(bq=("heads",), bk=("kv_heads",), bv=("kv_heads",))
    return p


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (B, H, S, D_h); positions: (B, S) or (S,)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[:, None, :, None].float() * freqs     # (B,1,S,half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Core attention math (xla / barrier paths)
# ---------------------------------------------------------------------------

def _full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool) -> torch.Tensor:
    """GQA without KV expansion: query heads grouped against their KV head
    in the product, no (H/G)-times repeated copy of K/V."""
    b, h, sq, hd = q.shape
    g, sk = k.shape[1], k.shape[2]
    scale = 1.0 / hd ** 0.5
    qg = q.reshape(b, g, h // g, sq, hd).float()
    s = torch.einsum("bgrqd,bgkd->bgrqk", qg, k.float()) * scale
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(diagonal=sk - sq)
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bgkd->bgrqd", p, v.float())
    return o.reshape(b, h, sq, hd).to(q.dtype)


def _chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, block_k: int = 512) -> torch.Tensor:
    """Online softmax over KV chunks at the tensor level: bounded memory
    for long sequences without a custom kernel (the xla-mode path).
    Statistics (m, l, acc) are float32; GQA is grouped, not repeated."""
    b, h, sq, hd = q.shape
    g, sk = k.shape[1], k.shape[2]
    scale = 1.0 / hd ** 0.5
    qg = q.reshape(b, g, h // g, sq, hd).float()
    q_idx = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, g, h // g, sq, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, g, h // g, sq, hd), device=q.device)
    for k0 in range(0, sk, block_k):
        kj, vj = k[:, :, k0:k0 + block_k], v[:, :, k0:k0 + block_k]
        s = torch.einsum("bgrqd,bgkd->bgrqk", qg, kj.float()) * scale
        if causal:
            k_idx = torch.arange(k0, k0 + kj.shape[2], device=q.device)
            s = torch.where(k_idx[None, :] <= q_idx + (sk - sq), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bgrqk,bgkd->bgrqd", p, vj.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(b, h, sq, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Layer entry points
# ---------------------------------------------------------------------------

def _project(params: dict, x: torch.Tensor, cfg: ModelConfig
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    h, g, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = base.matmul(x, params["wq"])
    k = base.matmul(x, params["wk"])
    v = base.matmul(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(b, s, h, hd).transpose(1, 2)
    k = k.reshape(b, s, g, hd).transpose(1, 2)
    v = v.reshape(b, s, g, hd).transpose(1, 2)
    return q, k, v


def apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
          rt: RuntimeConfig, *, positions: torch.Tensor | None = None
          ) -> torch.Tensor:
    """Full-sequence attention (prefill).  Under ``rt.tp_axis`` the
    parameters hold this rank's contiguous slice of the heads and ``cfg``
    its head counts (:func:`repro_torch.models.lm.tp_local_config`): the
    input enters through ``copy_to_model`` and the out-projection's
    partial sums leave through ``reduce_from_model``."""
    b, s, _ = x.shape
    causal = not cfg.is_encoder
    if rt.tp_axis is not None:
        x = collectives.copy_to_model(x, rt.tp_axis)
    q, k, v = _project(params, x, cfg)
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if rt.attn_impl == "skip_core":
        # cost-probe mode: the quadratic core is bypassed (o = q + 0*v so
        # every projection stays live)
        o = q + 0.0 * torch.mean(v) + 0.0 * torch.mean(k)
    elif rt.mode == "brainslug":
        o = attn_ops.flash_attention(q, k, v, causal, rt.attn_block_q,
                                     rt.attn_block_k)
    elif rt.mode == "barrier" or s <= FULL_SCORE_MAX_SEQ:
        o = _full_attention(q, k, v, causal)
    else:
        o = _chunked_attention(q, k, v, causal)

    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
    return _out_projection(o, params, rt)


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor          # (B, G, S_max, hd)
    v: torch.Tensor
    length: torch.Tensor     # (B,) int32

    #: The decode-cache sharding declaration that
    #: :func:`repro_torch.core.partition.plan_decode_cache` and
    #: :func:`repro_torch.distributed.sharding.cache_spec` read: per field,
    #: the *negative* dim that carries the batch-slot extent ("slot") and
    #: the one that carries the KV-head extent ("model").  Negative, so
    #: one declaration holds for a layer's node and for the engine's
    #: (L, ...)-stacked leaves.
    CACHE_AXES = {"k": {"slot": -4, "model": -3},
                  "v": {"slot": -4, "model": -3},
                  "length": {"slot": -1}}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, *, n_layers: int,
               dev: torch.device) -> KVCache:
    """Zeroed dense caches of ``n_layers`` layers, stacked on a leading
    layer axis: k/v ``(L, B, G, max_len, hd)``, length ``(L, B)``."""
    g, hd = cfg.n_kv_heads, cfg.head_dim
    shape = (n_layers, batch, g, max_len, hd)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=dev),
        v=torch.zeros(shape, dtype=dtype, device=dev),
        length=torch.zeros((n_layers, batch), dtype=torch.int32,
                           device=dev))


@dataclasses.dataclass
class PagedKVCache:
    """Block-mapped KV state: a fixed pool of ``block_size``-token physical
    blocks shared by every slot, addressed through a per-dispatch block
    table.  The table is not cache state: it changes only at host events
    (admission, on-demand append, copy-on-write fork), so the engine passes
    it into each dispatch.  Like :class:`KVCache`, the model's cache stacks
    the layers on a leading axis: pools ``(L, N, G, bs, hd)``, length
    ``(L, B)``; one layer's view drops it."""
    k_pool: torch.Tensor     # (N, G, block_size, hd) physical blocks
    v_pool: torch.Tensor
    length: torch.Tensor     # (B,) int32 logical positions per slot

    #: As :attr:`KVCache.CACHE_AXES`, but the pools have no slot dim:
    #: every slot writes into one shared pool.  ``pool: True`` tells the
    #: planner the leaf never shards over the batch axis (ranks that split
    #: the slots while each holds a whole pool would let the pools
    #: diverge after the first write).
    CACHE_AXES = {"k_pool": {"model": -3, "pool": True},
                  "v_pool": {"model": -3, "pool": True},
                  "length": {"slot": -1}}


def init_paged_cache(cfg: ModelConfig, batch: int, num_blocks: int,
                     block_size: int, dtype: torch.dtype = torch.bfloat16, *,
                     n_layers: int, dev: torch.device) -> PagedKVCache:
    """Zeroed pools of ``n_layers`` layers, stacked on a leading layer
    axis: ``(L, num_blocks, G, block_size, hd)``, length ``(L, B)``.  One
    block id addresses the same pool row in every layer, so one block
    table serves the whole model."""
    g, hd = cfg.n_kv_heads, cfg.head_dim
    shape = (n_layers, num_blocks, g, block_size, hd)
    return PagedKVCache(
        k_pool=torch.zeros(shape, dtype=dtype, device=dev),
        v_pool=torch.zeros(shape, dtype=dtype, device=dev),
        length=torch.zeros((n_layers, batch), dtype=torch.int32,
                           device=dev))


def _decode_paged(params: dict, x_t: torch.Tensor, cache: PagedKVCache,
                  cfg: ModelConfig, rt: RuntimeConfig, table: torch.Tensor,
                  active: torch.Tensor | None
                  ) -> tuple[torch.Tensor, PagedKVCache]:
    b = x_t.shape[0]
    h, hd = cfg.n_heads, cfg.head_dim
    n, _, bs, _ = cache.k_pool.shape
    mb = table.shape[1]
    q, k_new, v_new = _project(params, x_t, cfg)          # (B,*,1,hd)
    pos = cache.length.long()                              # (B,)
    q = rope(q, pos[:, None], cfg.rope_theta)
    k_new = rope(k_new, pos[:, None], cfg.rope_theta)

    # Write through the table, in place: position `pos` of an active slot
    # lands in physical block table[b, pos // bs] at offset pos % bs.  The
    # host maps (and copy-on-write forks) every block a dispatch writes
    # before it runs, so the target is private.  Inactive slots, and
    # targets outside the table or the pool, write nothing (the JAX
    # scatter's mode="drop"): every slot's row is rewritten with its old
    # contents unless an active slot writes that same row, so duplicate
    # indices all carry one value and no device-to-host read is needed.
    col = pos // bs
    phys = table.long().gather(1, col.clamp(max=mb - 1)[:, None])[:, 0]
    write = (col < mb) & (phys >= 0) & (phys < n)
    if active is not None:
        write = write & active
    phys = phys.clamp(0, n - 1)
    off = pos % bs
    addr = phys * bs + off
    same = (addr[:, None] == addr[None, :]) & write[None, :]   # (B, B)
    src = same.int().argmax(dim=1)              # the slot writing b's row
    hit = same.any(dim=1)[:, None, None]
    for pool, new in ((cache.k_pool, k_new), (cache.v_pool, v_new)):
        old = pool[phys, :, off]                             # (B, G, hd)
        pool[phys, :, off] = torch.where(
            hit, new[:, :, 0].to(pool.dtype)[src], old)
    adv = (torch.ones_like(cache.length) if active is None
           else active.to(cache.length.dtype))
    cache.length.add_(adv)
    lengths = cache.length
    if rt.mode == "brainslug":
        # the pool is read where it lies, float32 or not: no cast copy
        o = attn_ops.paged_flash_decode(q, cache.k_pool, cache.v_pool, table,
                                        lengths)
    else:
        attn_ops.STATS.record("paged_decode_ref")
        # the JAX layer's pool.astype(q.dtype), taken on the gathered view
        o = attn_ref.attention_ref(
            q, attn_ref.gather_paged(cache.k_pool, table).to(q.dtype),
            attn_ref.gather_paged(cache.v_pool, table).to(q.dtype),
            causal=False, lengths=lengths)
    o = o.transpose(1, 2).reshape(b, 1, h * hd)
    return _out_projection(o, params, rt), cache


def _out_projection(o: torch.Tensor, params: dict, rt: RuntimeConfig
                    ) -> torch.Tensor:
    """``o @ wo``; under ``rt.tp_axis`` the heads are split over the
    model ranks, each rank's product is a partial sum over its rows of
    ``wo``, and the sum over the ranks is the output."""
    out = base.matmul(o, params["wo"])
    if rt.tp_axis is not None:
        out = collectives.reduce_from_model(out, rt.tp_axis)
    return out


def decode(params: dict, x_t: torch.Tensor,
           cache: KVCache | PagedKVCache, cfg: ModelConfig,
           rt: RuntimeConfig, *, active: torch.Tensor | None = None,
           block_table: torch.Tensor | None = None,
           max_keys: int | None = None
           ) -> tuple[torch.Tensor, KVCache | PagedKVCache]:
    """One decode step on one layer's cache.  x_t: (B, 1, D).

    ``active`` is an optional (B,) bool slot mask: inactive slots neither
    write their K/V nor advance their length.  A :class:`PagedKVCache`
    takes the block-mapped path and requires ``block_table`` (B, MB).
    ``max_keys``: a host bound on every slot's length after this step,
    where the caller knows one; it picks the dense kernel's plan, never
    the result.  Under ``rt.tp_axis`` (the mesh engine's head split) the
    parameters and the cache hold this rank's heads and the
    out-projection's partial sums are all-reduced.  ``cache`` is updated
    in place and returned."""
    if isinstance(cache, PagedKVCache):
        if block_table is None:
            raise ValueError(
                "paged KV cache requires a block_table operand (the "
                "engine threads it through lm.decode_step)")
        return _decode_paged(params, x_t, cache, cfg, rt, block_table,
                             active)
    if not isinstance(cache, KVCache):
        raise TypeError(f"decode takes a KVCache or a PagedKVCache, got "
                        f"{type(cache).__name__}")
    b = x_t.shape[0]
    h, hd = cfg.n_heads, cfg.head_dim
    s_max = cache.k.shape[2]
    q, k_new, v_new = _project(params, x_t, cfg)          # (B,*,1,hd)
    pos = cache.length.long()                              # (B,)
    q = rope(q, pos[:, None], cfg.rope_theta)
    k_new = rope(k_new, pos[:, None], cfg.rope_theta)

    # In-place write at position `length` of every active slot whose
    # position is inside the cache (the where-select's rule); the others
    # write back what they read.
    write = pos < s_max
    if active is not None:
        write = write & active
    slot = torch.arange(b, device=x_t.device)
    at = pos.clamp(max=s_max - 1)
    w = write[:, None, None]
    for buf, new in ((cache.k, k_new), (cache.v, v_new)):
        old = buf[slot, :, at]                                # (B, G, hd)
        buf[slot, :, at] = torch.where(w, new[:, :, 0].to(buf.dtype), old)
    adv = (torch.ones_like(cache.length) if active is None
           else active.to(cache.length.dtype))
    cache.length.add_(adv)
    lengths = cache.length
    if rt.mode == "brainslug":
        o = attn_ops.flash_decode(q, cache.k, cache.v, lengths,
                                  block_k=rt.decode_block_k,
                                  max_keys=max_keys)
    else:
        attn_ops.STATS.record("decode_ref")
        o = attn_ref.decode_ref(q, cache.k.to(q.dtype), cache.v.to(q.dtype),
                                lengths)
    o = o.transpose(1, 2).reshape(b, 1, h * hd)
    return _out_projection(o, params, rt), cache
