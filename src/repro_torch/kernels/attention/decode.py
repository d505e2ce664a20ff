"""Flash decode (one new query position against a dense KV cache, or
against a block-mapped pool through a block table): the CUDA kernels and
their plain versions.

``flash_decode`` replaces ``repro/kernels/attention/decode.py:flash_decode``
(the Pallas kernel) and ``paged_flash_decode`` replaces
``repro/kernels/attention/decode.py:paged_flash_decode``.  Their kernels,
``csrc/flash_decode.cu`` and ``csrc/paged_flash_decode.cu``, run one chain
walk, ``csrc/decode_chain.cuh``: :data:`CHAINS` chains of 16 lanes a slot
and head, each walking every 16th valid key with its own float32 online
softmax, split over the CTAs of :func:`launch_plan` (the CTAs of a slot
and head one thread block cluster), key rows staged into shared memory by
``cp.async``, and merged in chain order by the cluster's first CTA through
distributed shared memory; so the two agree bit for bit on a gathered
view.  They differ in where a row lies: the dense cache's rows are
contiguous, the paged kernel's come through the slot's table row, clamped
to ``[0, N-1]``.

The plain versions are the Pallas kernels' algorithms on whole tensors:
:func:`flash_decode_plain` walks ``block_k`` cache tiles,
:func:`paged_flash_decode_plain` tiles of one pool block each; float32
running state, keys at positions ``>= lengths[b]`` masked with the finite
``NEG_INF``, and exact zeros for a slot with ``lengths == 0``.

Both read K and V in whatever float dtype the cache holds and round each
element to the query's dtype first (the layer's ``cache.astype(q.dtype)``):
the kernels do it in registers, so a float32 cache is never copied.
"""
from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path
from typing import Callable

import torch

from repro_torch.kernels import _build

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = _CSRC / "flash_decode.cu"
PAGED_SOURCE = _CSRC / "paged_flash_decode.cu"
#: The chain walk both kernels include.
CHAIN_SOURCE = _CSRC / "decode_chain.cuh"
NEG_INF = -1e30
#: Head dims both CUDA kernels are built for (granite-moe-3b's 64,
#: zamba2-7b's 112, 128 and paligemma-3b's 256): a lane holds 8 elements up
#: to 128 and lanes past ``D / 8`` of the 16 hold zeros; at 256 a lane
#: holds 16.
HEAD_DIMS = (64, 112, 128, 256)
DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}
#: Online-softmax chains of one (slot, head): ``CHAINS`` in
#: ``csrc/decode_chain.cuh``.
CHAINS = 16
#: CTAs one (slot, head) may be split over.
SPLITS = (1, 2, 4, 8, 16)
#: Keys a chain walks at the longest length the cache or table holds, at or
#: below which one CTA takes all the chains: the call is launch-bound, and a
#: split would add an exchange between CTAs.
SPLIT_MIN_KEYS = 64


def supports_head_dim(d: int) -> bool:
    """Whether the decode kernels have an instance of head dim ``d``."""
    return d in HEAD_DIMS


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       lengths: torch.Tensor, *, scale: float | None = None,
                       block_k: int = 512) -> torch.Tensor:
    """q: (B, H, 1, D); k, v: (B, G, S, D); lengths: (B,) int."""
    b, h, one, d = q.shape
    g, s = k.shape[1], k.shape[2]
    rep = h // g
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    block_k = min(block_k, s)
    qg = q.reshape(b, g, rep, one, d).float()
    lens = lengths.to(device=q.device, dtype=torch.int64)
    m = torch.full((b, g, rep, one, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, g, rep, one, d), device=q.device)
    for k0 in range(0, s, block_k):
        kb = k[:, :, k0:k0 + block_k].to(q.dtype).float()
        vb = v[:, :, k0:k0 + block_k].to(q.dtype).float()
        sc = torch.einsum("bgrqd,bgkd->bgrqk", qg, kb) * scale
        k_idx = torch.arange(k0, k0 + kb.shape[2], device=q.device)
        sc = torch.where(k_idx < lens[:, None, None, None, None], sc,
                         NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bgrqk,bgkd->bgrqd", p, vb)
        m = m_new
    # m never left its NEG_INF seed <=> every key was masked (length 0)
    acc = torch.where(m > NEG_INF * 0.5, acc, 0.0)
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(b, h, one, d).to(q.dtype)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, *, scale: float | None = None,
                 block_k: int = 512, splits: int | None = None,
                 max_keys: int | None = None) -> torch.Tensor:
    """q: (B, H, 1, D); k, v: (B, G, S, D); lengths: (B,) int.

    ``block_k`` is the plain version's tile (the Pallas kernel's); the CUDA
    kernel walks keys in its own order.  Lengths are clamped to [0, S].
    The cache is read where it lies: on the card it must be contiguous and
    16-byte aligned (a layer's view of a layer-stacked cache is), and it is
    never copied or cast.  ``splits``: CTAs a (slot, head), by default
    :func:`launch_plan`'s at ``max_keys = min(S, max_keys)``.
    ``max_keys``: a bound the caller knows on the host for every slot's
    length (a lock-step decode knows its step), so that short slots in a
    long cache run unsplit; it picks the plan and nothing else, since every
    split gives the same bits."""
    b, h, one, d = q.shape
    if one != 1 or k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != d or tuple(lengths.shape) != (b,):
        raise ValueError(f"flash decode: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    g, s = k.shape[1], k.shape[2]
    if h % g:
        raise ValueError(f"q heads {h} not a multiple of kv heads {g}")
    if splits is not None and splits not in SPLITS:
        raise ValueError(f"flash decode: splits {splits} not in {SPLITS}")
    if max_keys is not None and max_keys < 0:
        raise ValueError(f"flash decode: max_keys {max_keys} < 0")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, lengths, scale=scale,
                                  block_k=block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash decode takes cpu or cuda tensors, got "
                         f"{q.device}")
    check_kernel_operands("flash decode", q, k, v, lengths)
    q = q.contiguous()
    lens = lengths.to(torch.int32).contiguous()
    o = torch.empty_like(q)
    lib = _library()
    ids = DTYPE_IDS[q.dtype], DTYPE_IDS[k.dtype]
    with torch.cuda.device(q.device):
        if splits is None:
            splits = dense_plan(q, k, max_keys).splits
        err = lib.flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
            o.data_ptr(), b, h, g, s, d, float(scale), *ids, splits,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed: "
                           f"{lib.flash_decode_error(err).decode()}")
    flash_decode.launches += 1
    return o


flash_decode.launches = 0


def check_kernel_operands(what: str, q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *index: torch.Tensor) -> None:
    """What both decode kernels take, beyond the shapes: q float32 or bf16,
    K and V of q's dtype or float32, one device, a head dim of
    :data:`HEAD_DIMS`, and K and V contiguous and 16-byte aligned (rows are
    staged by 16-byte copies; a copy of a cache per call is what the
    kernels avoid)."""
    if q.dtype not in DTYPE_IDS or v.dtype != k.dtype or k.dtype not in (
            q.dtype, torch.float32):
        raise TypeError(f"{what}: q must be float32 or bfloat16 and k/v "
                        f"q's dtype or float32, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    dev = q.device
    if k.device != dev or v.device != dev or any(t.device != dev
                                                 for t in index):
        raise ValueError(f"{what}: q, k, v and their index tensors on "
                         f"different devices")
    if not supports_head_dim(q.shape[-1]):
        raise ValueError(f"{what}: head dim {q.shape[-1]} not in "
                         f"{HEAD_DIMS}")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{what}: the cache must be contiguous (a copy of "
                         f"it per call is what this kernel avoids)")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{what}: the cache must be 16-byte aligned (rows "
                         f"are staged by 16-byte copies)")


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """How a decode kernel runs one call shape: the chains of a (slot,
    head) split over ``splits`` CTAs of ``chains`` chains (16 lanes each);
    ``ctas`` in all."""
    splits: int
    chains: int
    threads: int
    ctas: int


def launch_plan(batch: int, heads: int, max_keys: int, block_size: int,
                sm_count: int, ctas_per_sm: Callable[[int], int]
                ) -> DecodePlan:
    """The split of one call shape, from the batch, the query heads, the
    longest length the cache holds (``S``) or the table maps (``MB * bs``),
    the block size (the dense cache is one block of ``S`` rows) and the
    card (``ctas_per_sm(splits)``: CTAs of that kernel's instance an SM
    holds, from the occupancy API).  Never from the lengths: they live on
    the device, and reading them would put a sync into every decode step
    and engine tick.

    One CTA a (slot, head) where a chain walks at most
    :data:`SPLIT_MIN_KEYS` keys.  Else the least split of :data:`SPLITS`
    at which one slot's CTAs reach every SM (the ragged worst case: one long
    slot among short ones), halved while the grid would not fit the card at
    once (every slot long).  ``block_size`` enters through ``ctas_per_sm``
    (the paged kernel stages the table row in shared memory)."""
    if min(batch, heads, max_keys, block_size, sm_count) < 1:
        raise ValueError(f"flash decode plan: batch {batch}, heads "
                         f"{heads}, keys {max_keys}, block {block_size}, "
                         f"SMs {sm_count}")
    splits = 1
    if -(-max_keys // CHAINS) > SPLIT_MIN_KEYS:
        splits = next((s for s in SPLITS if heads * s >= sm_count),
                      SPLITS[-1])
        while (splits > 1
               and batch * heads * splits > sm_count * ctas_per_sm(splits)):
            splits //= 2
    chains = CHAINS // splits
    return DecodePlan(splits, chains, chains * 16, batch * heads * splits)


def paged_flash_decode_plain(q: torch.Tensor, k_pool: torch.Tensor,
                             v_pool: torch.Tensor, table: torch.Tensor,
                             lengths: torch.Tensor, *,
                             scale: float | None = None) -> torch.Tensor:
    """q: (B, H, 1, D); k_pool, v_pool: (N, G, bs, D); table: (B, MB) int;
    lengths: (B,) int.

    The Pallas kernel's algorithm on whole tensors: tile ``j`` is pool
    block ``table[:, j]`` (clipped to ``[0, N-1]``), masked at logical
    position ``j*bs + lane``, float32 running state, exact zeros for a slot
    whose ``m`` never left its seed.  Tiles past every slot's length add
    exactly nothing (``exp(-1e30 - m) = 0``), so the walk stops after the
    last one a slot needs."""
    b, h, one, d = q.shape
    n, g, bs, _ = k_pool.shape
    rep = h // g
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    tbl = table.to(device=q.device, dtype=torch.int64).clamp(0, n - 1)
    lens = lengths.to(device=q.device, dtype=torch.int64)
    n_tiles = min(tbl.shape[1], -(-int(lens.max()) // bs)) if b else 0
    qg = q.reshape(b, g, rep, one, d).float()
    m = torch.full((b, g, rep, one, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, g, rep, one, d), device=q.device)
    lane = torch.arange(bs, device=q.device)
    for j in range(n_tiles):
        kb = k_pool[tbl[:, j]].to(q.dtype).float()          # (B, G, bs, D)
        vb = v_pool[tbl[:, j]].to(q.dtype).float()
        sc = torch.einsum("bgrqd,bgkd->bgrqk", qg, kb) * scale
        sc = torch.where(j * bs + lane < lens[:, None, None, None, None], sc,
                         NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bgrqk,bgkd->bgrqd", p, vb)
        m = m_new
    acc = torch.where(m > NEG_INF * 0.5, acc, 0.0)
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(b, h, one, d).to(q.dtype)


def paged_flash_decode(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, table: torch.Tensor,
                       lengths: torch.Tensor, *, scale: float | None = None,
                       splits: int | None = None) -> torch.Tensor:
    """q: (B, H, 1, D); k_pool, v_pool: (N, G, bs, D); table: (B, MB) int;
    lengths: (B,) int.

    Table entries are clamped to ``[0, N-1]`` (a sentinel tail entry reads
    nothing out of bounds); keys at logical positions ``>= lengths[b]`` are
    masked.  The pools are read where they lie: on the card they must be
    contiguous and 16-byte aligned (a layer's view of a layer-stacked pool
    is), and they are never copied or cast.  ``splits``: CTAs a (slot,
    head), by default :func:`launch_plan`'s; every split gives the same
    bits."""
    b, h, one, d = q.shape
    if one != 1 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape \
            or k_pool.shape[3] != d or table.dim() != 2 \
            or table.shape[0] != b or tuple(lengths.shape) != (b,):
        raise ValueError(f"paged flash decode: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}, "
                         f"table {tuple(table.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    n, g, bs, _ = k_pool.shape
    mb = table.shape[1]
    if h % g:
        raise ValueError(f"q heads {h} not a multiple of kv heads {g}")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if q.device.type == "cpu":
        return paged_flash_decode_plain(q, k_pool, v_pool, table, lengths,
                                        scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged flash decode takes cpu or cuda tensors, got "
                         f"{q.device}")
    check_kernel_operands("paged flash decode", q, k_pool, v_pool, table,
                          lengths)
    if splits is not None and splits not in SPLITS:
        raise ValueError(f"paged flash decode: splits {splits} not in "
                         f"{SPLITS}")
    q = q.contiguous()
    tbl = table.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    o = torch.empty_like(q)
    lib = _library(PAGED_SOURCE)
    ids = DTYPE_IDS[q.dtype], DTYPE_IDS[k_pool.dtype]
    with torch.cuda.device(q.device):
        if splits is None:
            splits = paged_plan(q, k_pool, table).splits
        err = lib.paged_flash_decode(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tbl.data_ptr(), lens.data_ptr(), o.data_ptr(), b, h, n, g, bs,
            mb, d, float(scale), *ids, splits,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_flash_decode launch failed: "
                           f"{lib.paged_flash_decode_error(err).decode()}")
    paged_flash_decode.launches += 1
    return o


paged_flash_decode.launches = 0

#: Plans by (source, device index, batch, heads, keys, block size, head
#: dim, q dtype, cache dtype).
_PLANS: dict[tuple, DecodePlan] = {}


def plan_keys(s: int, max_keys: int | None = None) -> int:
    """The ``max_keys`` :func:`dense_plan` gives :func:`launch_plan` for a
    cache of ``s`` keys and the caller's bound: ``min(s, max_keys)``, moved
    to the one value of its side of :data:`SPLIT_MIN_KEYS` (the plan reads
    it only against that threshold), so a bound that grows each step keeps
    at most two plans a shape."""
    keys = s if max_keys is None else max(min(s, max_keys), 1)
    if -(-keys // CHAINS) > SPLIT_MIN_KEYS:
        return s
    return min(s, CHAINS * SPLIT_MIN_KEYS)


def dense_plan(q: torch.Tensor, k: torch.Tensor,
               max_keys: int | None = None) -> DecodePlan:
    """The plan :func:`flash_decode` launches with on the card at these
    operands' shapes and dtypes: :func:`launch_plan` at
    :func:`plan_keys`'s ``max_keys``, with the dense instance's
    occupancy."""
    b, h, _, d = q.shape
    s = k.shape[2]
    key = (SOURCE, q.device.index, b, h, plan_keys(s, max_keys), s, d,
           q.dtype, k.dtype)
    hit = _PLANS.get(key)               # the hit is on every decode launch
    if hit is None:
        ids = DTYPE_IDS[q.dtype], DTYPE_IDS[k.dtype]
        lib = _library()
        hit = _plan(key, q.device,
                    lambda n: lib.flash_decode_ctas_per_sm(n, *ids, d),
                    lib.flash_decode_error)
    return hit


def paged_plan(q: torch.Tensor, k_pool: torch.Tensor,
               table: torch.Tensor) -> DecodePlan:
    """The plan :func:`paged_flash_decode` launches with on the card at
    these operands' shapes and dtypes: :func:`launch_plan` at ``max_keys =
    MB * bs``, with the paged instance's occupancy at this table width."""
    b, h, _, d = q.shape
    bs, mb = k_pool.shape[2], table.shape[1]
    key = (PAGED_SOURCE, q.device.index, b, h, mb * bs, bs, d, q.dtype,
           k_pool.dtype)
    hit = _PLANS.get(key)
    if hit is None:
        ids = DTYPE_IDS[q.dtype], DTYPE_IDS[k_pool.dtype]
        lib = _library(PAGED_SOURCE)
        hit = _plan(key, q.device,
                    lambda n: lib.paged_flash_decode_ctas_per_sm(
                        n, *ids, mb, d),
                    lib.paged_flash_decode_error)
    return hit


def _plan(key: tuple, device: torch.device,
          occupancy: Callable[[int], int],
          error: Callable[[int], bytes]) -> DecodePlan:
    """Make and keep the plan of ``key`` (source, device index, batch,
    heads, keys, block size, ...)."""
    source = key[0]

    def ctas_per_sm(splits: int) -> int:
        got = occupancy(splits)
        if got <= 0:
            raise RuntimeError(
                f"{source.stem}: no CTA of split {splits} fits an SM "
                f"({error(-got).decode()})")
        return got
    b, h, keys, bs = key[2:6]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = _PLANS[key] = launch_plan(b, h, keys, bs, sms, ctas_per_sm)
    return plan


#: The C entry point of each source's library and its ctypes argtypes.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ENTRY = {
    SOURCE: ("flash_decode", [_P] * 5 + [_I] * 5 + [_F, _I, _I, _I, _P]),
    PAGED_SOURCE: ("paged_flash_decode",
                   [_P] * 6 + [_I] * 7 + [_F, _I, _I, _I, _P]),
}


def _library(source: Path = SOURCE) -> ctypes.CDLL:
    """The built library of ``source`` with its entry point and the
    matching ``<entry>_error`` bound."""
    lib = _build.load_library(source)
    if not getattr(lib, "_bound", False):
        name, argtypes = _ENTRY[source]
        fn, err = getattr(lib, name), getattr(lib, f"{name}_error")
        fn.argtypes, fn.restype = argtypes, _I
        err.argtypes, err.restype = [_I], ctypes.c_char_p
        occ = getattr(lib, f"{name}_ctas_per_sm")
        occ.argtypes = [_I] * (5 if source == PAGED_SOURCE else 4)
        occ.restype = _I
        lib._bound = True
    return lib
