"""Flash decode (one new query position against a dense KV cache, or
against a block-mapped pool through a block table): the CUDA kernels and
their plain versions.

Replaces ``repro/kernels/attention/decode.py:flash_decode`` (the Pallas
kernel).  The kernel is ``csrc/flash_decode.cu`` (one CTA per slot and
query head, 16 partial online-softmax states merged at the end; its note
gives the bound and the design).  The plain version,
:func:`flash_decode_plain`, is the Pallas kernel's algorithm on whole
tensors: ``block_k`` cache tiles, float32 running state, keys at positions
``>= lengths[b]`` masked with the finite ``NEG_INF``, and exact zeros for a
slot with ``lengths == 0``.

Both read K and V in whatever float dtype the cache holds and round each
element to the query's dtype first (the layer's ``cache.astype(q.dtype)``):
the kernel does it in registers, so a float32 cache is never copied.

``paged_flash_decode`` replaces
``repro/kernels/attention/decode.py:paged_flash_decode``.  Its kernel is
``csrc/paged_flash_decode.cu``: the dense kernel's arithmetic, chain for
chain (:data:`CHAINS` chains of 16 lanes a slot and head, merged in chain
order), with the chains split over the CTAs of :func:`launch_plan` and key
rows staged into shared memory through the slot's table row, clamped to
``[0, N-1]``.  Its plain version, :func:`paged_flash_decode_plain`, walks
tiles of one pool block each, as the Pallas grid does.
"""
from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path
from typing import Callable

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_decode.cu"
PAGED_SOURCE = (Path(__file__).resolve().parent / "csrc"
                / "paged_flash_decode.cu")
NEG_INF = -1e30
#: Head dims both CUDA kernels are built for (zamba2-7b's 112 and 128): a
#: lane holds 8 elements, and lanes past ``D / 8`` of the 16 hold zeros.
HEAD_DIMS = (112, 128)
DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}
#: Online-softmax chains of one (slot, head): ``CHAINS`` in
#: ``csrc/paged_flash_decode.cu``, ``GROUPS`` in ``csrc/flash_decode.cu``.
CHAINS = 16
#: CTAs one (slot, head) may be split over.
SPLITS = (1, 2, 4, 8, 16)
#: Keys a chain walks at the longest length the table maps, at or below
#: which one CTA takes all the chains: the call is launch-bound, and a split
#: would add the workspace's round trip.
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
                 block_k: int = 512) -> torch.Tensor:
    """q: (B, H, 1, D); k, v: (B, G, S, D); lengths: (B,) int.

    ``block_k`` is the plain version's tile (the Pallas kernel's); the CUDA
    kernel walks keys in its own order.  Lengths are clamped to [0, S]."""
    b, h, one, d = q.shape
    if one != 1 or k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != d or tuple(lengths.shape) != (b,):
        raise ValueError(f"flash decode: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    g, s = k.shape[1], k.shape[2]
    if h % g:
        raise ValueError(f"q heads {h} not a multiple of kv heads {g}")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, lengths, scale=scale,
                                  block_k=block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash decode takes cpu or cuda tensors, got "
                         f"{q.device}")
    if q.dtype not in DTYPE_IDS or v.dtype != k.dtype or k.dtype not in (
            q.dtype, torch.float32):
        raise TypeError(f"flash decode: q must be float32 or bfloat16 and "
                        f"k/v q's dtype or float32, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if any(t.device != q.device for t in (k, v, lengths)):
        raise ValueError("flash decode: q, k, v, lengths on different "
                         "devices")
    if not supports_head_dim(d):
        raise ValueError(f"flash decode: head dim {d} not in {HEAD_DIMS}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lens = lengths.to(torch.int32).contiguous()
    o = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
            o.data_ptr(), b, h, g, s, d, float(scale), DTYPE_IDS[q.dtype],
            DTYPE_IDS[k.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed: "
                           f"{lib.flash_decode_error(err).decode()}")
    flash_decode.launches += 1
    return o


flash_decode.launches = 0


@dataclasses.dataclass(frozen=True)
class PagedPlan:
    """How ``csrc/paged_flash_decode.cu`` runs one call shape: the chains
    of a (slot, head) split over ``splits`` CTAs of ``chains`` chains (16
    lanes each); ``ctas`` in all."""
    splits: int
    chains: int
    threads: int
    ctas: int


def launch_plan(batch: int, heads: int, max_keys: int, block_size: int,
                sm_count: int, ctas_per_sm: Callable[[int], int]
                ) -> PagedPlan:
    """The split of one call shape, from the batch, the query heads, the
    longest length the table maps (``MB * bs``), the block size and the
    card (``ctas_per_sm(splits)``: CTAs of that instance an SM holds, from
    the occupancy API, at this table width).  Never from the lengths: they
    live on the device, and reading them would put a sync into every
    engine tick.

    One CTA a (slot, head) where a chain walks at most
    :data:`SPLIT_MIN_KEYS` keys.  Else the least split of :data:`SPLITS`
    at which one slot's CTAs reach every SM (the ragged worst case: one long
    slot among short ones), halved while the grid would not fit the card at
    once (every slot long).  ``block_size`` enters through ``ctas_per_sm``
    (the table row is staged in shared memory)."""
    if min(batch, heads, max_keys, block_size, sm_count) < 1:
        raise ValueError(f"paged flash decode plan: batch {batch}, heads "
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
    return PagedPlan(splits, chains, chains * 16, batch * heads * splits)


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
    if q.dtype not in DTYPE_IDS or v_pool.dtype != k_pool.dtype \
            or k_pool.dtype not in (q.dtype, torch.float32):
        raise TypeError(f"paged flash decode: q must be float32 or bfloat16 "
                        f"and the pools q's dtype or float32, got {q.dtype}, "
                        f"{k_pool.dtype}, {v_pool.dtype}")
    if any(t.device != q.device for t in (k_pool, v_pool, table, lengths)):
        raise ValueError("paged flash decode: q, pools, table, lengths on "
                         "different devices")
    if not supports_head_dim(d):
        raise ValueError(f"paged flash decode: head dim {d} not in "
                         f"{HEAD_DIMS}")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("paged flash decode: the pools must be contiguous "
                         "(a copy of a pool per call is what this kernel "
                         "avoids)")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged flash decode: the pools must be 16-byte "
                         "aligned (rows are staged by 16-byte copies)")
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
            splits = _plan(lib, q.device, b, h, mb, bs, d, ids).splits
        stream = torch.cuda.current_stream(q.device)
        ws = tickets = None
        if splits > 1:
            ws = torch.empty(b * h * CHAINS * (d + 2), device=q.device,
                             dtype=torch.float32)
            tickets = _tickets(q.device, stream, b * h)
        err = lib.paged_flash_decode(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tbl.data_ptr(), lens.data_ptr(), o.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            tickets.data_ptr() if tickets is not None else None, b, h, n, g,
            bs, mb, d, float(scale), *ids, splits, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_flash_decode launch failed: "
                           f"{lib.paged_flash_decode_error(err).decode()}")
    paged_flash_decode.launches += 1
    return o


paged_flash_decode.launches = 0

#: Plans by (device, batch, heads, table width, block size, head dim,
#: dtypes).
_PLANS: dict[tuple, PagedPlan] = {}
#: Ticket counters by (device, stream): zero between calls (the last CTA of
#: each (slot, head) resets its own), grown as calls widen.
_TICKETS: dict[tuple, torch.Tensor] = {}


def _plan(lib: ctypes.CDLL, device: torch.device, b: int, h: int, mb: int,
          bs: int, d: int, ids: tuple[int, int]) -> PagedPlan:
    key = (device.index, b, h, mb, bs, d, ids)
    hit = _PLANS.get(key)
    if hit is None:
        def ctas_per_sm(splits: int) -> int:
            got = lib.paged_flash_decode_ctas_per_sm(splits, *ids, mb, d)
            if got <= 0:
                raise RuntimeError(
                    f"paged_flash_decode: no CTA of split {splits} fits an SM "
                    f"({lib.paged_flash_decode_error(-got).decode()})")
            return got
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        hit = _PLANS[key] = launch_plan(b, h, mb * bs, bs, sms, ctas_per_sm)
    return hit


def _tickets(device: torch.device, stream: torch.cuda.Stream,
             n: int) -> torch.Tensor:
    key = (device.index, stream.cuda_stream)
    have = _TICKETS.get(key)
    if have is None or have.numel() < n:
        have = _TICKETS[key] = torch.zeros(n, device=device,
                                           dtype=torch.int32)
    return have


#: The C entry point of each source's library and its ctypes argtypes.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ENTRY = {
    SOURCE: ("flash_decode", [_P] * 5 + [_I] * 5 + [_F, _I, _I, _P]),
    PAGED_SOURCE: ("paged_flash_decode",
                   [_P] * 8 + [_I] * 7 + [_F, _I, _I, _I, _P]),
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
        if source == PAGED_SOURCE:
            occ = lib.paged_flash_decode_ctas_per_sm
            occ.argtypes, occ.restype = [_I] * 5, _I
        lib._bound = True
    return lib
