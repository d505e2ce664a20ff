"""The port's paged KV layout against the JAX package's, on the CPU.

* ``paged_flash_decode``'s plain version (what a CPU tensor runs) against
  the Pallas kernel in interpret mode and against ``paged_decode_ref``:
  ragged lengths, a length-0 slot (exact zeros), GQA at qwen2.5-14b's 40/8
  heads, a shuffled table with sentinel tail entries, q in bf16 over a
  float32 pool; 1e-5 in float32, 1e-2 in bf16;
* a transliteration of ``csrc/paged_flash_decode.cu``'s walk (the
  ``launch_plan``'s CTAs, each CTA's chains with their block and row
  cursors and ring of staged keys, and the merge in chain order, whichever
  CTA merges) against the same, and bit for bit
  against the dense kernel's walk on the gathered view at 1, 2, 4 and 16
  CTAs a (slot, head);
* ``launch_plan``: every (slot, head, chain) once, no lengths read, the
  chain count the dense kernel's;
* head dims 112 (zamba2-7b's), 64 (granite-moe-3b's) and 256
  (paligemma-3b's): the plain version and the walk against the Pallas
  kernel, paged bit for bit with dense on the gathered view, and the lane
  layout both kernels share (8 elements a lane up to D 128, lanes past ``D
  / 8`` zero; 16 a lane at D 256) covering every element of a row once;
* the layer's in-place paged write, ``lm.reset_slots`` and
  ``lm.copy_blocks`` against the JAX package's;
* ``BlockAllocator``/``PrefixCache`` under one random op sequence in both
  packages, and the ``kv.*`` invariants on ``test_paged_kv.py``'s seeded
  mutants.

The kernel itself runs only on the card (``chip_smoke.py`` phase 14)."""
from __future__ import annotations

import dataclasses
import inspect
import itertools
import re

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import RuntimeConfig as JRuntime
from repro.core import verify as jverify
from repro.kernels.attention import ops as jattn_ops
from repro.kernels.attention import ref as jattn_ref
from repro.launch import engine as jengine
from repro.layers import attention as jattn
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.configs.base import RuntimeConfig as TRuntime
from repro_torch.core import verify as tverify
from repro_torch.kernels.attention import decode as tdecode
from repro_torch.kernels.attention import ops as tattn_ops
from repro_torch.kernels.attention import ref as tattn_ref
from repro_torch.launch import engine as tengine
from repro_torch.layers import attention as tattn
from repro_torch.models import lm as tlm

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=1e-2, atol=1e-2)}
NP_DTYPE = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
T_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _t(a, dtype="float32"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(T_DTYPE[dtype])


def _close(got, want, dtype, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), err_msg=what,
                               **TOL[dtype])


# ---------------------------------------------------------------------------
# the decode kernel
# ---------------------------------------------------------------------------

#: name: (B, H, G, lengths, q dtype, pool dtype)
PAGED_CASES = {
    "ragged_f32": (4, 8, 2, [9, 4, 1, 23], "float32", "float32"),
    "length0_f32": (3, 4, 4, [0, 7, 0], "float32", "float32"),
    "gqa_40_8_f32": (2, 40, 8, [19, 24], "float32", "float32"),
    "ragged_bf16": (4, 8, 2, [9, 0, 1, 23], "bfloat16", "bfloat16"),
    "bf16_q_f32_pool": (4, 40, 8, [24, 0, 5, 13], "bfloat16", "float32"),
}
N_BLOCKS, BS, MB, D = 40, 4, 6, 32


def _paged_case(name, d=D):
    """Seeded operands: a table that is a shuffle of the pool, with the
    sentinel id N past each slot's mapped blocks."""
    b, h, g, lengths, qdt, pdt = PAGED_CASES[name]
    rng = np.random.default_rng(sorted(PAGED_CASES).index(name) + 30 + d)
    q = rng.standard_normal((b, h, 1, d), np.float32).astype(NP_DTYPE[qdt])
    kp = rng.standard_normal((N_BLOCKS, g, BS, d), np.float32).astype(
        NP_DTYPE[pdt])
    vp = rng.standard_normal((N_BLOCKS, g, BS, d), np.float32).astype(
        NP_DTYPE[pdt])
    table = rng.permutation(N_BLOCKS)[:b * MB].reshape(b, MB).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    used = -(-lens // BS)
    table = np.where(np.arange(MB)[None] < used[:, None], table,
                     N_BLOCKS).astype(np.int32)
    return q, kp, vp, table, lens, qdt


def _jax_paged(q, kp, vp, table, lens, qdt):
    """The JAX layer's call: the pool cast to q's dtype, then the Pallas
    kernel in interpret mode (it clips the sentinel ids itself)."""
    jq = jnp.asarray(q)
    jk = jnp.asarray(kp).astype(jq.dtype)
    jv = jnp.asarray(vp).astype(jq.dtype)
    return np.asarray(jattn_ops.paged_flash_decode(
        jq, jk, jv, jnp.asarray(table), jnp.asarray(lens),
        interpret=True)).astype(np.float32)


def _cu_const(path, name):
    return int(re.search(rf"constexpr int {name} = (\d+)",
                         path.read_text()).group(1))


#: The chains of a (slot, head): ``CHAINS`` of ``csrc/decode_chain.cuh``,
#: the walk both decode kernels run.
GROUPS = _cu_const(tdecode.CHAIN_SOURCE, "CHAINS")
#: A card of (SMs, CTAs an SM at every split) for the plan in these tests.
CARD = (3, lambda splits: 2)
#: Lanes a key row and elements a lane up to D 128, in both kernels.
LANES = _cu_const(tdecode.CHAIN_SOURCE, "LANES")
E = _cu_const(tdecode.CHAIN_SOURCE, "E")


def _elems(d):
    """``lane_elems<D>()`` of ``decode_chain.cuh``: elements a lane holds
    at head dim ``d``, ``E`` up to ``LANES * E``, else ``2 E``."""
    return E if d <= LANES * E else 2 * E


def _lanes(x):
    """(..., D) as (..., LANES, e), e = :func:`_elems`: lane ``i`` holds
    elements ``e*i .. e*i + e - 1``; lanes at or past ``D / e`` hold zeros
    (they read nothing)."""
    d = x.shape[-1]
    e = _elems(d)
    assert d % e == 0 and d <= LANES * e
    pad = torch.zeros(x.shape[:-1] + (LANES * e - d,), dtype=x.dtype)
    return torch.cat([x, pad], -1).view(x.shape[:-1] + (LANES, e))


def _chain_step(q, k, v, m, l, acc, act, scale):
    """One key of every chain at once (``CHAINS`` wide, whatever subset
    advances): the kernels' dot product, each lane's elements in order
    (exact zeros in a lane past ``D``), then the xor-shuffle tree 8, 4, 2,
    1 over the 16 lanes; then the online-softmax update.  Elementwise over
    the chains, so a chain's bits do not depend on which others
    advance."""
    lanes, e = LANES, _elems(q.shape[-1])
    qv, kv = _lanes(q), _lanes(k)
    dot = torch.zeros(k.shape[0], lanes)
    for i in range(e):
        dot = qv[:, i] * kv[:, :, i] + dot
    for x in (8, 4, 2, 1):
        dot = dot + dot[:, torch.arange(lanes) ^ x]
    sc = dot[:, 0] * scale
    m_new = torch.where(act, torch.maximum(m, sc), m)
    corr = torch.exp(m - m_new)
    p = torch.exp(sc - m_new)
    l = torch.where(act, l * corr + p, l)
    acc = torch.where(act[:, None], acc * corr[:, None] + p[:, None] * v, acc)
    return m_new, l, acc


def _merge(m, l, acc):
    """The CHAINS states merged in chain order (``decode_chain.cuh``'s fmaf
    sequence, as a multiply and an add)."""
    mx = m.max()
    w = torch.exp(m - mx)
    den, num = torch.zeros(()), torch.zeros(acc.shape[-1])
    for c in range(m.shape[0]):
        den = l[c] * w[c] + den
        num = acc[c] * w[c] + num
    o = num / torch.clamp(den, min=1e-30)
    return o if mx > 0.5 * tdecode.NEG_INF else torch.zeros_like(o)


def _seed(d):
    return (torch.full((GROUPS,), tdecode.NEG_INF), torch.zeros(GROUPS),
            torch.zeros(GROUPS, d))


def _ring_keys(pool_dtype, chains):
    """``ring_keys<TKV, CPS>()`` and ``step_keys<TKV, CPS>()`` of
    ``decode_chain.cuh``: keys a chain stages, and keys it takes a step
    (the same at every head dim: counted at ``E`` elements a lane)."""
    lane_bytes = (4 if pool_dtype == torch.float32 else 2) * 8
    r = (_cu_const(tdecode.CHAIN_SOURCE, "RING_BYTES")
         // (chains * 16 * 2 * lane_bytes))
    ring = min(max(r, 2), 16)
    return ring, min(ring // 2, 4)


def _paged_cta(q, kq, vq, tbl, g, n, bs, chains, c0, scale, ring):
    """One CTA of ``csrc/paged_flash_decode.cu``: chains ``c0 ..
    c0 + chains - 1`` walk keys ``c, c + CHAINS, ...`` below ``n``.  Each
    chain's cursor (block ``pj``, row ``pr``) starts at ``c // bs, c % bs``
    and steps by ``(CHAINS // bs, CHAINS % bs)`` with one wrap, the table
    entry read (clamped) at each new block.  ``ring`` = (RING, U): RING - U
    keys are staged ahead; a step stages U more into the slots the last
    step's keys left, then takes keys ``i0 .. i0 + U - 1`` from slots ``i %
    RING``, in order.  Returns the chains' (m, l, acc), seeds elsewhere."""
    ring_keys, step = ring
    d = q.shape[-1]
    own = torch.zeros(GROUPS, dtype=torch.bool)
    own[c0:c0 + chains] = True
    cs = torch.arange(GROUPS)
    n_keys = torch.where(own & (cs < n), (n - cs + GROUPS - 1) // GROUPS, 0)
    pj, pr = cs // bs, cs % bs
    dj, dr = GROUPS // bs, GROUPS % bs
    slots = [dict() for _ in range(GROUPS)]    # slot -> (block, row, key)
    staged = torch.zeros(GROUPS, dtype=torch.long)

    def stage():
        nonlocal pj, pr
        for c in range(GROUPS):
            i = int(staged[c])
            if i < n_keys[c]:
                blk = int(tbl[int(pj[c])].clamp(0, kq.shape[0] - 1))
                slots[c][i % ring_keys] = (blk, int(pr[c]), c + GROUPS * i)
        step_ = staged < n_keys
        pr = torch.where(step_, pr + dr, pr)
        pj = torch.where(step_, pj + dj, pj)
        wrap = step_ & (pr >= bs)
        pr = torch.where(wrap, pr - bs, pr)
        pj = torch.where(wrap, pj + 1, pj)
        staged.add_(1)

    for _ in range(ring_keys - step):
        stage()
    m, l, acc = _seed(d)
    for i in range(int(n_keys.max())):
        if i % step == 0:
            for _ in range(step):
                stage()
        act = i < n_keys
        k = torch.zeros(GROUPS, d)
        v = torch.zeros(GROUPS, d)
        for c in torch.nonzero(act).flatten().tolist():
            blk, row, key = slots[c][i % ring_keys]
            assert key == c + GROUPS * i        # the slot holds key i
            assert (blk, row) == (int(tbl[key // bs].clamp(
                0, kq.shape[0] - 1)), key % bs)
            k[c], v[c] = kq[blk, g, row], vq[blk, g, row]
        m, l, acc = _chain_step(q, k, v, m, l, acc, act, scale)
    return m, l, acc


def _paged_cuda(q, k_pool, v_pool, table, lengths, scale, splits=None,
                arrival=0):
    """``csrc/paged_flash_decode.cu`` over :func:`tdecode.launch_plan`'s
    grid (or ``splits`` CTAs a (slot, head)): per (slot, head) the length
    clamped to ``[0, MB*bs]`` (zeros at 0); CTA ``j`` holds chains
    ``j*chains ..``, holds keys iff ``j*chains < len``; with one CTA
    holding keys it merges in place, else one CTA merges (on the card the
    cluster's first; here the ``arrival``-th of a rotation of the CTAs
    holding keys, to show the bits do not depend on which), reading the
    other CTAs' chains below ``len`` and seeds above.  K/V rounded to q's
    dtype first."""
    b, h, _, d = q.shape
    n_blk, g, bs, _ = k_pool.shape
    mb = table.shape[1]
    if splits is None:
        splits = tdecode.launch_plan(b, h, mb * bs, bs, *CARD).splits
    chains = GROUPS // splits
    ring = _ring_keys(k_pool.dtype, chains)
    kq, vq = k_pool.to(q.dtype).float(), v_pool.to(q.dtype).float()
    out = torch.full(q.shape, float("nan"))
    for bi in range(b):
        n = min(max(int(lengths[bi]), 0), mb * bs)
        for hi in range(h):
            if n == 0:
                out[bi, hi, 0] = 0.0            # split 0 writes zeros
                continue
            gi = hi // (h // g)
            qv = q[bi, hi, 0].float()
            active = min(splits, -(-n // chains))
            ws = _seed(d)
            states = {}
            for j in range(active):             # CTAs that hold keys
                c0 = j * chains
                states[j] = _paged_cta(qv, kq, vq, table[bi], gi, n, bs,
                                       chains, c0, scale, ring)
                if active > 1:                  # publish the chains' states
                    for t, s in zip(ws, states[j]):
                        t[c0:c0 + chains] = s[c0:c0 + chains]
            last = arrival % active             # the CTA that merges
            c0 = last * chains
            # its own chains from shared memory, the others' from the
            # CTAs where they hold keys (c < len), seeds past len
            m, l, acc = (t.clone() for t in (ws if active > 1
                                              else _seed(d)))
            for t, o in zip((m, l, acc), states[last]):
                t[c0:c0 + chains] = o[c0:c0 + chains]
            for t, o in zip((m, l, acc), _seed(d)):
                t[n:] = o[n:]
            out[bi, hi, 0] = _merge(m, l, acc)
    return out.to(q.dtype)


def _dense_cuda(q, k, v, lengths, scale):
    """The dense kernel's walk before its chains were split over CTAs: one
    CTA of all GROUPS chains a (slot, head), keys ``c, c + GROUPS, ...``
    read in place, merged in chain order."""
    b, h, _, d = q.shape
    g, s = k.shape[1], k.shape[2]
    kq, vq = k.to(q.dtype).float(), v.to(q.dtype).float()
    out = torch.full(q.shape, float("nan"))
    for bi in range(b):
        n = min(max(int(lengths[bi]), 0), s)
        for hi in range(h):
            gi = hi // (h // g)
            m, l, acc = _seed(d)
            for t0 in range(0, n, GROUPS):
                t = t0 + torch.arange(GROUPS)
                act = t < n
                tc = t.clamp(max=max(n - 1, 0))
                m, l, acc = _chain_step(q[bi, hi, 0].float(), kq[bi, gi, tc],
                                        vq[bi, gi, tc], m, l, acc, act,
                                        scale)
            out[bi, hi, 0] = _merge(m, l, acc)
    return out.to(q.dtype)


@pytest.mark.parametrize("name", sorted(PAGED_CASES))
def test_paged_plain_matches_jax_kernel_and_oracle(name):
    q, kp, vp, table, lens, qdt = _paged_case(name)
    want = _jax_paged(q, kp, vp, table, lens, qdt)
    tq, tk, tv = _t(q, qdt), _t(kp, PAGED_CASES[name][5]), _t(
        vp, PAGED_CASES[name][5])
    before = tattn_ops.STATS.snapshot()
    got = tattn_ops.paged_flash_decode(tq, tk, tv, torch.from_numpy(table),
                                       torch.from_numpy(lens))
    delta = tattn_ops.STATS.delta(before)
    assert delta["paged_decode_plain"] == 1 and delta[
        "paged_decode_kernel"] == 0
    assert got.dtype == T_DTYPE[qdt] and bool(torch.isfinite(got).all())
    _close(got.float(), want, qdt, "plain vs Pallas kernel")
    for i in np.flatnonzero(lens == 0):
        assert bool((got[i] == 0).all()), "length 0 is not exactly zero"
    # both oracles on the clipped table (the sentinel is out of the pool)
    clipped = np.clip(table, 0, N_BLOCKS - 1)
    jref = np.asarray(jattn_ref.paged_decode_ref(
        jnp.asarray(q), jnp.asarray(kp).astype(jnp.asarray(q).dtype),
        jnp.asarray(vp).astype(jnp.asarray(q).dtype), jnp.asarray(clipped),
        jnp.asarray(lens))).astype(np.float32)
    tref = tattn_ref.paged_decode_ref(
        tq, tk.to(tq.dtype), tv.to(tq.dtype), torch.from_numpy(clipped),
        torch.from_numpy(lens))
    _close(tref.float(), jref, qdt, "port oracle vs JAX oracle")
    _close(got.float(), jref, qdt, "plain vs oracle")


@pytest.mark.parametrize("name", sorted(PAGED_CASES))
def test_paged_cuda_transliteration_matches_jax_kernel(name):
    q, kp, vp, table, lens, qdt = _paged_case(name)
    want = _jax_paged(q, kp, vp, table, lens, qdt)
    pdt = PAGED_CASES[name][5]
    got = _paged_cuda(_t(q, qdt), _t(kp, pdt), _t(vp, pdt),
                      torch.from_numpy(table), torch.from_numpy(lens),
                      1.0 / D ** 0.5)
    assert bool(torch.isfinite(got).all())
    _close(got.float(), want, qdt, "CUDA transliteration vs Pallas kernel")
    for i in np.flatnonzero(lens == 0):
        assert bool((got[i] == 0).all())


@pytest.mark.parametrize("splits", [1, 2, 4, 16])
@pytest.mark.parametrize("name", ["ragged_f32", "bf16_q_f32_pool"])
def test_paged_equals_dense_on_the_gathered_view(name, splits):
    """Paged decode on a pool equals dense decode on the gathered view:
    the plain versions within float32 rounding (their tiles differ), the
    two kernels' walks bit for bit (one key order, one chain arithmetic,
    one merge order) at every split, whichever CTA merges."""
    q, kp, vp, table, lens, qdt = _paged_case(name)
    pdt = PAGED_CASES[name][5]
    tq, tk, tv = _t(q, qdt), _t(kp, pdt), _t(vp, pdt)
    tbl, tl_ = torch.from_numpy(table), torch.from_numpy(lens)
    kd = tattn_ref.gather_paged(tk, tbl.clamp(0, N_BLOCKS - 1))
    vd = tattn_ref.gather_paged(tv, tbl.clamp(0, N_BLOCKS - 1))
    _close(tdecode.paged_flash_decode_plain(tq, tk, tv, tbl, tl_).float(),
           tdecode.flash_decode_plain(tq, kd, vd, tl_).float(), qdt,
           "plain versions")
    scale = 1.0 / D ** 0.5
    dense = _dense_cuda(tq, kd, vd, tl_, scale)
    for arrival in range(2):
        assert torch.equal(_paged_cuda(tq, tk, tv, tbl, tl_, scale, splits,
                                       arrival), dense)


@pytest.mark.parametrize("sm", [1, 8, 132])
def test_paged_launch_plan_covers_every_chain_once(sm):
    """Over a grid of batches, heads, table widths and block sizes on a
    card of ``sm`` SMs: the grid (splits, H, B) of CTAs of ``chains``
    chains, chain ``split * chains + grp`` for thread group ``grp``, holds
    every (slot, head, chain) exactly once; short tables take one CTA a
    (slot, head)."""
    for b, h, mb, bs in itertools.product((1, 3, 8), (4, 32, 40),
                                          (1, 16, 2048), (1, 8, 16, 32)):
        plan = tdecode.launch_plan(b, h, mb * bs, bs, sm,
                                   lambda s: 1 + s % 5)
        assert plan.splits in tdecode.SPLITS
        assert plan.chains * plan.splits == GROUPS
        assert plan.threads == 16 * plan.chains
        assert plan.ctas == b * h * plan.splits
        seen = np.zeros((b, h, GROUPS), np.int64)
        for split, hi, bi in itertools.product(range(plan.splits), range(h),
                                               range(b)):
            for grp in range(plan.threads // 16):
                seen[bi, hi, split * plan.chains + grp] += 1
        assert (seen == 1).all()
        if -(-mb * bs // GROUPS) <= tdecode.SPLIT_MIN_KEYS:
            assert plan.splits == 1


def test_paged_plan_reads_no_lengths_and_keeps_the_chains():
    """The plan is a function of shapes and the card alone (the lengths
    live on the device); the paged kernel's CHAINS is the dense kernel's
    GROUPS, so the two walk the same keys per chain; the plan spreads a
    lone long slot over every SM, keeps a batch of long slots within what
    the card holds at once, and one CTA a (slot, head) for short tables."""
    assert list(inspect.signature(tdecode.launch_plan).parameters) == [
        "batch", "heads", "max_keys", "block_size", "sm_count",
        "ctas_per_sm"]
    assert tdecode.CHAINS == GROUPS == _cu_const(tdecode.CHAIN_SOURCE,
                                                 "CHAINS")
    occupancy = {1: 4, 2: 5, 4: 5, 8: 9, 16: 13}.get
    assert tdecode.launch_plan(1, 32, 32768, 16, 132, occupancy).splits == 8
    assert tdecode.launch_plan(8, 32, 32768, 16, 132, occupancy).splits == 2
    assert tdecode.launch_plan(4, 32, 256, 16, 132, occupancy).splits == 1


def test_gather_paged_matches_jax():
    q, kp, vp, table, lens, _ = _paged_case("ragged_f32")
    clipped = np.clip(table, 0, N_BLOCKS - 1)
    np.testing.assert_array_equal(
        tattn_ref.gather_paged(torch.from_numpy(kp),
                               torch.from_numpy(clipped)).numpy(),
        np.asarray(jattn_ref.gather_paged(jnp.asarray(kp),
                                          jnp.asarray(clipped))))


def test_paged_wrapper_checks_and_names_its_tpu_kernel():
    q, kp, vp, table, lens, _ = _paged_case("ragged_f32")
    with pytest.raises(ValueError, match="paged flash decode"):
        tdecode.paged_flash_decode(_t(q), _t(kp), _t(vp),
                                   torch.from_numpy(table[:2]),
                                   torch.from_numpy(lens))
    with pytest.raises(ValueError, match="multiple"):
        tdecode.paged_flash_decode(_t(q[:, :3]), _t(kp), _t(vp),
                                   torch.from_numpy(table),
                                   torch.from_numpy(lens))
    text = tdecode.PAGED_SOURCE.read_text()
    assert "repro/kernels/attention/decode.py:paged_flash_decode" in text
    assert "pool + ((tbl[p / bs] * G + g) * bs + p % bs) * D" in text
    assert not tdecode.supports_head_dim(136)


# ---------------------------------------------------------------------------
# head dims 112 (zamba2-7b), 64 (granite-moe-3b) and 256 (paligemma-3b)
# ---------------------------------------------------------------------------

D112_CASES = ("ragged_f32", "bf16_q_f32_pool", "ragged_bf16")


def _paged_at_head_dim(name, d):
    """The plain version and the walk of ``csrc/paged_flash_decode.cu``
    against the Pallas kernel at head dim ``d``, through a shuffled table
    with sentinel tails; exact zeros at length 0."""
    q, kp, vp, table, lens, qdt = _paged_case(name, d)
    want = _jax_paged(q, kp, vp, table, lens, qdt)
    pdt = PAGED_CASES[name][5]
    tq, tk, tv = _t(q, qdt), _t(kp, pdt), _t(vp, pdt)
    tbl, tl_ = torch.from_numpy(table), torch.from_numpy(lens)
    assert tdecode.supports_head_dim(d)
    for got, how in ((tattn_ops.paged_flash_decode(tq, tk, tv, tbl, tl_),
                      "plain"),
                     (_paged_cuda(tq, tk, tv, tbl, tl_, d ** -0.5),
                      "CUDA transliteration")):
        assert got.dtype == T_DTYPE[qdt] and bool(torch.isfinite(got).all())
        _close(got.float(), want, qdt, how)
        for i in np.flatnonzero(lens == 0):
            assert bool((got[i] == 0).all()), how


def _paged_equals_dense(d, splits):
    """The two kernels' walks bit for bit on the gathered view at head dim
    ``d`` and ``splits`` CTAs a (slot, head), whichever CTA merges."""
    q, kp, vp, table, lens, qdt = _paged_case("bf16_q_f32_pool", d)
    tq, tk, tv = _t(q, qdt), _t(kp, "float32"), _t(vp, "float32")
    tbl, tl_ = torch.from_numpy(table), torch.from_numpy(lens)
    kd = tattn_ref.gather_paged(tk, tbl.clamp(0, N_BLOCKS - 1))
    vd = tattn_ref.gather_paged(tv, tbl.clamp(0, N_BLOCKS - 1))
    dense = _dense_cuda(tq, kd, vd, tl_, d ** -0.5)
    for arrival in range(2):
        assert torch.equal(_paged_cuda(tq, tk, tv, tbl, tl_, d ** -0.5,
                                       splits, arrival), dense)


@pytest.mark.parametrize("name", D112_CASES)
def test_paged_at_head_dim_112_matches_jax_kernel(name):
    """At D = 112: 14 of 16 lanes holding data."""
    _paged_at_head_dim(name, 112)


@pytest.mark.parametrize("splits", [1, 2, 16])
def test_paged_equals_dense_at_head_dim_112(splits):
    """At D = 112, at every split and whichever CTA merges."""
    _paged_equals_dense(112, splits)


@pytest.mark.parametrize("name", D112_CASES)
def test_paged_at_head_dim_64_matches_jax_kernel(name):
    """At D = 64 (granite-moe-3b's): 8 of 16 lanes holding data, the
    others zero-filled by their copies' source size 0."""
    _paged_at_head_dim(name, 64)


@pytest.mark.parametrize("splits", tdecode.SPLITS)
def test_paged_equals_dense_at_head_dim_64(splits):
    """At D = 64, at every split and whichever CTA merges."""
    _paged_equals_dense(64, splits)


@pytest.mark.parametrize("name", D112_CASES)
def test_paged_at_head_dim_256_matches_jax_kernel(name):
    """At D = 256 (paligemma-3b's 2048 / 8): 16 elements a lane, every
    lane live."""
    _paged_at_head_dim(name, 256)


@pytest.mark.parametrize("splits", [1, 2, 16])
def test_paged_equals_dense_at_head_dim_256(splits):
    """At D = 256, at every split and whichever CTA merges."""
    _paged_equals_dense(256, splits)


@pytest.mark.parametrize("d", tdecode.HEAD_DIMS)
@pytest.mark.parametrize("pool_bytes", [2, 4])
def test_lane_layout_covers_each_row_once(d, pool_bytes):
    """The index arithmetic both decode kernels share, element by element
    at every head dim they are built for: a lane holds ``E`` elements
    (``2 E`` at D 256) and is live iff ``lane * E < D``; the live lanes'
    elements ``lane * E + e`` cover ``0 .. D - 1`` once; each 16-byte copy
    of a live lane (one for bf16, two for float32, twice as many at D 256)
    lies inside its row of the pool at a 16-byte aligned address, for the
    row address ``((tbl * G + g) * bs + r) * D`` of logical key ``p`` (``r
    = p % bs``); a lane's staged slot ``(((grp * RING + i % RING) * 2 + kv)
    * LANES + lane) * E`` lies inside the ring, one slot a (key, tensor,
    lane), and the ring holds the merge's table of 16 rows of ``D``
    floats."""
    assert f"constexpr int E = {E};" in tdecode.CHAIN_SOURCE.read_text()
    text = tdecode.PAGED_SOURCE.read_text()
    assert "paged_flash_decode_kernel<TQ, TKV, CPS, D>" in text
    n, g_kv, bs = 5, 3, 4
    shape = (n, g_kv, bs, d)
    el = _elems(d)
    live = [lane for lane in range(LANES) if lane * el < d]
    assert len(live) == d // el
    cols = sorted(lane * el + e for lane in live for e in range(el))
    assert cols == list(range(d))
    row_bytes = d * pool_bytes
    for tbl, g, r in itertools.product(range(n), range(g_kv), range(bs)):
        row = ((tbl * g_kv + g) * bs + r) * d
        assert row == np.ravel_multi_index((tbl, g, r, 0), shape)
        for lane in live:
            start = (row + lane * el) * pool_bytes
            for v in range(el * pool_bytes // 16):
                at = start + 16 * v
                assert at % 16 == 0
                assert row * pool_bytes <= at
                assert at + 16 <= row * pool_bytes + row_bytes
    for chains in (16, 8, 1):
        ring, _ = _ring_keys(torch.float32 if pool_bytes == 4
                             else torch.bfloat16, chains)
        size = chains * ring * 2 * LANES * el
        slots = {(((grp * ring + i % ring) * 2 + kv) * LANES + lane) * el
                 for grp in range(chains) for i in range(2 * ring)
                 for kv in (0, 1) for lane in live}
        assert max(slots) + el <= size and min(slots) >= 0
        assert len(slots) == chains * ring * 2 * len(live)
        assert size * pool_bytes >= 4 * GROUPS * d


# ---------------------------------------------------------------------------
# the layer's paged write and the model's cache operations
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def attn_layer():
    cfg_t = tconfigs.get_config("qwen2.5-14b").reduced()
    from repro import configs as jconfigs
    cfg_j = jconfigs.get_config("qwen2.5-14b").reduced()
    rng = np.random.default_rng(4)
    d, h, g, hd = cfg_t.d_model, cfg_t.n_heads, cfg_t.n_kv_heads, \
        cfg_t.head_dim
    shapes = {"wq": (d, h * hd), "wk": (d, g * hd), "wv": (d, g * hd),
              "wo": (h * hd, d), "bq": (h * hd,), "bk": (g * hd,),
              "bv": (g * hd,)}
    params = {k: (0.2 * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()}
    return cfg_t, cfg_j, params


@pytest.mark.parametrize("mode", ["brainslug", "xla"])
def test_paged_layer_decode_matches_jax(attn_layer, mode):
    """One paged decode step per layer: active slots write one row each
    through the table; an inactive slot and an idle slot whose stale
    length and zeroed table row alias an active slot's target write
    nothing (the JAX scatter's drop rule); outputs, pools and lengths
    equal the JAX layer's."""
    cfg_t, cfg_j, params = attn_layer
    rng = np.random.default_rng(8)
    b, n_blk, bs, mb = 4, 10, 4, 3
    g, hd = cfg_t.n_kv_heads, cfg_t.head_dim
    x = rng.standard_normal((b, 1, cfg_t.d_model)).astype(np.float32)
    kp = rng.standard_normal((n_blk, g, bs, hd)).astype(np.float32)
    vp = rng.standard_normal((n_blk, g, bs, hd)).astype(np.float32)
    # slot 3 is idle: its table row is zeroed and its stale length 2 aims
    # at block 0, offset 2, where active slot 0 writes this step
    table = np.array([[0, 5, 6], [1, 2, 7], [3, 4, 8], [0, 0, 0]], np.int32)
    length = np.array([2, 9, 5, 2], np.int32)
    active = np.array([True, True, False, False])
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jcache = jattn.PagedKVCache(k_pool=jnp.asarray(kp), v_pool=jnp.asarray(vp),
                                length=jnp.asarray(length))
    jout, jc = jattn.decode(jp, jnp.asarray(x), jcache, cfg_j,
                            JRuntime(mode=mode), active=jnp.asarray(active),
                            block_table=jnp.asarray(table))
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    tcache = tattn.PagedKVCache(k_pool=torch.from_numpy(kp.copy()),
                                v_pool=torch.from_numpy(vp.copy()),
                                length=torch.from_numpy(length.copy()))
    key = "paged_decode_plain" if mode == "brainslug" else "paged_decode_ref"
    before = tattn_ops.STATS.snapshot()
    tout, tc = tattn.decode(tp, torch.from_numpy(x), tcache, cfg_t,
                            TRuntime(mode=mode),
                            active=torch.from_numpy(active),
                            block_table=torch.from_numpy(table))
    assert tattn_ops.STATS.delta(before)[key] == 1
    assert tc is tcache                                   # in place
    # the two active slots' rows (block 0 offset 2, block 7 offset 1) hold
    # the new K/V (rope rounds apart from JAX's by an ulp); every other
    # row, the idle slot's alias included, is untouched
    written = np.zeros((n_blk, bs), bool)
    written[0, 2] = written[7, 1] = True
    for got, want, old in ((tc.k_pool, jc.k_pool, kp),
                           (tc.v_pool, jc.v_pool, vp)):
        # (N, bs, G, hd): a row is one (block, offset)
        got, want, old = (np.asarray(a).transpose(0, 2, 1, 3)
                          for a in (got.numpy(), want, old))
        np.testing.assert_allclose(got[written], want[written], rtol=1e-6,
                                   atol=1e-6)
        assert not np.array_equal(got[written], old[written])
        np.testing.assert_array_equal(got[~written], old[~written])
        np.testing.assert_array_equal(want[~written], old[~written])
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=2e-5,
                               atol=2e-5)
    with pytest.raises(ValueError, match="block_table"):
        tattn.decode(tp, torch.from_numpy(x), tcache, cfg_t,
                     TRuntime(mode=mode))


def test_reset_slots_and_copy_blocks_match_jax():
    cfg_t = tconfigs.get_config("deepseek-7b").reduced()
    from repro import configs as jconfigs
    cfg_j = jconfigs.get_config("deepseek-7b").reduced()
    kw = dict(kv_layout="paged", kv_num_blocks=6, kv_block_size=4)
    jc = jlm.init_decode_cache(cfg_j, 3, 12, dtype=jnp.float32, **kw)
    tc = tlm.init_decode_cache(cfg_t, 3, 12, dtype=torch.float32,
                               device="cpu", **kw)
    rng = np.random.default_rng(2)
    pool = rng.standard_normal(tuple(tc["blocks"]["sub0"].k_pool.shape)
                               ).astype(np.float32)
    lens = np.array([[5, 7, 2]] * cfg_t.n_layers, np.int32)
    jc["blocks"]["sub0"] = jattn.PagedKVCache(
        k_pool=jnp.asarray(pool), v_pool=jnp.asarray(-pool),
        length=jnp.asarray(lens))
    sub = tc["blocks"]["sub0"]
    sub.k_pool.copy_(torch.from_numpy(pool))
    sub.v_pool.copy_(torch.from_numpy(-pool))
    sub.length.copy_(torch.from_numpy(lens))
    mask = np.array([True, False, True])
    for lengths in (None, np.array([3, 9, 0], np.int32)):
        jr = jlm.reset_slots(jc, jnp.asarray(mask),
                             None if lengths is None else jnp.asarray(lengths))
        tr = tlm.reset_slots(tc, torch.from_numpy(mask),
                             None if lengths is None
                             else torch.from_numpy(lengths))
        np.testing.assert_array_equal(tr["blocks"]["sub0"].length.numpy(),
                                      np.asarray(jr["blocks"]["sub0"].length))
    jcopy = jlm.copy_blocks(jc, jnp.asarray(1, jnp.int32),
                            jnp.asarray(4, jnp.int32))
    tcopy = tlm.copy_blocks(tc, 1, 4)
    assert tcopy is tc
    for f in ("k_pool", "v_pool"):
        np.testing.assert_array_equal(
            getattr(tcopy["blocks"]["sub0"], f).numpy(),
            np.asarray(getattr(jcopy["blocks"]["sub0"], f)))


# ---------------------------------------------------------------------------
# host bookkeeping: allocator, prefix cache, kv.* invariants
# ---------------------------------------------------------------------------

def _alloc_state(a):
    return (list(a.refcount), list(a.filled), a.free_blocks(), a.stored,
            a.peak_in_use, a.n_free, a.in_use)


def test_allocator_and_prefix_cache_follow_jax_under_random_ops():
    """One seeded sequence of alloc / share / release / fill / fork /
    register / lookup / evict on both packages: equal refcounts, free
    lists, fills, lookups and evictions at every step."""
    rng = np.random.default_rng(11)
    bs, n = 4, 16
    ja, ta = jengine.BlockAllocator(n, bs), tengine.BlockAllocator(n, bs)
    jp, tp = jengine.PrefixCache(ja), tengine.PrefixCache(ta)
    held: list[int] = []
    prompts = [rng.integers(1, 9, int(rng.integers(1, 14))).astype(np.int32)
               for _ in range(6)]
    for step in range(1500):
        op = int(rng.integers(0, 8))
        if op == 0 and ja.n_free:
            b = ja.alloc()
            assert ta.alloc() == b
            held.append(b)
        elif op == 1 and held:
            b = held[int(rng.integers(0, len(held)))]
            ja.share(b), ta.share(b)
            held.append(b)
        elif op == 2 and held:
            b = held.pop(int(rng.integers(0, len(held))))
            ja.release(b), ta.release(b)
        elif op == 3 and held:
            b = held[int(rng.integers(0, len(held)))]
            upto = int(rng.integers(0, bs + 1))
            ja.note_fill(b, upto), ta.note_fill(b, upto)
        elif op == 4 and len(held) >= 2:
            s, d = (held[int(i)] for i in rng.integers(0, len(held), 2))
            ja.note_fork(s, d), ta.note_fork(s, d)
        elif op == 5 and held:
            p = prompts[int(rng.integers(0, len(prompts)))]
            b = held[int(rng.integers(0, len(held)))]
            n_full = len(p) // bs
            jk = tk = b"\x00" * 16
            for c in range(n_full):
                jk = jp.register_full(jk, p[c * bs:(c + 1) * bs], b)
                tk = tp.register_full(tk, p[c * bs:(c + 1) * bs], b)
            assert jk == tk
            jp.register_partial(jk, p[n_full * bs:], b)
            tp.register_partial(tk, p[n_full * bs:], b)
        elif op == 6:
            p = prompts[int(rng.integers(0, len(prompts)))]
            assert jp.lookup(p) == tp.lookup(p)
        elif op == 7:
            k = int(rng.integers(0, 3))
            assert jp.evict(k) == tp.evict(k)
        assert _alloc_state(ja) == _alloc_state(ta), step
        assert jp.cached_blocks() == tp.cached_blocks(), step
    jp.clear(), tp.clear()
    assert _alloc_state(ja) == _alloc_state(ta)
    with pytest.raises(RuntimeError, match="exhausted"):
        small = tengine.BlockAllocator(1, 4)
        small.alloc(), small.alloc()


def _clean_state(m):
    return m.BlockTableState(
        num_blocks=8, block_size=4,
        refcounts=(2, 1, 1, 0, 0, 0, 0, 1),
        free=(3, 4, 5, 6),
        tables=((0, 1), (0, 2)),
        lengths=(8, 7),
        cached=(7,),
        writers=(1, 2))


MUTANTS = {
    "clean": {},
    "out_of_bounds": dict(tables=((0, 99), (0, 2))),
    "uncovered": dict(lengths=(9, 7)),
    "refcount": dict(refcounts=(1, 1, 1, 0, 0, 0, 0, 1)),
    "shared_writable": dict(writers=(0, 1, 2)),
    "freed_reachable": dict(free=(1, 3, 4, 5, 6),
                            refcounts=(2, 0, 1, 0, 0, 0, 0, 1)),
    "bad_ids_everywhere": dict(free=(3, 4, 5, -1), cached=(7, 12),
                               writers=(1, 2, 8)),
    "refcount_length": dict(refcounts=(2, 1, 1)),
}


def _findings(fs):
    return [(f.invariant, f.severity, f.subject, f.detail) for f in fs]


@pytest.mark.parametrize("name", sorted(MUTANTS))
def test_kv_invariants_give_the_jax_findings(name):
    js = dataclasses.replace(_clean_state(jverify), **MUTANTS[name])
    ts = dataclasses.replace(_clean_state(tverify), **MUTANTS[name])
    want = _findings(jverify.check_block_tables(js))
    got = tverify.check_block_tables(ts)
    assert _findings(got) == want
    assert (name == "clean") == (want == [])
    for f in got:
        assert f.source == "src/repro_torch/launch/engine.py"
        assert f.invariant in tverify.INVARIANTS
        assert str(f).startswith(f"[{f.severity}] {f.invariant} @ ")
    if want:
        with pytest.raises(tverify.VerifyError, match=want[0][0]):
            tverify.enforce(got, "strict")
        with pytest.warns(UserWarning, match="waived"):
            tverify.enforce(got, "warn", subject="engine tick")
    tverify.enforce(got, "off")
    with pytest.raises(ValueError, match="verify mode"):
        tverify.enforce(got, "loud")


def test_kv_invariant_table_matches_jax():
    want = {k: v[1] for k, v in jverify.INVARIANTS.items()
            if k.startswith("kv.")}
    assert {k: v[1] for k, v in tverify.INVARIANTS.items()} == want
    assert tverify.VERIFY_MODES == jverify.VERIFY_MODES
