"""The dense flash decode kernel's walk, on the CPU.

``csrc/flash_decode.cu`` runs the chain walk of ``csrc/decode_chain.cuh``
(the paged kernel's) over a dense cache: :func:`tdecode.launch_plan`'s CTAs
at ``max_keys = S``, each CTA's chains staging their rows through the ring,
row ``c + CHAINS * i`` of the slot's KV head for chain ``c``'s key ``i``
(an address that advances by ``CHAINS * D`` a key), each CTA's chains'
states in its own shared memory, and the merge in chain order by the
cluster's first CTA.  Here a transliteration of that walk:

* bit for bit against the dense kernel's walk before the split
  (``test_torch_paged._dense_cuda``) and the paged kernel's walk on a
  pooled view of the same cache (``test_torch_paged._paged_cuda``, merged
  by its first and by its second CTA), at splits 1, 2, 4, 8 and 16, at D
  64, 112 and 128 (1, 2 and 16 at D 256),
  over ragged lengths with a 0 and one above ``S`` (clamped), GQA at
  qwen2.5-14b's 40/8 heads, a bf16 query over a float32 cache, ``S`` below
  16 and ``S`` not a multiple of 16;
* against the Pallas kernel in interpret mode, 1e-5 in float32 and 1e-2 in
  bf16;
* ``launch_plan`` at ``max_keys = S`` covering every (slot, head, chain)
  once and reading no lengths;
* ``plan_keys``: the caller's host bound (``max_keys``) gives the plan
  ``launch_plan`` makes at ``min(S, max_keys)``; the Server passes its
  step and the Engine a bound on its slots' lengths;
* the wrapper's checks: the cache contiguous and 16-byte aligned, ``splits``
  one of :data:`tdecode.SPLITS`, ``max_keys`` not negative, the head dims
  and dtypes the kernel has.

The kernel itself runs only on the card (``chip_smoke.py`` phases 11, 14,
16 and 24a)."""
from __future__ import annotations

import inspect
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import ops as jattn_ops
from repro_torch.kernels.attention import decode as tdecode
from test_torch_paged import (CARD, GROUPS, NP_DTYPE, T_DTYPE, _chain_step,
                              _close, _cu_const, _dense_cuda, _merge,
                              _paged_cuda, _ring_keys, _seed, _t)

#: name: (B, H, G, S, lengths, q dtype, cache dtype); lengths past S are
#: clamped to S
DENSE_CASES = {
    "ragged_f32": (4, 8, 2, 40, [0, 9, 23, 47], "float32", "float32"),
    "ragged_bf16": (4, 8, 2, 40, [17, 0, 1, 40], "bfloat16", "bfloat16"),
    "gqa_40_8_f32": (2, 40, 8, 40, [19, 33], "float32", "float32"),
    "bf16_q_f32_cache": (4, 8, 2, 40, [40, 0, 5, 13], "bfloat16",
                         "float32"),
    "short_cache_f32": (3, 4, 2, 7, [7, 3, 0], "float32", "float32"),
    "odd_cache_f32": (3, 4, 4, 20, [20, 18, 50], "float32", "float32"),
}
#: Rows a block of the pooled view.
POOL_BLOCK = 4


def _dense_case(name, d):
    b, h, g, s, lengths, qdt, cdt = DENSE_CASES[name]
    rng = np.random.default_rng(sorted(DENSE_CASES).index(name) + 70 + d)
    q = rng.standard_normal((b, h, 1, d), np.float32).astype(NP_DTYPE[qdt])
    k = rng.standard_normal((b, g, s, d), np.float32).astype(NP_DTYPE[cdt])
    v = rng.standard_normal((b, g, s, d), np.float32).astype(NP_DTYPE[cdt])
    lens = np.asarray(lengths, np.int32)
    for i, n in enumerate(lens):               # garbage past each length
        k[i, :, n:] = 99.0
        v[i, :, n:] = -99.0
    return _t(q, qdt), _t(k, cdt), _t(v, cdt), torch.from_numpy(lens), qdt


def _pooled(k, v, seed):
    """The cache as a shuffled pool of POOL_BLOCK-row blocks and a table
    that maps it back: the gathered view of (pool, table) is (k, v), zero
    rows past ``S`` in the last block."""
    b, g, s, d = k.shape
    mb = -(-s // POOL_BLOCK)
    pad = mb * POOL_BLOCK - s

    def blocks(x):
        x = torch.cat([x, x.new_zeros(b, g, pad, d)], 2)
        return x.view(b, g, mb, POOL_BLOCK, d).permute(0, 2, 1, 3, 4) \
            .reshape(b * mb, g, POOL_BLOCK, d)
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(b * mb))
    inv = torch.argsort(perm)
    table = inv.view(b, mb).to(torch.int32)
    return blocks(k)[perm], blocks(v)[perm], table


def _dense_cta(q, kq, vq, g, n, chains, c0, scale, ring):
    """One CTA of ``csrc/flash_decode.cu``: chains ``c0 .. c0 + chains - 1``
    walk keys ``c, c + CHAINS, ...`` below ``n`` (the clamped length).
    Chain ``c``'s address starts at row ``c`` of KV head ``g`` and advances
    by ``CHAINS`` rows a staged key.  ``ring`` = (RING, U): RING - U
    keys are staged ahead; a step stages U more into the slots the last
    step's keys left, then takes keys ``i0 .. i0 + U - 1`` from slots ``i %
    RING``, in order.  Returns the chains' (m, l, acc), seeds elsewhere."""
    ring_keys, step = ring
    d = q.shape[-1]
    own = torch.zeros(GROUPS, dtype=torch.bool)
    own[c0:c0 + chains] = True
    cs = torch.arange(GROUPS)
    n_keys = torch.where(own & (cs < n), (n - cs + GROUPS - 1) // GROUPS, 0)
    row = cs.clone()                           # each chain's next row
    slots = [dict() for _ in range(GROUPS)]    # slot -> (row, key)
    staged = torch.zeros(GROUPS, dtype=torch.long)

    def stage():
        for c in range(c0, c0 + chains):
            i = int(staged[c])
            if i < n_keys[c]:
                slots[c][i % ring_keys] = (int(row[c]), c + GROUPS * i)
                row[c] += GROUPS
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
            r, key = slots[c][i % ring_keys]
            assert key == c + GROUPS * i == r   # the slot holds key i
            k[c], v[c] = kq[g, r], vq[g, r]
        m, l, acc = _chain_step(q, k, v, m, l, acc, act, scale)
    return m, l, acc


def _dense_split_cuda(q, k, v, lengths, scale, splits=None):
    """``csrc/flash_decode.cu`` over :func:`tdecode.launch_plan`'s grid at
    ``max_keys = S`` (or ``splits`` CTAs a (slot, head), one cluster): per
    (slot, head) the length clamped to ``[0, S]`` (zeros at 0, written by
    split 0); CTA ``j`` holds chains ``j*chains ..`` and keys iff
    ``j*chains < len``; with one CTA holding keys it merges in place, else
    CTA 0 reads the others' chains below ``len`` from their shared memory
    (seeds above) and merges.  K/V rounded to q's dtype first."""
    b, h, _, d = q.shape
    g, s = k.shape[1], k.shape[2]
    if splits is None:
        splits = tdecode.launch_plan(b, h, s, s, *CARD).splits
    chains = GROUPS // splits
    ring = _ring_keys(k.dtype, chains)
    kq, vq = k.to(q.dtype).float(), v.to(q.dtype).float()
    out = torch.full(q.shape, float("nan"))
    for bi, hi in itertools.product(range(b), range(h)):
        n = min(max(int(lengths[bi]), 0), s)
        if n == 0:
            out[bi, hi, 0] = 0.0
            continue
        gi = hi // (h // g)
        qv = q[bi, hi, 0].float()
        m, l, acc = _seed(d)                    # CTA 0's table
        for j in range(min(splits, -(-n // chains))):   # CTAs with keys
            c0 = j * chains
            own = _dense_cta(qv, kq[bi], vq[bi], gi, n, chains, c0, scale,
                             ring)
            for t, st in zip((m, l, acc), own):
                t[c0:c0 + chains] = st[c0:c0 + chains]
        for t, st in zip((m, l, acc), _seed(d)):
            t[n:] = st[n:]
        out[bi, hi, 0] = _merge(m, l, acc)
    return out.to(q.dtype)


#: (head dim, splits): every split at every head dim but 256, whose 16
#: elements a lane make the walk dearer on the CPU: there the unsplit,
#: the first split and the widest.
DIM_SPLITS = [(d, s) for d in tdecode.HEAD_DIMS for s in tdecode.SPLITS
              if d != 256 or s in (1, 2, 16)]


@pytest.mark.parametrize("d,splits", DIM_SPLITS)
@pytest.mark.parametrize("name", sorted(DENSE_CASES))
def test_dense_walk_equals_the_unsplit_walk_and_paged(name, d, splits):
    """Every split gives the bits of the walk with one CTA of all chains
    and of the paged walk through a shuffled table over the same rows,
    whichever of the paged walk's CTAs merges; length 0 gives exact
    zeros."""
    q, k, v, lens, _ = _dense_case(name, d)
    scale = d ** -0.5
    want = _dense_cuda(q, k, v, lens, scale)
    kp, vp, table = _pooled(k, v, d + splits)
    got = _dense_split_cuda(q, k, v, lens, scale, splits)
    assert torch.equal(got, want)
    for merger in range(2):
        paged = _paged_cuda(q, kp, vp, table, lens.clamp(max=k.shape[2]),
                            scale, splits, merger)
        assert torch.equal(got, paged)
    for i in torch.nonzero(lens == 0).flatten().tolist():
        assert bool((got[i] == 0).all())


@pytest.mark.parametrize("d", tdecode.HEAD_DIMS)
@pytest.mark.parametrize("name", sorted(DENSE_CASES))
def test_dense_walk_matches_jax_kernel(name, d):
    """The walk at the plan's split against the Pallas kernel in interpret
    mode (the layer's call: the cache cast to q's dtype), and the plain
    version beside it."""
    q, k, v, lens, qdt = _dense_case(name, d)
    s = k.shape[2]
    jq = jnp.asarray(q.float().numpy()).astype(NP_DTYPE[qdt])
    jk = jnp.asarray(k.float().numpy()).astype(jq.dtype)
    jv = jnp.asarray(v.float().numpy()).astype(jq.dtype)
    want = np.asarray(jattn_ops.flash_decode(
        jq, jk, jv, jnp.asarray(lens.clamp(max=s).numpy()),
        block_k=min(8, s), interpret=True)).astype(np.float32)
    got = _dense_split_cuda(q, k, v, lens, d ** -0.5)
    assert got.dtype == T_DTYPE[qdt] and bool(torch.isfinite(got).all())
    _close(got.float(), want, qdt, "CUDA transliteration vs Pallas kernel")
    _close(tdecode.flash_decode(q, k, v, lens).float(), want, qdt,
           "plain vs Pallas kernel")


@pytest.mark.parametrize("sm", [1, 8, 132])
def test_dense_launch_plan_covers_every_chain_once(sm):
    """``launch_plan`` at ``max_keys = block_size = S``, caches below 16
    keys and off multiples of 16 among them: the grid (splits, H, B) of
    CTAs of ``chains`` chains, chain ``split * chains + grp`` for thread
    group ``grp``, holds every (slot, head, chain) exactly once; a cache
    whose chains walk at most ``SPLIT_MIN_KEYS`` keys takes one CTA a
    (slot, head)."""
    for b, h, s in itertools.product((1, 4, 8), (4, 32, 40),
                                     (1, 7, 15, 16, 17, 100, 1024, 1025,
                                      1040, 32768)):
        plan = tdecode.launch_plan(b, h, s, s, sm, lambda n: 1 + n % 7)
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
        if -(-s // GROUPS) <= tdecode.SPLIT_MIN_KEYS:
            assert plan.splits == 1


def test_dense_plan_reads_no_lengths():
    """The dense plan is a function of the operands' shapes, dtypes, the
    caller's host bound and the card: ``dense_plan`` takes q, the cache and
    ``max_keys``, never the lengths; phase 16's ragged batch at S 32768
    splits as the paged kernel's table of the same width does."""
    assert list(inspect.signature(tdecode.dense_plan).parameters) == [
        "q", "k", "max_keys"]
    occupancy = {1: 4, 2: 6, 4: 6, 8: 13, 16: 13}.get
    assert tdecode.launch_plan(8, 32, 32768, 32768, 132,
                               occupancy).splits == 2
    assert tdecode.launch_plan(1, 32, 32768, 32768, 132,
                               occupancy).splits == 8
    assert tdecode.launch_plan(4, 32, 32768, 32768, 132,
                               occupancy).splits == 8
    assert tdecode.launch_plan(4, 32, 1024, 1024, 132,
                               occupancy).splits == 1


@pytest.mark.parametrize("s", [7, 97, 1024, 1025, 32768])
def test_plan_keys_gives_the_plan_of_the_bound(s):
    """``dense_plan``'s keys: the plan ``launch_plan`` makes at ``min(S,
    max_keys)`` (at S without a bound), from at most two values a cache
    length, so a bound that grows every step does not grow the plan cache;
    101 keys in a 32768-key cache run unsplit."""
    occupancy = {1: 4, 2: 6, 4: 6, 8: 13, 16: 13}.get
    keys = set()
    for b, max_keys in itertools.product(
            (1, 4, 8), (None, 0, 1, 101, 1023, 1024, 1025, 5000, 40000)):
        want = s if max_keys is None else max(min(s, max_keys), 1)
        got = tdecode.plan_keys(s, max_keys)
        keys.add(got)
        assert 1 <= got <= s
        assert tdecode.launch_plan(b, 32, got, s, 132, occupancy) == \
            tdecode.launch_plan(b, 32, want, s, 132, occupancy)
    assert len(keys) <= 2
    assert tdecode.plan_keys(s) == s
    if s == 32768:
        assert tdecode.launch_plan(4, 32, tdecode.plan_keys(s, 101), s, 132,
                                   occupancy).splits == 1


def _record_dense_calls(monkeypatch):
    """Wrap the dense wrapper: each call's (max_keys, longest length)."""
    calls = []
    wrapped = tdecode.flash_decode

    def record(q, k, v, lengths, **kw):
        calls.append((kw.get("max_keys"), int(lengths.max())))
        return wrapped(q, k, v, lengths, **kw)
    monkeypatch.setattr(tdecode, "flash_decode", record)
    return calls


def test_server_gives_the_step_as_the_bound(monkeypatch):
    """The static Server decodes in lock step: every dense decode call of
    its prefill and generation carries the slots' length after the step as
    ``max_keys``."""
    from repro_torch.launch import serve as tserve
    calls = _record_dense_calls(monkeypatch)
    sc = tserve.ServeConfig(arch="deepseek-7b", mode="brainslug", batch=2,
                            prompt_len=5, new_tokens=4, max_len=12,
                            torch_device="cpu")
    server = tserve.Server(sc)
    prompts = np.random.default_rng(3).integers(
        0, server.cfg.vocab_size, (2, 5)).astype(np.int32)
    server.generate(prompts)
    layers = server.cfg.n_layers
    assert len(calls) == layers * (5 + 3)
    assert [mk for mk, _ in calls] == [
        n for n in range(1, 9) for _ in range(layers)]
    assert all(mk == longest for mk, longest in calls)


@pytest.mark.parametrize("kv_layout", ["dense", "paged"])
def test_engine_bound_covers_every_slot(monkeypatch, kv_layout):
    """The Engine's dense decode calls carry a ``max_keys`` no shorter than
    any slot's length after the step (ragged prompts, a prefill window of
    3, slots freed and refilled); the paged layout makes no dense call."""
    from repro_torch.launch import engine as tengine
    from repro_torch.launch import serve as tserve
    calls = _record_dense_calls(monkeypatch)
    sc = tserve.ServeConfig(arch="deepseek-7b", mode="brainslug", batch=2,
                            max_len=24, torch_device="cpu")
    server = tserve.Server(sc)
    rng = np.random.default_rng(4)
    reqs = [tengine.Request(request_id=i, prompt=rng.integers(
        1, server.cfg.vocab_size, n).tolist(), max_new_tokens=m)
        for i, (n, m) in enumerate([(7, 3), (2, 5), (11, 2), (4, 4)])]
    kw = dict(kv_layout="paged", kv_block_size=4) if kv_layout == "paged" \
        else {}
    comps = server.engine(slots=2, prefill_chunk=3, **kw).run(reqs)
    assert [c.status for c in comps] == ["ok"] * 4
    if kv_layout == "paged":
        assert calls == []
        return
    assert calls
    assert all(mk is not None and mk >= longest for mk, longest in calls)


def test_dense_wrapper_checks_its_operands():
    q, k, v, lens, _ = _dense_case("ragged_f32", 128)
    with pytest.raises(ValueError, match="splits 3"):
        tdecode.flash_decode(q, k, v, lens, splits=3)
    with pytest.raises(ValueError, match="max_keys -1"):
        tdecode.flash_decode(q, k, v, lens, max_keys=-1)
    assert torch.equal(tdecode.flash_decode(q, k, v, lens, max_keys=3),
                       tdecode.flash_decode(q, k, v, lens))
    assert torch.equal(tdecode.flash_decode(q, k, v, lens, splits=4),
                       tdecode.flash_decode(q, k, v, lens))
    tdecode.check_kernel_operands("flash decode", q, k, v, lens)
    strided = k.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        tdecode.check_kernel_operands("flash decode", q, strided, v, lens)
    flat = torch.zeros(k.numel() + 1, dtype=k.dtype)
    shifted = flat[1:].view(k.shape)            # 4 bytes off 16
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        tdecode.check_kernel_operands("flash decode", q, shifted, shifted,
                                      lens)
    for dd in (96, 136):
        qd, kd = torch.zeros(q.shape[:3] + (dd,)), torch.zeros(
            k.shape[:3] + (dd,))
        with pytest.raises(ValueError, match="head dim"):
            tdecode.check_kernel_operands("flash decode", qd, kd, kd, lens)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tdecode.check_kernel_operands("flash decode", q.half(), k.half(),
                                      v.half(), lens)


def test_dense_source_shares_the_chain_walk():
    """Both kernels include the one chain walk and launch a (slot, head)'s
    CTAs as one cluster; the dense kernel keeps its own symbol (traces
    count it by ``flash_decode_kernel``, a fragment of the paged kernel's
    name too), reads rows without a table and names the TPU kernel it
    replaces."""
    dense = tdecode.SOURCE.read_text()
    paged = tdecode.PAGED_SOURCE.read_text()
    walk = tdecode.CHAIN_SOURCE.read_text()
    for text in (dense, paged):
        assert '#include "decode_chain.cuh"' in text
        assert "chain::walk<TQ, TKV, CPS, D>" in text
    assert "flash_decode_kernel<TQ, TKV, CPS, D>" in dense
    assert "paged_flash_decode_kernel" not in dense
    assert "k + ((b * G + g) * S + p) * D" in dense
    assert "repro/kernels/attention/decode.py:flash_decode" in dense
    assert "constexpr int CHAINS = 16;" in walk
    assert tdecode.CHAINS == GROUPS == _cu_const(tdecode.CHAIN_SOURCE,
                                                 "CHAINS")
    # the CTAs of a (slot, head) are one cluster, merged through
    # distributed shared memory
    assert "map_shared_rank" in walk
    for text in (dense, paged):
        assert "chain::launch_clusters<CPS>(" in text
