"""The port's fused vocab cross-entropy (``repro_torch.kernels.vocab_ce``)
against the JAX package's, on the CPU.

* the plain ``fused_ce_fwd`` (what a CPU tensor runs) against the Pallas
  kernel ``repro.kernels.vocab_ce.ce.fused_ce_fwd(interpret=True)`` and
  ``ce_ref``: float32, ragged T / D / V, negative logits, masked rows;
* ``fused_nll`` and ``fused_gold_logp`` values and ``h`` / ``w`` gradients
  against ``jax.grad`` of the JAX ops (whose backwards are V-chunked
  ``lax.scan``), float32;
* a fully masked batch and an empty one give 0 with zero gradients;
* ``_split_merge``, a transliteration of ``csrc/fused_ce.cu`` (the split
  partials and their fixed-order merge), against the plain version.

Float32 tolerance 1e-5: the same products summed in another order.  The
kernel itself runs only on the card (``chip_smoke.py`` phase 17)."""
from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.vocab_ce import ce as jce
from repro.kernels.vocab_ce import ops as jops
from repro.kernels.vocab_ce import ref as jref
from repro_torch.kernels.vocab_ce import ce as tce
from repro_torch.kernels.vocab_ce import ops as tops
from repro_torch.kernels.vocab_ce import ref as tref

# one intra-op thread: these small tensors gain nothing from more, and
# under pytest-xdist several workers' thread pools on the same cores
# made a 0.6 s test take minutes
torch.set_num_threads(1)

TOL = 1e-5
# the Pallas kernel's tiles, small enough that the test shapes take several
# row tiles, V chunks and D chunks (with ragged edges)
BLOCKS = dict(block_rows=16, block_v=128, block_d=32)

CASES = {
    # name: (T, D, V, logit shift)
    "ragged": (37, 70, 300, 0.0),
    "one_chunk": (5, 33, 129, 0.0),
    "negative_logits": (20, 40, 200, -30.0),      # logsumexp < 0
}


def _inputs(name, seed=0):
    """h, w (float32) and labels with a tenth masked and the first rows
    (a whole row tile of the Pallas kernel where T allows) masked."""
    t, d, v, shift = CASES[name]
    rng = np.random.default_rng(seed + sorted(CASES).index(name))
    h = rng.standard_normal((t, d), dtype=np.float32)
    w = (rng.standard_normal((d, v), dtype=np.float32) / np.sqrt(d)).astype(
        np.float32)
    if shift:
        # positive features against a head of mean shift / D: every logit
        # near ``shift``, with no single weight that large
        h = np.abs(h) * np.sqrt(np.pi / 2)
        w = (w + shift / d).astype(np.float32)
    labels = rng.integers(0, v, (t,)).astype(np.int32)
    labels[rng.random(t) < 0.1] = -1
    labels[: min(16, t // 2)] = -1
    return h, w, labels


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_ce_fwd_plain_matches_jax_kernel(name):
    h, w, labels = _inputs(name)
    want_lse, want_gold = jce.fused_ce_fwd(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels), interpret=True,
        **BLOCKS)
    ref_lse, ref_gold = jref.ce_ref(jnp.asarray(h), jnp.asarray(w),
                                    jnp.asarray(labels))
    lse, gold = tce.fused_ce_fwd(_t(h), _t(w), _t(labels))
    assert lse.dtype == gold.dtype == torch.float32
    for got, want in ((lse, want_lse), (gold, want_gold), (lse, ref_lse),
                      (gold, ref_gold)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
    assert (gold.numpy()[labels < 0] == 0).all()
    if CASES[name][3] < 0:
        assert float(lse.max()) < 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_nll_value_and_grads_match_jax(name):
    h, w, labels = _inputs(name, seed=10)
    jfn = jax.value_and_grad(
        lambda h_, w_: jops.fused_nll(h_, w_, jnp.asarray(labels), 16, 128,
                                      32, True), argnums=(0, 1))
    want, (dh_w, dw_w) = jfn(jnp.asarray(h), jnp.asarray(w))
    ht, wt = _t(h).requires_grad_(), _t(w).requires_grad_()
    before = tops.STATS.snapshot()
    got = tops.fused_nll(ht, wt, _t(labels))
    assert tops.STATS.delta(before) == {"kernel": 0, "plain": 1}
    dh, dw = torch.autograd.grad(got, (ht, wt))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(dh.numpy(), np.asarray(dh_w), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_w), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_gold_logp_value_and_grads_match_jax(name):
    """Per-token log-probabilities, negative labels wrapping, under a
    per-token cotangent."""
    h, w, labels = _inputs(name, seed=20)
    labels[1::7] = -3                       # wraps to V - 3
    g = np.random.default_rng(21).standard_normal(h.shape[0]).astype(
        np.float32)
    jval = jops.fused_gold_logp(jnp.asarray(h), jnp.asarray(w),
                                jnp.asarray(labels), 16, 128, 32, True)
    dh_w, dw_w = jax.grad(
        lambda h_, w_: jnp.sum(jops.fused_gold_logp(
            h_, w_, jnp.asarray(labels), 16, 128, 32, True) * g),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    ht, wt = _t(h).requires_grad_(), _t(w).requires_grad_()
    val = tops.fused_gold_logp(ht, wt, _t(labels))
    dh, dw = torch.autograd.grad(val, (ht, wt), _t(g))
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(jval),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        val.detach().numpy(),
        tref.gold_logp_ref(_t(h), _t(w), _t(labels)).numpy(), rtol=TOL,
        atol=TOL)
    np.testing.assert_allclose(dh.numpy(), np.asarray(dh_w), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_w), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("t", [0, 9])
def test_fused_nll_fully_masked_is_zero(t):
    """Every label masked (or no rows): the loss is exactly 0 and so are
    both gradients."""
    rng = np.random.default_rng(3)
    h = _t(rng.standard_normal((t, 24), dtype=np.float32)).requires_grad_()
    w = _t(rng.standard_normal((24, 130), dtype=np.float32)).requires_grad_()
    labels = torch.full((t,), -1, dtype=torch.int32)
    nll = tops.fused_nll(h, w, labels)
    dh, dw = torch.autograd.grad(nll, (h, w))
    assert float(nll.detach()) == 0.0
    assert not dh.any() and not dw.any()
    assert dh.shape == h.shape and dw.shape == w.shape


# -- csrc/fused_ce.cu, transliterated ---------------------------------------

def _split_bounds(vocab, n_split):
    """The column range ``[lo, hi)`` of each split: whole ``BLOCK_V``
    tiles, split ``s`` taking tiles ``[s n / S, (s + 1) n / S)`` (the
    kernel's ``t_begin`` / ``t_end``)."""
    v_tiles = -(-vocab // tce.BLOCK_V)
    return [(s * v_tiles // n_split * tce.BLOCK_V,
             min((s + 1) * v_tiles // n_split * tce.BLOCK_V, vocab))
            for s in range(n_split)]


def _split_merge(h, w, labels, n_split):
    """The kernel's algorithm on whole tensors: each split walks its
    ``BLOCK_V``-column tiles in order (a CTA does this for one row tile;
    rows are independent, so all rows at once here), masks columns >= V to
    -1e30, and makes the online (m, l, g) update per tile; the merge then
    takes the splits in split order."""
    t, v = h.shape[0], w.shape[1]
    hf, wf = h.float(), w.float()
    lab = labels.long()[:, None]
    parts = []
    for lo, hi in _split_bounds(v, n_split):
        m = torch.full((t,), tce.NEG_INF)
        l = torch.zeros(t)
        g = torch.zeros(t)
        for c0 in range(lo, hi, tce.BLOCK_V):
            cols = torch.arange(c0, c0 + tce.BLOCK_V)[None, :]
            tile = torch.zeros((t, tce.BLOCK_V))
            n = min(tce.BLOCK_V, v - c0)
            tile[:, :n] = hf @ wf[:, c0:c0 + n]
            x = torch.where(cols < v, tile, tce.NEG_INF)
            m_new = torch.maximum(m, x.max(dim=1).values)
            l = l * torch.exp(m - m_new) + torch.exp(
                x - m_new[:, None]).sum(dim=1)
            g = g + torch.where(cols == lab, x, 0.0).sum(dim=1)
            m = m_new
        parts.append((m, l, g))
    mx = torch.stack([p[0] for p in parts]).max(dim=0).values
    total, gold = torch.zeros(t), torch.zeros(t)
    for m, l, g in parts:
        total = total + l * torch.exp(m - mx)
        gold = gold + g
    return mx + torch.log(torch.clamp_min(total, 1e-30)), gold


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("n_split", [1, 2, "plan"])
def test_split_merge_matches_plain(name, n_split):
    """Split partials and their merge agree with the plain version at
    ragged shapes, for one split, two, and the plan's count on 132 SMs
    (one split per column tile where the rows are few)."""
    h, w, labels = _inputs(name, seed=30)
    t, _, v, _ = CASES[name]
    if n_split == "plan":
        n_split = tce.split_plan(t, v, 132)
    lse, gold = _split_merge(_t(h), _t(w), _t(labels), n_split)
    want_lse, want_gold = tref.ce_ref(_t(h), _t(w), _t(labels))
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(gold.numpy(), want_gold.numpy(), rtol=TOL,
                               atol=TOL)


def test_split_plan_fills_the_card():
    """At the training path's shape (4096 rows of the 102,400-word vocab)
    33 splits give 32 x 33 = 1056 CTAs on 132 SMs; few rows take one split
    per column tile at most, and every split holds whole tiles."""
    assert tce.split_plan(4096, 102400, 132) == 33
    assert tce.split_plan(1000, 50257, 132) == 132
    assert tce.split_plan(5, 129, 132) == 2
    bounds = _split_bounds(50257, 132)
    assert bounds[0][0] == 0 and bounds[-1][1] == 50257
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(lo % tce.BLOCK_V == 0 and hi > lo for lo, hi in bounds)


# -- the bf16 instance of csrc/fused_ce.cu (wgmma + TMA), transliterated ------

TC_CASES = {
    # name: (T, D, V): two row tiles, D and V ragged against the 64-deep
    # chunks and 256-column tiles, and D or V not a multiple of 8 (staged)
    "odd_d_and_v": (150, 70, 300),
    "odd_v": (37, 136, 517),
    "odd_d": (130, 131, 264),
    "aligned": (20, 64, 512),
}


def _bf16_inputs(name, seed=40):
    """bf16-representable h, w (as numpy float32) and labels with a tenth
    and the first row masked."""
    t, d, v = TC_CASES[name]
    rng = np.random.default_rng(seed + sorted(TC_CASES).index(name))
    bf = ml_dtypes.bfloat16
    h = rng.standard_normal((t, d), dtype=np.float32).astype(bf)
    w = (rng.standard_normal((d, v), dtype=np.float32) / np.sqrt(d)).astype(
        bf)
    labels = rng.integers(0, v, (t,)).astype(np.int32)
    labels[rng.random(t) < 0.1] = -1
    labels[0] = -1
    return h.astype(np.float32), w.astype(np.float32), labels


def _tc_kernel_source():
    """``csrc/fused_ce.cu`` from the bf16 kernel's definition on (its body
    and its launch)."""
    text = tce.SOURCE.read_text()
    return text[text.index("ce_tc_kernel(const"):]


def _tc_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+)",
                         tce.SOURCE.read_text()).group(1))


def _launch_order(row_tiles, n_split):
    """(row tile, split) of the bf16 kernel's CTAs in launch order, read
    from the kernel: the coordinate on ``blockIdx.x`` varies fastest."""
    src = _tc_kernel_source()
    row_axis = re.search(r"r0 = blockIdx\.([xy]) \* TC_BM;", src).group(1)
    split_axis = re.search(r"split = blockIdx\.([xy]);", src).group(1)
    grid_x = re.search(r"dim3 grid\(\((.*?)\) / TC_BM, n_split\)", src)
    assert {row_axis, split_axis} == {"x", "y"}
    assert (grid_x is not None) == (row_axis == "x")
    if row_axis == "x":
        return [(rt, s) for s in range(n_split) for rt in range(row_tiles)]
    return [(rt, s) for rt in range(row_tiles) for s in range(n_split)]


def _split_tiles(n_vtiles, n_split, split):
    """The column tiles of one split: the bf16 kernel's ``t_begin`` /
    ``t_end``."""
    src = _tc_kernel_source()
    assert "t_begin = (int)((int64_t)split * n_vtiles / n_split)" in src
    assert "t_end = (int)((int64_t)(split + 1) * n_vtiles / n_split)" in src
    return range(split * n_vtiles // n_split,
                 (split + 1) * n_vtiles // n_split)


def _tma_box(buf, pitch, rows, cols, r0, c0, box_rows, box_cols):
    """A TMA box of a tensor map over ``buf`` (rows of ``pitch`` elements,
    ``rows`` x ``cols`` described): elements past ``rows`` or ``cols`` are
    zero, whatever the buffer holds there."""
    flat = buf.reshape(-1)
    out = torch.zeros((box_rows, box_cols), dtype=buf.dtype)
    for i in range(box_rows):
        r = r0 + i
        if r >= rows:
            break
        n = max(0, min(box_cols, cols - c0))
        out[i, :n] = flat[r * pitch + c0: r * pitch + c0 + n]
    return out


def _tc_walk(h, w, labels, n_split):
    """The bf16 kernel's work on the CPU: the wrapper stages h and w
    (``ce.staged``); CTAs in the kernel's launch order, each a row tile of
    128 and one split's 256-column tiles; each tile's logits summed
    over 64-deep chunks of TMA boxes (zero past T, D and V) as bf16 products
    in float32; the epilogue (columns >= V to -1e30, gold at col == label,
    the online (m, l, g) update); one partial per (split, row), merged in
    split order."""
    t, d = h.shape
    v = w.shape[1]
    hb, ldh = tce.staged(h)
    wb, ldw = tce.staged(w)
    bm, bn, bk = _tc_const("TC_BM"), _tc_const("TC_BN"), _tc_const("TC_BK")
    assert (bm, bn, bk) == (tce.TC_BLOCK_ROWS, tce.TC_BLOCK_V,
                            tce.TC_BLOCK_D)
    row_tiles, n_vtiles = -(-t // bm), -(-v // bn)
    part = torch.full((3, n_split, t), float("nan"))
    for rt, s in _launch_order(row_tiles, n_split):
        r0 = rt * bm
        rows = torch.arange(r0, r0 + bm)
        lab = torch.where(rows < t, labels.long()[rows.clamp_max(t - 1)], -1)
        m = torch.full((bm,), tce.NEG_INF)
        l = torch.zeros(bm)
        g = torch.zeros(bm)
        for vt in _split_tiles(n_vtiles, n_split, s):
            c0 = vt * bn
            acc = torch.zeros((bm, bn))
            for k0 in range(0, d, bk):
                a = _tma_box(hb, ldh, t, d, r0, k0, bm, bk)
                b = torch.cat([_tma_box(wb, ldw, d, v, k0, c0 + 64 * j, bk, 64)
                               for j in range(bn // 64)], dim=1)
                acc = acc + a.float() @ b.float()
            cols = torch.arange(c0, c0 + bn)[None, :]
            x = torch.where(cols < v, acc, tce.NEG_INF)
            gs = torch.where(cols == lab[:, None], x, 0.0).sum(dim=1)
            m_new = torch.maximum(m, x.max(dim=1).values)
            l = l * torch.exp(m - m_new) + torch.exp(
                x - m_new[:, None]).sum(dim=1)
            m, g = m_new, g + gs
        keep = rows < t
        part[0, s, rows[keep]] = m[keep]
        part[1, s, rows[keep]] = l[keep]
        part[2, s, rows[keep]] = g[keep]
    assert not part.isnan().any()            # every (split, row) written
    mx = part[0].max(dim=0).values
    total, gold = torch.zeros(t), torch.zeros(t)
    for s in range(n_split):
        total = total + part[1, s] * torch.exp(part[0, s] - mx)
        gold = gold + part[2, s]
    return mx + torch.log(torch.clamp_min(total, 1e-30)), gold


@pytest.mark.parametrize("name", sorted(TC_CASES))
@pytest.mark.parametrize("n_split", [1, 2, "plan"])
def test_tc_walk_matches_jax_kernel(name, n_split):
    """The bf16 instance's algorithm (tile walk, staging, launch order,
    epilogue, split merge) against the Pallas kernel in interpret mode and
    ``ce_ref`` on the same bf16 values, at ragged T, D and V, D or V not a
    multiple of 8; bf16 products are exact in float32, so 1e-5."""
    h, w, labels = _bf16_inputs(name)
    t, _, v = TC_CASES[name]
    if n_split == "plan":
        n_split = tce.tc_split_plan(t, v, 132)
    bf = ml_dtypes.bfloat16
    want_lse, want_gold = jce.fused_ce_fwd(
        jnp.asarray(h.astype(bf)), jnp.asarray(w.astype(bf)),
        jnp.asarray(labels), interpret=True, **BLOCKS)
    ht, wt = _t(h).to(torch.bfloat16), _t(w).to(torch.bfloat16)
    lse, gold = _tc_walk(ht, wt, _t(labels), n_split)
    ref_lse, ref_gold = tref.ce_ref(ht, wt, _t(labels))
    for got, want in ((lse, want_lse), (gold, want_gold), (lse, ref_lse),
                      (gold, ref_gold)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
    assert (gold.numpy()[labels < 0] == 0).all()


@pytest.mark.parametrize("shape", [(5, 8), (7, 13), (300, 50257),
                                   (2, 4001)])
def test_staged_pitch_is_a_multiple_of_8(shape):
    """A row pitch that a tensor map cannot describe (not 16 bytes a
    multiple) is staged into a buffer of padded pitch holding the same
    values; an aligned operand is used as it is."""
    x = torch.randn(shape).to(torch.bfloat16)
    buf, pitch = tce.staged(x)
    assert pitch % tce.PITCH_ELEMS == 0 and pitch >= shape[1]
    assert buf.shape == (shape[0], pitch)
    assert torch.equal(buf[:, :shape[1]], x)
    if shape[1] % tce.PITCH_ELEMS == 0:
        assert buf is x


@pytest.mark.parametrize("t,v,sm", [(4096, 102400, 132), (1000, 50257, 132),
                                    (5, 129, 132), (37, 517, 4),
                                    (8192, 49155, 114), (1, 300, 1)])
def test_tc_split_plan_covers_every_column_tile_once(t, v, sm):
    """Every column tile of the vocab in exactly one split, every split
    non-empty, and every (row tile, split) CTA once in the launch order,
    the row tiles of one split side by side."""
    n_split = tce.tc_split_plan(t, v, sm)
    n_vtiles = -(-v // tce.TC_BLOCK_V)
    assert 1 <= n_split <= n_vtiles
    tiles = [vt for s in range(n_split)
             for vt in _split_tiles(n_vtiles, n_split, s)]
    assert tiles == list(range(n_vtiles))
    assert all(len(_split_tiles(n_vtiles, n_split, s)) >= 1
               for s in range(n_split))
    row_tiles = -(-t // tce.TC_BLOCK_ROWS)
    order = _launch_order(row_tiles, n_split)
    assert sorted(order) == sorted({(rt, s) for rt in range(row_tiles)
                                    for s in range(n_split)})
    assert [s for _, s in order] == sorted(s for _, s in order)


def test_tc_split_plan_and_w_traffic_at_the_training_shape():
    """(4096, 4096, 102400) on 132 SMs: 33 splits, 1056 CTAs (eight waves
    of one CTA an SM).  In the kernel's launch order a split's 32 row tiles
    are side by side, so any 132 consecutive CTAs span at most 6 splits
    and read at most 6/33 of ``w``'s columns: ``w`` (839 MB, far past L2)
    streams from device memory about once, not once a wave."""
    t, v, sm = 4096, 102400, 132
    n_split = tce.tc_split_plan(t, v, sm)
    row_tiles = -(-t // tce.TC_BLOCK_ROWS)
    assert (n_split, row_tiles * n_split) == (33, 1056)
    order = _launch_order(row_tiles, n_split)
    widest = max(len({s for _, s in order[i:i + sm]})
                 for i in range(len(order) - sm + 1))
    assert widest <= -(-sm // row_tiles) + 1 == 6
