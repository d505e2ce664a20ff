"""The port's LM serving kernels and configs against the JAX package, on the
CPU.

* ``repro_torch.configs`` equals ``repro.configs`` field by field for every
  arch, ``reduced()`` included;
* each kernel's plain version (what a CPU tensor runs) matches the JAX
  kernel in interpret mode on the JAX package's test grid: float32 at
  rtol/atol 2e-5, bfloat16 at 2e-2 (one bf16 rounding of an O(1) value);
* the Triton kernels' sources (rmsnorm, swiglu) run on a numpy stand-in for
  ``triton.language`` with bf16 from ``ml_dtypes``;
* the CUDA kernels (flash attention, flash decode) are held through
  transliterations of their loop order: tiles, causal block skipping, the
  16 partial softmax states of a decode CTA and their merge; at head dims
  112 (zamba2-7b's) and 64 (granite-moe-3b's) too, with the bf16 kernel's
  halves, zero-filled tiles, skipped k16 steps and epilogue walked element
  by element.

The kernels themselves run only on the card (``chip_smoke.py``)."""
from __future__ import annotations

import dataclasses
import itertools
import re
import sys
import types

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels.attention import ops as jattn_ops
from repro.kernels.attention import ref as jattn_ref
from repro.kernels.rmsnorm import ops as jrms_ops
from repro.kernels.swiglu import ops as jsw_ops
from repro_torch import configs as tconfigs
from repro_torch.kernels.attention import decode as tdecode
from repro_torch.kernels.attention import flash as tflash
from repro_torch.kernels.attention import ops as tattn_ops
from repro_torch.kernels.attention import ref as tattn_ref
from repro_torch.kernels.rmsnorm import ops as trms_ops
from repro_torch.kernels.rmsnorm import rmsnorm as trms
from repro_torch.kernels.swiglu import ops as tsw_ops
from repro_torch.kernels.swiglu import swiglu as tsw

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
NP_DTYPE = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
T_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _randn(rng, shape, dtype="float32"):
    """Seeded values already rounded to ``dtype`` (numpy, via ml_dtypes)."""
    return rng.standard_normal(shape, np.float32).astype(NP_DTYPE[dtype])


def _t(a, dtype="float32"):
    """numpy (float32 or ml_dtypes bf16) -> torch, exactly."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(T_DTYPE[dtype])


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else np.asarray(
        t, np.float32)


def _close(got, want, dtype, what=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what,
                               **TOL[dtype])


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(jconfigs._MODULES))
def test_configs_equal_jax_package(arch):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for jc, tc in ((j, t), (j.reduced(), t.reduced())):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert (tc.head_dim, tc.n_params(), tc.n_active_params()) == (
            jc.head_dim, jc.n_params(), jc.n_active_params())
        assert set(tconfigs.applicable_shapes(tc)) == set(
            jconfigs.applicable_shapes(jc))


def test_config_registry_and_runtime_defaults():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.LM_SHAPES.items()
            } == {k: dataclasses.asdict(v)
                  for k, v in jconfigs.LM_SHAPES.items()}
    trt, jrt = tconfigs.RuntimeConfig(), jconfigs.RuntimeConfig()
    for f in dataclasses.fields(trt):
        assert getattr(trt, f.name) == getattr(jrt, f.name), f.name
    paged = tconfigs.RuntimeConfig(kv_layout="paged", kv_block_size=4)
    assert (paged.kv_layout, paged.kv_block_size) == ("paged", 4)
    with pytest.raises(ValueError, match="kv_layout"):
        tconfigs.RuntimeConfig(kv_layout="ring")
    with pytest.raises(ValueError, match="mode"):
        tconfigs.RuntimeConfig(mode="fast")
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("gpt-5")


# ---------------------------------------------------------------------------
# The numpy stand-in for Triton
# ---------------------------------------------------------------------------

class _A(np.ndarray):
    """A block of the fake Triton: a numpy array with ``.to(dtype)``."""

    def to(self, dtype):
        return np.asarray(self).astype(dtype).view(_A)


def _a(x):
    return np.asarray(x).view(_A)


class _Ptr:
    def __init__(self, buf, off=0):
        self.buf, self.off = buf, off

    def __add__(self, off):
        return _Ptr(self.buf, self.off + np.asarray(off))


def _fake_triton(state):
    tl = types.ModuleType("triton.language")
    tl.constexpr = object
    tl.int64, tl.float32 = np.int64, np.float32
    tl.program_id = lambda axis: _a(np.int64(state["pid"]))
    tl.arange = lambda a, b: _a(np.arange(a, b))

    def load(ptr, mask, other=0.0):
        off = np.asarray(ptr.off)
        mask = np.broadcast_to(mask, np.broadcast_shapes(off.shape,
                                                         np.shape(mask)))
        off = np.broadcast_to(off, mask.shape)
        vals = ptr.buf[np.where(mask, off, 0)]
        return _a(np.where(mask, vals, other).astype(ptr.buf.dtype))

    def store(ptr, val, mask):
        off = np.asarray(ptr.off)
        val = np.broadcast_to(np.asarray(val).astype(ptr.buf.dtype),
                              off.shape)
        mask = np.broadcast_to(mask, off.shape)
        ptr.buf[off[mask]] = val[mask]

    tl.load, tl.store = load, store
    tl.sum = lambda x, axis: _a(np.sum(np.asarray(x), axis=axis,
                                       dtype=np.float32))
    tl.maximum = lambda a, b: _a(np.maximum(a, b))
    tl.sigmoid = lambda x: _a((1.0 / (1.0 + np.exp(-np.asarray(x)))
                               ).astype(np.float32))
    libdevice = types.ModuleType("triton.language.extra.libdevice")
    libdevice.rsqrt = lambda x: _a((1.0 / np.sqrt(np.asarray(x))
                                    ).astype(np.float32))
    libdevice.tanh = lambda x: _a(np.tanh(np.asarray(x)))
    extra = types.ModuleType("triton.language.extra")
    extra.libdevice = libdevice
    tl.extra = extra
    triton = types.ModuleType("triton")
    triton.jit = lambda fn: fn
    triton.language = tl
    return {"triton": triton, "triton.language": tl,
            "triton.language.extra": extra,
            "triton.language.extra.libdevice": libdevice}


def _fake_kernel(src, name, monkeypatch):
    """The kernel function of a Triton source string, on the fake Triton,
    and the program-id cell that drives it."""
    state = {"pid": 0}
    for k, v in _fake_triton(state).items():
        monkeypatch.setitem(sys.modules, k, v)
    ns: dict = {}
    exec(compile(src, f"<{name}>", "exec"), ns)
    return ns[name], state


# ---------------------------------------------------------------------------
# rmsnorm (Triton)
# ---------------------------------------------------------------------------

RMS_SHAPES = [(4, 128), (2, 7, 384), (1, 1, 256), (3, 129, 512)]


def _fake_rmsnorm(x, scale, res, eps, monkeypatch):
    kernel, state = _fake_kernel(trms.KERNEL_SRC, "rmsnorm_kernel",
                                 monkeypatch)
    d = x.shape[-1]
    rows = x.size // d
    xf = np.ascontiguousarray(x).reshape(-1)
    rf = np.ascontiguousarray(res).reshape(-1) if res is not None else xf
    y = np.full(x.size, np.nan, x.dtype)
    h = np.full(x.size, np.nan, x.dtype) if res is not None else y
    block_d, r_sub, _ = trms.launch_config(d)
    for pid in range(-(-rows // r_sub)):
        state["pid"] = pid
        kernel(_Ptr(xf), _Ptr(rf), _Ptr(np.asarray(scale)), _Ptr(y), _Ptr(h),
               rows, eps, D=d, BLOCK_D=block_d, R_SUB=r_sub,
               HAS_RES=res is not None)
    return y.reshape(x.shape), (h.reshape(x.shape) if res is not None else x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RMS_SHAPES)
@pytest.mark.parametrize("with_residual", [True, False])
def test_rmsnorm_matches_jax_kernel(dtype, shape, with_residual,
                                    monkeypatch):
    rng = np.random.default_rng(sum(shape) + with_residual)
    x = _randn(rng, shape, dtype)
    res = _randn(rng, shape, dtype) if with_residual else None
    scale = _randn(rng, shape[-1:], dtype)
    jy, jh = jrms_ops.rmsnorm(jnp.asarray(x), jnp.asarray(scale),
                              None if res is None else jnp.asarray(res),
                              1e-6, 64, True)
    ty, th = trms_ops.rmsnorm(_t(x, dtype), _t(scale, dtype),
                              None if res is None else _t(res, dtype), 1e-6)
    assert ty.dtype == T_DTYPE[dtype] and th.dtype == T_DTYPE[dtype]
    fy, fh = _fake_rmsnorm(x, scale, res, 1e-6, monkeypatch)
    for got, how in (((ty, th), "plain"), ((fy, fh), "triton source")):
        _close(got[0], jy, dtype, f"{how} y")
        _close(got[1], jh, dtype, f"{how} h")


def test_rmsnorm_launch_config_covers_d_model():
    assert trms.launch_config(4096) == (4096, 2, 16)
    assert trms.launch_config(384) == (512, 16, 16)
    assert trms.launch_config(5120)[:2] == (8192, 1)


# ---------------------------------------------------------------------------
# swiglu (Triton)
# ---------------------------------------------------------------------------

def _fake_swiglu(gate, up, act, monkeypatch):
    kernel, state = _fake_kernel(tsw.KERNEL_SRC, "swiglu_kernel",
                                 monkeypatch)
    gf = np.ascontiguousarray(gate).reshape(-1)
    uf = np.ascontiguousarray(up).reshape(-1)
    y = np.full(gf.size, np.nan, gate.dtype)
    block = 256                      # a smaller block: the tail is masked
    for pid in range(-(-gf.size // block)):
        state["pid"] = pid
        kernel(_Ptr(gf), _Ptr(uf), _Ptr(y), gf.size, ACT=tsw.ACT_IDS[act],
               BLOCK=block)
    return y.reshape(gate.shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["silu", "gelu", "squared_relu"])
@pytest.mark.parametrize("shape", [(2, 5, 256), (1, 130, 384)])
def test_swiglu_matches_jax_kernel(dtype, act, shape, monkeypatch):
    rng = np.random.default_rng(len(act) + shape[1])
    g, u = _randn(rng, shape, dtype), _randn(rng, shape, dtype)
    want = jsw_ops.swiglu(jnp.asarray(g), jnp.asarray(u), act, 64, True)
    got = tsw_ops.swiglu(_t(g, dtype), _t(u, dtype), act)
    assert got.dtype == T_DTYPE[dtype]
    _close(got, want, dtype, "plain")
    _close(_fake_swiglu(g, u, act, monkeypatch), want, dtype,
           "triton source")


def test_kernel_dispatch_on_cpu_counts_plain():
    x = torch.ones(3, 8)
    before = (trms_ops.STATS.snapshot(), tsw_ops.STATS.snapshot())
    launches = (trms.rmsnorm_fwd.launches, tsw.swiglu_fwd.launches)
    trms_ops.rmsnorm(x, torch.ones(8), x)
    tsw_ops.swiglu(x, x)
    assert trms_ops.STATS.delta(before[0]) == {"kernel": 0, "plain": 1}
    assert tsw_ops.STATS.delta(before[1]) == {"kernel": 0, "plain": 1}
    assert (trms.rmsnorm_fwd.launches, tsw.swiglu_fwd.launches) == launches
    with pytest.raises(ValueError, match="unknown activation"):
        tsw_ops.swiglu(x, x, "relu")


# ---------------------------------------------------------------------------
# flash attention (CUDA)
# ---------------------------------------------------------------------------

def _cu_const(source, name):
    text = source.read_text()
    return int(re.search(rf"constexpr int {name} = (\d+)", text).group(1))


def _flash_cuda(q, k, v, causal, scale):
    """The float32 instance of ``csrc/flash_attention.cu`` in torch
    float32, CTA by CTA: 64 x 64 tiles (read from the source), zero-filled
    tails, causal key blocks above the diagonal skipped, the online softmax
    of one CTA."""
    BQ = _cu_const(tflash.SOURCE, "BQ")
    BK = _cu_const(tflash.SOURCE, "BK")
    b, h, sq, d = q.shape
    g, sk = k.shape[1], k.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.full((b, h, sq, d), float("nan"))
    for bi in range(b):
        for hi in range(h):
            gi = hi // (h // g)
            for q0 in range(0, sq, BQ):
                qt = torch.zeros(BQ, d)
                qt[:min(BQ, sq - q0)] = qf[bi, hi, q0:q0 + BQ]
                m = torch.full((BQ,), tflash.NEG_INF)
                l = torch.zeros(BQ)
                acc = torch.zeros(BQ, d)
                nk = -(-sk // BK)
                if causal:
                    nk = min(nk, (q0 + BQ - 1) // BK + 1)
                for kb in range(nk):
                    k0 = kb * BK
                    kt, vt = torch.zeros(BK, d), torch.zeros(BK, d)
                    kt[:min(BK, sk - k0)] = kf[bi, gi, k0:k0 + BK]
                    vt[:min(BK, sk - k0)] = vf[bi, gi, k0:k0 + BK]
                    s = qt @ kt.T
                    qi = q0 + torch.arange(BQ)[:, None]
                    ki = k0 + torch.arange(BK)[None, :]
                    valid = (ki < sk) & ((ki <= qi) | (not causal))
                    s = torch.where(valid, s * scale, tflash.NEG_INF)
                    m_new = torch.maximum(m, s.amax(1))
                    corr = torch.exp(m - m_new)
                    p = torch.exp(s - m_new[:, None])
                    l = l * corr + p.sum(1)
                    acc = acc * corr[:, None] + p @ vt
                    m = m_new
                n = min(BQ, sq - q0)
                out[bi, hi, q0:q0 + n] = (acc / torch.clamp(l, min=1e-30)
                                          [:, None])[:n]
    return out.to(q.dtype)


def _flash_cuda_tc(q, k, v, causal, scale):
    """The bfloat16 instance of ``csrc/flash_attention.cu`` (wgmma) in torch
    float32, CTA by CTA: ``TC_BQ`` query rows in two warpgroups of half as
    many, key blocks of :func:`_tc_block_keys` (read from the source),
    tails zero-filled as TMA fills them, key blocks above the diagonal
    skipped, the mask applied only on a warpgroup's diagonal and tail
    blocks, and P fed to the second product as two bf16 terms, hi = bf16(p)
    and lo = bf16(p - hi), while ``l`` sums the float32 P."""
    BQ = _cu_const(tflash.SOURCE, "TC_BQ")
    BK = _tc_block_keys(q.shape[-1])
    WG = BQ // 2
    b, h, sq, d = q.shape
    g, sk = k.shape[1], k.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.full((b, h, sq, d), float("nan"))
    for bi in range(b):
        for hi in range(h):
            gi = hi // (h // g)
            for q0 in range(0, sq, BQ):
                nk = -(-sk // BK)
                if causal:
                    nk = min(nk, (q0 + BQ - 1) // BK + 1)
                for qw in (q0, q0 + WG):            # the two warpgroups
                    qt = torch.zeros(WG, d)
                    n = max(0, min(WG, sq - qw))
                    qt[:n] = qf[bi, hi, qw:qw + n]
                    m = torch.full((WG,), tflash.NEG_INF)
                    l = torch.zeros(WG)
                    acc = torch.zeros(WG, d)
                    for kb in range(nk):
                        k0 = kb * BK
                        kt, vt = torch.zeros(BK, d), torch.zeros(BK, d)
                        kt[:min(BK, sk - k0)] = kf[bi, gi, k0:k0 + BK]
                        vt[:min(BK, sk - k0)] = vf[bi, gi, k0:k0 + BK]
                        s = (qt @ kt.T) * scale
                        if k0 + BK > sk or (causal and k0 + BK - 1 > qw):
                            qi = qw + torch.arange(WG)[:, None]
                            ki = k0 + torch.arange(BK)[None, :]
                            valid = (ki < sk) & ((ki <= qi) | (not causal))
                            s = torch.where(valid, s, tflash.NEG_INF)
                        m_new = torch.maximum(m, s.amax(1))
                        corr = torch.exp(m - m_new)
                        p = torch.exp(s - m_new[:, None])
                        l = l * corr + p.sum(1)
                        p_hi = p.to(torch.bfloat16).float()
                        p_lo = (p - p_hi).to(torch.bfloat16).float()
                        acc = acc * corr[:, None] + p_hi @ vt + p_lo @ vt
                        m = m_new
                    out[bi, hi, qw:qw + n] = (
                        acc / torch.clamp(l, min=1e-30)[:, None])[:n]
    return out.to(q.dtype)


def _flash_transliteration(dtype):
    """The kernel instance a dtype launches, transliterated."""
    return _flash_cuda_tc if dtype == "bfloat16" else _flash_cuda


#: (Sq, the JAX kernel's block): one block, and (260) a Sq that is not a
#: multiple of the bf16 kernel's query or key tile, with several of each
FLASH_SEQS = ((100, 32), (33, 16), (260, 64))


@pytest.fixture(scope="module")
def flash_cases():
    """JAX flash kernel (interpret mode) outputs, shared by the plain and
    the CUDA transliteration tests."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        for h, g in ((4, 4), (8, 2), (4, 1)):
            for sq, block in FLASH_SEQS:
                if sq == 260 and g == 1:
                    continue
                for causal in (True, False):
                    rng = np.random.default_rng(h * 100 + g * 10 + sq)
                    b, d = 2, 32
                    q = _randn(rng, (b, h, sq, d), dtype)
                    k = _randn(rng, (b, g, sq, d), dtype)
                    v = _randn(rng, (b, g, sq, d), dtype)
                    want = jattn_ops.flash_attention(
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal, block, block, True)
                    out[(dtype, h, g, sq, causal)] = (q, k, v, block,
                                                      np.asarray(want))
    return out


FLASH_IDS = [(dt, h, g, sq, c) for dt in ("float32", "bfloat16")
             for h, g in ((4, 4), (8, 2), (4, 1)) for sq in (100, 33)
             for c in (True, False)] + [
    (dt, h, g, 260, c) for dt in ("float32", "bfloat16")
    for h, g in ((4, 4), (8, 2)) for c in (True, False)]


@pytest.mark.parametrize("case", FLASH_IDS, ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_matches_jax_kernel(case, flash_cases):
    dtype = case[0]
    q, k, v, block, want = flash_cases[case]
    tq, tk, tv = _t(q, dtype), _t(k, dtype), _t(v, dtype)
    got = tattn_ops.flash_attention(tq, tk, tv, case[4], block, block)
    assert got.dtype == T_DTYPE[dtype]
    _close(got, want, dtype, "plain")
    _close(_flash_transliteration(dtype)(tq, tk, tv, case[4],
                                         1.0 / q.shape[-1] ** 0.5), want,
           dtype, "CUDA transliteration")


@pytest.mark.parametrize("causal", (True, False))
def test_flash_bf16_p_rounding_within_its_bound(causal):
    """The bf16 kernel's one numerical change: P reaches the second product
    as hi + lo in bf16, so each p_j moves by at most 2^-18 relative (2^-9
    with hi alone), and the output stays within 2^-18 max|v| plus one bf16
    step of o, plus float32 summation in another order (Sk 2^-24 max|v|),
    of the JAX kernel (interpret mode, float32 P); here on a large max|v|
    and a peaked softmax.  That is inside the single-term bound, 2^-9
    max|v| plus one step."""
    rng = np.random.default_rng(29)
    b, h, g, s, d = 1, 4, 2, 200, 32
    q = (3.0 * rng.standard_normal((b, h, s, d))).astype(ml_dtypes.bfloat16)
    k = (3.0 * rng.standard_normal((b, g, s, d))).astype(ml_dtypes.bfloat16)
    v = (100.0 * rng.standard_normal((b, g, s, d))).astype(
        ml_dtypes.bfloat16)
    want = np.asarray(jattn_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, 64, 64,
        True)).astype(np.float32)
    tq, tk, tv = (_t(a, "bfloat16") for a in (q, k, v))
    got = _flash_cuda_tc(tq, tk, tv, causal, 1.0 / d ** 0.5).float().numpy()
    v_max = float(np.abs(v.astype(np.float32)).max())
    top = np.maximum(np.abs(got), np.abs(want))
    step = np.exp2(np.floor(np.log2(np.maximum(top, 1e-30))) - 7)
    bound = (2.0 ** -18 + s * 2.0 ** -24) * v_max + step
    d_got = np.abs(got - want)
    assert (d_got <= bound).all(), float((d_got - bound).max())
    assert (bound <= 2.0 ** -9 * v_max + step).all()


def test_flash_attention_oracle_agrees_at_equal_lengths():
    """The kernel's causal rule and the oracle's offset rule agree at
    Sq == Sk; the port's oracle matches the JAX oracle."""
    rng = np.random.default_rng(5)
    q = _randn(rng, (1, 4, 24, 16))
    k, v = _randn(rng, (1, 2, 24, 16)), _randn(rng, (1, 2, 24, 16))
    want = jattn_ref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True)
    _close(tattn_ref.attention_ref(_t(q), _t(k), _t(v), causal=True), want,
           "float32", "oracle")
    _close(tflash.flash_attention_plain(_t(q), _t(k), _t(v), block_q=8,
                                        block_k=8), want, "float32",
           "plain at Sq == Sk")
    # the oracle's offset rule at Sq < Sk (decode-style suffix queries)
    want = jattn_ref.attention_ref(jnp.asarray(q[:, :, 20:]), jnp.asarray(k),
                                   jnp.asarray(v), causal=True)
    _close(tattn_ref.attention_ref(_t(q[:, :, 20:]), _t(k), _t(v),
                                   causal=True), want, "float32", "offset")


# ---------------------------------------------------------------------------
# flash decode (CUDA)
# ---------------------------------------------------------------------------

def _decode_cuda(q, k, v, lengths, scale):
    """``csrc/flash_decode.cu`` in torch float32, a (slot, head) at a time:
    16 chains (``CHAINS`` of ``decode_chain.cuh``), chain ``i`` walking keys
    ``i, i + 16, ...`` below the clamped length with its own online
    softmax, then the merge; K/V rounded to the query's dtype first."""
    groups = _cu_const(tdecode.CHAIN_SOURCE, "CHAINS")
    b, h, _, d = q.shape
    g, s = k.shape[1], k.shape[2]
    kq, vq = k.to(q.dtype).float(), v.to(q.dtype).float()
    out = torch.full(q.shape, float("nan"))
    for bi in range(b):
        n = min(max(int(lengths[bi]), 0), s)
        for hi in range(h):
            gi = hi // (h // g)
            qv = q[bi, hi, 0].float()
            m = torch.full((groups,), tdecode.NEG_INF)
            l = torch.zeros(groups)
            acc = torch.zeros(groups, d)
            for t0 in range(0, n, groups):
                t = t0 + torch.arange(groups)
                act = t < n
                tc = t.clamp(max=s - 1)
                sc = (kq[bi, gi, tc] @ qv) * scale
                m_new = torch.where(act, torch.maximum(m, sc), m)
                corr = torch.exp(m - m_new)
                p = torch.exp(sc - m_new)
                l = torch.where(act, l * corr + p, l)
                acc = torch.where(act[:, None], acc * corr[:, None]
                                  + p[:, None] * vq[bi, gi, tc], acc)
                m = m_new
            mx = m.max()
            w = torch.exp(m - mx)
            o = (acc * w[:, None]).sum(0) / torch.clamp((l * w).sum(),
                                                        min=1e-30)
            out[bi, hi, 0] = o if mx > 0.5 * tdecode.NEG_INF else 0.0
    return out.to(q.dtype)


DECODE_CASES = [("float32", 128, 64), ("float32", 100, 64),
                ("float32", 512, 512), ("bfloat16", 100, 64),
                ("bfloat16", 512, 512)]


@pytest.mark.parametrize("dtype,s,block_k", DECODE_CASES)
def test_flash_decode_matches_jax_kernel(dtype, s, block_k):
    """Ragged lengths (0, 1, mid, full), garbage in the tail, S not a
    multiple of ``block_k`` in the 100-key cases."""
    rng = np.random.default_rng(s + block_k)
    b, h, g, d = 4, 8, 2, 32
    q = _randn(rng, (b, h, 1, d), dtype)
    k, v = _randn(rng, (b, g, s, d), dtype), _randn(rng, (b, g, s, d), dtype)
    lengths = np.array([0, 1, s // 2 + 3, s], np.int32)
    for i, n in enumerate(lengths):            # garbage past each length
        k[i, :, n:] = 99.0
        v[i, :, n:] = -99.0
    want = np.asarray(jattn_ops.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        block_k=block_k, interpret=True))
    tq, tk, tv = _t(q, dtype), _t(k, dtype), _t(v, dtype)
    tl_ = torch.from_numpy(lengths)
    before = tattn_ops.STATS.snapshot()
    got = tattn_ops.flash_decode(tq, tk, tv, tl_, block_k=block_k)
    assert tattn_ops.STATS.delta(before) == {
        "decode_kernel": 0, "decode_plain": 1, "decode_ref": 0,
        "paged_decode_kernel": 0, "paged_decode_plain": 0,
        "paged_decode_ref": 0}
    cuda = _decode_cuda(tq, tk, tv, tl_, 1.0 / d ** 0.5)
    for out, how in ((got, "plain"), (cuda, "CUDA transliteration")):
        assert out.dtype == T_DTYPE[dtype]
        assert bool(torch.isfinite(out).all())
        assert bool((out[0] == 0).all()), f"{how}: length 0 is not zero"
        _close(out, want, dtype, how)
    _close(tattn_ref.decode_ref(tq, tk, tv, tl_), want, dtype, "oracle")


def test_flash_decode_reads_a_float32_cache_as_the_query_dtype():
    """A float32 cache under a bf16 query: the same bits as casting the
    cache first (the layer's ``cache.astype(q.dtype)``)."""
    rng = np.random.default_rng(9)
    q = _t(_randn(rng, (2, 4, 1, 32), "bfloat16"), "bfloat16")
    k = torch.from_numpy(_randn(rng, (2, 4, 40, 32)))
    v = torch.from_numpy(_randn(rng, (2, 4, 40, 32)))
    lens = torch.tensor([40, 7])
    got = tdecode.flash_decode(q, k, v, lens)
    want = tdecode.flash_decode(q, k.bfloat16(), v.bfloat16(), lens)
    assert torch.equal(got, want)
    assert torch.equal(_decode_cuda(q, k, v, lens, 32 ** -0.5),
                       _decode_cuda(q, k.bfloat16(), v.bfloat16(), lens,
                                    32 ** -0.5))


def test_cuda_wrappers_name_the_tpu_kernels_they_replace():
    for src, fn in ((tflash.SOURCE, "flash.py:flash_attention_fwd"),
                    (tdecode.SOURCE, "decode.py:flash_decode")):
        assert f"repro/kernels/attention/{fn}" in src.read_text()
    assert "repro/kernels/rmsnorm/rmsnorm.py:rmsnorm_fwd" in trms.__doc__
    assert "repro/kernels/swiglu/swiglu.py:swiglu_fwd" in tsw.__doc__


# ---------------------------------------------------------------------------
# head dim 112 (zamba2-7b: 3584 / 32)
# ---------------------------------------------------------------------------

def _tc_halves(d):
    """The 64-column halves of the bf16 kernel's tiles at head dim ``d``
    (``NH`` in the source): one at 64, two up to 128, four at 256."""
    return -(-d // _cu_const(tflash.SOURCE, "HALF"))


def _tc_block_keys(d):
    """Keys a block of the bf16 kernel at head dim ``d`` (``Layout<NH>::BK``
    in the source): ``TC_BK`` up to two halves, ``TC_BK_WIDE`` past."""
    return _cu_const(tflash.SOURCE, "TC_BK_WIDE" if _tc_halves(d) > 2
                     else "TC_BK")


def _tc_steps(d):
    """The k16 steps of Q K^T the bf16 kernel issues at head dim ``d``:
    (half, j) over the tile's ``HALF``-column halves, those whose columns
    all lie at or past ``d`` skipped."""
    half = _cu_const(tflash.SOURCE, "HALF")
    return [(h, j) for h in range(_tc_halves(d)) for j in range(half // 16)
            if h * half + 16 * j < d]


def _tc_written(d):
    """(row, column) -> writes of the bf16 kernel's epilogue over a CTA:
    each warpgroup's 64 rows, a thread's pairs at column ``8 (i >> 2) + 2
    (lane & 3)`` of each half, where it lies below ``d``."""
    half = _cu_const(tflash.SOURCE, "HALF")
    written = {}
    for wg, warp, lane in itertools.product(range(2), range(4), range(32)):
        for i in range(0, 32, 2):
            row = wg * 64 + warp * 16 + lane // 4 + 8 * ((i >> 1) & 1)
            col = 8 * (i >> 2) + 2 * (lane & 3)
            targets = [c for hf in range(_tc_halves(d))
                       if hf * half + col < d
                       for c in (hf * half + col, hf * half + col + 1)]
            for c in targets:
                written[(row, c)] = written.get((row, c), 0) + 1
    return written


@pytest.mark.parametrize("d", tflash.HEAD_DIMS)
def test_flash_tc_zero_fill_and_epilogue_cover_the_head_dim(d):
    """The bf16 kernel's tiles keep ``ceil(d / HALF)`` 64-column halves;
    the tensor map's row is ``d`` elements, so TMA zero-fills columns past
    ``d`` of the last half.  The issued k16 steps cover every column below
    ``d`` and skip only columns at or past it (one of eight at 112, three
    of eight at 80, none at 64, 128 and 256); the row pitch ``2 d`` bytes
    is a multiple of 16; the epilogue writes every (row, column < d) of the
    CTA's 128 rows once and nothing past ``d``; the CTA's shared memory
    (Q, two K + V stages of :func:`_tc_block_keys` keys, barriers and 1 KB
    of alignment) fits the H100's 232,448 bytes."""
    tc_d = _cu_const(tflash.SOURCE, "TC_D")
    half = _cu_const(tflash.SOURCE, "HALF")
    bq = _cu_const(tflash.SOURCE, "TC_BQ")
    stages = _cu_const(tflash.SOURCE, "TC_STAGES")
    nh = _tc_halves(d)
    assert tc_d == 4 * half and (2 * d) % 16 == 0
    assert d == half if nh == 1 else (nh - 1) * half < d <= tc_d
    smem = (1024 + nh * bq * half * 2
            + stages * 2 * nh * _tc_block_keys(d) * half * 2
            + 8 * (1 + 2 * stages))
    assert smem <= 232448
    steps = _tc_steps(d)
    cols = {h * half + 16 * j + c for h, j in steps for c in range(16)}
    assert set(range(d)) <= cols and all(c < nh * half for c in cols)
    skipped = {h * half + 16 * j + c for h in range(nh)
               for j in range(half // 16) for c in range(16)} - cols
    assert all(c >= d for c in skipped)
    assert len(steps) == -(-d // 16)
    written = _tc_written(d)
    assert set(written) == {(r, c) for r in range(bq) for c in range(d)}
    assert set(written.values()) == {1}


def test_flash_tc_one_half_walk_at_head_dim_64():
    """At D = 64 the bf16 kernel's tiles are one swizzled half: Q K^T takes
    the four k16 steps of that half (keys 0-63 and 64-127 of the block
    into two chains), P V one n64 chain, and the epilogue the first half
    alone; a ring stage is one K and one V half, so the shared memory of
    a CTA is half the two-half layout's tiles.  The walk over the tiles as
    the kernel holds them (no column padding) equals the Pallas kernel."""
    text = tflash.SOURCE.read_text()
    half = _cu_const(tflash.SOURCE, "HALF")
    bq = _cu_const(tflash.SOURCE, "TC_BQ")
    bk = _cu_const(tflash.SOURCE, "TC_BK")
    stages = _cu_const(tflash.SOURCE, "TC_STAGES")
    assert _tc_halves(64) == 1 and _tc_steps(64) == [(0, j) for j in
                                                      range(4)]
    assert _tc_block_keys(64) == bk
    # P V runs one chain a half, the epilogue writes a half below D only
    assert "for (int hf = 0; hf < NH; ++hf)\n        mma_rs(oc[hf]" in text
    assert "if (hf * HALF + col < D)" in text
    # Layout<NH>::SMEM: 1 KB of alignment slack, Q, the ring, the barriers
    smem = {nh: 1024 + nh * bq * half * 2 + stages * 2 * nh * bk * half * 2
            + 8 * (1 + 2 * stages) for nh in (1, 2)}
    assert smem[1] < smem[2] <= 232448 and smem[1] == 82984
    rng = np.random.default_rng(64)
    b, h, g, s, d = 1, 4, 2, 200, 64
    q = _randn(rng, (b, h, s, d), "bfloat16")
    k, v = (_randn(rng, (b, g, s, d), "bfloat16") for _ in range(2))
    want = np.asarray(jattn_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, 64, 64, True))
    got = _flash_cuda_tc(*(_t(a, "bfloat16") for a in (q, k, v)), True,
                         1.0 / d ** 0.5)
    assert set(_tc_written(d)) == {(r, c) for r in range(bq)
                                   for c in range(d)}
    _close(got, want, "bfloat16", "one-half walk")


def _flash_at_head_dim(d, dtype, causal, seed, h=8, g=2, s=150):
    """The plain version and the transliteration of the instance the dtype
    launches at head dim ``d`` against the Pallas kernel (interpret mode),
    GQA ``h``/``g`` (8/2 by default), a sequence not a multiple of any
    tile.  The bf16 walk runs on tiles zero-filled to its halves' columns,
    as TMA fills them, and the columns past ``d`` come out exactly zero
    (computed, never written)."""
    rng = np.random.default_rng(seed)
    b = 1
    q = _randn(rng, (b, h, s, d), dtype)
    k, v = _randn(rng, (b, g, s, d), dtype), _randn(rng, (b, g, s, d), dtype)
    want = np.asarray(jattn_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, 32, 32,
        True))
    tq, tk, tv = _t(q, dtype), _t(k, dtype), _t(v, dtype)
    assert tflash.supports_head_dim(d) and not tflash.supports_head_dim(136)
    got = tattn_ops.flash_attention(tq, tk, tv, causal, 32, 32)
    _close(got, want, dtype, "plain")
    scale = 1.0 / d ** 0.5
    if dtype == "bfloat16":
        cols = _tc_halves(d) * _cu_const(tflash.SOURCE, "HALF")
        pad = [torch.nn.functional.pad(t, (0, cols - d)) for t in (tq, tk,
                                                                   tv)]
        full = _flash_cuda_tc(*pad, causal, scale)
        assert bool((full[..., d:] == 0).all())
        cuda = full[..., :d]
    else:
        cuda = _flash_cuda(tq, tk, tv, causal, scale)
    _close(cuda, want, dtype, "CUDA transliteration")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_at_head_dim_112_matches_jax_kernel(dtype, causal):
    """At D = 112 (two halves, the second zero-filled past 112)."""
    _flash_at_head_dim(112, dtype, causal, 112 + causal)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_at_head_dim_64_matches_jax_kernel(dtype, causal):
    """At D = 64 (granite-moe-3b's 1536 / 24: one half, no zero fill)."""
    _flash_at_head_dim(64, dtype, causal, 64 + causal)


def _decode_at_head_dim(d, dtype, seed, g=2):
    """Ragged lengths (0, 1, mid, full) with garbage past them, at head dim
    ``d`` and 8 query heads over ``g``: the plain version and the
    transliteration against the Pallas kernel, exact zeros at length 0."""
    rng = np.random.default_rng(seed)
    b, h, s = 4, 8, 100
    q = _randn(rng, (b, h, 1, d), dtype)
    k, v = _randn(rng, (b, g, s, d), dtype), _randn(rng, (b, g, s, d), dtype)
    lengths = np.array([0, 1, 53, s], np.int32)
    for i, n in enumerate(lengths):
        k[i, :, n:] = 99.0
        v[i, :, n:] = -99.0
    want = np.asarray(jattn_ops.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        block_k=32, interpret=True))
    tq, tk, tv = _t(q, dtype), _t(k, dtype), _t(v, dtype)
    tl_ = torch.from_numpy(lengths)
    assert tdecode.supports_head_dim(d) and not tdecode.supports_head_dim(96)
    for out, how in ((tattn_ops.flash_decode(tq, tk, tv, tl_, block_k=32),
                      "plain"),
                     (_decode_cuda(tq, tk, tv, tl_, 1.0 / d ** 0.5),
                      "CUDA transliteration")):
        assert out.dtype == T_DTYPE[dtype] and bool(torch.isfinite(out).all())
        assert bool((out[0] == 0).all()), how
        _close(out, want, dtype, how)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_at_head_dim_112_matches_jax_kernel(dtype):
    """At D = 112: 14 of the 16 lanes live."""
    _decode_at_head_dim(112, dtype, 1120)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_at_head_dim_64_matches_jax_kernel(dtype):
    """At D = 64: 8 of the 16 lanes live, the others read nothing and
    hold exact zeros."""
    _decode_at_head_dim(64, dtype, 640)



# ---------------------------------------------------------------------------
# head dims 80 (hubert-xlarge: 1280 / 16) and 256 (paligemma-3b: 2048 / 8)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_at_head_dim_80_matches_jax_kernel(dtype, causal):
    """At D = 80 (two halves, the second zero-filled past 80, three of its
    k16 steps skipped); hubert's encoder runs it non-causal."""
    _flash_at_head_dim(80, dtype, causal, 80 + causal, h=4, g=4, s=130)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_at_head_dim_256_matches_jax_kernel(dtype):
    """At D = 256, causal, 8 query heads over 1 KV head (paligemma's): four
    halves, 64-key blocks in the bf16 instance."""
    assert _tc_halves(256) == 4 and _tc_block_keys(256) == 64
    _flash_at_head_dim(256, dtype, True, 256, h=8, g=1, s=130)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_at_head_dim_256_matches_jax_kernel(dtype):
    """At D = 256, 8 query heads over 1: 16 elements a lane, every lane
    live."""
    _decode_at_head_dim(256, dtype, 2560, g=1)
