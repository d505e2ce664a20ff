"""The port's SSD kernels (``repro_torch.kernels.ssd``) against the JAX
package's on the CPU: the sequential oracle ``ssd_ref``, the chunked path
``ssd_chunked``, the dispatch ``ops.ssd`` (the port's CPU path runs the
kernel's plain version, JAX its Pallas kernel in interpret mode) and the
intra-chunk block itself (``ssd_intra_chunk_ref`` against the Pallas
``ssd_intra_chunk``), with sequences that are and are not whole chunks, in
float32 and bf16; the decode step rolled over a sequence; gradients of
``ops.ssd`` against ``jax.grad`` of the JAX ``ssd_chunked``; and
``_intra_chunk_cuda``, a transliteration of ``csrc/ssd_intra_chunk.cu``
(its grid order, offsets and select), against the plain version.

Tolerances: float32 within 1e-5 of max|want| (the same float32 products
summed in another order); bf16 outputs within one bf16 step of max|want|
(2^-7 of it: both cast float32 values 1e-6 apart, which may round one
step apart); gradients within 1e-4 of each gradient's max|g| (float32 sums
over the whole sequence in another order).  The CUDA kernel itself runs
only on the card (``chip_smoke.py`` phase 20)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.ssd import chunked as jchunked
from repro.kernels.ssd import ops as jops
from repro.kernels.ssd import ref as jref
from repro.kernels.ssd import ssd as jssd
from repro_torch.kernels.ssd import chunked as tchunked
from repro_torch.kernels.ssd import ops as tops
from repro_torch.kernels.ssd import ref as tref
from repro_torch.kernels.ssd import ssd as tssd

torch.set_num_threads(1)

TOL = 1e-5
BF16_STEP = 2.0 ** -7
GRAD_TOL = 1e-4
CHUNK = 16
B, H, P, N = 2, 3, 8, 5


def _inputs(s, seed, dt_range=(0.01, 0.5), a_range=(0.5, 2.0)):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal((B, s, H, P)).astype(np.float32),
        dt=rng.uniform(*dt_range, (B, s, H)).astype(np.float32),
        A=-rng.uniform(*a_range, (H,)).astype(np.float32),
        B=rng.standard_normal((B, s, N)).astype(np.float32),
        C=rng.standard_normal((B, s, N)).astype(np.float32),
        D=rng.uniform(0.5, 1.5, (H,)).astype(np.float32))


def _cast(arrs, dtype):
    """x, dt, B, C in ``dtype`` (numpy: ml_dtypes bf16); A and D float32,
    as the mamba layer keeps them."""
    if dtype == "float32":
        return arrs
    return {k: (v.astype(ml_dtypes.bfloat16) if k in ("x", "dt", "B", "C")
                else v) for k, v in arrs.items()}


def _torch(arrs):
    return {k: (torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
                if v.dtype == ml_dtypes.bfloat16 else torch.from_numpy(v))
            for k, v in arrs.items()}


def _jax(arrs):
    return {k: jnp.asarray(v) for k, v in arrs.items()}


def _close(got, want, rel, what):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(
        got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max|d| {err:.3e} > {rel} x {scale:.3e}"


ORDER = ("x", "dt", "A", "B", "C", "D")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [48, 50])
def test_ssd_paths_match_jax(s, dtype):
    arrs = _cast(_inputs(s, seed=s), dtype)
    t, j = _torch(arrs), _jax(arrs)
    targs = [t[k] for k in ORDER]
    jargs = [j[k] for k in ORDER]
    rel = TOL if dtype == "float32" else BF16_STEP
    got = tref.ssd_ref(*targs)
    assert got.dtype == targs[0].dtype
    _close(got, jref.ssd_ref(*jargs), rel, "ssd_ref")
    _close(tchunked.ssd_chunked(*targs, chunk=CHUNK),
           jchunked.ssd_chunked(*jargs, chunk=CHUNK), rel, "ssd_chunked")
    tops.STATS.reset()
    _close(tops.ssd(*targs, CHUNK), jops.ssd(*jargs, CHUNK, True), rel,
           "ops.ssd")
    assert tops.STATS.counts == {"kernel": 0, "plain": 1}
    # the three paths agree with the sequential oracle
    _close(tops.ssd(*targs, CHUNK), jref.ssd_ref(*jargs), rel, "vs oracle")


def _intra_operands(nc, L, seed, dt_scale=0.2):
    rng = np.random.default_rng(seed)
    dtx = rng.standard_normal((B, H, nc, L, P)).astype(np.float32)
    dta = -dt_scale * rng.uniform(0.1, 1.0, (B, H, nc, L, 1))
    a = np.cumsum(dta, axis=3).astype(np.float32)
    Bm = rng.standard_normal((B, nc, L, N)).astype(np.float32)
    Cm = rng.standard_normal((B, nc, L, N)).astype(np.float32)
    return dtx, a, Bm, Cm


@pytest.mark.parametrize("nc,L", [(3, 16), (2, 64)])
def test_intra_chunk_plain_version_matches_pallas(nc, L):
    ops_ = _intra_operands(nc, L, seed=L)
    jy, js = jssd.ssd_intra_chunk(*(jnp.asarray(o) for o in ops_),
                                  interpret=True)
    ty, ts = tssd.ssd_intra_chunk(*(torch.from_numpy(o) for o in ops_))
    _close(ty, jy, TOL, "y_intra")
    _close(ts, js, TOL, "S")


def test_decode_step_rolled_matches_chunked():
    arrs = _inputs(37, seed=5)
    t = _torch(arrs)
    state = torch.zeros((B, H, N, P))
    ys = []
    for i in range(37):
        state, y = tchunked.ssd_decode_step(
            state, t["x"][:, i], t["dt"][:, i], t["A"], t["B"][:, i],
            t["C"][:, i], t["D"])
        ys.append(y)
    want = tchunked.ssd_chunked(*(t[k] for k in ORDER), chunk=CHUNK)
    _close(torch.stack(ys, 1), want.numpy(), TOL, "decode rolled")
    jstate, jy = jchunked.ssd_decode_step(
        jnp.zeros((B, H, N, P)), *(jnp.asarray(arrs[k][:, 0]) if k in
                                   ("x", "dt", "B", "C") else
                                   jnp.asarray(arrs[k]) for k in
                                   ("x", "dt", "A", "B", "C", "D")))
    tstate, ty = tchunked.ssd_decode_step(
        torch.zeros((B, H, N, P)), t["x"][:, 0], t["dt"][:, 0], t["A"],
        t["B"][:, 0], t["C"][:, 0], t["D"])
    _close(tstate, jstate, TOL, "decode state")
    _close(ty, jy, TOL, "decode y")


def _grads_jax(arrs, w, chunk):
    def loss(*args):
        return jnp.sum(jchunked.ssd_chunked(*args, chunk=chunk) * w)
    return jax.grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(arrs[k]) for k in ORDER))


def _grads_torch(arrs, w, chunk):
    leaves = [torch.from_numpy(arrs[k]).requires_grad_() for k in ORDER]
    y = tops.ssd(*leaves, chunk)
    return torch.autograd.grad((y * torch.from_numpy(w)).sum(), leaves)


@pytest.mark.parametrize("s", [48, 50])
def test_ssd_gradients_match_jax(s):
    arrs = _inputs(s, seed=10 + s)
    w = np.random.default_rng(s).standard_normal(
        (B, s, H, P)).astype(np.float32)
    for k, g, jg in zip(ORDER, _grads_torch(arrs, w, CHUNK),
                        _grads_jax(arrs, w, CHUNK)):
        assert np.isfinite(np.asarray(jg)).all(), k
        _close(g, jg, GRAD_TOL, f"d{k}")


def test_overflowing_decay_gradient_is_finite_where_jax_is_nan():
    """chunk 64, A = -1, dt = 2: above the diagonal a_i - a_j reaches 126,
    past float32 ``exp``'s 88.  The JAX ``ssd_chunked`` takes ``exp`` over
    the whole square before its select, so its gradient in dt is NaN (a
    defect of the reference, kept there); the port masks the exponent
    first: its forward equals the reference's and its gradient is
    finite."""
    s, chunk = 64, 64
    arrs = _inputs(s, seed=3)
    arrs["A"] = -np.ones((H,), np.float32)
    arrs["dt"] = np.full((B, s, H), 2.0, np.float32)
    w = np.random.default_rng(0).standard_normal(
        (B, s, H, P)).astype(np.float32)
    jg = _grads_jax(arrs, w, chunk)
    assert np.isnan(np.asarray(jg[1])).any(), "the reference defect is gone"
    for k, g in zip(ORDER, _grads_torch(arrs, w, chunk)):
        assert torch.isfinite(g).all(), k
    t, j = _torch(arrs), _jax(arrs)
    _close(tops.ssd(*(t[k] for k in ORDER), chunk),
           jchunked.ssd_chunked(*(j[k] for k in ORDER), chunk=chunk), TOL,
           "forward")
    _close(tops.ssd(*(t[k] for k in ORDER), chunk),
           jref.ssd_ref(*(j[k] for k in ORDER)), TOL, "forward vs oracle")


# -- csrc/ssd_intra_chunk.cu, transliterated --------------------------------

def _intra_chunk_cuda(dtx, a, Bm, Cm):
    """The kernel on flat buffers: one CTA per grid index, head fastest
    (``h = blk % H``, ``bc = blk / H``), the cell's offsets into dtx, a, y
    and S (``((b H + h) NC + c)``) and into B and C (``bc``); the scores
    computed for the whole tile and selected (``j <= i`` takes
    ``G exp(a_i - a_j)``, every other entry 0, no ``exp`` evaluated there);
    the state decay ``exp(a_{L-1} - a_l)`` applied to B before the
    product."""
    b, h, nc, L, p = dtx.shape
    n = Bm.shape[-1]
    f_dtx, f_a = dtx.reshape(-1), a.reshape(-1)
    f_b, f_c = Bm.reshape(-1), Cm.reshape(-1)
    y = np.full(b * h * nc * L * p, np.nan, np.float32)
    S = np.full(b * h * nc * n * p, np.nan, np.float32)
    for blk in range(b * h * nc):
        hh, bc = blk % h, blk // h
        c, bb = bc % nc, bc // nc
        cell = (bb * h + hh) * nc + c
        xs = f_dtx[cell * L * p:(cell + 1) * L * p].reshape(L, p)
        av = f_a[cell * L:(cell + 1) * L]
        bs = f_b[bc * L * n:(bc + 1) * L * n].reshape(L, n)
        cs = f_c[bc * L * n:(bc + 1) * L * n].reshape(L, n)
        g = cs @ bs.T
        ms = np.zeros((L, L), np.float32)
        for i in range(L):
            ms[i, :i + 1] = g[i, :i + 1] * np.exp(av[i] - av[:i + 1])
        y[cell * L * p:(cell + 1) * L * p] = (ms @ xs).reshape(-1)
        ds = np.exp(av[L - 1] - av)
        S[cell * n * p:(cell + 1) * n * p] = (
            (bs * ds[:, None]).T @ xs).reshape(-1)
    return y.reshape(b, h, nc, L, p), S.reshape(b, h, nc, n, p)


@pytest.mark.parametrize("overflow", [False, True])
def test_kernel_transliteration_matches_plain_version(overflow):
    nc, L = 3, 64
    dtx, a, Bm, Cm = _intra_operands(nc, L, seed=7,
                                     dt_scale=4.0 if overflow else 0.2)
    if overflow:        # above the diagonal a_i - a_j passes 88
        assert float(a[..., 0, 0].max() - a[..., -1, 0].min()) > 88
    y, S = _intra_chunk_cuda(dtx, a, Bm, Cm)
    ty, ts = tssd.ssd_intra_chunk_ref(*(torch.from_numpy(o)
                                        for o in (dtx, a, Bm, Cm)))
    _close(ty, y, TOL, "y_intra")
    _close(ts, S, TOL, "S")


def test_kernel_wrapper_checks_shapes_and_devices():
    dtx, a, Bm, Cm = (torch.from_numpy(o) for o in _intra_operands(2, 16, 0))
    with pytest.raises(ValueError, match="ssd_intra_chunk"):
        tssd.ssd_intra_chunk(dtx, a[..., :8, :], Bm, Cm)
    before = tssd.ssd_intra_chunk.launches
    tssd.ssd_intra_chunk(dtx, a, Bm, Cm)            # CPU: the plain version
    assert tssd.ssd_intra_chunk.launches == before
    assert tssd.SOURCE.is_file() and tssd.SOURCE.suffix == ".cu"
