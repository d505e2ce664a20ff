"""Mamba2 (SSD) mixer layer, ported from ``repro/layers/mamba2.py``:
projections, causal depthwise conv, SSD scan, gated RMSNorm,
out-projection.

The gated-norm epilogue ``y = rmsnorm(y * silu(z)) * scale`` is a BrainSlug
stack (silu -> mul -> row norm) and runs through the fused dispatcher (the
Triton rows kernel in ``brainslug`` mode); the SSD scan goes to the
intra-chunk CUDA kernel in ``brainslug`` mode (:func:`repro_torch.kernels.
ssd.ops.ssd`) and to the plain chunked path in ``xla`` and ``barrier``.

Parameters carry a leading layer axis as the JAX package's stacked tree
does; :func:`apply` and :func:`decode` take one layer's slice.  Decode
updates the layer's :class:`MambaCache` in place (the JAX package returns
a new one) and returns the same object.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RuntimeConfig
from repro_torch.core import ir
from repro_torch.kernels.fused_stack import ops as fused_ops
from repro_torch.kernels.ssd import chunked as ssd_chunked
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.layers import base


def init(g: torch.Generator, cfg: ModelConfig, n_layers: int,
         dtype: torch.dtype) -> dict:
    """The mixer parameters of ``n_layers`` layers, stacked on a leading
    layer axis, with the JAX package's tree, shapes, dtypes and scales:
    ``A_log`` (zeros, so A = -1) and ``D`` (ones) stay float32."""
    d, di, n, h, cw, L = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                          cfg.ssm_heads, cfg.ssm_conv_width, n_layers)
    dev = g.device
    conv = dict(scale=1.0 / cw ** 0.5, dtype=dtype)
    return {
        "wz": base.normal(g, (L, d, di), fan_in=d, dtype=dtype),
        "wx": base.normal(g, (L, d, di), fan_in=d, dtype=dtype),
        "wB": base.normal(g, (L, d, n), fan_in=d, dtype=dtype),
        "wC": base.normal(g, (L, d, n), fan_in=d, dtype=dtype),
        "wdt": base.normal(g, (L, d, h), fan_in=d, dtype=dtype),
        "dt_bias": torch.zeros((L, h), dtype=dtype, device=dev),
        "conv_x": base.normal(g, (L, cw, di), **conv),
        "conv_B": base.normal(g, (L, cw, n), **conv),
        "conv_C": base.normal(g, (L, cw, n), **conv),
        "A_log": torch.zeros((L, h), dtype=torch.float32, device=dev),
        "D": torch.ones((L, h), dtype=torch.float32, device=dev),
        "norm_scale": torch.ones((L, di), dtype=dtype, device=dev),
        "wo": base.normal(g, (L, di, d), scale=1.0 / di ** 0.5, dtype=dtype),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, with no threshold (unlike
    ``F.softplus``)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: (B, S, C); w: (cw, C).  Tap by tap in
    x's dtype, as the JAX package sums it (each product and each partial
    sum rounds in a bf16 model)."""
    cw = w.shape[0]
    s = x.shape[1]
    xp = F.pad(x, (0, 0, cw - 1, 0))
    y = torch.zeros_like(x)
    for i in range(cw):
        y = y + xp[:, i: i + s, :] * w[i]
    return y


@functools.lru_cache(maxsize=None)
def _gated_norm_program(eps: float) -> ir.StackProgram:
    return ir.StackProgram(
        name="gated_rmsnorm", inputs=("y", "z"), outputs=("o",),
        layout="rows",
        ops=(
            ir.OpNode(ir.OpKind.EW_UNARY, "gate_act", ("z",), "g", fn="silu"),
            ir.OpNode(ir.OpKind.EW_BINARY, "gate_mul", ("y", "g"), "m",
                      fn="mul"),
            ir.OpNode(ir.OpKind.ROW_NORM, "norm", ("m",), "o",
                      params=("scale",), attrs={"norm": "rms", "eps": eps}),
        ))


def _gated_norm(params: dict, y: torch.Tensor, z: torch.Tensor,
                rt: RuntimeConfig) -> torch.Tensor:
    return fused_ops.fused_stack_apply(
        _gated_norm_program(1e-6), {"y": y, "z": z},
        {"scale": params["norm_scale"]}, mode=rt.mode)["o"]


def _ssd_dispatch(xs, dt, A, B, C, D, rt: RuntimeConfig) -> torch.Tensor:
    if rt.mode == "brainslug":
        return ssd_ops.ssd(xs, dt, A, B, C, D, rt.ssd_chunk)
    return ssd_chunked.ssd_chunked(xs, dt, A, B, C, D, chunk=rt.ssd_chunk)


def _dt(params: dict, x: torch.Tensor) -> torch.Tensor:
    return softplus((x @ params["wdt"]).float()
                    + params["dt_bias"].float())


def apply(params: dict, x: torch.Tensor, cfg: ModelConfig, rt: RuntimeConfig
          ) -> torch.Tensor:
    """Full-sequence mixer.  x: (B, S, D)."""
    b, s, _ = x.shape
    h, p = cfg.ssm_heads, cfg.ssm_head_dim
    z = x @ params["wz"]
    xs = x @ params["wx"]
    Bc = x @ params["wB"]
    Cc = x @ params["wC"]
    dt = _dt(params, x)

    xs = F.silu(_causal_conv(xs, params["conv_x"]))
    Bc = F.silu(_causal_conv(Bc, params["conv_B"]))
    Cc = F.silu(_causal_conv(Cc, params["conv_C"]))

    A = -torch.exp(params["A_log"])
    y = _ssd_dispatch(xs.reshape(b, s, h, p), dt, A, Bc, Cc, params["D"], rt)
    y = y.reshape(b, s, cfg.d_inner)
    return _gated_norm(params, y, z, rt) @ params["wo"]


# ---------------------------------------------------------------------------
# Decode (recurrent) path
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MambaCache:
    conv: torch.Tensor      # (..., B, cw-1, di + 2n): rolling pre-conv inputs
    state: torch.Tensor     # (..., B, H, N, P) float32 SSM state


def init_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
               *, n_layers: int, dev: torch.device) -> MambaCache:
    """``n_layers`` layers' caches, stacked on a leading layer axis: conv
    ``(L, B, cw-1, di+2n)`` in ``dtype``, state ``(L, B, H, N, P)`` in
    float32."""
    return MambaCache(
        conv=torch.zeros((n_layers, batch, cfg.ssm_conv_width - 1,
                          cfg.d_inner + 2 * cfg.ssm_state), dtype=dtype,
                         device=dev),
        state=torch.zeros((n_layers, batch, cfg.ssm_heads, cfg.ssm_state,
                           cfg.ssm_head_dim), dtype=torch.float32,
                          device=dev))


def decode(params: dict, x_t: torch.Tensor, cache: MambaCache,
           cfg: ModelConfig, rt: RuntimeConfig, *,
           active: torch.Tensor | None = None
           ) -> tuple[torch.Tensor, MambaCache]:
    """One recurrent step.  x_t: (B, 1, D); ``cache`` one layer's.

    ``active`` (B,) bool freezes inactive slots' recurrent state (conv
    window and SSM state), the mamba analogue of not advancing a KV cache.
    The cache is updated in place and returned."""
    b = x_t.shape[0]
    h, p, n, di = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                   cfg.d_inner)
    xt = x_t[:, 0]
    z = xt @ params["wz"]
    xs = xt @ params["wx"]
    Bc = xt @ params["wB"]
    Cc = xt @ params["wC"]
    dt = _dt(params, xt)

    new_in = torch.cat([xs, Bc, Cc], dim=-1)                  # (B, di+2n)
    window = torch.cat([cache.conv.to(new_in.dtype), new_in[:, None]], dim=1)
    w_all = torch.cat([params["conv_x"], params["conv_B"], params["conv_C"]],
                      dim=-1)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", window, w_all))
    xs_c, B_c, C_c = torch.split(conv_out, [di, n, n], dim=-1)

    A = -torch.exp(params["A_log"])
    state, y = ssd_chunked.ssd_decode_step(
        cache.state, xs_c.reshape(b, h, p), dt, A, B_c, C_c, params["D"])
    y = y.reshape(b, di)

    out = _gated_norm(params, y[:, None], z[:, None], rt)
    new_conv = window[:, 1:].to(cache.conv.dtype)
    if active is not None:
        new_conv = torch.where(active[:, None, None], new_conv, cache.conv)
        state = torch.where(active[:, None, None, None], state, cache.state)
    cache.conv.copy_(new_conv)
    cache.state.copy_(state)
    return (out[:, 0] @ params["wo"])[:, None], cache
