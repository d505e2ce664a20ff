"""Dense MLP blocks (gated and plain) and norm parameters, ported from
``repro/layers/dense.py``.  The matmuls are ``torch.matmul`` (the JAX
package leaves them to XLA), in the promoted dtype of activation and
weight (:func:`repro_torch.layers.base.matmul`); the chains between them go
through :mod:`repro_torch.layers.stacks`."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, RuntimeConfig
from repro_torch.distributed import collectives
from repro_torch.layers import base, stacks

GATED_ACTS = ("silu", "gelu")


def is_gated(cfg: ModelConfig) -> bool:
    # llama/qwen/deepseek/gemma use gated MLPs; hubert (encoder) and
    # minitron (squared-relu) use plain two-matmul MLPs.
    return cfg.act in GATED_ACTS and not cfg.is_encoder


def init(g: torch.Generator, cfg: ModelConfig, n_layers: int,
         dtype: torch.dtype, *, d_ff: int | None = None) -> dict:
    """The MLP parameters of ``n_layers`` layers, stacked on a leading
    layer axis; ``d_ff`` replaces ``cfg.d_ff`` (an MoE's shared expert)."""
    d, f, L = cfg.d_model, d_ff or cfg.d_ff, n_layers
    if is_gated(cfg):
        return {
            "wg": base.normal(g, (L, d, f), fan_in=d, dtype=dtype),
            "wu": base.normal(g, (L, d, f), fan_in=d, dtype=dtype),
            "wd": base.normal(g, (L, f, d), fan_in=f, dtype=dtype),
        }
    zeros = dict(dtype=dtype, device=g.device)
    return {
        "wu": base.normal(g, (L, d, f), fan_in=d, dtype=dtype),
        "bu": torch.zeros((L, f), **zeros),
        "wd": base.normal(g, (L, f, d), fan_in=f, dtype=dtype),
        "bd": torch.zeros((L, d), **zeros),
    }


def param_axes(cfg: ModelConfig) -> dict:
    """Logical axes of one layer's :func:`init` leaves (the JAX package's
    ``boxed`` annotations): ``d_model`` over ``fsdp``, ``d_ff`` over
    ``ffn``; the plain MLP's output bias replicated."""
    if is_gated(cfg):
        return {"wg": ("fsdp", "ffn"), "wu": ("fsdp", "ffn"),
                "wd": ("ffn", "fsdp")}
    return {"wu": ("fsdp", "ffn"), "bu": ("ffn",), "wd": ("ffn", "fsdp"),
            "bd": (None,)}


def apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
          rt: RuntimeConfig) -> torch.Tensor:
    """The MLP.  Under ``rt.tp_axis`` the parameters hold this rank's slice
    of the ``d_ff`` columns (``wd`` its rows): the input enters through
    ``copy_to_model``, the down-projection's partial sums leave through
    ``reduce_from_model``, and the replicated bias ``bd`` is added once,
    after the reduction."""
    tp = rt.tp_axis
    if tp is not None:
        x = collectives.copy_to_model(x, tp)
    if "wg" in params:
        gate = base.matmul(x, params["wg"])
        up = base.matmul(x, params["wu"])
        h = stacks.glu(gate, up, act=cfg.act, mode=rt.mode)
        out = base.matmul(h, params["wd"])
        return out if tp is None else collectives.reduce_from_model(out, tp)
    h = base.matmul(x, params["wu"]) + params["bu"]
    h = stacks.activation(h, act=cfg.act, mode=rt.mode)
    out = base.matmul(h, params["wd"])
    if tp is not None:
        out = collectives.reduce_from_model(out, tp)
    return out + params["bd"]


def norm_axes(cfg: ModelConfig) -> dict:
    """Logical axes of a norm's leaves: replicated."""
    return ({"scale": (None,), "bias": (None,)} if cfg.norm == "layer"
            else {"scale": (None,)})


def norm_init(cfg: ModelConfig, n_layers: int | None, dtype: torch.dtype,
              dev: torch.device) -> dict:
    """Norm scale (and, for layer norm, bias): ones and zeros, stacked on a
    leading layer axis unless ``n_layers`` is None."""
    shape = ((cfg.d_model,) if n_layers is None
             else (n_layers, cfg.d_model))
    p = {"scale": torch.ones(shape, dtype=dtype, device=dev)}
    if cfg.norm == "layer":
        p["bias"] = torch.zeros(shape, dtype=dtype, device=dev)
    return p
