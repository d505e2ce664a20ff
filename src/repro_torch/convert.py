"""Weight carry-over from numpy arrays (for example the JAX package's), and
gradients back to numpy under the same names.

The port keeps the JAX package's layouts (NHWC activations, HWIO conv
weights, ``(C,)`` per-channel vectors, the LM's nested parameter tree with
layer-stacked blocks), so carrying weights over is a dtype and device move,
with shape checks.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.layers import base


def params_from_numpy(params: Mapping[str, np.ndarray],
                      device: torch.device | str,
                      *, like: Mapping[str, torch.Tensor] | None = None,
                      dtype: torch.dtype = torch.float32
                      ) -> dict[str, torch.Tensor]:
    """``params`` as contiguous ``dtype`` tensors on ``device``.

    With ``like`` (for example the port's own parameters of the same
    network), the key sets must be equal and every shape must match."""
    if like is not None and set(params) != set(like):
        raise ValueError(f"parameter names differ: only in params "
                         f"{sorted(set(params) - set(like))}, only in like "
                         f"{sorted(set(like) - set(params))}")
    out: dict[str, torch.Tensor] = {}
    for name, value in params.items():
        arr = np.asarray(value)
        if like is not None and tuple(arr.shape) != tuple(like[name].shape):
            raise ValueError(f"{name!r}: shape {tuple(arr.shape)} != "
                             f"{tuple(like[name].shape)}")
        out[name] = torch.tensor(arr, dtype=dtype, device=device)
    return out


def grads_to_numpy(grads: Mapping[str, torch.Tensor],
                   *, like: Mapping[str, object] | None = None
                   ) -> dict[str, np.ndarray]:
    """The port's gradients (a dict of tensors keyed by parameter name, or
    the LM's nested tree) as float32 numpy arrays under the same names, the
    JAX package's, so two gradient trees compare name by name.  With
    ``like`` (for example the JAX parameters), the key sets and shapes must
    match at every level."""
    if like is not None and set(grads) != set(like):
        raise ValueError(f"gradient names differ: only in grads "
                         f"{sorted(set(grads) - set(like))}, only in like "
                         f"{sorted(set(like) - set(grads))}")
    out: dict = {}
    for name, g in grads.items():
        if isinstance(g, Mapping):           # a nested (LM) tree
            out[name] = grads_to_numpy(
                g, like=None if like is None else like[name])
            continue
        arr = g.detach().to("cpu", torch.float32).numpy()
        if like is not None and tuple(arr.shape) != tuple(np.shape(like[name])):
            raise ValueError(f"{name!r}: shape {tuple(arr.shape)} != "
                             f"{tuple(np.shape(like[name]))}")
        out[name] = arr
    return out


def lm_params_from_numpy(tree: Mapping[str, object],
                         device: torch.device | str) -> dict:
    """A nested LM parameter tree of numpy arrays (the JAX package's, with
    its stacked ``blocks/sub0/...`` layout) as tensors on ``device`` under
    the same names and shapes.  bfloat16 leaves (``ml_dtypes.bfloat16`` in
    numpy) go through float32, which holds every bf16 value exactly, then
    to ``torch.bfloat16``; float32 and integer leaves keep their dtype."""
    out: dict = {}
    for name, value in tree.items():
        if isinstance(value, Mapping):
            out[name] = lm_params_from_numpy(value, device)
            continue
        arr = np.asarray(value)
        if arr.dtype.name == "bfloat16":
            out[name] = torch.from_numpy(arr.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        else:
            out[name] = torch.tensor(arr, device=device)     # a copy
    return out


def opt_state_from_numpy(state: Mapping[str, object],
                         device: torch.device | str) -> dict:
    """AdamW state of numpy arrays (the JAX package's ``adamw.init`` /
    ``update`` output, or a checkpoint it wrote: ``{"mu": tree, "nu": tree,
    "count": scalar}``) as the port's: float32 moment trees and an int32
    scalar ``count`` on ``device``."""
    out = {k: lm_params_from_numpy(state[k], device) for k in ("mu", "nu")}
    for k in ("mu", "nu"):
        for leaf in base.tree_leaves(out[k]):
            if leaf.dtype != torch.float32:
                raise ValueError(f"AdamW moment {k} must be float32, got "
                                 f"{leaf.dtype}")
    out["count"] = torch.tensor(np.asarray(state["count"]), dtype=torch.int32,
                                device=device)
    return out
