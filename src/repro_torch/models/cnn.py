"""The paper's evaluation domain: CNNs, as hand-built graphs and plain twins.

IR constructors (the input of :func:`repro_torch.core.api.optimize_graph`):

* :func:`block_net` — the paper's §5.1 synthetic benchmark: N consecutive
  ``<MaxPool(3x3, s1, p1), BatchNorm, ReLU>`` blocks (Fig. 10).
* :func:`vgg_net` — a VGG-style network (conv/BN/ReLU/pool stages + head);
  ``stages=(64, 128, 256, 512, 512)`` gives VGG-16's channel widths.

Plain twins :func:`block_fn` / :func:`vgg_fn` compute the same networks as
ordinary PyTorch functions of ``(x, params)`` on the same parameter
dictionaries.  Layouts are the JAX package's: NHWC activations, HWIO conv
weights, ``(C,)`` batch-norm vectors.  Weights are drawn from a seeded CPU
``torch.Generator`` and then moved to ``device``, so a seed gives the same
weights on every device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import ir


def _generator(generator: torch.Generator | None) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


def _normal(shape: tuple[int, ...], g: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=g, dtype=torch.float32)


def _block_ops(i: int, vin: str) -> tuple[list[ir.OpNode], str]:
    ops = [
        ir.OpNode(ir.OpKind.POOL2D, f"pool{i}", (vin,), f"p{i}", fn="max",
                  attrs={"window": (3, 3), "stride": (1, 1),
                         "padding": (1, 1)}),
        ir.OpNode(ir.OpKind.AFFINE, f"bn{i}", (f"p{i}",), f"b{i}",
                  params=(f"bn{i}_s", f"bn{i}_o")),
        ir.OpNode(ir.OpKind.EW_UNARY, f"relu{i}", (f"b{i}",), f"r{i}",
                  fn="relu"),
    ]
    return ops, f"r{i}"


def block_net(n_blocks: int, channels: int = 32, *,
              generator: torch.Generator | None = None,
              device: torch.device | str = "cuda"
              ) -> tuple[ir.NetGraph, dict[str, torch.Tensor]]:
    """Paper Fig. 10: a pure stack of <MaxPool, BN, ReLU> blocks."""
    g = _generator(generator)
    ops: list[ir.OpNode] = []
    v = "x"
    params: dict[str, torch.Tensor] = {}
    for i in range(n_blocks):
        blk, v = _block_ops(i, v)
        ops.extend(blk)
        params[f"bn{i}_s"] = 1.0 + 0.1 * _normal((channels,), g)
        params[f"bn{i}_o"] = 0.1 * _normal((channels,), g)
    graph = ir.NetGraph(name=f"blocknet{n_blocks}", input="x", output=v,
                        ops=tuple(ops))
    return graph, {k: p.to(device) for k, p in params.items()}


def _global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x, dim=(1, 2))


def vgg_net(stages: tuple[int, ...] = (32, 64, 128), in_channels: int = 3,
            n_classes: int = 10, batch_norm: bool = True, *,
            generator: torch.Generator | None = None,
            device: torch.device | str = "cuda"
            ) -> tuple[ir.NetGraph, dict[str, torch.Tensor]]:
    """VGG-style: per stage [conv3x3 -> (BN) -> ReLU -> MaxPool(2,2)],
    then global-avg-pool head + linear classifier."""
    g = _generator(generator)
    ops: list[ir.OpNode] = []
    params: dict[str, torch.Tensor] = {}
    v = "x"
    cin = in_channels
    for i, cout in enumerate(stages):
        params[f"conv{i}_w"] = (_normal((3, 3, cin, cout), g)
                                * (2.0 / (9 * cin)) ** 0.5)
        ops.append(ir.OpNode(
            ir.OpKind.CONV2D, f"conv{i}", (v,), f"c{i}",
            params=(f"conv{i}_w",),
            attrs={"kernel_shape": (3, 3, cin, cout), "stride": (1, 1),
                   "padding": (1, 1)}))
        v = f"c{i}"
        if batch_norm:
            params[f"bn{i}_s"] = 1.0 + 0.1 * _normal((cout,), g)
            params[f"bn{i}_o"] = 0.1 * _normal((cout,), g)
            ops.append(ir.OpNode(ir.OpKind.AFFINE, f"bn{i}", (v,), f"b{i}",
                                 params=(f"bn{i}_s", f"bn{i}_o")))
            v = f"b{i}"
        ops.append(ir.OpNode(ir.OpKind.EW_UNARY, f"relu{i}", (v,), f"r{i}",
                             fn="relu"))
        v = f"r{i}"
        ops.append(ir.OpNode(ir.OpKind.POOL2D, f"mp{i}", (v,), f"m{i}",
                             fn="max", attrs={"window": (2, 2),
                                              "stride": (2, 2),
                                              "padding": (0, 0)}))
        v = f"m{i}"
        cin = cout
    # head: global average pool as an OPAQUE mean over H, W + linear
    ops.append(ir.OpNode(ir.OpKind.OPAQUE, "gap", (v,), "g",
                         attrs={"fn": _global_avg_pool}))
    params["head_w"] = (_normal((stages[-1], n_classes), g)
                        * (1.0 / stages[-1]) ** 0.5)
    ops.append(ir.OpNode(ir.OpKind.MATMUL, "head", ("g",), "y",
                         params=("head_w",),
                         attrs={"features_out": n_classes}))
    graph = ir.NetGraph(name="vgg", input="x", output="y", ops=tuple(ops))
    return graph, {k: p.to(device) for k, p in params.items()}


# ---------------------------------------------------------------------------
# Plain twins: the same networks written as ordinary tensor code.
# ---------------------------------------------------------------------------

def max_pool(x: torch.Tensor, window: tuple[int, int],
             stride: tuple[int, int], padding: tuple[int, int]) -> torch.Tensor:
    """NHWC max pooling, padded with -inf."""
    ph, pw = padding
    xc = F.pad(x.permute(0, 3, 1, 2), (pw, pw, ph, ph), value=-torch.inf)
    return F.max_pool2d(xc, window, stride).permute(0, 2, 3, 1)


def block_fn(x: torch.Tensor, params: dict) -> torch.Tensor:
    """Plain twin of :func:`block_net`; the block count is inferred from the
    ``bn{i}_*`` parameter keys."""
    i = 0
    while f"bn{i}_s" in params:
        x = max_pool(x, (3, 3), (1, 1), (1, 1))
        x = torch.relu(x * params[f"bn{i}_s"] + params[f"bn{i}_o"])
        i += 1
    return x.contiguous()


def vgg_fn(x: torch.Tensor, params: dict) -> torch.Tensor:
    """Plain twin of :func:`vgg_net`; stage count and the batch-norm flag are
    inferred from the parameter keys."""
    i = 0
    while f"conv{i}_w" in params:
        x = F.conv2d(x.permute(0, 3, 1, 2),
                     params[f"conv{i}_w"].permute(3, 2, 0, 1),
                     padding=1).permute(0, 2, 3, 1)
        if f"bn{i}_s" in params:
            x = x * params[f"bn{i}_s"] + params[f"bn{i}_o"]
        x = max_pool(torch.relu(x), (2, 2), (2, 2), (0, 0))
        i += 1
    return torch.mean(x, dim=(1, 2)) @ params["head_w"]
