"""Quickstart: the paper's Listing 3 experience, in PyTorch.

Write a plain PyTorch VGG forward, call ``repro_torch.api.optimize`` on it
(one function call, no IR construction), and run it.  The optimized
callable computes the same function; the depth-first schedule changes only
memory traffic.  On the card (the default) the stacks run the hand-written
kernels; ``--device cpu`` runs their plain versions at the same sizes:

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
import argparse

import torch

from repro_torch import api
from repro_torch.models import cnn


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mode", default="brainslug",
                    choices=["brainslug", "xla", "barrier"])
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("quickstart: no CUDA device; pass --device cpu")
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # 1. the model: an ordinary PyTorch function and its parameters
    #    (paper: model = torchvision.models.vgg16(...))
    _, params = cnn.vgg_net(stages=(32, 64, 128), batch_norm=True,
                            device=args.device)
    x = torch.randn((8, 32, 32, 3), generator=torch.Generator().manual_seed(
        0)).to(args.device)

    # 2. optimize with BrainSlug (paper: brainslug.optimize(model)): the
    #    tracer lifts the aten graph into the IR, finds the optimizable
    #    stacks and collapses them against the device budget
    net = api.optimize(cnn.vgg_fn, x, params, config=api.OptimizeConfig(
        mode=args.mode, torch_device=args.device))

    # 3. execute: a drop-in for the original function
    y = net(x, params)
    y_ref = cnn.vgg_fn(x, params)
    torch.testing.assert_close(y, y_ref, rtol=2e-4, atol=2e-4)

    print(f"output shape            : {tuple(y.shape)}")
    print(f"max |optimized - raw fn|: {float((y - y_ref).abs().max()):.3e}")
    print(f"stacks found            : {net.n_stacks}")
    print(f"fused sequences emitted : {net.n_sequences}")

    # 4. what the tracer captured and what the schedule change buys (ops
    #    captured vs left opaque, analytic HBM traffic per stack)
    print(net.explain())


if __name__ == "__main__":
    main()
