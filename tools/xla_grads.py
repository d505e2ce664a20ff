#!/usr/bin/env python3
"""Step-1 gradients of the VGG-16 cell per mode against a float64 run, on
one GPU.

    python3 tools/xla_grads.py [--out FILE]

``optimize_graph`` of VGG-16's widths at (32, 224, 224, 3) with
``differentiable=True``, the cross-entropy of ``chip_smoke.py`` phase 9's
labels, one step's gradient of every parameter in ``barrier``, ``xla``
(each stack under ``torch.compile``), ``xla`` compiled with inductor's
``emulate_precision_casts`` (no FP fusion, so no FMA in the batch norm)
and ``brainslug``, each printed as its relative L2 distance to
``barrier``'s float64 gradient and to ``barrier``'s float32 one.  The
distances go to ``--out`` as JSON too.  TF32 is off, as in the script.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" / "xla_grads.json"))
    args = ap.parse_args()
    import torch
    import torch._dynamo
    import torch._inductor.config as inductor_config
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("xla_grads: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import api
    from repro_torch.kernels.fused_stack import ops
    from repro_torch.models import cnn
    smoke = cs.Smoke(torch)
    smoke.phase0_device()
    smoke.phase1_build()
    graph, params = cnn.vgg_net(cs.VGG16_STAGES, device=smoke.dev)
    x = smoke.randn(cs.VGG_INPUT, 7)
    labels = torch.randint(0, 10, (cs.VGG_INPUT[0],), device=smoke.dev,
                           generator=torch.Generator(
                               device=smoke.dev).manual_seed(8))
    nets = {m: api.optimize_graph(graph, cs.VGG_INPUT, api.OptimizeConfig(
        mode=m, differentiable=True)) for m in ("xla", "barrier",
                                                "brainslug")}

    def grads(mode, x, params):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = F.cross_entropy(nets[mode](x, leaves), labels)
        return dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))

    g = {}
    for mode in ("barrier", "xla", "brainslug"):
        t = time.perf_counter()
        g[mode] = grads(mode, x, params)
        print(f"{mode}: {time.perf_counter() - t:.1f} s with its compiles")
    ops._XLA_CACHE.clear()
    torch._dynamo.reset()
    with inductor_config.patch(emulate_precision_casts=True):
        g["xla_no_fp_fusion"] = grads("xla", x, params)
    g64 = grads("barrier", x.double(),
                {k: v.double() for k, v in params.items()})

    def rel(a, b):
        return float(torch.linalg.vector_norm(a.double() - b.double())
                     / torch.linalg.vector_norm(b.double()))

    out = {m: {k: {"to_float64": rel(gm[k], g64[k]),
                   "to_barrier": rel(gm[k], g["barrier"][k])}
               for k in gm} for m, gm in g.items()}
    for k in g64:
        print(k, "  ".join(f"{m}: to float64 {out[m][k]['to_float64']:.3e}"
                           f" to barrier {out[m][k]['to_barrier']:.3e}"
                           for m in out))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": smoke.smi,
                                          "distances": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
