#!/usr/bin/env python3
"""Where a decode step's time goes in ``barrier`` and ``xla``, on one GPU.

    python3 tools/xla_decode.py [--layers 8] [--steps 20] [--out FILE]

deepseek-7b at full width cut to ``--layers`` layers, bf16, random weights
from seed 0: one ``lm.prefill`` (1, 2048) per mode (as ``chip_smoke.py``
phase 26a runs it first), then ``lm.decode_step`` at batch 4, position
64, on a float32 cache of 97 keys, timed in turns ``barrier``, ``xla``,
``xla``, ``barrier``.  For each turn it prints the median step (CUDA
events over one step, and the host clock around a synchronised step),
the host time spent inside the stacks' ``fused_stack_apply`` calls a
step (a wrapper around the function, host clock, no synchronisation),
their count, and the frames dynamo compiled during the timed steps (0
means no recompile).  The same numbers go to ``--out`` as JSON.
"""
import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default=str(ROOT / "build" / "xla_decode.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("xla_decode: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    from torch._dynamo.utils import counters
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.kernels.fused_stack import ops
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config("deepseek-7b"),
                              n_layers=args.layers)
    params = lm.init(0, cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(2600)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=g,
                           device=dev)
    batch, pos = 4, 64

    spent = {"s": 0.0, "n": 0}
    apply = ops.fused_stack_apply

    def timed_apply(*a, **k):
        t = time.perf_counter()
        try:
            return apply(*a, **k)
        finally:
            spent["s"] += time.perf_counter() - t
            spent["n"] += 1

    ops.fused_stack_apply = timed_apply
    rows = []
    with torch.inference_mode():
        for m in ("barrier", "xla"):
            lm.prefill(params, {"tokens": tokens}, cfg, RuntimeConfig(mode=m))
        cache = lm.init_decode_cache(cfg, batch, 97, dtype=torch.float32,
                                     device=dev)
        tok = tokens[:, :batch].reshape(batch, 1)

        def step(m):
            cache["blocks"]["sub0"].length.fill_(pos)
            return lm.decode_step(params, cache, tok, cfg,
                                  RuntimeConfig(mode=m))

        for m in ("barrier", "xla"):
            for _ in range(3):
                step(m)
        torch.cuda.synchronize()
        for m in ("barrier", "xla", "xla", "barrier"):
            frames = counters["frames"]["total"]
            ev, host, stack_ms, stack_n = [], [], [], []
            for _ in range(args.steps):
                spent["s"], spent["n"] = 0.0, 0
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                t = time.perf_counter()
                a.record()
                step(m)
                b.record()
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t) * 1e3)
                ev.append(a.elapsed_time(b))
                stack_ms.append(spent["s"] * 1e3)
                stack_n.append(spent["n"])
            rows.append({
                "mode": m, "step_ms_events": statistics.median(ev),
                "step_ms_host": statistics.median(host),
                "stacks_host_ms": statistics.median(stack_ms),
                "stack_calls": statistics.median(stack_n),
                "frames_compiled": counters["frames"]["total"] - frames})
    ops.fused_stack_apply = apply
    print(f"xla_decode: {smi}; deepseek-7b at {cfg.n_layers} layers, bf16, "
          f"decode step at batch {batch}, position {pos}, median of "
          f"{args.steps} steps, in turns:")
    for r in rows:
        print(f"  {r['mode']}: step {r['step_ms_events']:.3f} ms (events), "
              f"{r['step_ms_host']:.3f} ms (host clock); inside "
              f"{r['stack_calls']} fused_stack_apply calls "
              f"{r['stacks_host_ms']:.3f} ms of host time "
              f"({r['stacks_host_ms'] / max(r['stack_calls'], 1) * 1e3:.1f} "
              f"us a call); the rest {r['step_ms_host'] - r['stacks_host_ms']:.3f}"
              f" ms; frames compiled while timed {r['frames_compiled']}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"device": smi, "rows": rows},
                                         indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
