"""Continuous-batching serving example: a queue of ragged requests through
the slot-managed engine (``Engine.run``), with the fixed static loop as a
baseline (``--static``); the twin of the JAX package's
``examples/serve_batch.py``.

    python -m repro_torch.examples.serve_batch --arch deepseek-7b \\
        --mode brainslug --kv-layout paged
    python -m repro_torch.examples.serve_batch --device cpu --reduced
    python -m repro_torch.examples.serve_batch --arch mamba2-2.7b
    python -m repro_torch.examples.serve_batch --arch granite-moe-3b-a800m \\
        --reduced --device cpu

It serves the full-width model on the card by default; ``--device cpu
--reduced`` runs the config's small variant with the plain versions.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch.launch.engine import Request
from repro_torch.launch.serve import ServeConfig, Server


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--mode", default="brainslug",
                    choices=["brainslug", "xla", "barrier"])
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--kv-layout", default="paged",
                    choices=["dense", "paged"])
    ap.add_argument("--kv-block-size", type=int, default=16)
    ap.add_argument("--reduced", action="store_true",
                    help="the config's small CPU-smoke variant")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--static", action="store_true",
                    help="run the static lock-step loop instead")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as the scheduler commits them "
                         "(Engine.run(on_token=...))")
    args = ap.parse_args(argv)

    sc = ServeConfig(arch=args.arch, reduced=args.reduced, mode=args.mode,
                     batch=args.slots, prompt_len=args.prompt_len,
                     new_tokens=args.new_tokens,
                     max_len=args.prompt_len + args.new_tokens + 1,
                     temperature=args.temperature, torch_device=args.device)
    server = Server(sc)
    rng = np.random.default_rng(0)

    if args.static:
        prompts = rng.integers(0, server.cfg.vocab_size,
                               (sc.batch, sc.prompt_len)).astype(np.int32)
        stops = rng.integers(sc.new_tokens // 2, sc.new_tokens + 1,
                             (sc.batch,))
        t0 = time.time()
        gen = server.generate(prompts, stop_lengths=stops)
        dt = time.time() - t0
        print(f"[static] {sc.batch} requests in {dt:.2f}s "
              f"({server.last_stats.decode_slot_steps} decode slot-steps)")
        for i in range(sc.batch):
            print(f"  request {i} (stop={stops[i]:2d}): "
                  f"{gen[i, : stops[i]].tolist()}")
        return 0

    # ragged traffic: mixed prompt and stop lengths (a freed slot admits
    # the next queued request; prefill chunks share steps with decode)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(1, sc.prompt_len + 1))
        reqs.append(Request(
            request_id=i,
            prompt=rng.integers(0, server.cfg.vocab_size,
                                (plen,)).astype(np.int32),
            max_new_tokens=int(rng.integers(sc.new_tokens // 2,
                                            sc.new_tokens + 1)),
            temperature=args.temperature))

    engine = server.engine(slots=args.slots, kv_layout=args.kv_layout,
                           kv_block_size=args.kv_block_size)
    on_token = None
    if args.stream:
        def on_token(ev):
            if ev.done:
                print(f"  [stream] request {ev.request_id} done "
                      f"({ev.completion.status})")
            else:
                print(f"  [stream] request {ev.request_id} "
                      f"token[{ev.index}] = {ev.token}")
    t0 = time.time()
    completions = engine.run(reqs, on_token=on_token)
    dt = time.time() - t0
    s = engine.last_stats
    print(f"arch={server.cfg.name} mode={args.mode} slots={args.slots} "
          f"kv_layout={args.kv_layout} device={server.device}")
    print(f"[engine] {len(reqs)} requests in {dt:.2f}s: "
          f"{s.generated_tokens} tokens, {s.step_dispatches} dispatches, "
          f"{s.decode_slot_steps} decode slot-steps, "
          f"slot utilization {s.slot_utilization:.2f}; decode path "
          f"{engine.report()['decode_path']}")
    for c in completions:
        print(f"  request {c.request_id} (prompt={c.prompt_len:2d}, "
              f"stop={len(c.tokens):2d}): {c.tokens.tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
