"""Streaming serving example: per-request token callbacks and the generator
API over the continuous-batching engine, on one device or a mesh of ranks;
the twin of the JAX package's ``examples/serve_stream.py``.

Two ways to consume tokens before the run drains:

* ``Request.on_token``: a per-request callback that fires with each of
  that request's :class:`~repro_torch.launch.engine.TokenEvent`\\ s as the
  scheduler commits them (time to first token lands in
  ``last_stats.ttft_p50_ms`` / ``ttft_p99_ms``);
* ``Engine.stream(reqs)``: one generator over every request's events in
  commit order; each terminal event carries its Completion.

``--mesh N`` starts N ranks (``repro_torch.launch.mesh.spawn``) and
serves through ``Server.engine(mesh=...)`` over a ``(N / M, M)`` (data,
model) mesh, ``M`` from ``--model-parallel``: slots split over "data",
attention heads over "model".  Every rank serves the same requests and
commits the same tokens; rank 0 prints.

    python -m repro_torch.examples.serve_stream --device cpu
    python -m repro_torch.examples.serve_stream --device cpu --mesh 2 \\
        --model-parallel 2
    python -m repro_torch.examples.serve_stream --arch qwen2.5-32b \\
        --layers 2 --mesh 2 --model-parallel 2

On the CPU it serves the config's small variant (``reduced()``) with the
kernels' plain versions; on the card the full-width model (``--layers``
cuts its depth), where ranks of a mesh share the one card over gloo.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np


def serve(opts: dict) -> dict:
    """Serve ``opts["requests"]`` requests twice, through callbacks and
    through the generator, in this process or in every rank of a mesh;
    returns rank 0's completions' tokens."""
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.engine import Request
    from repro_torch.launch.serve import ServeConfig, Server

    device = opts["device"]
    reduced = device == "cpu"
    cfg = get_config(opts["arch"])
    if reduced:
        cfg = cfg.reduced()
    if opts["layers"]:
        cfg = dataclasses.replace(cfg, n_layers=opts["layers"])
    sc = ServeConfig(arch=opts["arch"], reduced=reduced, mode=opts["mode"],
                     batch=opts["slots"], prompt_len=opts["prompt_len"],
                     new_tokens=opts["new_tokens"],
                     max_len=opts["prompt_len"] + opts["new_tokens"] + 1,
                     torch_device=device)
    mesh = None
    if opts["mesh"]:
        mesh = mesh_mod.make_test_mesh(model_parallel=opts["model_parallel"],
                                       device=device)
    printing = mesh is None or mesh.rank == 0
    say = print if printing else (lambda *a, **k: None)
    server = Server(sc, cfg=cfg)
    engine = server.engine(slots=opts["slots"], mesh=mesh)
    rng = np.random.default_rng(0)

    def make_reqs(cb=None):
        reqs = []
        for i in range(opts["requests"]):
            plen = int(rng.integers(1, sc.prompt_len + 1))
            reqs.append(Request(
                request_id=i,
                prompt=rng.integers(0, cfg.vocab_size,
                                    (plen,)).astype(np.int32),
                max_new_tokens=int(rng.integers(2, sc.new_tokens + 1)),
                on_token=cb))
        return reqs

    # --- per-request callbacks (they fire in every rank; rank 0 prints) --
    t0 = time.time()

    def cb(ev):
        if ev.done:
            say(f"  [{time.time() - t0:5.2f}s] request {ev.request_id} "
                f"done: {ev.completion.tokens.tolist()}")
        elif ev.index == 0:
            say(f"  [{time.time() - t0:5.2f}s] request {ev.request_id} "
                f"first token {ev.token}")

    completions = engine.run(make_reqs(cb))
    s = engine.last_stats
    say(f"[callbacks] {s.completed} completions, ttft p50 "
        f"{s.ttft_p50_ms:.1f}ms p99 {s.ttft_p99_ms:.1f}ms")

    # --- generator ----------------------------------------------------------
    n_tok, done = 0, []
    for ev in engine.stream(make_reqs()):
        if ev.done:
            done.append(ev.completion)
        else:
            n_tok += 1
    assert n_tok == sum(len(c.tokens) for c in done)
    say(f"[generator] streamed {n_tok} tokens across {len(done)} "
        f"completions")
    rep = engine.report()
    say(f"[report] {cfg.name} decode_path={rep['decode_path']} "
        f"mesh={rep['mesh_axes'] or 'single-device'} "
        f"serve_partition={rep['serve_partition'] or '-'}")
    return {"tokens": [c.tokens.tolist() for c in completions]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.serve_stream")
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--mode", default="brainslug",
                    choices=["brainslug", "xla", "barrier"])
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=10)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to this many layers (0: all)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="serve through a mesh of N ranks (0: one device)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="the mesh's model axis (attention heads)")
    args = ap.parse_args(argv)
    opts = {k.replace("-", "_"): v for k, v in vars(args).items()}
    if args.mesh:
        from repro_torch.launch import mesh as mesh_mod
        mesh_mod.spawn(serve, args.mesh, opts, device=args.device)
    else:
        serve(opts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
