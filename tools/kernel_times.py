#!/usr/bin/env python3
"""Time the port's decode kernels (dense and paged) and nhwc forward
kernel, and the decode paths that run the dense kernel, in one or more
source trees, on one GPU, so that two versions compare within one run.

    python3 tools/kernel_times.py TREE [TREE ...] [--out FILE]
                                  [--kernels dense,paged,nhwc,steps]

Each TREE (a checkout of this repository: ``TREE/src/repro_torch``) is
timed in a process of its own, in the order given: list the parent and the
change as ``parent change change parent`` to take them in turns.  A tree's
run builds its kernels from its own sources and reads only its public entry
points (``decode.flash_decode``, ``decode.paged_flash_decode``,
``nhwc.fused_nhwc``), so any version of the port serves.  Timed, each as
the mean device duration of the kernel's launches in a ``torch.profiler``
trace of 20 calls (CUDA events per call where the trace holds none):

* ``flash_decode`` in bf16, 32 heads, over a dense cache of 32768 keys a
  slot: 8 slots at lengths 0-32768 at D 128 and at D 112, 8 slots at
  lengths drawn from 16384-32768 (``chip_smoke.py`` phase 13's), and 4
  slots of 101 keys each (a lock-step decode early in a long
  generation); in a tree whose wrapper takes ``splits``, also at every
  split, with the plan it chose, and in one whose wrapper takes
  ``max_keys``, the 4 short slots also with ``max_keys = 101`` (the
  Server's bound);
* ``paged_flash_decode`` in bf16, D 128, 32 heads, block 16: the table's
  shape (8 slots, lengths 0-32768), one slot at 32768, and the engine
  tick's (4 slots at 101 keys, a table of 16 blocks); in a tree whose
  wrapper takes ``splits``, also at every split;
* ``fused_nhwc`` at VGG-16's five stacks (batch norm, ReLU, 2x2/s2 max
  pool), batch 32 at 224 x 224, on random inputs of each stack's shape,
  with the planner's tile;
* with ``steps`` (not timed by default): deepseek-7b at full width, bf16,
  random weights from seed 0, in ``brainslug`` mode: one ``lm.decode_step``
  of the 30 layers at batch 4, position 64 of a 97-key float32 cache
  (``chip_smoke.py`` phase 13's; CUDA events around each step, median of
  50 after 3 warm-up steps), and the wall time of ``Engine.run`` over the
  dense KV layout at 8 of the layers with phase 15's 12 requests (4 slots,
  ``max_len`` 256, prefill chunk 8; median of 3 runs after a warm-up run).
  Both are host-bound: they read the host's work per launch, and so does
  the third number, the host time of one ``decode.flash_decode`` call at
  the step's operands (a bf16 query over a float32 cache of 97 keys, 4
  slots at 65 keys; 1000 calls back to back, median of 7 groups), with
  the kernel's device time there.

One JSON line a tree, with the card's name and power limit, goes to
standard output and to ``--out`` (appended).  Needs a GPU; exits 2
without one.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

PAGED_LENGTHS = [0, 1, 17, 513, 4000, 8191, 20000, 32768]
DENSE_S = 32768
DENSE_SHAPES = {            # name: (lengths or a seed to draw them, D)
    "ragged_128": (PAGED_LENGTHS, 128),
    "ragged_112": (PAGED_LENGTHS, 112),
    "long_128": (1523, 128),
    "short_128": ([101] * 4, 128),
}
PAGED_SHAPES = {            # name: (lengths, table width in blocks)
    "table": (PAGED_LENGTHS, 2048),
    "one_slot_32768": ([32768], 2048),
    "tick": ([101] * 4, 16),
}
HEADS, BLOCK, HEAD_DIM = 32, 16, 128
STEP = dict(batch=4, position=64, max_len=97, reps=50)
ENGINE = dict(layers=8, slots=4, max_len=256, prefill_chunk=8, runs=3)
VGG_STAGES = (64, 128, 256, 512, 512)
VGG_BATCH, VGG_SIDE = 32, 224
SPIN = 16                   # sacrificial launches at the start of a trace


def kernel_ms(torch, fn, frag, reps=20):
    """Mean device ms of the launches whose name holds ``frag`` in a trace
    of ``reps`` calls, and how it was read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(SPIN):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        durs = [e.time_range.end - e.time_range.start for e in prof.events()
                if e.device_type == DeviceType.CUDA
                and frag in e.name.lower()]
        if durs:
            return sum(durs) / len(durs) / 1e3, "device"
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps, "events"


def paged_operands(torch, lengths, mb, seed=1700):
    dev = torch.device("cuda")
    b = len(lengths)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    n = max(int(((lens + BLOCK - 1) // BLOCK).sum()), 1) + 8
    g = torch.Generator(device=dev).manual_seed(seed)
    perm = torch.randperm(n, generator=g, device=dev)
    table = torch.full((b, mb), n, dtype=torch.int32, device=dev)
    at = 0
    for i, ln in enumerate(lengths):
        used = -(-ln // BLOCK)
        table[i, :used] = perm[at:at + used].int()
        at += used

    def randn(shape, s):
        gen = torch.Generator(device=dev).manual_seed(s)
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
    q = randn((b, HEADS, 1, HEAD_DIM), seed + 1)
    kp = randn((n, HEADS, BLOCK, HEAD_DIM), seed + 2)
    vp = randn((n, HEADS, BLOCK, HEAD_DIM), seed + 3)
    return q, kp, vp, table, lens


def dense_operands(torch, lengths, d, seed=1520):
    """q and a (B, 32, DENSE_S, d) bf16 cache; ``lengths`` an int draws 8
    lengths from [DENSE_S / 2, DENSE_S] with that seed (phase 13's)."""
    dev = torch.device("cuda")
    if isinstance(lengths, int):
        g = torch.Generator(device=dev).manual_seed(lengths)
        lens = torch.randint(DENSE_S // 2, DENSE_S + 1, (8,), generator=g,
                             device=dev, dtype=torch.int32)
    else:
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    b = lens.numel()

    def randn(shape, s):
        gen = torch.Generator(device=dev).manual_seed(s)
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
    q = randn((b, HEADS, 1, d), seed)
    k = randn((b, HEADS, DENSE_S, d), seed + 1)
    v = randn((b, HEADS, DENSE_S, d), seed + 2)
    return q, k, v, lens


def time_dense(torch, decode) -> dict:
    params = inspect.signature(decode.flash_decode).parameters
    takes_splits = "splits" in params
    out = {}
    for name, (lengths, d) in DENSE_SHAPES.items():
        q, k, v, lens = dense_operands(torch, lengths, d)
        ms, how = kernel_ms(torch, lambda: decode.flash_decode(q, k, v, lens),
                            "flash_decode_kernel")
        row = {"ms": ms, "how": how, "lengths": lens.tolist()}
        if takes_splits:
            row["plan"] = decode.dense_plan(q, k).splits
            for s in decode.SPLITS:
                row[f"splits_{s}"] = kernel_ms(
                    torch, lambda s=s: decode.flash_decode(q, k, v, lens,
                                                           splits=s),
                    "flash_decode_kernel")[0]
        if "max_keys" in params and name == "short_128":
            n = int(lens.max())
            row["max_keys_plan"] = decode.dense_plan(q, k, n).splits
            row["max_keys_ms"] = kernel_ms(
                torch, lambda: decode.flash_decode(q, k, v, lens,
                                                   max_keys=n),
                "flash_decode_kernel")[0]
        out[name] = row
        del q, k, v
        torch.cuda.empty_cache()
    return out


def engine_queue(request_cls, vocab):
    """``chip_smoke.py`` phase 15's 12 requests (numpy seed 0): eight
    share a 64-token prefix with 0-40-token tails, four have unrelated
    16-96-token prompts; max_new_tokens 16-48, one 0, one sampled at
    temperature 0.8."""
    import numpy as np
    rng = np.random.default_rng(0)
    common = rng.integers(1, vocab, 64).tolist()
    reqs = []
    for i in range(12):
        if i % 3 == 2:
            prompt = rng.integers(1, vocab, int(rng.integers(16, 97))).tolist()
        else:
            prompt = common + rng.integers(
                1, vocab, int(rng.integers(0, 41))).tolist()
        reqs.append(request_cls(
            request_id=i, prompt=prompt,
            max_new_tokens=0 if i == 5 else int(rng.integers(16, 49)),
            temperature=0.8 if i == 7 else 0.0))
    return reqs


def time_steps(torch) -> dict:
    """The decode step and the dense engine run (see the module's
    docstring)."""
    import dataclasses
    import statistics
    import time
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.launch import engine as engine_mod
    from repro_torch.launch import serve
    from repro_torch.layers import base
    from repro_torch.models import lm
    cfg = get_config("deepseek-7b")
    params = lm.init(0, cfg, device="cuda")
    rt = RuntimeConfig(mode="brainslug")
    b = STEP["batch"]
    cache = lm.init_decode_cache(cfg, b, STEP["max_len"], dtype=torch.float32,
                                 device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1400)
    tok = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen,
                        device="cuda")

    def step():
        cache["blocks"]["sub0"].length.fill_(STEP["position"])
        return lm.decode_step(params, cache, tok, cfg, rt)
    a = torch.cuda.Event(enable_timing=True)
    z = torch.cuda.Event(enable_timing=True)
    times = []
    for i in range(STEP["reps"] + 3):
        torch.cuda.synchronize()
        a.record()
        step()
        z.record()
        z.synchronize()
        if i >= 3:
            times.append(a.elapsed_time(z))
    out = {"decode_step": {"ms": statistics.median(times),
                           "layers": cfg.n_layers, **STEP}}
    from repro_torch.kernels.attention import decode
    heads, d = cfg.n_heads, cfg.head_dim
    q = torch.randn((b, heads, 1, d), generator=gen,
                    device="cuda").to(torch.bfloat16)
    k = torch.randn((b, heads, STEP["max_len"], d), generator=gen,
                    device="cuda")
    v = torch.randn((b, heads, STEP["max_len"], d), generator=gen,
                    device="cuda")
    lens = torch.full((b,), STEP["position"] + 1, dtype=torch.int32,
                      device="cuda")
    for _ in range(50):
        decode.flash_decode(q, k, v, lens)
    torch.cuda.synchronize()
    groups = []
    for _ in range(7):
        t = time.perf_counter()
        for _ in range(1000):
            decode.flash_decode(q, k, v, lens)
        groups.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
    out["dense_call"] = {
        "us": statistics.median(groups), "groups_us": groups,
        "ms": kernel_ms(torch, lambda: decode.flash_decode(q, k, v, lens),
                        "flash_decode_kernel")[0]}
    del q, k, v
    cut = dataclasses.replace(cfg, n_layers=ENGINE["layers"])
    cut_params = {**params, "blocks": base.tree_map(
        lambda t: t[:ENGINE["layers"]], params["blocks"])}
    sc = serve.ServeConfig(arch=cfg.name, reduced=False, mode="brainslug",
                           batch=ENGINE["slots"], max_len=ENGINE["max_len"],
                           torch_device="cuda")
    server = serve.Server(sc, params=cut_params, cfg=cut)
    reqs = engine_queue(engine_mod.Request, cfg.vocab_size)
    walls = []
    for _ in range(ENGINE["runs"] + 1):
        eng = server.engine(slots=ENGINE["slots"],
                            prefill_chunk=ENGINE["prefill_chunk"],
                            kv_layout="dense")
        torch.cuda.synchronize()
        t = time.perf_counter()
        comps = eng.run(reqs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        if any(c.status != "ok" for c in comps):
            raise RuntimeError("engine run: a request did not complete")
    out["engine_dense"] = {"s": statistics.median(walls[1:]),
                           "runs_s": walls[1:], **ENGINE}
    return out


def worker(tree: Path, kernels: set[str]) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.core import analyzer, collapse, resource
    from repro_torch.kernels.attention import decode
    from repro_torch.kernels.fused_stack import nhwc
    from repro_torch.models import cnn
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    out = {"tree": str(tree), "card": smi[0] if smi else "not read",
           "dense": {}, "paged": {}, "nhwc": {}, "steps": {}}
    takes_splits = "splits" in inspect.signature(
        decode.paged_flash_decode).parameters
    with torch.inference_mode():
        if "dense" in kernels:
            out["dense"] = time_dense(torch, decode)
        if "steps" in kernels:
            out["steps"] = time_steps(torch)
        for name, (lengths, mb) in (PAGED_SHAPES.items()
                                    if "paged" in kernels else ()):
            q, kp, vp, table, lens = paged_operands(torch, lengths, mb)
            ms, how = kernel_ms(torch, lambda: decode.paged_flash_decode(
                q, kp, vp, table, lens), "paged_flash_decode")
            row = {"ms": ms, "how": how}
            if hasattr(decode, "paged_plan"):
                row["plan"] = decode.paged_plan(q, kp, table).splits
            if takes_splits:
                for s in decode.SPLITS:
                    row[f"splits_{s}"] = kernel_ms(
                        torch, lambda s=s: decode.paged_flash_decode(
                            q, kp, vp, table, lens, splits=s),
                        "paged_flash_decode")[0]
            out["paged"][name] = row
            del q, kp, vp
            torch.cuda.empty_cache()
        if "nhwc" not in kernels:
            return out
        graph, params = cnn.vgg_net(VGG_STAGES, device="cuda")
        side, c_in = VGG_SIDE, 3
        for seg in analyzer.analyze(graph, keep=frozenset({graph.output})):
            if not seg.is_stack:
                if seg.op.kind.name == "CONV2D":
                    c_in = seg.op.attrs["kernel_shape"][-1]
                continue
            shape = (VGG_BATCH, side, side, c_in)
            plan = collapse.collapse(seg.stack, {seg.stack.inputs[0]: shape},
                                     resource.H100)
            seq, sub = plan.sequences[0], plan.subprogram(0)
            gen = torch.Generator(device="cuda").manual_seed(7)
            xs = torch.randn(shape, generator=gen, device="cuda")
            ms, how = kernel_ms(torch, lambda: nhwc.fused_nhwc(
                sub, xs, params, tile_out_h=seq.tile_out_h,
                tile_out_w=seq.tile_out_w), "fused_nhwc")
            out["nhwc"][f"{seg.stack.name} {shape}"] = {"ms": ms, "how": how}
            side //= 2
            del xs
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--kernels", default="dense,paged,nhwc",
                    help="which of dense, paged, nhwc, steps to time")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    kernels = set(args.kernels.split(","))
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no GPU", file=sys.stderr)
        return 2
    if args.worker:
        print(json.dumps(worker(args.trees[0].resolve(), kernels)))
        return 0
    for tree in args.trees:
        done = subprocess.run([sys.executable, __file__, "--worker",
                               "--kernels", args.kernels,
                               str(tree.resolve())], capture_output=True,
                              text=True, cwd=tree)
        if done.returncode != 0:
            print(done.stderr[-4000:], file=sys.stderr)
            return done.returncode
        line = done.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        if args.out:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            with args.out.open("a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
