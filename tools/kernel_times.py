#!/usr/bin/env python3
"""Time the port's paged decode and nhwc forward kernels in one or more
source trees, on one GPU, so that two versions compare within one run.

    python3 tools/kernel_times.py TREE [TREE ...] [--out FILE]

Each TREE (a checkout of this repository: ``TREE/src/repro_torch``) is
timed in a process of its own, in the order given: list the parent and the
change as ``parent change change parent`` to take them in turns.  A tree's
run builds its kernels from its own sources and reads only its public entry
points (``decode.paged_flash_decode``, ``nhwc.fused_nhwc``), so any version
of the port serves.  Timed, each as the mean device duration of the
kernel's launches in a ``torch.profiler`` trace of 20 calls (CUDA events
per call where the trace holds none):

* ``paged_flash_decode`` in bf16, D 128, 32 heads, block 16: the table's
  shape (8 slots, lengths 0-32768), one slot at 32768, and the engine
  tick's (4 slots at 101 keys, a table of 16 blocks); in a tree whose
  wrapper takes ``splits``, also at every split;
* ``fused_nhwc`` at VGG-16's five stacks (batch norm, ReLU, 2x2/s2 max
  pool), batch 32 at 224 x 224, on random inputs of each stack's shape,
  with the planner's tile.

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
PAGED_SHAPES = {            # name: (lengths, table width in blocks)
    "table": (PAGED_LENGTHS, 2048),
    "one_slot_32768": ([32768], 2048),
    "tick": ([101] * 4, 16),
}
HEADS, BLOCK, HEAD_DIM = 32, 16, 128
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


def worker(tree: Path) -> dict:
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
           "paged": {}, "nhwc": {}}
    takes_splits = "splits" in inspect.signature(
        decode.paged_flash_decode).parameters
    with torch.inference_mode():
        for name, (lengths, mb) in PAGED_SHAPES.items():
            q, kp, vp, table, lens = paged_operands(torch, lengths, mb)
            ms, how = kernel_ms(torch, lambda: decode.paged_flash_decode(
                q, kp, vp, table, lens), "paged_flash_decode")
            row = {"ms": ms, "how": how}
            if takes_splits:
                row["plan"] = decode._plan(
                    decode._library(decode.PAGED_SOURCE), q.device,
                    len(lengths), HEADS, mb, BLOCK, (1, 1)).splits
                for s in decode.SPLITS:
                    row[f"splits_{s}"] = kernel_ms(
                        torch, lambda s=s: decode.paged_flash_decode(
                            q, kp, vp, table, lens, splits=s),
                        "paged_flash_decode")[0]
            out["paged"][name] = row
            del q, kp, vp
            torch.cuda.empty_cache()
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
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no GPU", file=sys.stderr)
        return 2
    if args.worker:
        print(json.dumps(worker(args.trees[0].resolve())))
        return 0
    for tree in args.trees:
        done = subprocess.run([sys.executable, __file__, "--worker",
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
