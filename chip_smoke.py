#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``src/repro_torch``) on one GPU and check it.

    python3 chip_smoke.py

Phases, one line each (plus tables):

0. the device (``torch.cuda.get_device_name``, ``nvidia-smi`` name and
   power limit); TF32 off, so every comparison is float32 against float32;
1. build the kernels from the sources in this tree (nvcc for the CUDA
   source, Triton for the generated rows kernels at first launch);
2. the nhwc CUDA kernel against its plain version (max |d| <= 1e-5);
3. the rows Triton kernel against its plain version at deepseek-7b widths
   (d_model 4096, d_ff 11008, 4 x 2048 rows; <= 1e-5, rtol 1e-4 for norms
   and softmax);
4. the main paths: ``optimize_graph`` of VGG-16's widths at 224 x 224,
   batch 32, float32 (``brainslug`` against ``barrier`` within 1e-4), and
   the LM block's row chains through ``optimize_stack``; dispatch and
   launch counters are zeroed before each path and read after it;
5. per-kernel device times (profiler) and per-call times (CUDA events)
   beside the plain version, a library call where one computes the same
   function, and the bound; a traced forward per mode gives the device
   time by kernel group and the idle share;
6. the ``kernels`` JSON line, the card line, and the ``ok`` line last.

Exits non-zero, printing no result, without CUDA, outside this tree, or
when any phase fails.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

D_MODEL, D_FF, ROWS = 4096, 11008, (4, 2048)     # deepseek-7b widths
VGG16_STAGES = (64, 128, 256, 512, 512)
VGG_INPUT = (32, 224, 224, 3)
NHWC_TOL = dict(atol=1e-5, rtol=1e-5)
ROWS_TOL = dict(atol=1e-5, rtol=1e-5)
ROWS_NORM_TOL = dict(atol=1e-5, rtol=1e-4)
PATH_TOL = dict(atol=1e-4, rtol=1e-4)


class PhaseError(RuntimeError):
    pass


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels.fused_stack import nhwc  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not next to this script ({e})",
              file=sys.stderr)
        return 2
    try:
        Smoke(torch).run()
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    return 0


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda")
        self.err = {"fused_nhwc": 0.0, "fused_rows": 0.0}
        self.kernels: dict[str, dict] = {}

    # -- helpers ------------------------------------------------------------
    def randn(self, shape, seed, scale=1.0):
        g = self.torch.Generator(device=self.dev).manual_seed(seed)
        return scale * self.torch.randn(shape, generator=g, device=self.dev)

    def check(self, kernel, what, got, want, tol):
        torch = self.torch
        torch.cuda.synchronize()
        for k in want:
            g, w = got[k], want[k]
            if g.shape != w.shape:
                raise PhaseError(f"{kernel} {what}: shape {tuple(g.shape)} != "
                                 f"{tuple(w.shape)}")
            if not bool(torch.isfinite(g).all()):
                raise PhaseError(f"{kernel} {what}: non-finite output {k}")
            err = float((g - w).abs().max())
            self.err[kernel] = max(self.err[kernel], err)
            if not torch.allclose(g, w, **tol):
                raise PhaseError(f"{kernel} {what}: output {k} max|d|={err:.3e}"
                                 f" outside {tol}")
        return max(float((got[k] - want[k]).abs().max()) for k in want)

    def cuda_ms(self, fn, reps=20, groups=5, warmup=3):
        """Milliseconds per call: CUDA events around ``reps`` back-to-back
        calls, divided by ``reps``; the median of ``groups`` such runs.
        Where the host enqueues slower than the card runs, this is the
        host's time per call."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(groups):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / reps)
        return statistics.median(times)

    # -- phases ---------------------------------------------------------------
    def run(self):
        t0 = time.perf_counter()
        self.phase0_device()
        self.phase1_build()
        self.phase2_nhwc()
        self.phase3_rows()
        self.phase4_paths()
        self.phase5_timing()
        print(f"[total] {time.perf_counter() - t0:.1f} s")
        print(json.dumps({"kernels": [self.kernels[k] for k in
                                      ("fused_nhwc", "fused_rows")]}))
        print(self.smi)
        torch = self.torch
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))

    def phase0_device(self):
        torch = self.torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        try:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60, check=True)
        except (OSError, subprocess.SubprocessError) as e:
            raise PhaseError(f"nvidia-smi: {e}") from e
        self.smi = smi.stdout.strip().splitlines()[0]
        print(f"[0 device] {torch.cuda.get_device_name(0)} | {self.smi} | "
              f"torch {torch.__version__} cuda {torch.version.cuda} | "
              f"tf32 off")

    def phase1_build(self):
        from repro_torch.kernels import _build
        from repro_torch.kernels.fused_stack import nhwc
        t = time.perf_counter()
        procs = [(src, _build.start_build(src)) for src in (nhwc.SOURCE,)]
        try:
            libs = [_build.finish_build(src, p) for src, p in procs]
        except _build.BuildError as e:
            raise PhaseError(str(e)) from e
        nhwc._library()
        import triton
        print(f"[1 build] nvcc {', '.join(p.name for p in libs)} in "
              f"{time.perf_counter() - t:.1f} s; triton {triton.__version__} "
              f"compiles each rows signature at its first launch")

    def phase2_nhwc(self):
        from repro_torch.core import analyzer, collapse, ir, resource
        from repro_torch.kernels.fused_stack import nhwc, ref
        from repro_torch.models import cnn
        K = ir.OpKind

        def pool(name, vin, vout, fn="max", w=(3, 3), s=(1, 1), p=(1, 1)):
            return ir.OpNode(K.POOL2D, name, (vin,), vout, fn=fn,
                             attrs={"window": w, "stride": s, "padding": p})

        def prog(name, ops, inputs=("x",)):
            return ir.StackProgram(name=name, inputs=inputs,
                                   outputs=(ops[-1].output,), ops=tuple(ops),
                                   layout="nhwc")

        affine = ir.OpNode(K.AFFINE, "bn", ("p",), "b", params=("s", "o"))
        relu = ir.OpNode(K.EW_UNARY, "relu", ("b",), "r", fn="relu")
        unary = ("tanh", "sigmoid", "relu", "relu6", "squared_relu", "gelu",
                 "gelu_exact", "silu", "exp", "abs", "square", "identity",
                 "neg", "softplus")
        chain = [ir.OpNode(K.EW_UNARY, f"u{i}", ("x" if i == 0 else
                                                 f"u{i - 1}",), f"u{i}", fn=f)
                 for i, f in enumerate(unary)]
        cases = [
            ("max_pool_padded", prog("maxpad", [pool("p", "x", "p"), affine,
                                                relu]), (8, 56, 56, 64), 8, {}),
            ("avg_pool_padded", prog("avgpad", [pool("p", "x", "y", "avg")]),
             (8, 56, 56, 64), 8, {}),
            ("stride_not_tiling", prog("strided", [
                pool("p0", "x", "a", "max", (3, 3), (2, 2), (1, 1)),
                pool("p1", "a", "y", "avg", (2, 2), (2, 2), (0, 0))]),
             (8, 57, 57, 32), 4, {}),
            ("image_not_tile_multiple", prog("untiled", [
                ir.OpNode(K.AFFINE, "bn", ("x",), "b", params=("s", "o")),
                ir.OpNode(K.EW_UNARY, "relu", ("b",), "r", fn="relu"),
                pool("p", "r", "y", "max", (2, 2), (2, 2), (0, 0))]),
             (8, 30, 30, 64), 8, {}),
            ("broadcast_extra", prog("extra", [
                ir.OpNode(K.EW_BINARY, "add", ("x", "e"), "a", fn="add"),
                ir.OpNode(K.EW_BINARY, "mul", ("e", "a"), "m", fn="mul"),
                pool("p", "m", "y", "max", (2, 2), (2, 2), (0, 0))],
                inputs=("x", "e")), (8, 28, 28, 64), 8, {"e": (1, 1, 1, 64)}),
            ("every_unary_fn", prog("unary", chain + [
                pool("p", chain[-1].output, "y", "max", (3, 3), (2, 2),
                     (1, 1))]), (4, 28, 28, 32), 4, {}),
            ("row_norm_softmax_over_c", prog("rowops", [
                ir.OpNode(K.ROW_NORM, "ln", ("x",), "a", params=("s", "o"),
                          attrs={"norm": "layer", "eps": 1e-5}),
                pool("p", "a", "c", "max", (2, 2), (2, 2), (0, 0)),
                ir.OpNode(K.ROW_NORM, "rms", ("c",), "d", params=("s",),
                          attrs={"norm": "rms", "eps": 1e-6}),
                ir.OpNode(K.ROW_SOFTMAX, "sm", ("d",), "y")]),
             (4, 28, 28, 64), 4, {}),
        ]
        graph, bparams = cnn.block_net(8, channels=32, device=self.dev)
        seg, = analyzer.analyze(graph, keep=frozenset({graph.output}))
        plan = collapse.collapse(seg.stack, {"x": (8, 56, 56, 32)},
                                 resource.H100)
        for i, seq in enumerate(plan.sequences):
            cases.append((f"block_net8_seq{i}", plan.subprogram(i),
                          (8, 56, 56, 32), seq.tile_out_h, "block"))
        worst = 0.0
        for k, (name, program, shape, tile, extra_shapes) in enumerate(cases):
            x = self.randn(shape, 100 + k, 2.0)
            c = shape[-1]
            if extra_shapes == "block":
                params, extras = bparams, {}
            else:
                params = {p: self.randn((c,), 200 + j, 0.3)
                          + (1.0 if p == "s" else 0.0)
                          for j, p in enumerate(program.param_names)}
                extras = {e: self.randn(s, 300) for e, s in
                          extra_shapes.items()}
            got = nhwc.fused_nhwc(program, x, params, extras=extras,
                                  tile_out_h=tile, tile_out_w=tile)
            want = ref.fused_stack_ref(program, {program.inputs[0]: x,
                                                 **extras}, params)
            out = program.outputs[0]
            worst = max(worst, self.check("fused_nhwc", name, {out: got},
                                          want, NHWC_TOL))
        print(f"[2 nhwc] {len(cases)} cases ({', '.join(c[0] for c in cases)})"
              f" agree with the plain version: max|d| = {worst:.3e} "
              f"(tol {NHWC_TOL})")

    def rows_cases(self):
        """(name, program, input shapes, param shapes, tol) of phase 3."""
        from repro_torch.core import ir
        from repro_torch.layers import stacks
        K = ir.OpKind
        unary = ("tanh", "sigmoid", "relu", "relu6", "squared_relu", "gelu",
                 "gelu_exact", "silu", "exp", "abs", "square", "identity",
                 "neg", "softplus")
        ops, v = [], "x"
        for i, f in enumerate(unary):
            ops.append(ir.OpNode(K.EW_UNARY, f"u{i}", (v,), f"u{i}", fn=f))
            v = f"u{i}"
        for i, f in enumerate(("add", "sub", "mul", "div", "max", "min")):
            ops.append(ir.OpNode(K.EW_BINARY, f"b{i}", (v, "z"), f"b{i}",
                                 fn=f))
            v = f"b{i}"
        ops.append(ir.OpNode(K.EW_BINARY, "bp", (v,), "bp", fn="mul",
                             params=("k",)))
        ops.append(ir.OpNode(K.AFFINE, "aff", ("bp",), "y",
                             params=("s", "o")))
        all_fns = ir.StackProgram(name="all_fns", inputs=("x", "z"),
                                  outputs=("y",), ops=tuple(ops))
        softmax = ir.StackProgram(name="softmax", inputs=("x",),
                                  outputs=("y",), ops=(
            ir.OpNode(K.ROW_SOFTMAX, "sm", ("x",), "y"),))
        d, f = ROWS + (D_MODEL,), ROWS + (D_FF,)
        ragged = (ROWS[0] * ROWS[1] - 3, D_MODEL)
        vec = (D_MODEL,)
        return [
            ("every_fn_affine", all_fns, {"x": d, "z": d},
             {"k": vec, "s": vec, "o": vec}, ROWS_TOL),
            ("rms", stacks.norm_program("rms", 1e-6, False), {"x": d},
             {"scale": vec}, ROWS_NORM_TOL),
            ("rms_bias", stacks.norm_program("rms", 1e-6, True), {"x": d},
             {"scale": vec, "bias": vec}, ROWS_NORM_TOL),
            ("layer", stacks.norm_program("layer", 1e-5, False), {"x": d},
             {"scale": vec}, ROWS_NORM_TOL),
            ("layer_bias", stacks.norm_program("layer", 1e-5, True),
             {"x": d}, {"scale": vec, "bias": vec}, ROWS_NORM_TOL),
            ("softmax", softmax, {"x": d}, {}, ROWS_NORM_TOL),
            ("ragged_rows", stacks.addnorm_program("layer", 1e-5, True),
             {"x": ragged, "res": ragged}, {"scale": vec, "bias": vec},
             ROWS_NORM_TOL),
            ("addnorm_rms", stacks.addnorm_program("rms", 1e-6, False),
             {"x": d, "res": d}, {"scale": vec}, ROWS_NORM_TOL),
            ("glu_silu", stacks.glu_program("silu"), {"gate": f, "up": f},
             {}, ROWS_TOL),
        ]

    def rows_inputs(self, name, in_shapes, p_shapes, seed):
        inputs = {k: self.randn(s, seed + i) for i, (k, s) in
                  enumerate(in_shapes.items())}
        if "z" in inputs:       # divisors away from zero
            z = inputs["z"]
            inputs["z"] = self.torch.where(z.abs() < 0.5, 1.0, z)
        params = {k: self.randn(s, seed + 50 + i) + (1.0 if k == "scale"
                                                     else 0.0)
                  for i, (k, s) in enumerate(p_shapes.items())}
        return inputs, params

    def phase3_rows(self):
        from repro_torch.core import api
        from repro_torch.kernels.fused_stack import ref
        cfg = api.OptimizeConfig(mode="brainslug")
        t = time.perf_counter()
        lines = []
        for k, (name, program, in_shapes, p_shapes, tol) in enumerate(
                self.rows_cases()):
            inputs, params = self.rows_inputs(name, in_shapes, p_shapes,
                                              400 + 100 * k)
            exe = api.optimize_stack(program, in_shapes, cfg)
            got = exe(inputs, params)
            want = ref.fused_stack_ref(program, inputs, params)
            err = self.check("fused_rows", name, got, want, tol)
            lines.append(f"{name}={err:.1e}")
        print(f"[3 rows] {len(lines)} cases through optimize_stack agree with "
              f"the plain version ({' '.join(lines)}); first launches "
              f"(Triton compiles) included: {time.perf_counter() - t:.1f} s")

    def phase4_paths(self):
        torch = self.torch
        from repro_torch.core import api
        from repro_torch.kernels.fused_stack import nhwc, ops, ref, rows
        from repro_torch.models import cnn
        graph, params = cnn.vgg_net(VGG16_STAGES, device=self.dev)
        x = self.randn(VGG_INPUT, 7)
        nets = {m: api.optimize_graph(graph, VGG_INPUT,
                                      api.OptimizeConfig(mode=m))
                for m in ("brainslug", "barrier")}
        with torch.no_grad():
            want = nets["barrier"](x, params)
            torch.cuda.synchronize()
            ops.STATS.reset()
            nhwc.fused_nhwc.launches = rows.fused_rows.launches = 0
            got = nets["brainslug"](x, params)
            torch.cuda.synchronize()
            stats = ops.STATS.snapshot()
            launches = {"fused_nhwc": nhwc.fused_nhwc.launches,
                        "fused_rows": rows.fused_rows.launches}
        if tuple(got.shape) != (VGG_INPUT[0], 10):
            raise PhaseError(f"VGG output shape {tuple(got.shape)}")
        if not bool(torch.isfinite(got).all()):
            raise PhaseError("VGG output is not finite")
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, **PATH_TOL):
            raise PhaseError(f"VGG brainslug vs barrier max|d|={err:.3e}")
        if stats["fwd_generated"] <= 0 or stats["fwd_reference"] != 0:
            raise PhaseError(f"VGG dispatch counters {stats}")
        if launches["fused_nhwc"] != nets["brainslug"].n_sequences:
            raise PhaseError(f"VGG launches {launches}")
        self.vgg_launches = launches["fused_nhwc"]
        print(f"[4a main path: optimize_graph VGG-16 widths {VGG_INPUT}] "
              f"brainslug vs barrier max|d|={err:.3e} (tol {PATH_TOL}); "
              f"counters {stats}; launches {launches}")
        print(nets["brainslug"].explain())
        # the plain twin, written as ordinary tensor code, on a small input
        small = api.optimize_graph(graph, (2,) + VGG_INPUT[1:],
                                   api.OptimizeConfig(mode="brainslug"))
        with torch.no_grad():
            err_small = float((small(x[:2], params)
                               - cnn.vgg_fn(x[:2], params)).abs().max())
        if not err_small <= PATH_TOL["atol"]:
            raise PhaseError(f"VGG brainslug vs vgg_fn on 2 images "
                             f"max|d|={err_small:.3e}")
        print(f"[4a twin] brainslug on 2 images vs the plain twin vgg_fn: "
              f"max|d|={err_small:.3e}")
        with torch.no_grad():
            ms = [(m, self.cuda_ms(lambda m=m: nets[m](x, params), reps=1,
                                   groups=20))
                  for m in ("barrier", "brainslug", "brainslug", "barrier")]
        print("[4a time] forward, median of 20 runs (CUDA events), in turns: "
              + "  ".join(f"{m}={v:.3f} ms" for m, v in ms))
        for m in ("barrier", "brainslug"):
            print(f"[4a trace {m}] " + self.trace(lambda m=m: nets[m](x, params)))

        # 4b: the LM block's row chains at deepseek-7b widths
        cases = {c[0]: c for c in self.rows_cases()}
        cfg = api.OptimizeConfig(mode="brainslug")
        block = []
        for k, name in enumerate(("rms", "addnorm_rms", "glu_silu")):
            _, program, in_shapes, p_shapes, tol = cases[name]
            inputs, params_ = self.rows_inputs(name, in_shapes, p_shapes,
                                               900 + 100 * k)
            block.append((name, api.optimize_stack(program, in_shapes, cfg),
                          inputs, params_, program, tol))
        torch.cuda.synchronize()
        ops.STATS.reset()
        nhwc.fused_nhwc.launches = rows.fused_rows.launches = 0
        outs = [exe(inputs, p) for _, exe, inputs, p, _, _ in block]
        torch.cuda.synchronize()
        stats = ops.STATS.snapshot()
        launches_b = {"fused_nhwc": nhwc.fused_nhwc.launches,
                      "fused_rows": rows.fused_rows.launches}
        if stats["fwd_generated"] != 3 or stats["fwd_reference"] != 0 \
                or launches_b["fused_rows"] != 3:
            raise PhaseError(f"LM row chains: counters {stats}, launches "
                             f"{launches_b}")
        for (name, _, inputs, p, program, tol), out in zip(block, outs):
            self.check("fused_rows", f"LM row chain {name}", out,
                       ref.fused_stack_ref(program, inputs, p), tol)
        self.rows_launches = launches_b["fused_rows"]
        print(f"[4b main path: optimize_stack LM row chains rms, addnorm_rms,"
              f" glu_silu at {ROWS} x {D_MODEL}/{D_FF}] counters {stats}; "
              f"launches {launches_b}")

    def device_spans(self, fn, reps=1):
        """(kernel name, start us, end us) of every device kernel ``reps``
        calls of ``fn`` launch, from a torch.profiler trace (after one
        untraced call); empty when the profiler records no device events."""
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with torch.no_grad():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
        return sorted(((e.name, e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA),
                      key=lambda s: s[1])

    def device_ms(self, fn, reps=20):
        """Device milliseconds per call: the summed durations of the
        kernels one call launches (profiler, mean of ``reps`` calls), free
        of the host's launch overhead.  Without device events, the
        event-timed :meth:`cuda_ms` stands in, and the label says so."""
        spans = self.device_spans(fn, reps)
        if not spans:
            return self.cuda_ms(fn), "events"
        return sum(t1 - t0 for _, t0, t1 in spans) / reps / 1e3, "device"

    def trace(self, fn) -> str:
        """Device time of one call by kernel group, the share of the traced
        window in which no kernel ran, and the largest kernels outside the
        named groups."""
        spans = self.device_spans(fn)
        if not spans:
            return "not measured (the profiler recorded no device events)"
        groups: dict[str, float] = {}
        other: dict[str, float] = {}
        for name, t0, t1 in spans:
            low = name.lower()
            g = ("fused_nhwc" if "fused_nhwc" in low else "fused_rows"
                 if "fused_rows" in low else "conv" if any(
                     k in low for k in ("conv", "cudnn", "xmma", "implicit",
                                        "fft", "_complex"))
                 else "gemm" if "gemm" in low else "other")
            groups[g] = groups.get(g, 0.0) + (t1 - t0) / 1e3
            if g == "other":
                other[name[:70]] = other.get(name[:70], 0.0) + (t1 - t0) / 1e3
        busy, end = 0.0, spans[0][1]
        for _, t0, t1 in spans:                    # union of kernel spans
            if t1 > end:
                busy += t1 - max(t0, end)
                end = t1
        window = max(t1 for _, _, t1 in spans) - spans[0][1]
        parts = "  ".join(f"{g}={v:.3f} ms" for g, v in sorted(groups.items()))
        top = "; ".join(f"{n} {v:.3f} ms" for n, v in sorted(
            other.items(), key=lambda kv: -kv[1])[:4])
        return (f"device {busy / 1e3:.3f} ms busy of a {window / 1e3:.3f} ms "
                f"window (idle {100 * (1 - busy / window):.1f}%); by kernel "
                f"group: {parts}; {len(spans)} kernels; largest other: {top}")

    def bound(self, program, in_bytes, out_bytes, out_elems, in_elems):
        """Least time: bytes moved once over HBM, or the chain's float32
        operations over the float32 peak, whichever is larger (the H100
        spec's SXM5 datasheet rates)."""
        from repro_torch.core import ir
        from repro_torch.core.resource import H100
        ops = 0
        for op in program.ops:
            if op.kind == ir.OpKind.POOL2D:
                kh, kw = op.attrs["window"]
                ops += kh * kw * out_elems
            elif op.kind == ir.OpKind.AFFINE:
                ops += 2 * in_elems
            elif op.kind in (ir.OpKind.ROW_NORM, ir.OpKind.ROW_SOFTMAX):
                ops += 5 * in_elems
            else:
                ops += in_elems
        t_bytes = (in_bytes + out_bytes) / H100.hbm_bandwidth * 1e3
        t_ops = ops / H100.peak_flops_f32 * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                             "operations")

    def phase5_timing(self):
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.core import analyzer, collapse, ir, resource
        from repro_torch.kernels.fused_stack import nhwc, ref, rows
        from repro_torch.models import cnn

        def nbytes(ts):
            return sum(t.numel() * t.element_size() for t in ts)

        graph, params = cnn.vgg_net(VGG16_STAGES, device=self.dev)
        x = self.randn(VGG_INPUT, 7)
        segments = analyzer.analyze(graph, keep=frozenset({graph.output}))
        env = {graph.input: x}
        entries = []
        with torch.no_grad():
            for seg in segments:
                if not seg.is_stack:
                    env[seg.op.output] = ir.apply_op(seg.op, env, params)
                    continue
                xs = env[seg.stack.inputs[0]]
                plan = collapse.collapse(seg.stack,
                                         {seg.stack.inputs[0]: tuple(xs.shape)},
                                         resource.H100)
                seq = plan.sequences[0]
                sub = plan.subprogram(0)
                run = lambda: nhwc.fused_nhwc(  # noqa: E731
                    sub, xs, params, tile_out_h=seq.tile_out_h,
                    tile_out_w=seq.tile_out_w)
                y = run()
                want = ref.fused_stack_ref(seg.stack,
                                           {seg.stack.inputs[0]: xs}, params)
                self.check("fused_nhwc", f"VGG {seg.stack.name}",
                           {sub.outputs[0]: y}, want, NHWC_TOL)
                env.update(want)
                k_ms, k_how = self.device_ms(run)
                k_call = self.cuda_ms(run)
                p_ms, _ = self.device_ms(lambda: ref.fused_stack_ref(
                    sub, {sub.inputs[0]: xs}, params))
                pv = [params[p] for p in sub.param_names]
                b_ms, b_by = self.bound(sub, nbytes([xs] + pv), nbytes([y]),
                                        y.numel(), xs.numel())
                entries.append((seg.stack.name, tuple(xs.shape),
                                tuple(y.shape), seq.tile_out_h, k_ms, k_how,
                                k_call, p_ms, b_ms, b_by))
        print("[5 nhwc] per launch on the main path's shapes, each checked "
              "against the plain version; device time (profiler, mean of 20 "
              "calls) and per call (CUDA events around 20 back-to-back calls,"
              " median of 5):")
        for (name, si, so, tile, k_ms, k_how, k_call, p_ms, b_ms,
             b_by) in entries:
            print(f"  {name} {si}->{so} tile {tile}: kernel {k_ms:.4f} ms "
                  f"{k_how} ({k_call:.4f} per call)  plain {p_ms:.4f} ms  "
                  f"bound {b_ms:.4f} ms ({b_by})  kernel/bound "
                  f"{k_ms / b_ms:.2f}  library none")
        name, si, so, tile, k_ms, _, _, p_ms, b_ms, b_by = entries[0]
        self.kernels["fused_nhwc"] = {
            "name": "fused_nhwc", "route": "cuda",
            "source": "src/repro_torch/kernels/fused_stack/csrc/fused_nhwc.cu",
            "replaces": "src/repro/kernels/fused_stack/nhwc.py:282",
            "launches": self.vgg_launches,
            "max_abs_err": self.err["fused_nhwc"], "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "shape": f"{name} {si}->{so}"}

        library = {
            "rms": lambda i, p: F.rms_norm(i["x"], (D_MODEL,), p["scale"],
                                           1e-6),
            "layer_bias": lambda i, p: F.layer_norm(
                i["x"], (D_MODEL,), p["scale"], p["bias"], 1e-5),
            "softmax": lambda i, p: F.softmax(i["x"], dim=-1),
        }
        print("[5 rows] per launch at deepseek-7b widths; device time and per "
              "call as above:")
        rows_entries = {}
        for k, (name, program, in_shapes, p_shapes, _) in enumerate(
                self.rows_cases()):
            inputs, params_ = self.rows_inputs(name, in_shapes, p_shapes,
                                               400 + 100 * k)
            plan = collapse.collapse(program, in_shapes, resource.H100)
            tile = plan.sequences[0].tile_rows
            run = lambda: rows.fused_rows(  # noqa: E731
                program, inputs, params_, tile_rows=tile)
            out = run()
            k_ms, k_how = self.device_ms(run)
            k_call = self.cuda_ms(run)
            p_ms, _ = self.device_ms(lambda: ref.fused_stack_ref(
                program, inputs, params_))
            lib = library.get(name)
            l_ms = (self.device_ms(lambda: lib(inputs, params_))[0]
                    if lib else None)
            first = next(iter(out.values()))
            b_ms, b_by = self.bound(
                program, nbytes(list(inputs.values()) + list(
                    params_.values())), nbytes(out.values()), first.numel(),
                first.numel())
            rows_entries[name] = (k_ms, p_ms, l_ms, b_ms, b_by, tile)
            lib_s = f"{l_ms:.4f} ms" if l_ms is not None else "none"
            print(f"  {name} rows={math.prod(in_shapes[program.inputs[0]][:-1])}"
                  f" F={in_shapes[program.inputs[0]][-1]} tile_rows={tile}: "
                  f"kernel {k_ms:.4f} ms {k_how} ({k_call:.4f} per call)  "
                  f"plain {p_ms:.4f} ms  library {lib_s}"
                  f"  bound {b_ms:.4f} ms ({b_by})  kernel/bound "
                  f"{k_ms / b_ms:.2f}")
        k_ms, p_ms, l_ms, b_ms, b_by, tile = rows_entries["rms"]
        self.kernels["fused_rows"] = {
            "name": "fused_rows", "route": "triton",
            "source": "src/repro_torch/kernels/fused_stack/rows.py",
            "replaces": "src/repro/kernels/fused_stack/rows.py:111",
            "launches": self.rows_launches,
            "max_abs_err": self.err["fused_rows"], "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": l_ms,
            "shape": f"norm_program rms {ROWS} x {D_MODEL}"}
        print(f"[6 kernels] fused_nhwc max|d|={self.err['fused_nhwc']:.3e}  "
              f"fused_rows max|d|={self.err['fused_rows']:.3e}")


if __name__ == "__main__":
    sys.exit(main())
