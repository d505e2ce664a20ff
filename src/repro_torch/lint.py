"""Static verification CLI: ``python -m repro_torch.lint``.

Runs the :mod:`repro_torch.core.verify` pass over every shipped
architecture without launching a kernel: for each LM arch the block stack
programs (:mod:`repro_torch.layers.stacks`) are instantiated at the
config's real widths, collapsed for the target device in both inference
and training sizing, and every invariant family is checked: program
well-formedness, plan legality (partition, tile coverage, halo arithmetic,
the working set and the nhwc kernels' shared memory), differentiability,
and the write model of every kernel launch the plan compiles to, on an
H100's 132 SMs.  ``brainslug-cnn`` verifies the VGG NetGraph end to end
(graph SSA and dead values, then each nhwc stack segment); ``paged-kv``
self-tests the serve engine's block-table family (``kv.*``) against a
seeded mutant.  Every LM arch's stack programs are also partitioned under
a production-shaped (data 4 x model 2) mesh skeleton, collapsed per shard
and held to the ``dist.*`` family; ``dist-partition`` self-tests that
family against seeded mutants; ``serve-dist`` self-tests the serving
decode-cache partition's ``dist.serve-*`` family the same way.

Exit status is 1 when any error-severity finding survives; warnings are
reported but do not fail the run.  ``--out`` writes every finding as JSON.

Usage:
  python -m repro_torch.lint                      # all archs on the H100
  python -m repro_torch.lint --device tiny --arch deepseek-7b
  python -m repro_torch.lint --arch dist-partition --arch serve-dist
  python -m repro_torch.lint --out chiprun_out/verify_report.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from types import SimpleNamespace

from repro_torch.core import analyzer, collapse, ir, partition, resource
from repro_torch.core import api as core_api
from repro_torch.core import verify

#: Rows the LM stack programs are verified at (the plans are re-derived
#: per shape at optimize() time anyway).
_ROWS = 512

_DEVICES = {"h100": resource.H100, "tiny": resource.TINY_DEVICE}

#: Arch ids of the mesh self-tests.
MESH_ARCHS = ("dist-partition", "serve-dist")

#: Production-shaped mesh skeleton the ``dist.*`` family is linted against:
#: 4-way data x 2-way model, no ranks needed (the planner and the verifier
#: reason about :class:`repro_torch.core.partition.MeshAxes` only).
_DIST_AXES = partition.MeshAxes(("data", "model"), (4, 2))


def lint_program(program: ir.StackProgram,
                 shapes: dict[str, tuple[int, ...]],
                 device: resource.DeviceSpec,
                 itemsize: int) -> list[verify.Finding]:
    """Verify one stack program end to end: well-formedness, then a
    collapse under both inference and training sizing with plan-legality
    and write-model checks on each."""
    fs = verify.check_program(program, shapes=shapes)
    if verify.errors(fs):
        return fs                    # collapse needs a well-formed program
    for differentiable in (False, True):
        try:
            plan = collapse.collapse(program, shapes, device,
                                     itemsize=itemsize,
                                     differentiable=differentiable)
        except Exception as e:  # noqa: BLE001 (a lint must not crash)
            fs.append(verify.Finding(
                "plan.budget-exceeded", "error", program.name,
                f"collapse failed ({'train' if differentiable else 'infer'}"
                f" sizing): {type(e).__name__}: {e}"))
            continue
        fs.extend(verify.check_plan(plan, itemsize=itemsize,
                                    differentiable=differentiable))
        if differentiable:
            fs.extend(verify.check_differentiable(program))
        for spec in verify.plan_write_specs(plan,
                                            differentiable=differentiable):
            fs.extend(verify.check_write_spec(spec))
    return fs


def lint_dist_program(program: ir.StackProgram,
                      shapes: dict[str, tuple[int, ...]],
                      device: resource.DeviceSpec, itemsize: int,
                      axes: partition.MeshAxes = _DIST_AXES
                      ) -> list[verify.Finding]:
    """The ``dist.*`` family over one stack program: derive the partition
    ``optimize`` would commit under a production-shaped mesh, collapse
    against the implied per-shard view, and hand both to
    :func:`repro_torch.core.verify.check_partitions`."""
    # stack params (norm gain/bias) broadcast over rows: feature-shaped
    feat = next(iter(shapes.values()))[-1]
    param_shapes = {p: (feat,)
                    for p in partition.stack_param_names(program)}
    part = partition.plan_stack(program, shapes, param_shapes, "both", axes,
                                sublane=device.sublane)
    plans: dict[int, object] = {}
    if part.active:
        shard_in = partition.shard_shapes(shapes, part.in_specs, axes)
        sdev = resource.shard_device(device, axes.n_devices)
        try:
            plans[0] = collapse.collapse(program, shard_in, sdev,
                                         itemsize=itemsize)
        except Exception as e:  # noqa: BLE001 (a lint must not crash)
            return [verify.Finding(
                "dist.vmem-refit", "error", program.name,
                f"per-shard collapse failed: {type(e).__name__}: {e}")]
    pp = partition.PartitionPlan(axes=axes, partition="both",
                                 segments={0: part})
    seg = SimpleNamespace(is_stack=True, stack=program, op=None)
    cfg = SimpleNamespace(device=device, itemsize=itemsize,
                          differentiable=False)
    return verify.check_partitions([seg], plans, pp, shapes, cfg)


def lint_lm_arch(arch: str, device: resource.DeviceSpec,
                 rows: int = _ROWS) -> list[verify.Finding]:
    """Verify the stack programs an LM arch's blocks dispatch through, at
    that arch's real widths (bf16 sizing)."""
    from repro_torch.configs import get_config
    from repro_torch.layers import stacks

    cfg = get_config(arch)
    has_bias = cfg.norm == "layer"
    cases = [
        (stacks.norm_program(cfg.norm, 1e-6, has_bias),
         {"x": (rows, cfg.d_model)}),
        (stacks.addnorm_program(cfg.norm, 1e-6, has_bias),
         {"x": (rows, cfg.d_model), "res": (rows, cfg.d_model)}),
    ]
    if cfg.d_ff:
        cases.append((stacks.glu_program(cfg.act),
                      {"gate": (rows, cfg.d_ff), "up": (rows, cfg.d_ff)}))
        cases.append((stacks.act_program(cfg.act),
                      {"x": (rows, cfg.d_ff)}))
    fs: list[verify.Finding] = []
    for program, shapes in cases:
        fs.extend(lint_program(program, shapes, device, itemsize=2))
        fs.extend(lint_dist_program(program, shapes, device, itemsize=2))
    return fs


def lint_cnn(device: resource.DeviceSpec,
             input_shape: tuple[int, ...] = (1, 32, 32, 3)
             ) -> list[verify.Finding]:
    """Verify the paper's CNN domain: the VGG NetGraph (graph SSA and dead
    values), then every nhwc stack segment through the same program, plan
    and write-model pass (float32 sizing)."""
    from repro_torch.models import cnn

    graph, _params = cnn.vgg_net(device="cpu")
    segments = analyzer.analyze(graph, layout="nhwc",
                                keep=frozenset({graph.output}))
    shapes: dict[str, tuple[int, ...]] = {graph.input: input_shape}
    for seg in segments:
        if seg.is_stack:
            in_shapes = {v: shapes[v] for v in seg.stack.inputs}
            shapes.update(ir.infer_shapes(seg.stack, in_shapes))
        else:
            core_api._infer_opaque_shape(seg.op, shapes)
    fs = list(verify.check_graph(graph, shapes=shapes,
                                 keep=frozenset({graph.output})))
    for seg in segments:
        if not seg.is_stack:
            continue
        in_shapes = {v: shapes[v] for v in seg.stack.inputs}
        fs.extend(lint_program(seg.stack, in_shapes, device, itemsize=4))
    return fs


def lint_paged_kv() -> list[verify.Finding]:
    """Self-test of the ``kv.*`` family (the serve engine's paged KV
    cache): a consistent allocator snapshot must verify clean, and a seeded
    mutant (one shared block left writable by two slot tables without a
    copy-on-write fork) must be caught and must raise under
    ``verify='strict'``.  A checker that waves the mutant through is
    itself the lint failure."""
    fs: list[verify.Finding] = []
    clean = verify.BlockTableState(
        num_blocks=8, block_size=4,
        refcounts=(2, 1, 1, 0, 0, 0, 0, 1),
        free=(3, 4, 5, 6),
        tables=((0, 1), (0, 2)),        # block 0 is a shared prefix
        lengths=(8, 7),
        cached=(7,),
        writers=(1, 2))                 # private tails only: sound
    for f in verify.check_block_tables(clean):
        fs.append(verify.Finding(
            f.invariant, "error", "paged-kv/selftest-clean",
            f"checker flagged a consistent snapshot: {f}"))
    # the seeded mutant: the shared block 0 joins the write set un-forked
    mutant = dataclasses.replace(clean, writers=(0, 1, 2))
    got = verify.check_block_tables(mutant)
    if not any(f.invariant == "kv.shared-writable" and f.severity == "error"
               for f in got):
        fs.append(verify.Finding(
            "kv.shared-writable", "error", "paged-kv/selftest-mutant",
            "seeded double-mapped writable block was not caught"))
        return fs
    try:
        verify.enforce(got, "strict", subject="paged-kv selftest")
    except verify.VerifyError:
        pass
    else:
        fs.append(verify.Finding(
            "kv.shared-writable", "error", "paged-kv/selftest-mutant",
            "strict mode did not raise on the seeded mutant"))
    return fs


def lint_dist_selftest(device: resource.DeviceSpec) -> list[verify.Finding]:
    """Self-test of the ``dist.*`` family against seeded mutants: the
    planner's partition of a norm stack must verify clean, while tampered
    copies (a trailing-dim shard across a feature reduction, an over-rank
    spec, a spec naming a mesh axis that does not exist, and a kernel spec
    splitting the rms reduction) must each be caught.  A checker that
    waves a mutant through is itself the lint failure."""
    from repro_torch.layers import stacks

    P = partition.PartitionSpec
    fs: list[verify.Finding] = []
    axes = _DIST_AXES
    program = stacks.norm_program("rms", 1e-6, False)
    shapes = {"x": (512, 256)}
    part = partition.plan_stack(
        program, shapes,
        {p: (256,) for p in partition.stack_param_names(program)},
        "both", axes, sublane=device.sublane)
    cfg = SimpleNamespace(device=device, itemsize=2, differentiable=False)
    seg = SimpleNamespace(is_stack=True, stack=program, op=None)

    def run(p):
        pp = partition.PartitionPlan(axes=axes, partition="both",
                                     segments={0: p})
        return verify.check_partitions([seg], {}, pp, shapes, cfg)

    if not part.active:
        fs.append(verify.Finding(
            "dist.spec-rank", "error", "dist-partition/selftest-clean",
            "planner replicated a cleanly shardable norm stack: "
            f"{part.notes}"))
    for f in run(part):
        fs.append(verify.Finding(
            f.invariant, "error", "dist-partition/selftest-clean",
            f"checker flagged a planner-derived partition: {f}"))
    mutants = [
        ("dist.collective-placement",
         dataclasses.replace(part, in_specs={"x": P("data", "model")})),
        ("dist.spec-rank",
         dataclasses.replace(part,
                             in_specs={"x": P("data", None, "model")})),
        ("dist.mesh-axis",
         dataclasses.replace(part, in_specs={"x": P("pod", None)})),
    ]
    for want, mutant in mutants:
        if not any(f.invariant == want and f.severity == "error"
                   for f in run(mutant)):
            fs.append(verify.Finding(
                want, "error", "dist-partition/selftest-mutant",
                f"seeded {want} mutant was not caught"))
    # kernel-side fence: an rmsnorm KERNEL op whose feature dim (the rms
    # reduction) is sharded over "model" must be refused
    op = SimpleNamespace(name="rmsnorm_site", output="out",
                         attrs={"kernel": "rmsnorm",
                                "arg_shapes": ((512, 256), (256,)),
                                "out_shape": (512, 256)})
    kseg = SimpleNamespace(is_stack=False, stack=None, op=op)
    kpart = partition.SegmentPartition(
        in_specs={"arg0": P("data", "model"), "arg1": P("model")},
        out_specs={"out": P("data", "model")},
        param_specs={}, shard_shapes={}, notes=())
    pp = partition.PartitionPlan(axes=axes, partition="both",
                                 segments={0: kpart})
    got = verify.check_partitions([kseg], {}, pp, shapes, cfg)
    if not any(f.invariant == "dist.collective-placement"
               and f.severity == "error" for f in got):
        fs.append(verify.Finding(
            "dist.collective-placement", "error",
            "dist-partition/selftest-mutant",
            "seeded rmsnorm feature-dim shard was not caught"))
    return fs


def lint_serve_dist() -> list[verify.Finding]:
    """Self-test of the ``dist.serve-*`` family (the mesh engine's
    decode-cache partition): the planner's plan for a dense qwen2.5-32b
    cache under the production-shaped mesh must engage both splits and
    verify clean, while seeded mutants (a pool leaf sharded over the
    batch axis, an over-rank spec, a spec naming a mesh axis that does not
    exist, and one slot leaf left replicated while the rest shard) must
    each be caught, and strict mode must raise.  A checker that waves a
    mutant through is itself the lint failure."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm

    P = partition.PartitionSpec
    fs: list[verify.Finding] = []
    axes = _DIST_AXES
    cfg = get_config("qwen2.5-32b").reduced()
    slots = 8
    # shapes only: the lint never materialises the cache
    shapes = lm.init_decode_cache(cfg, slots, 64, dtype=torch.float32,
                                  device="meta")
    plan = partition.plan_decode_cache(
        shapes, "auto", axes, slots=slots,
        head_extents=(cfg.n_heads, cfg.n_kv_heads))
    if not (plan.use_data and plan.use_model):
        fs.append(verify.Finding(
            "dist.serve-slot-axis", "error", "serve-dist/selftest-clean",
            f"planner fenced a cleanly shardable dense cache: {plan.notes}"))
    for f in verify.check_decode_plan(plan):
        fs.append(verify.Finding(
            f.invariant, "error", "serve-dist/selftest-clean",
            f"checker flagged a planner-derived decode plan: {f}"))

    def mutate(field: str, **changes) -> partition.DecodeCachePlan:
        # every leaf whose path ends in `field` (the "k" of each layer)
        leaves = tuple(
            dataclasses.replace(leaf, **changes)
            if leaf.path.rsplit("/", 1)[-1] == field else leaf
            for leaf in plan.leaves)
        return dataclasses.replace(plan, leaves=leaves)

    k_leaf = next(leaf for leaf in plan.leaves
                  if leaf.path.rsplit("/", 1)[-1] == "k")
    rank = len(k_leaf.shape)
    mutants = [
        # the KV columns declared a shared pool while still slot-sharded
        ("dist.serve-pool-write", mutate("k", kind="pool")),
        ("dist.spec-rank", mutate("k", spec=P(*([None] * (rank + 1))))),
        ("dist.mesh-axis", mutate("k", spec=P("pod"))),
        # lengths replicated while the KV slot dims shard over "data"
        ("dist.serve-slot-axis", mutate("length", spec=P(None))),
    ]
    for want, mutant in mutants:
        got = verify.check_decode_plan(mutant)
        if not any(f.invariant == want and f.severity == "error"
                   for f in got):
            fs.append(verify.Finding(
                want, "error", "serve-dist/selftest-mutant",
                f"seeded {want} mutant was not caught"))
            continue
        try:
            verify.enforce(got, "strict", subject="serve-dist selftest")
        except verify.VerifyError:
            pass
        else:
            fs.append(verify.Finding(
                want, "error", "serve-dist/selftest-mutant",
                f"strict mode did not raise on the seeded {want} mutant"))
    return fs


def lint_arch(arch: str, device: resource.DeviceSpec,
              rows: int = _ROWS) -> list[verify.Finding]:
    if arch == "serve-dist":
        return lint_serve_dist()
    if arch == "dist-partition":
        return lint_dist_selftest(device)
    if arch == "brainslug-cnn":
        return lint_cnn(device)
    if arch == "paged-kv":
        return lint_paged_kv()
    return lint_lm_arch(arch, device, rows)


def main(argv=None) -> int:
    from repro_torch.configs import ARCH_IDS

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="Static verification over the shipped architectures "
                    "(repro_torch.core.verify; no kernel is launched).")
    ap.add_argument("--arch", action="append", default=None,
                    help="arch id (repeatable); default: all")
    ap.add_argument("--device", choices=sorted(_DEVICES), default="h100")
    ap.add_argument("--rows", type=int, default=_ROWS,
                    help="row count LM stack programs are verified at")
    ap.add_argument("--out", default=None,
                    help="write the findings as JSON to this path")
    args = ap.parse_args(argv)

    archs = args.arch or [*ARCH_IDS, "brainslug-cnn", "paged-kv",
                          *MESH_ARCHS]
    device = _DEVICES[args.device]

    report: dict = {"device": device.name, "archs": {}}
    n_errors = n_warnings = 0
    for arch in archs:
        try:
            findings = lint_arch(arch, device, args.rows)
        except Exception as e:  # noqa: BLE001 (record and continue)
            findings = [verify.Finding(
                "graph.shape-mismatch", "error", arch,
                f"lint crashed: {type(e).__name__}: {e}")]
        errs = verify.errors(findings)
        warns = [f for f in findings if f.severity != "error"]
        n_errors += len(errs)
        n_warnings += len(warns)
        status = "error" if errs else ("warning" if warns else "clean")
        report["archs"][arch] = {
            "status": status,
            "findings": [f.to_json() for f in findings],
        }
        print(f"[{status:>7}] {arch}: {len(errs)} error(s), "
              f"{len(warns)} warning(s)")
        for f in findings:
            print(f"    {f}")
    report["n_errors"] = n_errors
    report["n_warnings"] = n_warnings

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"report: {args.out}")
    print(f"total: {n_errors} error(s), {n_warnings} warning(s) across "
          f"{len(archs)} arch(s)")
    return 1 if n_errors else 0


if __name__ == "__main__":
    sys.exit(main())
