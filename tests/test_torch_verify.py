"""The port's static verifier (``repro_torch.core.verify``) on the CPU.

Seeded mutants: each corrupts one compile artifact after it was produced
(so the code that produced it cannot notice) and must be caught under its
named invariant, raise under ``verify='strict'``, warn and be recorded
under ``'warn'``, and stay silent under ``'off'``; the pipeline gates
(``compile_stacks`` raises before codegen, ``optimize`` and
``optimize_graph`` record findings for ``report()``).

Parity: on ``TINY_DEVICE`` (the spec both packages share) the JAX
package's ``repro.core.verify`` and the port's give the same set of
``(invariant, severity, subject)`` on the same programs, plans and graphs,
clean and under every mutant outside the ``grid.*`` family.

The grid family on the port's own write models (``write_model`` of the
four fused-stack kernel modules) at 132 SMs and at 7 (a tail of masked
grid points): writes disjoint, every live point in bounds, the live blocks
covering each output exactly once (counted block by block here, apart
from the verifier's own check), one partials row per program; a
``grid-sum`` spec, which the JAX package accepts on its sequential grid,
is an error on a CUDA grid.  The models are checked against the kernels'
real writes only on the card (``chip_smoke.py`` phase 28c)."""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro.core import collapse as jcollapse
from repro.core import ir as jir
from repro.core import registry as jregistry
from repro.core import resource as jresource
from repro.core import verify as jverify
from repro.kernels.fused_stack import nhwc as jnhwc
from repro.layers import stacks as jstacks
from repro_torch import api
from repro_torch.core import analyzer, codegen, collapse, ir, resource, verify
from repro_torch.core import api as core_api
from repro_torch.core import registry as registry_mod
from repro_torch.core import trace as trace_mod
from repro_torch.kernels.fused_stack import nhwc, nhwc_bwd, rows, rows_bwd
from repro_torch.layers import stacks as tstacks

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# Artifact builders, one per package (``m`` is a package's ir module).
# ---------------------------------------------------------------------------

def rows_program(m=ir):
    return m.StackProgram(
        name="glu", inputs=("gate", "up"), outputs=("y",), layout="rows",
        ops=(m.OpNode(m.OpKind.EW_UNARY, "act", ("gate",), "a", fn="silu"),
             m.OpNode(m.OpKind.EW_BINARY, "mul", ("a", "up"), "y",
                      fn="mul")))


ROWS_SHAPES = {"gate": (64, 128), "up": (64, 128)}


def nhwc_program(m=ir):
    return m.StackProgram(
        name="block", inputs=("x",), outputs=("r",), layout="nhwc",
        ops=(m.OpNode(m.OpKind.POOL2D, "pool", ("x",), "p", fn="max",
                      attrs={"window": (3, 3), "stride": (1, 1),
                             "padding": (1, 1)}),
             m.OpNode(m.OpKind.AFFINE, "bn", ("p",), "b", params=("s", "o")),
             m.OpNode(m.OpKind.EW_UNARY, "relu", ("b",), "r", fn="relu")))


NHWC_SHAPES = {"x": (1, 16, 16, 8)}


def rows_plan(device=resource.H100, pkg=collapse, m=ir, **overrides):
    plan = pkg.collapse(rows_program(m), ROWS_SHAPES, device, itemsize=4)
    return dataclasses.replace(plan, **overrides) if overrides else plan


def nhwc_plan(differentiable=False):
    return collapse.collapse(nhwc_program(), NHWC_SHAPES, resource.H100,
                             itemsize=4, differentiable=differentiable)


def corrupt(obj, **fields):
    """Mutate a frozen dataclass in place, after the fact: the drift the
    verifier exists to catch."""
    for k, v in fields.items():
        object.__setattr__(obj, k, v)
    return obj


def swiglu_kernel_op(m=ir, **attr_overrides):
    attrs = {"kernel": "swiglu",
             "slots": (("in", "gate"), ("in", "up")),
             "arg_shapes": ((64, 128), (64, 128)),
             "arg_dtypes": ("float32", "float32"),
             "out_shape": (64, 128), "out_dtype": "float32",
             "act": "silu"}
    attrs.update(attr_overrides)
    return m.OpNode(m.OpKind.KERNEL, "swiglu0", ("gate", "up"), "y",
                    attrs=attrs)


KERNEL_SHAPES = {"gate": (64, 128), "up": (64, 128), "y": (64, 128)}


# ---------------------------------------------------------------------------
# The mutant matrix.  Each builder takes (package, monkeypatch); ``P`` is
# the port, ``J`` the JAX package, for the parity test below.
# ---------------------------------------------------------------------------

P = dict(ir=ir, collapse=collapse, resource=resource, verify=verify,
         nhwc=nhwc, registry=registry_mod, device=resource.H100)
J = dict(ir=jir, collapse=jcollapse, resource=jresource, verify=jverify,
         nhwc=jnhwc, registry=jregistry, device=jresource.TINY_DEVICE)


def _m_def_before_use(k, mp):
    prog = rows_program(k["ir"])
    corrupt(prog, ops=tuple(reversed(prog.ops)))
    return k["verify"].check_program(prog)


def _m_redefinition(k, mp):
    prog = rows_program(k["ir"])
    corrupt(prog.ops[1], output="a")            # clobbers act's output
    return k["verify"].check_program(prog)


def _m_output_undefined(k, mp):
    prog = rows_program(k["ir"])
    corrupt(prog, outputs=("ghost",))
    return k["verify"].check_program(prog)


def _m_unknown_fn(k, mp):
    prog = rows_program(k["ir"])
    corrupt(prog.ops[0], fn="frobnicate")
    return k["verify"].check_program(prog)


def _m_program_shape_drift(k, mp):
    # the recorded shape of an op output contradicts the op semantics
    shapes = dict(ROWS_SHAPES, a=(64, 64), y=(64, 128))
    return k["verify"].check_program(rows_program(k["ir"]), shapes=shapes)


def _m_program_dtype_drift(k, mp):
    shapes = dict(ROWS_SHAPES, a=(64, 128), y=(64, 128))
    dtypes = {"gate": "float32", "up": "float32", "a": "float16",
              "y": "float32"}
    return k["verify"].check_program(rows_program(k["ir"]), shapes=shapes,
                                     dtypes=dtypes)


def _m_graph_shape_drift(k, mp):
    m = k["ir"]
    graph = m.NetGraph(
        name="g", input="x", output="p",
        ops=(m.OpNode(m.OpKind.POOL2D, "pool", ("x",), "p", fn="max",
                      attrs={"window": (2, 2), "stride": (2, 2),
                             "padding": (0, 0)}),))
    # the right output shape is (1, 8, 8, 8): the recorded one lies
    shapes = {"x": (1, 16, 16, 8), "p": (1, 16, 16, 8)}
    return k["verify"].check_graph(graph, shapes=shapes)


def _plan(k):
    return rows_plan(k["device"], k["collapse"], k["ir"])


def _m_partition_gap(k, mp):
    plan = _plan(k)
    seq = plan.sequences[0]
    corrupt(seq, steps=seq.steps[1:])           # the first step vanishes
    return k["verify"].check_plan(plan, itemsize=4)


def _m_partition_overlap(k, mp):
    plan = _plan(k)
    seq = plan.sequences[0]
    corrupt(seq, steps=seq.steps + seq.steps[:1])
    return k["verify"].check_plan(plan, itemsize=4)


def _m_budget_exceeded(k, mp):
    plan = rows_plan(k["resource"].TINY_DEVICE, k["collapse"], k["ir"])
    corrupt(plan.sequences[0], tile_rows=1 << 16)
    return k["verify"].check_plan(plan, itemsize=4)


def _m_tile_not_positive(k, mp):
    plan = _plan(k)
    corrupt(plan.sequences[0], tile_rows=-8)
    return k["verify"].check_plan(plan, itemsize=4)


def _m_halo_mismatch(k, mp):
    prog = nhwc_program(k["ir"])
    image_hw = [(16, 16)] * 4
    levels = list(k["nhwc"]._plan_levels(prog.ops, 8, 8, image_hw))
    # the input level's halo origin shifted by one: every tile loads a
    # window displaced from its receptive field
    levels[0] = dataclasses.replace(levels[0], off_h=levels[0].off_h + 1)
    return k["verify"].check_nhwc_levels(prog, levels, 8, 8, image_hw)


def _m_missing_vjp(k, mp):
    prog = rows_program(k["ir"])
    corrupt(prog.ops[0], fn="frobnicate")       # no derivative entry
    return k["verify"].check_differentiable(prog)


def _m_write_race(k, mp):
    return k["verify"].check_write_spec(k["verify"].WriteSpec(
        name="race", grid=(4,), block_shape=(8, 128),
        index_map=lambda i: (0, 0), array_shape=(32, 128)))


def _m_write_out_of_bounds(k, mp):
    return k["verify"].check_write_spec(k["verify"].WriteSpec(
        name="oob", grid=(4,), block_shape=(8, 128),
        index_map=lambda i: (i + 1, 0), array_shape=(32, 128)))


def _m_bad_accumulator(k, mp):
    # claims grid-sum but addresses a different block a point
    return k["verify"].check_write_spec(k["verify"].WriteSpec(
        name="acc", grid=(4,), block_shape=(8, 128),
        index_map=lambda i: (i, 0), array_shape=(32, 128),
        accumulate="grid-sum"))


def _m_unknown_kernel(k, mp):
    return k["verify"].check_kernel_op(
        swiglu_kernel_op(k["ir"], kernel="nonexistent"))


def _m_slots_mismatch(k, mp):
    return k["verify"].check_kernel_op(swiglu_kernel_op(
        k["ir"], slots=(("in", "gate"), ("in", "wrong"))))


def _m_kernel_aval_mismatch(k, mp):
    return k["verify"].check_kernel_op(
        swiglu_kernel_op(k["ir"]),
        shapes=dict(KERNEL_SHAPES, gate=(64, 256)))


def _m_kernel_out_contract(k, mp):
    # out_shape breaks the swiglu contract (out == arg_shapes[0])
    return k["verify"].check_kernel_op(
        swiglu_kernel_op(k["ir"], out_shape=(64, 256)))


def _m_kernel_no_vjp(k, mp):
    reg = k["registry"]
    mp.setitem(reg.REGISTRY, "swiglu",
               dataclasses.replace(reg.REGISTRY["swiglu"], vjp=None))
    return k["verify"].check_kernel_op(swiglu_kernel_op(k["ir"]),
                                       differentiable=True)


MUTANTS = [
    # graph / program well-formedness
    ("program-def-before-use", "program.def-before-use", _m_def_before_use),
    ("program-redefinition", "program.redefinition", _m_redefinition),
    ("program-output-undefined", "program.output-undefined",
     _m_output_undefined),
    ("program-unknown-fn", "program.unknown-fn", _m_unknown_fn),
    ("program-shape-drift", "program.shape-mismatch",
     _m_program_shape_drift),
    ("program-dtype-drift", "program.dtype-mismatch",
     _m_program_dtype_drift),
    ("graph-shape-drift", "graph.shape-mismatch", _m_graph_shape_drift),
    # CollapsePlan legality
    ("plan-partition-gap", "plan.partition-gap", _m_partition_gap),
    ("plan-partition-overlap", "plan.partition-overlap",
     _m_partition_overlap),
    ("plan-budget-exceeded", "plan.budget-exceeded", _m_budget_exceeded),
    ("plan-tile-not-positive", "plan.tile-coverage", _m_tile_not_positive),
    ("plan-halo-mismatch", "plan.halo-mismatch", _m_halo_mismatch),
    ("plan-missing-vjp", "plan.missing-vjp", _m_missing_vjp),
    # grid write model
    ("grid-write-race", "grid.write-race", _m_write_race),
    ("grid-out-of-bounds", "grid.out-of-bounds", _m_write_out_of_bounds),
    ("grid-bad-accumulator", "grid.accumulator", _m_bad_accumulator),
    # registry rewrite soundness
    ("kernel-unknown", "kernel.unknown", _m_unknown_kernel),
    ("kernel-slots-mismatch", "kernel.slots-mismatch", _m_slots_mismatch),
    ("kernel-aval-mismatch", "kernel.aval-mismatch",
     _m_kernel_aval_mismatch),
    ("kernel-out-contract", "kernel.aval-mismatch", _m_kernel_out_contract),
    ("kernel-no-vjp", "kernel.no-vjp", _m_kernel_no_vjp),
]
IDS = [m[0] for m in MUTANTS]


class TestMutants:
    """Every injected corruption is caught under its named invariant and
    follows the strict / warn / off policy."""

    @pytest.mark.parametrize("mid,invariant,builder", MUTANTS, ids=IDS)
    def test_caught_with_named_invariant(self, mid, invariant, builder,
                                         monkeypatch):
        errs = verify.errors(builder(P, monkeypatch))
        assert errs, f"mutant {mid} produced no error finding"
        assert any(f.invariant == invariant for f in errs), \
            [f.invariant for f in errs]
        for f in errs:
            assert f.invariant in verify.INVARIANTS
            assert f.source == verify.INVARIANTS[f.invariant][0]

    @pytest.mark.parametrize("mid,invariant,builder", MUTANTS, ids=IDS)
    def test_strict_raises(self, mid, invariant, builder, monkeypatch):
        findings = builder(P, monkeypatch)
        with pytest.raises(verify.VerifyError) as e:
            verify.enforce(findings, "strict")
        assert invariant in {f.invariant for f in e.value.findings}
        assert invariant in str(e.value)        # names the first violation

    @pytest.mark.parametrize("mid,invariant,builder", MUTANTS, ids=IDS)
    def test_warn_warns(self, mid, invariant, builder, monkeypatch):
        findings = builder(P, monkeypatch)
        with pytest.warns(UserWarning, match="repro_torch.verify"):
            verify.enforce(findings, "warn")

    @pytest.mark.parametrize("mid,invariant,builder", MUTANTS, ids=IDS)
    def test_off_is_silent(self, mid, invariant, builder, monkeypatch):
        findings = builder(P, monkeypatch)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            verify.enforce(findings, "off")     # no raise, no warning

    def test_unknown_mode_rejected(self):
        with pytest.raises(ValueError, match="unknown verify mode"):
            verify.enforce([], "bogus")


# ---------------------------------------------------------------------------
# Parity with the JAX package on TINY_DEVICE.
# ---------------------------------------------------------------------------

def _keys(findings):
    return {(f.invariant, f.severity, f.subject) for f in findings}


NON_GRID = [m for m in MUTANTS if not m[1].startswith("grid.")]


@pytest.mark.parametrize("mid,invariant,builder", NON_GRID,
                         ids=[m[0] for m in NON_GRID])
def test_mutant_findings_match_jax(mid, invariant, builder, monkeypatch):
    tiny_p = dict(P, device=resource.TINY_DEVICE)
    got, want = builder(tiny_p, monkeypatch), builder(J, monkeypatch)
    assert _keys(got) == _keys(want)
    assert invariant in {f.invariant for f in got}


def _stack_cases(stacks, rows=64, d=128, d_ff=256):
    return [
        (stacks.norm_program("rms", 1e-6, False), {"x": (rows, d)}),
        (stacks.norm_program("layer", 1e-6, True), {"x": (rows, d)}),
        (stacks.addnorm_program("rms", 1e-6, False),
         {"x": (rows, d), "res": (rows, d)}),
        (stacks.glu_program("silu"),
         {"gate": (rows, d_ff), "up": (rows, d_ff)}),
        (stacks.act_program("gelu"), {"x": (rows, d_ff)}),
    ]


def _plan_findings(v, pkg, device, program, shapes, differentiable):
    plan = pkg.collapse(program, shapes, device, itemsize=4,
                        differentiable=differentiable)
    fs = v.check_program(program, shapes=shapes)
    fs += v.check_plan(plan, itemsize=4, differentiable=differentiable)
    if differentiable:
        fs += v.check_differentiable(program)
    return [f for f in fs if not f.invariant.startswith("grid.")]


@pytest.mark.parametrize("differentiable", [False, True])
@pytest.mark.parametrize("case", range(5))
def test_stack_programs_match_jax(case, differentiable):
    """The layers' stack programs at small widths, collapsed on the tiny
    device by each package: the same findings (clean)."""
    jp, shapes = _stack_cases(jstacks)[case]
    tp, _ = _stack_cases(tstacks)[case]
    want = _plan_findings(jverify, jcollapse, jresource.TINY_DEVICE, jp,
                          shapes, differentiable)
    got = _plan_findings(verify, collapse, resource.TINY_DEVICE, tp,
                         shapes, differentiable)
    assert _keys(got) == _keys(want) == set()


@pytest.mark.parametrize("differentiable", [False, True])
def test_vgg_graph_matches_jax(differentiable):
    """The VGG NetGraph at (1, 32, 32, 3): graph checks and every nhwc
    sequence's plan checks, the same in both packages (clean)."""
    from repro.core import analyzer as janalyzer
    from repro.core import api as jcore_api
    from repro.models import cnn as jcnn
    from repro_torch.models import cnn as tcnn

    def run(v, an, capi, m, pkg, dev, graph):
        segs = an.analyze(graph, layout="nhwc",
                          keep=frozenset({graph.output}))
        shapes = {graph.input: (1, 32, 32, 3)}
        for seg in segs:
            if seg.is_stack:
                shapes.update(m.infer_shapes(
                    seg.stack, {x: shapes[x] for x in seg.stack.inputs}))
            else:
                capi._infer_opaque_shape(seg.op, shapes)
        fs = v.check_graph(graph, shapes=shapes,
                           keep=frozenset({graph.output}))
        for seg in segs:
            if seg.is_stack:
                fs += _plan_findings(
                    v, pkg, dev, seg.stack,
                    {x: shapes[x] for x in seg.stack.inputs},
                    differentiable)
        return fs

    want = run(jverify, janalyzer, jcore_api, jir, jcollapse,
               jresource.TINY_DEVICE, jcnn.vgg_net()[0])
    got = run(verify, analyzer, core_api, ir, collapse,
              resource.TINY_DEVICE, tcnn.vgg_net(device="cpu")[0])
    assert _keys(got) == _keys(want) == set()


def test_invariant_ids_match_jax():
    """Every invariant of the JAX package's verifier has its row here, the
    serving partition family (``dist.serve-*``) included; the port adds
    ``grid.coverage``."""
    assert set(verify.INVARIANTS) == set(jverify.INVARIANTS) | {
        "grid.coverage"}
    assert {k for k in verify.INVARIANTS if k.startswith("dist.serve-")} \
        == {"dist.serve-slot-axis", "dist.serve-pool-write"}
    for k, (source, _) in verify.INVARIANTS.items():
        assert source.startswith("src/repro_torch/"), k


def test_tiny_plan_over_budget_matches_jax():
    """A row too wide for the tiny device: both packages refuse to plan
    it (the port's one-sublane rule changes nothing where the budget is
    all of the fast memory)."""
    shapes = {"gate": (64, 11008), "up": (64, 11008)}
    with pytest.raises(jresource.ResourceError):
        jcollapse.collapse(rows_program(jir), shapes, jresource.TINY_DEVICE)
    with pytest.raises(resource.ResourceError):
        collapse.collapse(rows_program(), shapes, resource.TINY_DEVICE)


# ---------------------------------------------------------------------------
# Plans that verify clean; the H100's one-sublane rows tile.
# ---------------------------------------------------------------------------

def test_valid_plans_produce_no_findings():
    assert verify.errors(verify.check_plan(rows_plan(), itemsize=4)) == []
    for differentiable in (False, True):
        plan = nhwc_plan(differentiable)
        assert verify.check_plan(plan, itemsize=4,
                                 differentiable=differentiable) == []


def test_wide_row_plans_on_one_sublane_within_a_cta():
    """qwen2.5-32b's glu at d_ff 27648 in bf16 (165,888 B a row) exceeds
    the H100's budget but fits the 232,448 B a CTA may opt in to: it plans
    a one-row tile, which verifies; a row past even that still fails."""
    shapes = {"gate": (512, 27648), "up": (512, 27648)}
    plan = collapse.collapse(rows_program(), shapes, resource.H100,
                             itemsize=2)
    assert [s.tile_rows for s in plan.sequences] == [1]
    assert verify.check_plan(plan, itemsize=2) == []
    corrupt(plan.sequences[0], tile_rows=2)
    assert {f.invariant for f in verify.check_plan(plan, itemsize=2)} == {
        "plan.budget-exceeded"}
    with pytest.raises(resource.ResourceError):
        collapse.collapse(rows_program(), shapes, resource.H100, itemsize=4)


def test_kernel_shared_memory_over_the_cta_limit_is_flagged():
    """The nhwc kernels size their own shared memory: a chain that
    reduces over C holds all of C a CTA, and 4096 channels of a 3 x 3
    halo patch do not fit."""
    prog = ir.StackProgram(
        name="wide", inputs=("x",), outputs=("y",), layout="nhwc",
        ops=(ir.OpNode(ir.OpKind.POOL2D, "p", ("x",), "p", fn="max",
                       attrs={"window": (3, 3), "stride": (1, 1),
                              "padding": (1, 1)}),
             ir.OpNode(ir.OpKind.ROW_SOFTMAX, "sm", ("p",), "y")))
    plan = collapse.collapse(prog, {"x": (1, 4, 4, 4096)},
                             resource.TINY_DEVICE, itemsize=1)
    fs = verify.check_plan(plan, itemsize=1)
    assert any(f.invariant == "plan.budget-exceeded"
               and "fused_nhwc" in f.detail for f in fs), fs


def test_kernel_tiles_are_held_to_the_halo_derivation(monkeypatch):
    """The halo check runs at the tiles the kernels pick: a drifted level
    planner shows at the fused path's 8 x 8 tile too."""
    prog = nhwc_program()
    shapes = ir.infer_shapes(prog, NHWC_SHAPES)
    real = nhwc._plan_levels

    def drifted(ops, out_h, out_w, image_hw):
        levels = real(ops, out_h, out_w, image_hw)
        return [dataclasses.replace(levels[0], off_w=levels[0].off_w + 1),
                *levels[1:]]

    monkeypatch.setattr(nhwc, "_plan_levels", drifted)
    # the drifted descriptors go to caches of their own, dropped after
    monkeypatch.setattr(nhwc, "_TEMPLATES", type(nhwc._TEMPLATES)())
    monkeypatch.setattr(nhwc_bwd, "_TEMPLATES", type(nhwc_bwd._TEMPLATES)())
    fs = verify._check_nhwc_kernels(prog, shapes, 8, 8, [(16, 16)] * 4,
                                    True, "block/seq0")
    subjects = {f.subject for f in fs if f.invariant == "plan.halo-mismatch"}
    assert {"block/seq0:fused_nhwc/level0",
            "block/seq0:fused_nhwc_bwd/level0"} <= subjects


# ---------------------------------------------------------------------------
# The grid family on the port's write models.
# ---------------------------------------------------------------------------

def _counts(spec):
    """How many live grid points write each element: block by block,
    independently of ``check_write_spec``'s vectorised proof."""
    counts = np.zeros(spec.array_shape, np.int32)
    stride = spec.stride or spec.block_shape
    offset = spec.offset or (0,) * len(stride)
    for p in np.ndindex(*spec.grid):
        if spec.live is not None and not bool(spec.live(*p)):
            continue
        idx = [int(c) for c in spec.index_map(*p)]
        counts[tuple(slice(max(i * s + o, 0), max(i * s + o + b, 0))
                     for i, s, o, b in zip(idx, stride, offset,
                                           spec.block_shape))] += 1
    return counts


def _live_points(spec):
    total = int(np.prod(spec.grid))
    if spec.live is None:
        return total
    return sum(bool(spec.live(*p)) for p in np.ndindex(*spec.grid))


def _rows_models(program, shapes, sm, f_chunk=resource.H100.f_chunk,
                 param_widths=None):
    in_w = {v: s[-1] for v, s in shapes.items()}
    feats = max(in_w.values())
    pw = param_widths or {p: feats for p in program.param_names}
    n_rows = int(np.prod(next(iter(shapes.values()))[:-1]))
    widths = rows.value_widths(program, in_w, pw)
    fwd = rows.write_model(program, widths, n_rows,
                           rows.forward_plan(n_rows, feats, sm))
    f_block = resource.feature_block(program, feats, f_chunk)
    bwd = rows_bwd.write_model(program, in_w, pw, n_rows,
                               rows_bwd.launch_plan(n_rows, feats, f_block,
                                                    sm))
    return [("fwd", m) for m in fwd] + [("bwd", m) for m in bwd]


def _norm_w1():
    """A layer norm with bias, times a width-1 gate: a width-1 input."""
    return ir.StackProgram(
        name="lnw1", inputs=("x", "g"), outputs=("y",), layout="rows",
        ops=(ir.OpNode(ir.OpKind.ROW_NORM, "ln", ("x",), "n",
                       params=("scale", "bias"),
                       attrs={"norm": "layer", "eps": 1e-6}),
             ir.OpNode(ir.OpKind.EW_BINARY, "m", ("n", "g"), "y", fn="mul")))


ROWS_CASES = {
    # name: (program, shapes, f_chunk): a tail of rows, chunked features
    "glu_2048x4096": (tstacks.glu_program("silu"),
                      {"gate": (2048, 4096), "up": (2048, 4096)}, 2048),
    "glu_chunked_ragged": (tstacks.glu_program("silu"),
                           {"gate": (3, 37, 5000), "up": (3, 37, 5000)},
                           2048),
    "addnorm_rows_4": (tstacks.addnorm_program("rms", 1e-6, False),
                       {"x": (4, 512), "res": (4, 512)}, 2048),
    "layernorm_width1_input": (_norm_w1(), {"x": (301, 96), "g": (301, 1)},
                               0),
    "gated_norm_chunked_width1": (
        ir.StackProgram(name="gw1", inputs=("x", "g"), outputs=("y",),
                        layout="rows",
                        ops=(ir.OpNode(ir.OpKind.EW_BINARY, "m", ("x", "g"),
                                       "y", fn="mul"),)),
        {"x": (33, 4100), "g": (33, 1)}, 2048),
}


def _nhwc_models(program, x_shape, tile, sm, extra_shapes=()):
    fwd = nhwc.write_model(program, x_shape, extra_shapes, tile, tile, sm)
    bwd = nhwc_bwd.write_model(program, x_shape, extra_shapes, tile, tile,
                               sm)
    return [("fwd", m) for m in fwd] + [("bwd", m) for m in bwd]


def _vgg_stage(pad=0):
    return ir.StackProgram(
        name="vggstage", inputs=("x",), outputs=("y",), layout="nhwc",
        ops=(ir.OpNode(ir.OpKind.AFFINE, "bn", ("x",), "b",
                       params=("s", "o")),
             ir.OpNode(ir.OpKind.EW_UNARY, "r", ("b",), "r", fn="relu"),
             ir.OpNode(ir.OpKind.POOL2D, "p", ("r",), "y", fn="max",
                       attrs={"window": (2, 2), "stride": (2, 2),
                              "padding": (pad, pad)})))


def _gapped():
    """2 x 2 windows on a stride of 3: tiles' input regions leave gaps,
    so the backward zeroes dx first."""
    return ir.StackProgram(
        name="gapped", inputs=("x",), outputs=("y",), layout="nhwc",
        ops=(ir.OpNode(ir.OpKind.EW_UNARY, "t", ("x",), "t", fn="tanh"),
             ir.OpNode(ir.OpKind.POOL2D, "p", ("t",), "y", fn="avg",
                       attrs={"window": (2, 2), "stride": (3, 3),
                              "padding": (0, 0)})))


def _rowred():
    return ir.StackProgram(
        name="rowred", inputs=("x",), outputs=("y",), layout="nhwc",
        ops=(ir.OpNode(ir.OpKind.ROW_NORM, "rms", ("x",), "n",
                       params=("g",), attrs={"norm": "rms", "eps": 1e-6}),
             ir.OpNode(ir.OpKind.POOL2D, "p", ("n",), "y", fn="max",
                       attrs={"window": (2, 2), "stride": (2, 2),
                              "padding": (0, 0)})))


NHWC_CASES = {
    # name: (program, x shape, planner tile)
    "vgg_stage1_fused": (_vgg_stage(), (2, 64, 48, 64), 8),
    "vgg_odd_two_blocks": (_vgg_stage(), (2, 15, 9, 72), 2),
    "vgg_padded": (_vgg_stage(1), (1, 13, 10, 6), 4),
    "block_patches": (nhwc_program(), (2, 20, 17, 8), 4),
    "gapped_zero_fill": (_gapped(), (1, 17, 16, 8), 2),
    "rowred_all_channels": (_rowred(), (1, 12, 10, 40), 4),
}


def _all_models(sm):
    out = []
    for name, (prog, shapes, f_chunk) in ROWS_CASES.items():
        out += [(name, k, m) for k, m in _rows_models(prog, shapes, sm,
                                                      f_chunk)]
    for name, (prog, shape, tile) in NHWC_CASES.items():
        out += [(name, k, m) for k, m in _nhwc_models(prog, shape, tile, sm)]
    return out


@pytest.mark.parametrize("sm", [132, 7])
def test_write_models_are_sound_and_cover_their_outputs(sm):
    """Every model of every case: no finding; each element of a covering
    model's array written by exactly one live point, and no element of any
    model's array written twice; partials one row a program."""
    masked = 0
    for name, kind, m in _all_models(sm):
        spec = verify.WriteSpec.from_model(f"{name}:{kind}", m)
        assert verify.check_write_spec(spec) == [], spec.name
        counts = _counts(spec)
        assert counts.max(initial=0) <= 1, spec.name
        if spec.covers:
            assert (counts == 1).all(), spec.name
        assert np.array_equal(verify.write_mask(spec), counts == 1), \
            spec.name
        if spec.accumulate == "partials":
            assert spec.array_shape[0] == spec.grid[0]
            assert spec.block_shape[0] == 1
        masked += int(np.prod(spec.grid)) - _live_points(spec)
    assert masked > 0               # persistent tails of masked points


def test_models_follow_the_wrappers_plans():
    """The models come from the plans the wrappers launch: the rows
    forward's grid is ``forward_plan``'s programs, the nhwc backward's
    patch path and zero fill follow ``bwd_template``'s descriptor."""
    prog, shapes, _ = ROWS_CASES["glu_2048x4096"]
    fplan = rows.forward_plan(2048, 4096, 132)
    (_, out), *_ = _rows_models(prog, shapes, 132)
    assert out["grid"][0] == fplan.n_prog and out["block_shape"] == (
        fplan.r_sub, fplan.block_f)
    names = {n: [m["name"] for k, m in _nhwc_models(*NHWC_CASES[n][:2],
                                                    NHWC_CASES[n][2], 132)
                 if k == "bwd"]
             for n in ("vgg_stage1_fused", "block_patches",
                       "gapped_zero_fill")}
    assert names == {"vgg_stage1_fused": ["dx", "partials", "dvecs"],
                     "block_patches": ["patches", "dx", "partials", "dvecs"],
                     "gapped_zero_fill": ["dx:zero", "dx"]}


def test_plan_write_specs_cover_every_launch():
    """``plan_write_specs`` on collapse plans: the forward's outputs, and
    for training the backward's cotangents, partials and sums."""
    plan = collapse.collapse(_norm_w1(), {"x": (301, 96), "g": (301, 1)},
                             resource.H100, differentiable=True)
    specs = verify.plan_write_specs(plan, differentiable=True,
                                    param_shapes={"scale": (96,),
                                                  "bias": (96,)})
    assert [s.name.split(":", 1)[1] for s in specs] == [
        "fwd:out:y", "bwd:din:x", "bwd:din:g", "bwd:partials",
        "bwd:dparams"]
    assert all(verify.check_write_spec(s) == [] for s in specs)
    specs = verify.plan_write_specs(nhwc_plan(True), differentiable=True)
    assert [s.name.split(":", 1)[1] for s in specs] == [
        "fwd:out", "bwd:patches", "bwd:dx", "bwd:partials", "bwd:dvecs"]


def test_dropped_block_is_flagged():
    """A model with one live block dropped no longer covers its output:
    ``grid.coverage`` names the block."""
    n_dropped = 0
    for name, kind, m in _all_models(132):
        spec = verify.WriteSpec.from_model(name, m)
        if not spec.covers or spec.grid == (1,):
            continue
        n_dropped += 1
        live = spec.live

        def dropped(*p, live=live):
            keep = np.ones(np.broadcast(*p).shape, bool) if live is None \
                else np.asarray(live(*p), bool)
            first = np.ones_like(keep)
            for c in p:
                first = first & (np.asarray(c) == 0)
            return keep & ~first

        bad = dataclasses.replace(spec, live=dropped)
        fs = verify.check_write_spec(bad)
        assert [f.invariant for f in fs] == ["grid.coverage"], spec.name
        assert "unwritten" in fs[0].detail
    assert n_dropped >= 20


def test_grid_sum_is_an_error_here_and_sound_in_jax():
    """The Pallas package's parameter-gradient accumulator: every grid
    point adds into one shared block, right on the TPU's sequential grid
    (JAX accepts it) and a race on a CUDA grid (the port flags it)."""
    kw = dict(name="acc", grid=(8,), block_shape=(1, 128),
              index_map=lambda i: (0 * i, 0 * i), array_shape=(1, 128),
              accumulate="grid-sum")
    assert jverify.check_write_spec(jverify.WriteSpec(**kw)) == []
    fs = verify.check_write_spec(verify.WriteSpec(**kw))
    assert [(f.invariant, f.severity) for f in fs] == [
        ("grid.accumulator", "error")]
    assert "concurrently" in fs[0].detail


def test_partials_must_be_one_row_a_program():
    kw = dict(name="p", grid=(4,), block_shape=(1, 16),
              array_shape=(4, 16), accumulate="partials")
    assert verify.check_write_spec(verify.WriteSpec(
        index_map=lambda p: (p, 0), **kw)) == []
    fs = verify.check_write_spec(verify.WriteSpec(
        index_map=lambda p: (3 - p, 0), **kw))
    assert [f.invariant for f in fs] == ["grid.accumulator"]


def test_masked_points_are_not_out_of_bounds():
    """A persistent program's iteration past the last sub-block is masked,
    not counted as a write past the array."""
    spec = verify.WriteSpec(
        name="tail", grid=(4, 3), block_shape=(8, 16),
        index_map=lambda p, k: (p + 4 * k, 0), array_shape=(75, 16),
        live=lambda p, k: p + 4 * k < 10, covers=True)
    assert verify.check_write_spec(spec) == []
    unmasked = dataclasses.replace(spec, live=None)
    assert [f.invariant for f in verify.check_write_spec(unmasked)] == [
        "grid.out-of-bounds"]


def test_overlapping_blocks_race():
    spec = verify.WriteSpec(
        name="halo", grid=(4,), block_shape=(6,), stride=(4,),
        index_map=lambda i: (i,), array_shape=(16,))
    assert [f.invariant for f in verify.check_write_spec(spec)] == [
        "grid.write-race"]


def test_grid_enumeration_cap_is_a_warning():
    spec = verify.WriteSpec(
        name="big", grid=(verify._GRID_ENUM_CAP + 1,), block_shape=(8,),
        index_map=lambda i: (i,), array_shape=(8 * (verify._GRID_ENUM_CAP
                                                    + 1),))
    findings = verify.check_write_spec(spec)
    assert verify.errors(findings) == []
    assert any("enumeration cap" in f.detail for f in findings)


# ---------------------------------------------------------------------------
# Pipeline gates.
# ---------------------------------------------------------------------------

def _kernel_segment_with_drift():
    """A KERNEL segment whose recorded avals drifted from the traced ones:
    codegen compiles it; only the verifier notices."""
    op = swiglu_kernel_op(arg_shapes=((64, 64), (64, 128)),
                          out_shape=(64, 64))
    return [analyzer.Segment(op=op)], dict(KERNEL_SHAPES)


def _stack_segment_with_drift():
    """A stack segment whose recorded shapes contradict its ops."""
    return ([analyzer.Segment(stack=rows_program())],
            dict(ROWS_SHAPES, a=(64, 64), y=(64, 128)))


def _cfg(**kw):
    return core_api.OptimizeConfig(torch_device="cpu", **kw)


class TestPipelineGate:
    @pytest.mark.parametrize("make,invariant", [
        (_kernel_segment_with_drift, "kernel.aval-mismatch"),
        (_stack_segment_with_drift, "program.shape-mismatch")])
    def test_strict_raises_before_codegen(self, make, invariant,
                                          monkeypatch):
        def boom(*a, **k):
            raise AssertionError("codegen ran before verification")

        monkeypatch.setattr(codegen, "compile_plan", boom)
        monkeypatch.setattr(codegen, "compile_kernel_op", boom)
        segments, shapes = make()
        with pytest.raises(verify.VerifyError) as e:
            core_api.compile_stacks(segments, shapes, _cfg(verify="strict"))
        assert invariant in str(e.value)

    def test_warn_records_findings_and_compiles(self):
        segments, shapes = _kernel_segment_with_drift()
        with pytest.warns(UserWarning, match="repro_torch.verify"):
            executors, _, _, _, findings, _ = core_api.compile_stacks(
                segments, shapes, _cfg(verify="warn"))
        assert 0 in executors                   # compile still succeeded
        assert any(f.invariant == "kernel.aval-mismatch" for f in findings)

    def test_off_skips_the_pass_entirely(self, monkeypatch):
        segments, shapes = _kernel_segment_with_drift()

        def boom(*a, **k):
            raise AssertionError("verify ran under verify='off'")

        monkeypatch.setattr(verify, "verify_segments", boom)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            executors, _, _, _, findings, _ = core_api.compile_stacks(
                segments, shapes, _cfg(verify="off"))
        assert 0 in executors
        assert findings == ()

    def test_default_is_warn_and_unknown_modes_are_rejected(self):
        assert core_api.OptimizeConfig().verify == "warn"
        with pytest.raises(ValueError, match="verify"):
            core_api.OptimizeConfig(verify="bogus")

    def test_unknown_kernel_is_verify_error_not_keyerror(self):
        op = swiglu_kernel_op(kernel="nonexistent")
        for call in (lambda: codegen.compile_kernel_op(op, mode="xla"),
                     lambda: codegen.kernel_inner(
                         op, backend=registry_mod.KernelType.REF)):
            with pytest.raises(verify.VerifyError) as e:
                call()
            assert "kernel.unknown" in str(e.value)
            assert e.value.findings[0].subject == "swiglu0"


# ---------------------------------------------------------------------------
# The traced frontend and optimize_graph.
# ---------------------------------------------------------------------------

class TestTracedFrontend:
    def test_trace_leaves_no_dead_values(self):
        def f(x):
            dead = torch.exp(x) * 3.0          # computed, never used
            del dead
            return torch.tanh(x) + 1.0

        tr = trace_mod.trace(f, torch.ones(8, 16))
        assert not [g for g in verify.verify_trace(tr)
                    if g.invariant == "graph.dead-value"]

    def test_check_graph_flags_dead_value(self):
        graph = ir.NetGraph(
            name="g", input="x", output="y",
            ops=(ir.OpNode(ir.OpKind.EW_UNARY, "dead", ("x",), "d",
                           fn="exp"),
                 ir.OpNode(ir.OpKind.EW_UNARY, "live", ("x",), "y",
                           fn="tanh")))
        dead = [f for f in verify.check_graph(graph)
                if f.invariant == "graph.dead-value"]
        assert len(dead) == 1 and dead[0].severity == "warning"
        assert "'d'" in dead[0].detail

    @pytest.mark.parametrize("differentiable", [False, True])
    def test_optimize_clean_records_no_findings(self, differentiable):
        def f(x):
            return torch.tanh(x) + 1.0

        with warnings.catch_warnings():
            warnings.simplefilter("error", UserWarning)
            net = api.optimize(f, torch.ones(8, 16), config=api.OptimizeConfig(
                mode="brainslug", torch_device="cpu", verify="strict",
                differentiable=differentiable))
        assert net.verify_findings == ()
        rep = net.report()
        assert (rep.verify_errors, rep.verify_warnings) == (0, 0)
        assert net.verify_seconds > 0

    def test_report_reemits_waived_findings(self):
        net = api.optimize(lambda x: torch.tanh(x) + 1.0, torch.ones(8, 16),
                           config=api.OptimizeConfig(torch_device="cpu"))
        # a waived finding injected after the fact: report() re-emits it
        # long after the compile-time warning scrolled away
        net.verify_findings = (verify.Finding(
            "plan.budget-exceeded", "error", "glu/seq0", "over budget"),)
        rep = net.report()
        assert rep.verify_errors == 1
        assert "plan.budget-exceeded" in str(rep) and "glu/seq0" in str(rep)

    def test_strict_optimize_raises_on_a_drifted_trace(self, monkeypatch):
        real = trace_mod.trace

        def drifted(fn, *args):
            tr = real(fn, *args)
            op = tr.graph.ops[-1]
            tr.shapes[op.output] = (1,) + tuple(tr.shapes[op.output])
            return tr

        monkeypatch.setattr(trace_mod, "trace", drifted)
        with pytest.raises(verify.VerifyError, match="graph.shape-mismatch"):
            api.optimize(lambda x: torch.tanh(x), torch.ones(8, 16),
                         config=api.OptimizeConfig(torch_device="cpu",
                                                   verify="strict"))

    def test_optimized_graph_records_findings(self):
        graph = ir.NetGraph(
            name="g", input="x", output="y",
            ops=(ir.OpNode(ir.OpKind.EW_UNARY, "t", ("x",), "y",
                           fn="tanh"),))
        net = core_api.optimize_graph(graph, (8, 128), _cfg(verify="strict"),
                                      layout="rows")
        assert net.verify_findings == ()
        assert net.report().verify_errors == 0
        dead = ir.NetGraph(
            name="g", input="x", output="y",
            ops=(ir.OpNode(ir.OpKind.EW_UNARY, "d", ("x",), "d", fn="exp"),
                 ir.OpNode(ir.OpKind.EW_UNARY, "t", ("x",), "y",
                           fn="tanh")))
        net = core_api.optimize_graph(dead, (8, 128), _cfg(verify="strict"),
                                      layout="rows")
        assert "graph.dead-value" in {f.invariant
                                      for f in net.verify_findings}
        assert verify.errors(net.verify_findings) == []
        assert "verify [warning] graph.dead-value" in net.explain()
