"""The mesh partition planner of the port (``repro_torch.core.partition``),
its per-shard resource view and the ``dist.*`` verifier family, held to
the JAX package's (``repro.core.partition``, ``resource.shard_device``,
``verify.check_partitions``) on mesh skeletons, in one process.

Meshes (data, model) = (8, 1), (4, 2) and (2, 2) under ``data``,
``tensor`` and ``both``: the specs (compared as tuples) and notes of
``plan_stack`` on the rms, glu and activation programs and on the VGG nhwc
stacks, and of ``plan_kernel`` on the four registry kernels; the per-shard
shapes, the haircut ``TINY_DEVICE`` and the plans collapsed against it;
the invariant codes of ``check_partitions`` on the planner's output and
on the four seeded mutants of ``tests/test_partition.py``.

One planned difference: under a feature split the port splits a
per-feature parameter (a norm gain, a batch-norm scale) with the features
it scales, where the JAX planner replicates it and hands each shard all F
entries against F/n features.  The tests pin both sides of it."""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.core import analyzer as janalyzer
from repro.core import api as japi
from repro.core import collapse as jcollapse
from repro.core import ir as jir
from repro.core import partition as jpartition
from repro.core import resource as jresource
from repro.core import verify as jverify
from repro.layers import stacks as jstacks
from repro.models import cnn as jcnn
from repro_torch.core import analyzer as tanalyzer
from repro_torch.core import api as tapi
from repro_torch.core import collapse as tcollapse
from repro_torch.core import ir as tir
from repro_torch.core import partition
from repro_torch.core import resource as tresource
from repro_torch.core import verify as tverify
from repro_torch.layers import stacks as tstacks
from repro_torch.models import cnn as tcnn

torch.set_num_threads(1)

P = partition.PartitionSpec
MESHES = [(8, 1), (4, 2), (2, 2)]
MODES = ["data", "tensor", "both"]


def _axes(shape):
    return (jpartition.MeshAxes(("data", "model"), shape),
            partition.MeshAxes(("data", "model"), shape))


def _specs(d):
    return {k: tuple(v) for k, v in d.items()}


def _same_partition(jp, tp, *, feature_params=()):
    """Specs as tuples, shard shapes and notes agree; the params in
    ``feature_params`` are the planned difference (split with the
    features on the port's side)."""
    assert _specs(tp.in_specs) == _specs(jp.in_specs)
    assert _specs(tp.out_specs) == _specs(jp.out_specs)
    assert tp.shard_shapes == jp.shard_shapes
    assert tp.notes == jp.notes
    assert tp.active == jp.active
    for name, spec in jp.param_specs.items():
        if name in feature_params:
            assert tuple(spec) == (None,) * len(spec)
            assert tuple(tp.param_specs[name]) == (
                *(None,) * (len(spec) - 1), "model")
        else:
            assert tuple(tp.param_specs[name]) == tuple(spec)


def _feature_split(part) -> bool:
    return any(tuple(s) and tuple(s)[-1] == "model"
               for s in part.in_specs.values())


def _programs():
    return [
        ("rms", jstacks.norm_program("rms", 1e-6, False),
         tstacks.norm_program("rms", 1e-6, False), {"x": (512, 256)}),
        ("addnorm", jstacks.addnorm_program("rms", 1e-6, False),
         tstacks.addnorm_program("rms", 1e-6, False),
         {"x": (512, 256), "res": (512, 256)}),
        ("glu", jstacks.glu_program("silu"), tstacks.glu_program("silu"),
         {"gate": (512, 512), "up": (512, 512)}),
        ("act", jstacks.act_program("gelu"), tstacks.act_program("gelu"),
         {"x": (512, 512)}),
        ("ragged", jstacks.act_program("gelu"), tstacks.act_program("gelu"),
         {"x": (510, 24)}),
    ]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("mode", MODES)
def test_plan_stack_matches_jax_on_lm_programs(mesh, mode):
    jaxes, taxes = _axes(mesh)
    for name, jprog, tprog, shapes in _programs():
        feat = next(iter(shapes.values()))[-1]
        pshapes = {p: (feat,) for p in jpartition.stack_param_names(jprog)}
        jp = jpartition.plan_stack(jprog, shapes, pshapes, mode, jaxes)
        tp = partition.plan_stack(tprog, shapes, pshapes, mode, taxes)
        _same_partition(jp, tp, feature_params=(
            tuple(pshapes) if _feature_split(tp) else ()))


def _vgg_stacks():
    jgraph, _ = jcnn.vgg_net()
    tgraph, _ = tcnn.vgg_net(device="cpu")
    jsegs = janalyzer.analyze(jgraph, keep=frozenset({jgraph.output}))
    tsegs = tanalyzer.analyze(tgraph, keep=frozenset({tgraph.output}))
    shapes = {jgraph.input: (8, 32, 32, 3)}
    for seg in jsegs:
        if seg.is_stack:
            shapes.update(jir.infer_shapes(
                seg.stack, {v: shapes[v] for v in seg.stack.inputs}))
        else:
            japi._infer_opaque_shape(seg.op, shapes)
    out = []
    for js, ts in zip(jsegs, tsegs):
        if js.is_stack:
            assert js.stack.signature() == ts.stack.signature()
            out.append((js.stack, ts.stack,
                        {v: shapes[v] for v in js.stack.inputs}))
    return out


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("mode", MODES)
def test_plan_stack_matches_jax_on_vgg_stacks(mesh, mode):
    jaxes, taxes = _axes(mesh)
    stacks = _vgg_stacks()
    assert len(stacks) == 3
    for jprog, tprog, shapes in stacks:
        c = next(iter(shapes.values()))[-1]
        pshapes = {p: (c,) for p in jpartition.stack_param_names(jprog)}
        jp = jpartition.plan_stack(jprog, shapes, pshapes, mode, jaxes)
        tp = partition.plan_stack(tprog, shapes, pshapes, mode, taxes)
        split = _feature_split(tp)
        assert split == (mode != "data" and mesh[1] > 1)
        _same_partition(jp, tp, feature_params=tuple(pshapes) if split
                        else ())


def _kernel_ops():
    """(kernel, arg_shapes, out_shape) of each registry kernel, with a
    shape that some meshes cannot divide."""
    return [
        ("attention", ((4, 8, 64, 32),) * 3, (4, 8, 64, 32)),
        ("attention", ((4, 64, 32),) * 3, (4, 64, 32)),
        ("attention", ((6, 3, 64, 32),) * 3, (6, 3, 64, 32)),
        ("rmsnorm", ((512, 256), (256,)), (512, 256)),
        ("rmsnorm", ((512, 256), (512, 256)), (512, 256)),
        ("swiglu", ((512, 256), (512, 256)), (512, 256)),
        ("swiglu", ((512, 24), (512, 24)), (512, 24)),
        ("vocab_ce", ((512, 64), (64, 1000), (512,)), (512,)),
        ("vocab_ce", ((510, 64), (64, 1000), (510,)), (510,)),
    ]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("mode", MODES)
def test_plan_kernel_matches_jax(mesh, mode):
    jaxes, taxes = _axes(mesh)
    for kernel, args, out in _kernel_ops():
        attrs = {"kernel": kernel, "arg_shapes": args, "out_shape": out}
        jop = jir.OpNode(kind=jir.OpKind.KERNEL, name="k", inputs=(),
                         output="y", attrs=attrs)
        top = tir.OpNode(kind=tir.OpKind.KERNEL, name="k", inputs=(),
                         output="y", attrs=attrs)
        jp = jpartition.plan_kernel(jop, mode, jaxes)
        tp = partition.plan_kernel(top, mode, taxes)
        _same_partition(jp, tp)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_shard_device_matches_jax(n):
    jd = jresource.shard_device(jresource.TINY_DEVICE, n)
    td = tresource.shard_device(tresource.TINY_DEVICE, n)
    assert td.name == jd.name
    assert td.resource_limit == jd.resource_limit
    assert (tresource.SHARD_RESERVE_FRACTION
            == jresource.SHARD_RESERVE_FRACTION)
    if n > 1:
        assert td.resource_limit < tresource.TINY_DEVICE.resource_limit


def _plan_key(plan):
    return [([tuple(op.name for op in st.ops) for st in seq.steps],
             seq.tile_rows, seq.tile_out_h, seq.tile_out_w)
            for seq in plan.sequences]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("differentiable", [False, True])
def test_per_shard_collapse_matches_jax_on_tiny(mesh, differentiable):
    """The plans ``compile_stacks`` commits under a mesh: each stack
    collapsed against its per-shard shapes on the haircut tiny device,
    and the shard view the ``dist.vmem-refit`` check rebuilds."""
    jaxes, taxes = _axes(mesh)
    jdev = jresource.shard_device(jresource.TINY_DEVICE, jaxes.n_devices)
    tdev = tresource.shard_device(tresource.TINY_DEVICE, taxes.n_devices)
    cases = [(j, t, s) for _, j, t, s in _programs()[:4]]
    cases += _vgg_stacks()
    for jprog, tprog, shapes in cases:
        feat = next(iter(shapes.values()))[-1]
        pshapes = {p: (feat,) for p in jpartition.stack_param_names(jprog)}
        jp = jpartition.plan_stack(jprog, shapes, pshapes, "both", jaxes)
        tp = partition.plan_stack(tprog, shapes, pshapes, "both", taxes)
        shard_in = partition.shard_shapes(shapes, tp.in_specs, taxes)
        assert shard_in == jpartition.shard_shapes(shapes, jp.in_specs,
                                                   jaxes)
        try:
            jplan = jcollapse.collapse(jprog, shard_in, jdev, itemsize=4,
                                       differentiable=differentiable)
        except jresource.ResourceError:
            # training sizing can outgrow the tiny budget: both refuse
            with pytest.raises(tresource.ResourceError):
                tcollapse.collapse(tprog, shard_in, tdev, itemsize=4,
                                   differentiable=differentiable)
            continue
        tplan = tcollapse.collapse(tprog, shard_in, tdev, itemsize=4,
                                   differentiable=differentiable)
        assert _plan_key(tplan) == _plan_key(jplan)
        if differentiable:
            continue
        # the independent re-check: a whole-tensor plan viewed per shard
        whole = tcollapse.collapse(tprog, shapes, tresource.TINY_DEVICE,
                                   itemsize=4, differentiable=differentiable)
        jwhole = jcollapse.collapse(jprog, shapes, jresource.TINY_DEVICE,
                                    itemsize=4,
                                    differentiable=differentiable)
        tv = tresource.shard_view(whole, taxes, tp.in_specs)
        jv = jresource.shard_view(jwhole, jaxes, jp.in_specs)
        assert tv.budget == jv.budget == tdev.resource_limit
        assert tv.shard_shapes == jv.shard_shapes
        assert tv.seq_bytes == jv.seq_bytes
        assert tv.fits == jv.fits


# ---------------------------------------------------------------------------
# The dist.* verifier family against the JAX package's.
# ---------------------------------------------------------------------------

JAXES, TAXES = _axes((4, 2))


def _check(module, axes, part, program, shapes):
    pp = (jpartition if module is jverify else partition).PartitionPlan(
        axes=axes, partition="both", segments={0: part})
    seg = SimpleNamespace(is_stack=True, stack=program, op=None)
    cfg = SimpleNamespace(
        device=(jresource if module is jverify else tresource).TINY_DEVICE,
        itemsize=2, differentiable=False)
    return {f.invariant for f in module.errors(
        module.check_partitions([seg], {}, pp, shapes, cfg))}


MUTANTS = [
    ("clean", None, {"x": (512, 256)}, set()),
    ("overrank", ("data", None, "model"), {"x": (512, 256)},
     {"dist.spec-rank"}),
    ("unknown-axis", ("pod", None), {"x": (512, 256)}, {"dist.mesh-axis"}),
    ("reduction", ("data", "model"), {"x": (512, 256)},
     {"dist.collective-placement"}),
    ("indivisible", None, {"x": (510, 256)}, {"dist.spec-rank"}),
]


@pytest.mark.parametrize("name,spec,shapes,want", MUTANTS,
                         ids=[m[0] for m in MUTANTS])
def test_check_partitions_matches_jax(name, spec, shapes, want):
    jprog = jstacks.norm_program("rms", 1e-6, False)
    tprog = tstacks.norm_program("rms", 1e-6, False)
    pshapes = {p: (256,) for p in jpartition.stack_param_names(jprog)}
    jpart = jpartition.plan_stack(jprog, {"x": (512, 256)}, pshapes, "both",
                                  JAXES)
    tpart = partition.plan_stack(tprog, {"x": (512, 256)}, pshapes, "both",
                                 TAXES)
    if spec is not None:
        jpart = dataclasses.replace(jpart, in_specs={"x": JP(*spec)})
        tpart = dataclasses.replace(tpart, in_specs={"x": P(*spec)})
    got = _check(tverify, TAXES, tpart, tprog, shapes)
    assert got == _check(jverify, JAXES, jpart, jprog, shapes) == want


def test_kernel_fence_and_vmem_refit_are_caught():
    """An rmsnorm KERNEL spec splitting the rms reduction, and a stack plan
    collapsed against other shapes than its specs imply."""
    op = tir.OpNode(kind=tir.OpKind.KERNEL, name="rms_site", inputs=(),
                    output="out", attrs={"kernel": "rmsnorm",
                                         "arg_shapes": ((512, 256), (256,)),
                                         "out_shape": (512, 256)})
    kpart = partition.SegmentPartition(
        in_specs={"arg0": P("data", "model"), "arg1": P("model")},
        out_specs={"out": P("data", "model")}, param_specs={},
        shard_shapes={})
    pp = partition.PartitionPlan(TAXES, "both", {0: kpart})
    cfg = SimpleNamespace(device=tresource.TINY_DEVICE, itemsize=2,
                          differentiable=False)
    seg = SimpleNamespace(is_stack=False, stack=None, op=op)
    assert {f.invariant for f in tverify.check_partitions(
        [seg], {}, pp, {}, cfg)} == {"dist.collective-placement"}
    prog = tstacks.norm_program("rms", 1e-6, False)
    part = partition.plan_stack(prog, {"x": (512, 256)}, {"scale": (256,)},
                                "data", TAXES)
    wrong = tcollapse.collapse(prog, {"x": (512, 256)},
                               tresource.TINY_DEVICE, itemsize=2)
    sseg = SimpleNamespace(is_stack=True, stack=prog, op=None)
    fs = tverify.check_partitions([sseg], {0: wrong}, partition.
                                  PartitionPlan(TAXES, "data", {0: part}),
                                  {"x": (512, 256)}, cfg)
    assert [f.invariant for f in fs] == ["dist.vmem-refit"]


def test_dist_invariants_are_listed():
    """The four training-side dist.* rows and the two serving rows (mesh
    serving's), each naming a port file, as the JAX package lists them."""
    for code in ("dist.spec-rank", "dist.mesh-axis", "dist.vmem-refit",
                 "dist.collective-placement", "dist.serve-slot-axis",
                 "dist.serve-pool-write"):
        assert code in jverify.INVARIANTS
        assert tverify.INVARIANTS[code][0].startswith("src/repro_torch/")
    assert sorted(c for c in tverify.INVARIANTS if c.startswith("dist.")) \
        == sorted(c for c in jverify.INVARIANTS if c.startswith("dist."))


class TestOptimizeConfigValidation:
    def test_partition_requires_mesh(self):
        with pytest.raises(ValueError, match="needs a mesh"):
            tapi.OptimizeConfig(partition="data", torch_device="cpu")

    def test_unknown_partition_rejected(self):
        with pytest.raises(ValueError, match="unknown partition"):
            tapi.OptimizeConfig(partition="rowwise", mesh=object(),
                                torch_device="cpu")

    def test_skeleton_mesh_plans_and_verifies_without_ranks(self):
        """A MeshAxes skeleton drives per-shard sizing and the dist.*
        family; nothing is wrapped (there are no ranks)."""
        graph, params = tcnn.vgg_net(device="cpu")
        cfg = tapi.OptimizeConfig(mode="barrier", torch_device="cpu",
                                  mesh=partition.MeshAxes(("data", "model"),
                                                          (2, 1)),
                                  partition="data", verify="strict",
                                  device=tresource.TINY_DEVICE)
        net = tapi.optimize_graph(graph, (8, 32, 32, 3), cfg,
                                  param_shapes={k: tuple(v.shape)
                                                for k, v in params.items()})
        rep = net.report()
        assert rep.mesh_axes == (("data", 2), ("model", 1))
        assert len(rep.dist) == 3 and all(d.active for d in rep.dist)
        budget = tresource.shard_device(tresource.TINY_DEVICE,
                                        2).resource_limit
        assert {d.shard_budget_bytes for d in rep.dist} == {budget}
        assert "mesh data=2 x model=1" in net.explain()
        assert all(p.device.resource_limit == budget
                   for p in net.plans.values())
