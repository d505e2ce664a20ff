"""The port's planner (analyzer, resource model, collapser) against the JAX
package's: identical segments and CollapsePlans on ``TINY_DEVICE``, which
both packages carry, and every program of the slice planning on ``H100``."""
from __future__ import annotations

import pytest

from repro.core import analyzer as janalyzer
from repro.core import collapse as jcollapse
from repro.core import ir as jir
from repro.core import resource as jresource
from repro.layers import stacks as jstacks
from repro.models import cnn as jcnn
from repro_torch.core import analyzer as tanalyzer
from repro_torch.core import collapse as tcollapse
from repro_torch.core import ir as tir
from repro_torch.core import resource as tresource
from repro_torch.layers import stacks as tstacks
from repro_torch.models import cnn as tcnn


def _plan_key(plan):
    return [([tuple(op.name for op in st.ops) for st in seq.steps],
             seq.tile_rows, seq.tile_out_h, seq.tile_out_w)
            for seq in plan.sequences]


def _graph_shapes(ir_mod, segments, graph, input_shape):
    from repro.core import api as japi
    shapes = {graph.input: input_shape}
    for seg in segments:
        if seg.is_stack:
            shapes.update(ir_mod.infer_shapes(
                seg.stack, {v: shapes[v] for v in seg.stack.inputs}))
        else:
            japi._infer_opaque_shape(seg.op, shapes)
    return shapes


def _graph_plans(jgraph, tgraph, input_shape, **kw):
    jsegs = janalyzer.analyze(jgraph, keep=frozenset({jgraph.output}))
    tsegs = tanalyzer.analyze(tgraph, keep=frozenset({tgraph.output}))
    assert [(s.is_stack, s.stack.signature() if s.is_stack else s.op.name)
            for s in jsegs] == [
        (s.is_stack, s.stack.signature() if s.is_stack else s.op.name)
        for s in tsegs]
    shapes = _graph_shapes(jir, jsegs, jgraph, input_shape)
    plans = []
    for js, ts in zip(jsegs, tsegs):
        if not js.is_stack:
            continue
        in_shapes = {v: shapes[v] for v in js.stack.inputs}
        jp = jcollapse.collapse(js.stack, in_shapes, jresource.TINY_DEVICE,
                                itemsize=4, **kw)
        tp = tcollapse.collapse(ts.stack, in_shapes, tresource.TINY_DEVICE,
                                itemsize=4, **kw)
        plans.append((jp, tp))
    return plans


def test_tiny_device_numbers_match():
    j, t = jresource.TINY_DEVICE, tresource.TINY_DEVICE
    assert (j.resource_limit, j.lane, j.sublane) == (
        t.resource_limit, t.lane, t.sublane)


@pytest.mark.parametrize("n_blocks,shape,max_steps", [
    (4, (2, 32, 32, 16), None),
    (8, (1, 56, 56, 32), None),          # several sequences on TINY
    (6, (1, 20, 20, 8), 2),              # Fig. 10 step-cap knob
])
def test_block_net_plans_match(n_blocks, shape, max_steps):
    jg, _ = jcnn.block_net(n_blocks, channels=shape[-1])
    tg, _ = tcnn.block_net(n_blocks, channels=shape[-1], device="cpu")
    plans = _graph_plans(jg, tg, shape, max_steps_per_sequence=max_steps)
    assert plans
    for jp, tp in plans:
        assert _plan_key(jp) == _plan_key(tp)
        for i in range(len(jp.sequences)):
            assert jp.subprogram(i).signature() == tp.subprogram(i).signature()
    if n_blocks == 8:
        assert len(plans[0][1].sequences) > 1


@pytest.mark.parametrize("stages,shape", [((16, 32), (2, 16, 16, 3)),
                                          ((32, 64, 128), (1, 32, 32, 3))])
def test_vgg_net_plans_match(stages, shape):
    jg, _ = jcnn.vgg_net(stages, batch_norm=True)
    tg, _ = tcnn.vgg_net(stages, batch_norm=True, device="cpu")
    plans = _graph_plans(jg, tg, shape)
    assert len(plans) == len(stages)
    for jp, tp in plans:
        assert _plan_key(jp) == _plan_key(tp)


@pytest.mark.parametrize("name,args,shapes", [
    ("addnorm_program", ("rms", 1e-6, False), {"x": (4, 64, 512),
                                               "res": (4, 64, 512)}),
    ("addnorm_program", ("layer", 1e-5, True), {"x": (8, 384),
                                                "res": (8, 384)}),
    ("norm_program", ("rms", 1e-6, False), {"x": (3, 640)}),
    ("glu_program", ("silu",), {"gate": (2, 16, 512), "up": (2, 16, 512)}),
    ("act_program", ("gelu",), {"x": (5, 256)}),
])
def test_stack_program_plans_match(name, args, shapes):
    jp = getattr(jstacks, name)(*args)
    tp = getattr(tstacks, name)(*args)
    assert jp.signature() == tp.signature()
    a = jcollapse.collapse(jp, shapes, jresource.TINY_DEVICE, itemsize=4)
    b = tcollapse.collapse(tp, shapes, tresource.TINY_DEVICE, itemsize=4)
    assert _plan_key(a) == _plan_key(b)


def test_rows_split_into_several_sequences_matches():
    """A rows program whose live set outgrows the budget (every norm output
    escapes) splits into several sequences, the same way in both packages."""
    def make(m):
        ops = [m.OpNode(m.OpKind.EW_BINARY, "a0", ("x", "r"), "h0", fn="add")]
        for i in range(4):
            ops.append(m.OpNode(m.OpKind.ROW_NORM, f"n{i}", (f"h{i}",),
                                f"h{i + 1}", attrs={"norm": "rms"}))
        return m.StackProgram(name="split", inputs=("x", "r"),
                              outputs=("h4", "h3", "h2", "h1", "h0"),
                              ops=tuple(ops))

    shapes = {"x": (16, 512), "r": (16, 512)}
    a = jcollapse.collapse(make(jir), shapes, jresource.TINY_DEVICE, itemsize=4)
    b = tcollapse.collapse(make(tir), shapes, tresource.TINY_DEVICE, itemsize=4)
    assert len(b.sequences) > 1
    assert _plan_key(a) == _plan_key(b)


def test_traffic_model_matches():
    jg, _ = jcnn.block_net(3, channels=16)
    tg, _ = tcnn.block_net(3, channels=16, device="cpu")
    (jp, tp), = _graph_plans(jg, tg, (2, 24, 24, 16))
    shapes = {"x": (2, 24, 24, 16)}
    assert tresource.breadth_first_traffic(tp.program, shapes, 4) == \
        jresource.breadth_first_traffic(jp.program, shapes, 4)
    assert tresource.depth_first_traffic(tp, shapes, 4) == \
        jresource.depth_first_traffic(jp, shapes, 4)


# ---------------------------------------------------------------------------
# The H100 spec: every program of the slice plans at its real width.
# ---------------------------------------------------------------------------

D_MODEL, D_FF, ROWS = 4096, 11008, (4, 2048)     # deepseek-7b widths


@pytest.mark.parametrize("program,shapes", [
    (tstacks.addnorm_program("rms", 1e-6, False),
     {"x": ROWS + (D_MODEL,), "res": ROWS + (D_MODEL,)}),
    (tstacks.norm_program("rms", 1e-6, False), {"x": ROWS + (D_MODEL,)}),
    (tstacks.norm_program("layer", 1e-5, True), {"x": ROWS + (D_MODEL,)}),
    (tstacks.glu_program("silu"), {"gate": ROWS + (D_FF,),
                                   "up": ROWS + (D_FF,)}),
    (tstacks.act_program("gelu"), {"x": ROWS + (D_FF,)}),
])
def test_h100_plans_lm_programs(program, shapes):
    plan = tcollapse.collapse(program, shapes, tresource.H100, itemsize=4)
    assert len(plan.sequences) == 1
    assert plan.sequences[0].tile_rows >= 1


def test_h100_budget_binds_on_glu_at_d_ff():
    """3 live values x 11008 x 4 B = 132,096 B must fit one row."""
    prog = tstacks.glu_program("silu")
    assert tresource.max_live_values(prog) == 3
    need = tresource.rows_tile_bytes(3, 1, D_FF, 4, tresource.H100)
    assert need == 132_096 <= tresource.H100.resource_limit
    assert tresource.H100.resource_limit < 2 * need   # one row per tile
    assert tresource.H100.fast_bytes == 232_448


@pytest.mark.parametrize("stages,shape", [
    ((64, 128, 256, 512, 512), (32, 224, 224, 3)),   # VGG-16 widths
])
def test_h100_plans_vgg16(stages, shape):
    graph, _ = tcnn.vgg_net(stages, device="cpu")
    segs = tanalyzer.analyze(graph, keep=frozenset({graph.output}))
    shapes = _graph_shapes(tir, segs, graph, shape)
    tiles = []
    for seg in segs:
        if seg.is_stack:
            plan = tcollapse.collapse(
                seg.stack, {v: shapes[v] for v in seg.stack.inputs},
                tresource.H100, itemsize=4)
            assert len(plan.sequences) == 1
            tiles.append(plan.sequences[0].tile_out_h)
    assert len(tiles) == 5 and min(tiles) >= 2


def test_h100_plans_block_net_in_one_sequence():
    graph, _ = tcnn.block_net(8, channels=32, device="cpu")
    seg, = tanalyzer.analyze(graph, keep=frozenset({graph.output}))
    plan = tcollapse.collapse(seg.stack, {"x": (8, 56, 56, 32)},
                              tresource.H100, itemsize=4)
    assert len(plan.sequences) == 1 and plan.sequences[0].tile_out_h == 8


def test_resource_error_on_a_step_that_cannot_fit():
    prog = tstacks.norm_program("rms", 1e-6, False)
    with pytest.raises(tresource.ResourceError):
        tcollapse.collapse(prog, {"x": (4, 1 << 20)}, tresource.H100)
