"""The slice as a whole: ``optimize_graph``/``optimize_stack`` of the port
against the JAX package's, on the CPU, in all three modes, with weights
carried over by ``params_from_numpy``; the device guards; gradients in
every mode; and the package boundary (no ``jax``, no ``repro`` import under
``src/repro_torch/`` or in ``chip_smoke.py``)."""
from __future__ import annotations

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.layers import stacks as jstacks
from repro.models import cnn as jcnn
from repro_torch.convert import params_from_numpy
from repro_torch.core import api as tapi
from repro_torch.core import codegen as tcodegen
from repro_torch.kernels.fused_stack import ops as tops
from repro_torch.layers import stacks as tstacks
from repro_torch.models import cnn as tcnn

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-4            # the tolerance of examples/quickstart.py
MODES = ("brainslug", "xla", "barrier")

NETS = {
    "vgg_bn": (lambda: jcnn.vgg_net((16, 32), batch_norm=True),
               lambda: tcnn.vgg_net((16, 32), batch_norm=True, device="cpu"),
               (2, 16, 16, 3)),
    "block4": (lambda: jcnn.block_net(4, channels=16),
               lambda: tcnn.block_net(4, channels=16, device="cpu"),
               (2, 12, 12, 16)),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("net", sorted(NETS))
def test_optimize_graph_matches_jax(net, mode):
    jmake, tmake, shape = NETS[net]
    jgraph, jparams = jmake()
    tgraph, tparams = tmake()
    params = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                               "cpu", like=tparams)
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    jnet = japi.optimize_graph(jgraph, shape, japi.OptimizeConfig(
        mode=mode, verify="off"))
    want = np.asarray(jnet(jnp.asarray(x), jparams))
    tnet = tapi.optimize_graph(tgraph, shape, tapi.OptimizeConfig(
        mode=mode, torch_device="cpu"))
    before = tops.STATS.snapshot()
    got = tnet(torch.from_numpy(x), params)
    delta = tops.STATS.delta(before)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    if mode == "brainslug":        # an explicit CPU run is never coverage
        assert delta["fwd_generated"] == 0
        assert delta["fwd_reference"] == tnet.n_sequences
    elif mode == "xla":            # every sequence one compiled call
        assert delta == {**dict.fromkeys(delta, 0),
                         "fwd_xla_compiled": tnet.n_sequences}
    else:
        assert sum(delta.values()) == 0
    report = tnet.report()
    jreport = jnet.report()
    assert (report.n_stacks, report.n_captured, report.capture_ratio) == (
        jreport.n_stacks, jreport.n_captured, jreport.capture_ratio)
    assert [(s.hbm_breadth_bytes, s.hbm_depth_bytes) for s in report.stacks] \
        == [(s.hbm_breadth_bytes, s.hbm_depth_bytes) for s in jreport.stacks]
    assert "capture_ratio" in tnet.explain()


def test_plain_twins_match_the_graphs():
    for name in NETS:
        _, tmake, shape = NETS[name]
        graph, params = tmake()
        x = torch.randn(shape, generator=torch.Generator().manual_seed(1))
        net = tapi.optimize_graph(graph, shape, tapi.OptimizeConfig(
            mode="barrier", torch_device="cpu"))
        twin = tcnn.vgg_fn if name.startswith("vgg") else tcnn.block_fn
        torch.testing.assert_close(net(x, params), twin(x, params),
                                   rtol=TOL, atol=TOL)


STACK_CASES = {
    "addnorm_rms": (("addnorm_program", "rms", 1e-6, False),
                    {"x": (2, 9, 64), "res": (2, 9, 64)}, {"scale": (64,)}),
    "addnorm_layer": (("addnorm_program", "layer", 1e-5, True),
                      {"x": (7, 48), "res": (7, 48)},
                      {"scale": (48,), "bias": (48,)}),
    "norm_rms": (("norm_program", "rms", 1e-6, False), {"x": (5, 80)},
                 {"scale": (80,)}),
    "glu_silu": (("glu_program", "silu"), {"gate": (3, 11, 96),
                                           "up": (3, 11, 96)}, {}),
    "act_gelu": (("act_program", "gelu"), {"x": (10, 40)}, {}),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(STACK_CASES))
def test_optimize_stack_matches_jax(case, mode):
    (maker, *args), in_shapes, p_shapes = STACK_CASES[case]
    rng = np.random.default_rng(3)
    inputs = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in in_shapes.items()}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in p_shapes.items()}
    jexe = japi.optimize_stack(getattr(jstacks, maker)(*args), in_shapes,
                               japi.OptimizeConfig(mode=mode))
    want = jexe({k: jnp.asarray(v) for k, v in inputs.items()},
                {k: jnp.asarray(v) for k, v in params.items()})
    texe = tapi.optimize_stack(getattr(tstacks, maker)(*args), in_shapes,
                               tapi.OptimizeConfig(mode=mode,
                                                   torch_device="cpu"))
    got = texe({k: torch.from_numpy(v) for k, v in inputs.items()},
               params_from_numpy(params, "cpu"))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=TOL, atol=TOL)


def test_cuda_request_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    graph, _ = tcnn.block_net(1, channels=4, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.optimize_graph(graph, (1, 4, 4, 4), tapi.OptimizeConfig(
            mode="brainslug"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.optimize_stack(tstacks.act_program("relu"), {"x": (2, 4)},
                            tapi.OptimizeConfig(torch_device="cuda"))
    assert tapi.OptimizeConfig().torch_device == "cuda"     # the default


def test_brainslug_refuses_grad_and_other_modes_differentiate():
    """brainslug differentiates too now (its CPU backward is the plain
    version, counted as ``bwd_reference``), with the same gradient as the
    two interpreter modes."""
    graph, params = tcnn.block_net(2, channels=4, device="cpu")
    x = torch.randn(1, 6, 6, 4, requires_grad=True)
    grads = {}
    for mode in MODES:
        net = tapi.optimize_graph(graph, tuple(x.shape), tapi.OptimizeConfig(
            mode=mode, torch_device="cpu"))
        before = tops.STATS.snapshot()
        (grads[mode],) = torch.autograd.grad(net(x, params).sum(), x)
        delta = tops.STATS.delta(before)
        assert torch.isfinite(grads[mode]).all()
        assert delta["bwd_reference"] == (net.n_sequences
                                          if mode == "brainslug" else 0)
        assert delta["bwd_generated"] == 0
    with torch.no_grad():
        assert net(x, params).shape == (1, 6, 6, 4)
    for mode in ("xla", "barrier"):
        torch.testing.assert_close(grads["brainslug"], grads[mode],
                                   rtol=TOL, atol=TOL)


def test_training_plan_checks_backward_slots_when_built(monkeypatch):
    """A plan sized for training builds its executables with the nhwc
    backward's slot plan, so a chain the backward cannot hold raises when
    compiled, not mid-backward; a forward-only plan does not ask.  Every
    executable carries its plan's device's feature chunk."""
    from collections import OrderedDict

    from repro_torch.core import resource as tresource
    from repro_torch.kernels.fused_stack import nhwc as tnhwc
    from repro_torch.kernels.fused_stack import nhwc_bwd as tnhwc_bwd
    graph, _ = tcnn.block_net(2, channels=4, device="cpu")
    tcodegen.clear_cache()
    monkeypatch.setattr(tnhwc_bwd, "_CHAINS", OrderedDict())
    monkeypatch.setattr(tnhwc_bwd, "BWD_MAX_SLOTS", 3)
    for differentiable in (False, True):
        cfg = tapi.OptimizeConfig(mode="brainslug", torch_device="cpu",
                                  differentiable=differentiable)
        if differentiable:
            with pytest.raises(tnhwc.DescriptorError, match="more than 3"):
                tapi.optimize_graph(graph, (1, 6, 6, 4), cfg)
        else:
            tapi.optimize_graph(graph, (1, 6, 6, 4), cfg)
    assert {e.f_chunk for e in tops._EXEC_CACHE.values()} == {
        tresource.H100.f_chunk}
    tcodegen.clear_cache()


def test_device_mismatch_and_bad_config_raise():
    graph, params = tcnn.block_net(1, channels=4, device="cpu")
    net = tapi.optimize_graph(graph, (1, 4, 4, 4), tapi.OptimizeConfig(
        torch_device="cpu"))
    with pytest.raises(ValueError, match="optimized for"):
        net(torch.zeros(1, 4, 4, 4, device="meta"), params)
    with pytest.raises(ValueError, match="mode"):
        tapi.OptimizeConfig(mode="fast")
    with pytest.raises(ValueError, match="torch_device"):
        tapi.OptimizeConfig(torch_device="meta")
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy({"bn0_s": np.zeros(3), "bn0_o": np.zeros(4)}, "cpu",
                          like=params)


def test_code_cache_is_bounded_and_clear_resets_stats():
    tcodegen.clear_cache()
    tcodegen.set_cache_limit(2)
    try:
        for f in (8, 16, 24):
            tapi.optimize_stack(tstacks.act_program("relu"), {"x": (2, f)},
                                tapi.OptimizeConfig(torch_device="cpu"))
        assert len(tcodegen._CODE_CACHE) == 2
        tops.STATS.record("fwd_reference")
        tcodegen.clear_cache()
        assert sum(tops.STATS.counts.values()) == 0
    finally:
        tcodegen._LIMIT_PINNED = False
        tcodegen.set_cache_limit(256)
        tcodegen._LIMIT_PINNED = False


def _imports(path: Path) -> set[str]:
    names: set[str] = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module or "")
    return names


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT) for p in (ROOT / "src" / "repro_torch").rglob("*.py")]
    + [Path("chip_smoke.py")]), ids=str)
def test_port_imports_neither_jax_nor_repro(path):
    for name in _imports(ROOT / path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path} imports {name}"
