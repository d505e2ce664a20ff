"""The traced frontend of the port (``repro_torch.api.optimize`` on plain
PyTorch functions, ``repro_torch.core.trace``) against the JAX package, on
the CPU: the bn-VGG and ``block_fn`` twins against the plain jnp functions
and ``jax.grad``, the conv stages' plans against the JAX
``optimize_graph`` of the matching hand-built net, one test per lifting
rule, the gradient fences, the call checks and pytrees.  (The JAX frontend
does not run under this JAX, so nothing here imports ``repro.core.trace``.)
"""
from __future__ import annotations

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import api as japi
from repro.core import resource as jresource
from repro.models import cnn as jcnn
from repro_torch import api
from repro_torch.convert import params_from_numpy
from repro_torch.core import ir, resource, trace
from repro_torch.kernels.fused_stack import ops as tops
from repro_torch.models import cnn as tcnn

TOL = 2e-4            # the tolerance of examples/quickstart.py
MODES = ("brainslug", "xla", "barrier")
K = ir.OpKind


def _cfg(mode="xla", **kw):
    return api.OptimizeConfig(mode=mode, torch_device="cpu", **kw)


def _carry(jparams, tparams):
    return params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                             "cpu", like=tparams)


def _kinds(net):
    return [op.kind for op in net.graph.ops]


# ---------------------------------------------------------------------------
# The slice as a whole: bn-VGG and block_fn against the JAX package.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_vgg_capture_matches_jax(mode):
    jgraph, jparams = jcnn.vgg_net((16, 32, 64), batch_norm=True)
    _, tparams = tcnn.vgg_net((16, 32, 64), batch_norm=True, device="cpu")
    params = _carry(jparams, tparams)
    x = np.random.default_rng(0).standard_normal((2, 16, 16, 3)).astype(
        np.float32)
    want = np.asarray(jcnn.vgg_fn(jnp.asarray(x), jparams))
    xt = torch.from_numpy(x)
    net = api.optimize(tcnn.vgg_fn, xt, params,
                       config=_cfg(mode, device=resource.TINY_DEVICE))
    before = tops.STATS.snapshot()
    got = net(xt, params)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    report = net.report()
    assert report.capture_ratio >= 0.9 and net.n_stacks >= 3
    assert report.n_opaque == 1                # the global mean, only
    assert [op.attrs.get("prim") for op in net.graph.ops
            if op.kind == K.OPAQUE] == ["mean"]
    delta = tops.STATS.delta(before)
    assert delta["fwd_reference"] == (net.n_sequences if mode == "brainslug"
                                      else 0)
    # the conv stages' stacks plan as the JAX optimize_graph's do
    jnet = japi.optimize_graph(
        jcnn.vgg_net((16, 32), batch_norm=True)[0], (2, 16, 16, 3),
        japi.OptimizeConfig(mode=mode, device=jresource.TINY_DEVICE,
                            verify="off"))
    jstacks = jnet.report().stacks
    for mine, theirs in zip(report.stacks, jstacks):
        assert mine.kinds == theirs.kinds
        assert mine.n_sequences == theirs.n_sequences
        assert (mine.hbm_breadth_bytes, mine.hbm_depth_bytes) == (
            theirs.hbm_breadth_bytes, theirs.hbm_depth_bytes)
    assert "capture_ratio=90.0%" in net.explain()


def test_block_fn_capture_and_gradients_match_jax():
    jgraph, jparams = jcnn.block_net(4, channels=8)
    _, tparams = tcnn.block_net(4, channels=8, device="cpu")
    params = _carry(jparams, tparams)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 10, 10, 8)).astype(np.float32)
    cot = rng.standard_normal((2, 10, 10, 8)).astype(np.float32)

    def jloss(x, p):
        return jnp.sum(jcnn.block_fn(x, p) * cot)

    jgx, jgp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jparams)
    net = api.optimize(tcnn.block_fn, torch.from_numpy(x), params,
                       config=_cfg("brainslug", differentiable=True))
    report = net.report()
    assert report.capture_ratio == 1.0 and report.n_opaque == 0
    assert net.n_stacks == 1 and report.n_captured == 12
    xt = torch.from_numpy(x).requires_grad_()
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    before = tops.STATS.snapshot()
    loss = torch.sum(net(xt, leaves) * torch.from_numpy(cot))
    loss.backward()
    delta = tops.STATS.delta(before)
    assert delta["bwd_reference"] == net.n_sequences     # CPU: plain
    assert delta["bwd_generated"] == 0
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-4 * float(np.abs(jgx).max()))
    for k, g in jgp.items():
        np.testing.assert_allclose(leaves[k].grad.numpy(), np.asarray(g),
                                   rtol=1e-4,
                                   atol=1e-4 * float(np.abs(g).max()))


def test_block_fn_training_in_every_mode_matches_autograd():
    _, params = tcnn.block_net(2, channels=4, device="cpu")
    x = torch.randn(1, 6, 6, 4, generator=torch.Generator().manual_seed(2))
    want = torch.autograd.grad(
        tcnn.block_fn(x.requires_grad_(), params).square().sum(), x)[0]
    for mode in MODES:
        net = api.optimize(tcnn.block_fn, x.detach(), params,
                           config=_cfg(mode, differentiable=True))
        xt = x.detach().requires_grad_()
        got = torch.autograd.grad(net(xt, params).square().sum(), xt)[0]
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# One test per lifting rule.
# ---------------------------------------------------------------------------

def _lifted(fn, *args, kinds, fn_names=None):
    """Trace ``fn``, check the lifted op kinds (OPAQUE binds excluded), and
    hold the optimized callable to ``fn`` in every mode."""
    net = api.optimize(fn, *args, config=_cfg())
    got = [op.kind for op in net.graph.ops if not op.attrs.get("synthetic")]
    assert got == kinds, [(o.kind.value, o.fn, o.attrs.get("prim"))
                          for o in net.graph.ops]
    if fn_names is not None:
        assert [op.fn for op in net.graph.ops if op.fn] == fn_names
    want = fn(*args)
    for mode in MODES:
        out = api.optimize(fn, *args, config=_cfg(mode))(*args)
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    return net


ACTIVATIONS = {
    "relu": (torch.relu, "relu"),
    "relu6": (F.relu6, "relu6"),
    "hardtanh06": (lambda x: F.hardtanh(x, 0.0, 6.0), "relu6"),
    "gelu": (F.gelu, "gelu_exact"),
    "gelu_tanh": (lambda x: F.gelu(x, approximate="tanh"), "gelu"),
    "silu": (F.silu, "silu"),
    "sigmoid": (torch.sigmoid, "sigmoid"),
    "softplus": (F.softplus, "softplus"),
    "tanh": (torch.tanh, "tanh"),
    "exp": (torch.exp, "exp"),
    "abs": (torch.abs, "abs"),
    "neg": (torch.neg, "neg"),
    "square": (torch.square, "square"),
    "pow2": (lambda x: x ** 2, "square"),
}


@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_activation_lifts_to_one_unary(name):
    fn, want = ACTIVATIONS[name]
    x = 3.0 * torch.randn(4, 16, generator=torch.Generator().manual_seed(3))
    _lifted(fn, x, kinds=[K.EW_UNARY], fn_names=[want])


@pytest.mark.parametrize("fn", ["add", "sub", "mul", "div", "max", "min"])
def test_binary_lifts_with_values_params_and_scalars(fn):
    op = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
          "div": torch.div, "max": torch.maximum, "min": torch.minimum}[fn]
    g = torch.Generator().manual_seed(4)
    x, y = torch.randn(3, 8, generator=g), torch.randn(3, 8, generator=g)
    p = torch.rand(8, generator=g) + 0.5
    net = _lifted(lambda x, y, p: op(op(x, y), p), x, y, p,
                  kinds=[K.EW_BINARY, K.EW_BINARY])
    assert net.graph.ops[-1].params == ("arg2",)      # the vector rides
    assert net.graph.ops[0].attrs["synthetic"]        # y bound as a value
    if fn in ("add", "mul"):
        net = _lifted(lambda x: 2.0 * x + 1.0, x,
                      kinds=[K.AFFINE])               # scalars ride too


def test_per_channel_mul_add_lifts_to_affine():
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 4, 4, 6, generator=g)
    s, b = torch.randn(6, generator=g), torch.randn(1, 1, 1, 6, generator=g)
    net = _lifted(lambda x, s, b: x * s + b, x, s, b, kinds=[K.AFFINE])
    assert net.graph.ops[0].params == ("arg1", "arg2")
    # a full-shape multiplier is no channel vector: two binaries
    full = torch.randn(2, 4, 4, 6, generator=g)
    _lifted(lambda x, s, b: x * s + b, x, full, b,
            kinds=[K.EW_BINARY, K.EW_BINARY])


@pytest.mark.parametrize("layout", ["nhwc", "rows"])
def test_eval_batch_norm_lifts_to_affine_with_derived_params(layout):
    g = torch.Generator().manual_seed(6)
    c = 5
    w, b = torch.randn(c, generator=g), torch.randn(c, generator=g)
    rm, rv = torch.randn(c, generator=g), torch.rand(c, generator=g) + 0.5
    if layout == "nhwc":
        x = torch.randn(2, 4, 4, c, generator=g)

        def fn(x, w, b, rm, rv):
            y = F.batch_norm(x.permute(0, 3, 1, 2), rm, rv, w, b,
                             training=False, eps=1e-3)
            return y.permute(0, 2, 3, 1)
    else:
        x = torch.randn(7, c, generator=g)

        def fn(x, w, b, rm, rv):
            return F.batch_norm(x, rm, rv, w, b, training=False, eps=1e-3)
    net = _lifted(fn, x, w, b, rm, rv, kinds=[K.AFFINE])
    assert set(net.trace_result.derived_params) == set(net.graph.ops[0].params)
    # training-mode batch norm uses batch statistics: opaque
    tr = trace.trace(lambda x, w, b, rm, rv: F.batch_norm(
        x, rm.clone(), rv.clone(), w, b, training=True),
        torch.randn(7, c), w, b, rm, rv)
    assert K.AFFINE not in [op.kind for op in tr.graph.ops]


def test_rms_and_layer_norms_lift_to_row_norm():
    g = torch.Generator().manual_seed(7)
    x = torch.randn(3, 5, 32, generator=g)
    w, b = torch.randn(32, generator=g), torch.randn(32, generator=g)

    def rms(x):
        return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True)
                               + 1e-6)

    def layer(x):
        f = x - torch.mean(x, dim=-1, keepdim=True)
        return f * torch.rsqrt(f.pow(2).mean(-1, keepdim=True) + 1e-5)

    for fn, norm in ((rms, "rms"), (layer, "layer")):
        net = _lifted(fn, x, kinds=[K.ROW_NORM])
        assert net.graph.ops[0].attrs["norm"] == norm
    net = _lifted(lambda x, w: F.rms_norm(x, (32,), w, eps=1e-6), x, w,
                  kinds=[K.ROW_NORM])
    assert net.graph.ops[0].params == ("arg1",)
    net = _lifted(lambda x, w, b: F.layer_norm(x, (32,), w, b), x, w, b,
                  kinds=[K.ROW_NORM])
    assert net.graph.ops[0].attrs == {"norm": "layer", "eps": 1e-5}
    # a mean over another axis is no row norm
    tr = trace.trace(lambda x: x * torch.rsqrt(
        torch.mean(x * x, dim=1, keepdim=True) + 1e-6), x)
    assert K.ROW_NORM not in [op.kind for op in tr.graph.ops]


def test_softmax_lifts_on_the_trailing_axis_only():
    x = torch.randn(2, 3, 8, generator=torch.Generator().manual_seed(8))
    _lifted(lambda x: torch.softmax(x, dim=-1), x, kinds=[K.ROW_SOFTMAX])
    _lifted(lambda x: torch.softmax(x, dim=2), x, kinds=[K.ROW_SOFTMAX])
    net = _lifted(lambda x: torch.softmax(x, dim=1), x, kinds=[K.OPAQUE])
    assert net.graph.ops[0].attrs["prim"] == "softmax"


@pytest.mark.parametrize("pool", ["max_glue", "max_own_pad", "avg", "avg_pad",
                                  "max_indices_unread", "max_asym_pad"])
def test_pools_fold_their_layout_glue_into_pool2d(pool):
    x = torch.randn(2, 9, 9, 4, generator=torch.Generator().manual_seed(9))
    nchw = (0, 3, 1, 2)
    back = (0, 2, 3, 1)
    fns = {
        "max_glue": (lambda x: tcnn.max_pool(x, (3, 3), (2, 2), (1, 1)),
                     ("max", (3, 3), (2, 2), (1, 1))),
        "max_own_pad": (lambda x: F.max_pool2d(x.permute(nchw), 3, 1, 1)
                        .permute(back), ("max", (3, 3), (1, 1), (1, 1))),
        "avg": (lambda x: F.avg_pool2d(x.permute(nchw), 2).permute(back),
                ("avg", (2, 2), (2, 2), (0, 0))),
        "avg_pad": (lambda x: F.avg_pool2d(
            F.pad(x.permute(nchw), (1, 1, 1, 1)), 3, 2).permute(back),
            ("avg", (3, 3), (2, 2), (1, 1))),
        "max_indices_unread": (lambda x: F.max_pool2d(
            x.permute(nchw), 2, return_indices=True)[0].permute(back),
            ("max", (2, 2), (2, 2), (0, 0))),
        "max_asym_pad": (lambda x: F.max_pool2d(F.pad(
            x.permute(nchw), (0, 1, 0, 1), value=-torch.inf), 2)
            .permute(back), None),
    }
    fn, geom = fns[pool]
    if geom is None:                      # asymmetric padding: opaque
        tr = trace.trace(fn, x)
        assert K.POOL2D not in [op.kind for op in tr.graph.ops]
        return
    net = _lifted(fn, x, kinds=[K.POOL2D])
    op = net.graph.ops[0]
    assert (op.fn, op.attrs["window"], op.attrs["stride"],
            op.attrs["padding"]) == geom


def test_conv_and_matmul_lift_to_the_backbone_kinds():
    g = torch.Generator().manual_seed(10)
    x = torch.randn(2, 8, 8, 3, generator=g)
    w, bias = torch.randn(3, 3, 3, 5, generator=g), torch.randn(5, generator=g)

    def conv(x, w, bias):
        return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), bias,
                        stride=2, padding=1).permute(0, 2, 3, 1)

    net = _lifted(conv, x, w, bias, kinds=[K.CONV2D])
    op = net.graph.ops[0]
    assert (op.params, op.attrs["kernel_shape"], op.attrs["stride"],
            op.attrs["padding"]) == (("arg1", "arg2"), (3, 3, 3, 5), (2, 2),
                                     (1, 1))
    # an NCHW convolution (no glue) stays opaque
    tr = trace.trace(lambda x, w: F.conv2d(x, w), torch.randn(1, 3, 6, 6),
                     torch.randn(4, 3, 3, 3))
    assert [op.kind for op in tr.graph.ops] == [K.OPAQUE]
    h, m = torch.randn(2, 5, 6, generator=g), torch.randn(6, 7, generator=g)
    net = _lifted(lambda h, m: h @ m, h, m, kinds=[K.MATMUL])
    assert net.graph.ops[0].attrs["features_out"] == 7
    lin_w, lin_b = torch.randn(7, 6, generator=g), torch.randn(7, generator=g)
    _lifted(lambda h, w, b: F.linear(h, w, b), h, lin_w, lin_b,
            kinds=[K.MATMUL])
    # a product of two values is no weight matmul
    _lifted(lambda h, m: h @ m, h, h.transpose(1, 2).contiguous(),
            kinds=[K.OPAQUE])


def test_several_results_replay_through_a_holder_and_projections():
    x = torch.randn(4, 10, generator=torch.Generator().manual_seed(11))

    def fn(x):
        a, b = torch.split(x, [4, 6], dim=-1)
        m, i = torch.max(x, dim=-1)
        return torch.relu(a).sum(-1) + b.mean(-1) + m, i

    net = api.optimize(fn, x, config=_cfg())
    holders = [op for op in net.graph.ops if op.attrs.get("prim") in
               ("split", "split_with_sizes", "max")]
    assert [op.attrs["out_shape"] for op in holders] == [(40,), (8,)]
    got, want = net(x), fn(x)
    torch.testing.assert_close(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert net.report().n_synthetic >= 3         # the projections


# ---------------------------------------------------------------------------
# Gradient fences.
# ---------------------------------------------------------------------------

def test_detach_fenced_rms_scale_is_not_lifted():
    g = torch.Generator().manual_seed(12)
    x, w = torch.randn(3, 16, generator=g), torch.randn(16, generator=g)

    def fenced(x, w):
        r = torch.rsqrt(torch.mean(torch.square(x), -1, keepdim=True) + 1e-6)
        return x * r.detach() * w

    for mode in MODES:
        net = api.optimize(fenced, x, w, config=_cfg(mode))
        assert K.ROW_NORM not in _kinds(net)
        assert "detach" in [op.attrs.get("prim") for op in net.graph.ops]
        xt, xr = x.clone().requires_grad_(), x.clone().requires_grad_()
        got = torch.autograd.grad(net(xt, w).sum(), xt)[0]
        want = torch.autograd.grad(fenced(xr, w).sum(), xr)[0]
        torch.testing.assert_close(got, want)


class _StraightThrough(torch.autograd.Function):
    """relu forward, a backward of its own (3 x the cotangent)."""

    @staticmethod
    def forward(ctx, x):
        return torch.relu(x)

    @staticmethod
    def backward(ctx, g):
        return 3.0 * g


def test_user_autograd_function_keeps_its_own_backward():
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(13))

    def fn(x):
        return torch.sigmoid(_StraightThrough.apply(2.0 * x))

    net = api.optimize(fn, x, config=_cfg("brainslug", differentiable=True))
    call = [op for op in net.graph.ops
            if op.attrs.get("prim") == "autograd_function"]
    assert len(call) == 1 and K.EW_UNARY in _kinds(net)
    assert "relu" not in [op.fn for op in net.graph.ops]      # not inlined
    xt, xr = x.clone().requires_grad_(), x.clone().requires_grad_()
    got = torch.autograd.grad(net(xt).sum(), xt)[0]
    want = torch.autograd.grad(fn(xr).sum(), xr)[0]
    torch.testing.assert_close(got, want)
    relu_grad = torch.autograd.grad(
        torch.sigmoid(torch.relu(2.0 * xr)).sum(), xr)[0]
    assert not torch.allclose(got, relu_grad)


def test_no_grad_region_replays_under_no_grad():
    x = torch.randn(3, 4, generator=torch.Generator().manual_seed(14))

    def fn(x):
        with torch.no_grad():
            s = torch.relu(x).sum()
        return x * s

    net = api.optimize(fn, x, config=_cfg())
    assert K.EW_UNARY not in _kinds(net)
    xt, xr = x.clone().requires_grad_(), x.clone().requires_grad_()
    torch.testing.assert_close(torch.autograd.grad(net(xt).sum(), xt)[0],
                               torch.autograd.grad(fn(xr).sum(), xr)[0])


# ---------------------------------------------------------------------------
# Calls: errors, pytrees, empty inputs, the device, deprecations.
# ---------------------------------------------------------------------------

def test_wrong_structure_shape_or_dtype_raises_type_error():
    x = torch.randn(4, 8)
    net = api.optimize(lambda x: torch.relu(x) + 1.0, x, config=_cfg())
    with pytest.raises(TypeError, match="argument structure"):
        net(x, x)
    with pytest.raises(TypeError, match="re-run optimize"):
        net(torch.randn(3, 8))
    with pytest.raises(TypeError, match="re-run optimize"):
        net(x.double())
    with pytest.raises(TypeError, match="not a tensor"):
        api.optimize(lambda x, n: x * n, x, 3, config=_cfg())


def test_pytree_inputs_and_outputs():
    g = torch.Generator().manual_seed(15)
    x, y, v = (torch.randn(3, 8, generator=g), torch.randn(3, 8, generator=g),
               torch.randn(8, generator=g))

    def fn(d, t):
        return {"a": torch.relu(d["x"] * d["y"]), "b": (t[0] + v, t[1]),
                "c": [d["x"]]}

    net = api.optimize(fn, {"x": x, "y": y}, (x, v), config=_cfg())
    got, want = net({"x": x, "y": y}, (x, v)), fn({"x": x, "y": y}, (x, v))
    assert got.keys() == want.keys() and got["c"][0] is x
    for a, b in zip(torch.utils._pytree.tree_leaves(got),
                    torch.utils._pytree.tree_leaves(want)):
        torch.testing.assert_close(a, b)


def test_zero_size_input_stays_opaque_and_runs():
    z = torch.zeros(0, 8)
    net = api.optimize(lambda a: torch.relu(a) * 2.0 + a.sum(), z,
                       config=_cfg("brainslug"))
    assert net.n_stacks == 0 and net(z).shape == (0, 8)


def test_cuda_by_default_and_deprecated_reexports(monkeypatch):
    assert api.OptimizeConfig().torch_device == "cuda"
    assert api.OptimizeConfig().kernel_registry is True
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.optimize(torch.relu, torch.randn(2, 4))
    graph, _ = tcnn.block_net(1, channels=4, device="cpu")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        api.optimize_graph(graph, (1, 4, 4, 4), _cfg())
    assert any(issubclass(x.category, DeprecationWarning) for x in w)
    with pytest.raises(ValueError, match="kernel_registry"):
        api.OptimizeConfig(kernel_registry=1)
