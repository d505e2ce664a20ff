"""``optimize`` under a mesh of gloo CPU ranks (``repro_torch.launch.mesh.
spawn``): the port's mesh-compiled callables against its single-device
compile (itself held to the JAX package elsewhere) and against the JAX
package's plain functions on the same numpy-seeded inputs.  The bars are
those of ``tests/test_mesh_parity.py``, which fail in the reference:

* the row-chain loss at 2 ranks under ``data``: gradients within 1e-5,
  and ``explain()`` names ``mesh data=2`` and the per-shard budget the
  collapser sized against;
* a planted defect (the sharded backward without the all-reduce of a
  replicated operand's cotangent) fails that gradient check;
* the rmsnorm + swiglu block at (1, 2) under ``tensor``: ``kernel_hits``
  rmsnorm 1 and swiglu 1, logits within 1e-5;
* ``cnn.block_fn`` training at (2, 2) under ``both`` and a VGG step under
  ``data`` within the training check's rule (rtol 1e-4, atol 1e-4 x
  max|g|), and ``optimize_stack`` under ``data``.

Two launches: two ranks (every two-rank check in one), then four."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch.core import resource
from repro_torch.examples import mesh_checks
from repro_torch.launch import mesh as mesh_mod

TOL = 1e-5


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 128)).astype(np.float32)
    w = rng.normal(size=(128, 128)).astype(np.float32)
    d, f = mesh_checks.TP_BLOCK[1:]
    block = {
        "x": rng.standard_normal((mesh_checks.TP_BLOCK[0], d)),
        "g": 1.0 + 0.1 * rng.standard_normal(d),
        "wg": rng.standard_normal((d, f)) * 0.2,
        "wu": rng.standard_normal((d, f)) * 0.2,
        "wd": rng.standard_normal((f, d)) * 0.2}
    return x, w, {k: v.astype(np.float32) for k, v in block.items()}


def two_rank_checks(x, w, block):
    """Every two-rank check, in each rank of one launch."""
    return {
        "loss": mesh_checks.loss_grads("cpu", x, w),
        "planted": mesh_checks.vgg_step("cpu", stages=(16, 32),
                                        input_shape=(4, 16, 16, 3),
                                        planted=True),
        "block": mesh_checks.block_forward("cpu", block),
        "vgg": mesh_checks.vgg_step("cpu", stages=(16, 32),
                                    input_shape=(4, 16, 16, 3)),
        "stack": mesh_checks.stack_checks("cpu"),
    }


@functools.lru_cache(maxsize=None)
def _two():
    x, w, block = _inputs()
    return mesh_mod.spawn(two_rank_checks, 2, x, w, block, device="cpu",
                          timeout=240)


@functools.lru_cache(maxsize=None)
def _four():
    return mesh_mod.spawn(mesh_checks.block_fn_train, 4, "cpu",
                          device="cpu", timeout=240)


def _every_sequence_once(c, n):
    """Each rank ran every sequence's forward and backward once (no second
    forward in the sharded backward).  On the CPU the fused-stack wrappers
    count their plain versions as ``*_reference``; chip_smoke.py phase 29
    holds the card's ``*_generated``."""
    assert c["fwd_reference"] == c["bwd_reference"] == n, c
    assert c["fwd_generated"] == c["bwd_generated"] == 0, c


def _jax_loss(x, w):
    h = x @ w + x
    h = h / jnp.sqrt(jnp.mean(h * h, axis=-1, keepdims=True) + 1e-6)
    return jnp.mean(jnp.tanh(h) * h)


def test_dp_gradients_match_one_device_and_jax():
    got = _two()["loss"]
    assert got["max_abs_err"] <= TOL, got["max_abs_err"]
    x, w, _ = _inputs()
    want = jax.grad(_jax_loss, argnums=(0, 1))(jnp.asarray(x),
                                               jnp.asarray(w))
    for g, j in zip(got["grads"], want):
        np.testing.assert_allclose(g, np.asarray(j), atol=TOL, rtol=TOL)
    for c in got["ranks"]:
        _every_sequence_once(c, got["n_sequences"])
        assert c["collectives"]["calls"]["all_gather_into_tensor"] > 0


def test_explain_reports_mesh_and_per_shard_budget():
    got = _two()["loss"]
    text = got["explain"]
    assert "mesh data=2" in text, text
    budget = resource.shard_device(resource.H100, 2).resource_limit
    assert got["budget"] == budget
    assert f"per-shard shared-memory budget={budget} B = " \
           f"{budget / 2 ** 20:.2f} MiB" in text, text
    assert "sharded" in text


def test_planted_missing_cotangent_reduction_fails_the_gradient_check():
    """Without the all-reduce each rank keeps its shard's partial sum of
    a batch-norm scale's gradient: the check must fail on those, and only
    on those (the sharded input's gradient is gathered, not reduced)."""
    got = _two()["planted"]
    assert got["forward_ok"] and not got["grads_ok"]
    bad = {k for k, r in got["grad_rel"].items() if r > 1e-4}
    assert bad and all(k.startswith("bn") for k in bad), got["grad_rel"]


def _jax_block(x, g, wg, wu, wd):
    var = jnp.mean(jnp.square(x), axis=-1, keepdims=True)
    h = x * jax.lax.rsqrt(var + 1e-6) * g
    gate, up = h @ wg, h @ wu
    return x + (gate * jax.nn.sigmoid(gate) * up) @ wd


def test_tp_block_logits_match_one_device_and_jax():
    got = _two()["block"]
    assert got["kernel_hits"] == {"rmsnorm": 1, "swiglu": 1}
    assert got["kernel_fallbacks"] == {}
    assert got["max_abs_err"] <= TOL, got["max_abs_err"]
    assert got["registry_all_kernels"]
    # swiglu's features are split over "model"; rmsnorm's reduction fences
    active = {name: a for kind, name, a in got["dist"] if kind == "kernel"}
    assert sorted(active.values()) == [False, True]
    _, _, block = _inputs()
    want = _jax_block(*(jnp.asarray(block[k])
                        for k in ("x", "g", "wg", "wu", "wd")))
    np.testing.assert_allclose(got["y"], np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_vgg_step_under_data_matches_one_device():
    got = _two()["vgg"]
    assert got["forward_ok"] and got["grads_ok"], got["grad_rel"]
    assert abs(got["loss"] - got["loss_one"]) <= 1e-4 * abs(got["loss_one"])
    assert all(active for _, _, active in got["dist"])
    for c in got["ranks"]:
        _every_sequence_once(c, got["n_sequences"])


def test_optimize_stack_under_data_matches_one_device():
    got = _two()["stack"]
    assert max(got["out_rel"], *got["grad_rel"]) <= TOL, got


def test_block_fn_training_under_both_matches_one_device():
    got = _four()
    assert "data=2 x model=2" in got["mesh"]
    np.testing.assert_allclose(got["losses"], got["losses_one"], rtol=1e-4)
    assert max(got["grad_rel"].values()) <= 1e-4, got["grad_rel"]
    assert any(active for _, _, active in got["dist"])
    assert len(got["ranks"]) == 4
    steps = len(got["losses"])
    for c in got["ranks"]:
        _every_sequence_once(c, steps * got["n_sequences"])


@pytest.mark.parametrize("n,backend", [(2, None), (1, "gloo")])
def test_backend_choice_on_the_cpu(n, backend):
    assert mesh_mod.choose_backend(n, "cpu", backend)[0] == "gloo"
    with pytest.raises(RuntimeError, match="nccl"):
        mesh_mod.choose_backend(n, "cpu", "nccl")
