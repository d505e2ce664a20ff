"""The port's GPipe schedule (``repro_torch.distributed.pipeline_parallel``)
on gloo CPU ranks against the JAX package:

* the twin of ``tests/test_multidevice.py``'s pipeline case: ``tanh(x @
  w)``, 4 stages on 4 ranks, 4 microbatches, within 1e-5 of the stages
  applied in turn (by JAX), every stage returning the whole output;
* the gradients of ``sum(y * c)`` through the schedule, ``x``'s and each
  stage's ``w``'s, within 1e-5 of ``jax.grad`` of the stages applied in
  turn;
* ``bubble_fraction`` equal to JAX's on a grid;
* a reduced deepseek-7b block a stage (rmsnorm, attention, swiglu MLP) on
  2 ranks bit for bit against the blocks applied in turn on one rank."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import pipeline_parallel as jpp
from repro_torch.distributed import pipeline_parallel as pp
from repro_torch.examples import mesh_checks
from repro_torch.launch import mesh as mesh_mod

torch.set_num_threads(1)


def _arrays():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 16, 16), np.float32) * 0.5
    x = rng.standard_normal((8, 16), np.float32)
    cot = rng.standard_normal((8, 16), np.float32)
    return x, w, cot


def _sequential(x, w):
    for i in range(4):
        x = jnp.tanh(x @ w[i])
    return x


@functools.lru_cache(maxsize=None)
def _tanh_run():
    x, w, cot = _arrays()
    return mesh_mod.spawn(mesh_checks.run_checks, 4, [
        ("tanh", "pipeline_tanh", dict(device="cpu", x=x, w=w)),
        ("tanh_8", "pipeline_tanh", dict(device="cpu", x=x, w=w,
                                         n_microbatches=8)),
        ("grad", "pipeline_tanh", dict(device="cpu", x=x, w=w, cot=cot))],
        device="cpu", timeout=180)


@pytest.mark.parametrize("case", ["tanh", "tanh_8"])
def test_pipeline_matches_sequential_apply(case):
    x, w, _ = _arrays()
    want = _sequential(jnp.asarray(x), jnp.asarray(w))
    got = _tanh_run()[case]
    assert "stage=4" in got["mesh"]
    np.testing.assert_allclose(got["y"], np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # activations hop forward only: the last stage sends nothing, every
    # other stage once a microbatch; the last stage's outputs reach all
    n_mb = 4 if case == "tanh" else 8
    sends = [c["collectives"]["calls"].get("send", 0) for c in
             got["ranks"]]
    assert sends == [n_mb, n_mb, n_mb, 0]
    assert all(c["collectives"]["calls"]["broadcast"] == 1
               for c in got["ranks"])


def test_pipeline_gradients_match_sequential_apply():
    """The reverse schedule: every stage's ``w`` gradient and ``x``'s
    against ``jax.grad`` of the stages applied in turn; the cotangents hop
    back once a microbatch from every stage but the first."""
    x, w, cot = _arrays()
    want_x, want_w = jax.grad(
        lambda x_, w_: jnp.sum(_sequential(x_, w_) * cot), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    got = _tanh_run()["grad"]
    np.testing.assert_allclose(got["y"], np.asarray(
        _sequential(jnp.asarray(x), jnp.asarray(w))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["grad_x"], np.asarray(want_x), rtol=1e-5,
                               atol=1e-5)
    for stage in range(4):
        np.testing.assert_allclose(got["grad_w"][stage],
                                   np.asarray(want_w[stage]), rtol=1e-5,
                                   atol=1e-5)
    sends = [c["collectives"]["calls"].get("send", 0) for c in
             got["ranks"]]
    assert sends == [4, 8, 8, 4]


def test_bubble_fraction_matches_jax():
    for s in range(1, 9):
        for m in range(1, 17):
            assert pp.bubble_fraction(s, m) == jpp.bubble_fraction(s, m)
    assert pp.bubble_fraction(2, 4) == 0.2


def test_pipeline_rejects_a_ragged_batch():
    class _Mesh:
        coords = {"stage": 0}

        def extent(self, axis):
            return 1
    with pytest.raises(ValueError, match="microbatches"):
        pp.pipeline_apply(lambda p, h: h, {"w": torch.zeros(1, 2)},
                          torch.zeros(6, 2), mesh=_Mesh(), n_microbatches=4)


def test_pipeline_of_lm_blocks_is_bit_for_bit():
    got = mesh_mod.spawn(mesh_checks.run_checks, 2, [
        ("block", "pipeline_block", dict(device="cpu", reduced=True,
                                         seq=32, dtype="float32"))],
        device="cpu", timeout=180)["block"]
    assert got["bitwise"] and got["finite"], got["max_abs_err"]
    assert got["bubble"] == 0.2
    # every stage holds the whole output
    assert len({c["y_sum"] for c in got["ranks"]}) == 1
