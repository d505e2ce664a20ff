"""The port's data-parallel training on gloo CPU ranks
(``repro_torch.distributed``, ``TrainerConfig(data_parallel=True)``)
against the JAX package's.

* ``compression``: ``quantize``, ``dequantize``, ``compress_decompress``
  and ``compressed_bytes`` against ``repro.distributed.compression`` on
  the same arrays, within one quantum;
* ``plan_mesh`` against the JAX package's over a grid of (n, model
  parallel, pods);
* the hierarchical all-reduce, and ``reduce_scatter_mean`` followed by an
  all-gather, equal the flat mean (as ``tests/test_multidevice.py``), at
  (pod, data, model) = (2, 2, 1);
* the DP step with ``DPConfig(reduce_scatter=True)`` (leaves whose leading
  dim splits over ``data`` reduce-scattered and gathered, a ragged one on
  the flat mean) equals the flat-mean step and the one-device step on the
  whole batch, there too;
* the DP ``Trainer`` at 2 ranks from the JAX ``lm.init`` weights against
  the JAX DP trainer on a forced 2-device host mesh (a subprocess):
  reduced deepseek-7b, batch 4 x 32 tokens, lr 3e-3, uncompressed and
  compressed, losses within 1e-4 relative and grad norms within 1e-3
  (as ``test_trainer_matches_jax_trainer``); the port runs its kernels'
  plain versions (``brainslug``), JAX its fused ``xla`` step;
* the DP step equals the single-device step on the whole batch;
* the compressed run tracks the uncompressed one over 20 steps (rtol
  0.05, as ``tests/test_mesh_parity.py``);
* kill and resume through the DP driver: the saved error-feedback state
  is not zero, the resumed run starts from zero and completes."""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.distributed import compression as jcomp
from repro.distributed import fault_tolerance as jft
from repro.models import lm as jlm
from repro_torch.distributed import collectives, compression
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.examples import mesh_checks
from repro_torch.launch import mesh as mesh_mod

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
COMMON = dict(arch="deepseek-7b", reduced=True, batch_override=4,
              seq_override=32, lr=3e-3, log_every=100)
JAX_STEPS = 3
LONG_STEPS = 20


# ---------------------------------------------------------------------------
# Compression and plan_mesh: one process.
# ---------------------------------------------------------------------------

def _arrays():
    rng = np.random.default_rng(3)
    return [rng.standard_normal(s).astype(np.float32) * sc
            for s, sc in (((1000,), 1.0), ((17, 33), 1e-3), ((256,), 50.0),
                          ((4, 64, 3), 0.1))]


@pytest.mark.parametrize("i", range(4))
def test_quantize_and_dequantize_match_jax(i):
    a = _arrays()[i]
    jq, js = jcomp.quantize(a)
    tq, ts = compression.quantize(torch.from_numpy(a))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    # round-half-even on both sides; a tie computed one ulp apart may land
    # one quantum off
    assert np.abs(tq.numpy().astype(int) - np.asarray(jq).astype(int)
                  ).max() <= 1
    jd = np.asarray(jcomp.dequantize(jq, js, a.shape, np.float32))
    td = compression.dequantize(tq, ts, a.shape, torch.float32).numpy()
    quantum = float(np.asarray(js).max())
    assert np.abs(td - jd).max() <= quantum * (1 + 1e-6)
    assert np.abs(td - a).max() <= 0.5 * quantum * (1 + 1e-5)


def test_compress_decompress_and_bytes_match_jax():
    arrays = _arrays()
    grads = {f"g{i}": a for i, a in enumerate(arrays)}
    err = {k: np.full_like(a, 0.01) for k, a in grads.items()}
    jg, je = jcomp.compress_decompress(grads, err)
    tg, te = compression.compress_decompress(
        {k: torch.from_numpy(v) for k, v in grads.items()},
        {k: torch.from_numpy(v) for k, v in err.items()})
    for k, a in grads.items():
        quantum = np.abs(a + 0.01).max() / 127.0
        assert np.abs(tg[k].numpy() - np.asarray(jg[k])).max() \
            <= quantum * (1 + 1e-5)
        # g + e == g' + e' on both sides
        np.testing.assert_allclose(tg[k].numpy() + te[k].numpy(),
                                   a + 0.01, atol=1e-6)
    assert compression.compressed_bytes(
        {k: torch.from_numpy(v) for k, v in grads.items()}) \
        == jcomp.compressed_bytes(grads)
    zero = compression.reset_error_state(te)
    assert all(float(v.abs().max()) == 0.0 for v in zero.values())


@pytest.mark.parametrize("pods", [1, 2])
def test_plan_mesh_matches_jax(pods):
    for n in (1, 2, 3, 7, 8, 12, 16, 31, 64, 100, 256, 512):
        for mp in (1, 2, 4, 8, 16):
            for lo in (1, 2):
                if n // pods < 1:
                    continue
                try:
                    want = jft.plan_mesh(n, model_parallel=mp,
                                         min_model_parallel=lo, pods=pods)
                except ValueError:
                    with pytest.raises(ValueError):
                        ft.plan_mesh(n, model_parallel=mp,
                                     min_model_parallel=lo, pods=pods)
                    continue
                got = ft.plan_mesh(n, model_parallel=mp,
                                   min_model_parallel=lo, pods=pods)
                assert (got.shape, got.axis_names, got.n_devices) == (
                    want.shape, want.axis_names, want.n_devices)


# ---------------------------------------------------------------------------
# Collectives: four ranks.
# ---------------------------------------------------------------------------

def collective_checks():
    """In each of 4 ranks at (pod, data, model) = (2, 2, 1)."""
    import torch.distributed as dist
    mesh = mesh_mod.make_mesh((2, 2, 1), mesh_mod.POD_AXES, "cpu")
    rank = dist.get_rank()
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6) * (rank + 1)
    flat = x.clone()
    dist.all_reduce(flat)
    hier = collectives.psum_hierarchical(x.clone(), mesh)
    piece = collectives.reduce_scatter_mean(x.clone(), mesh, "data", 0)
    data_mean = collectives.all_gather(piece, mesh, "data", 0)
    data_flat = collectives.all_reduce(x.clone(), mesh, "data") / 2
    summed = collectives.tree_psum({"a": {"b": x.clone()}}, mesh, "pod")
    gathered = collectives.all_gather_params({"w": piece}, mesh, "data")
    return {"hier": float((hier - flat).abs().max()),
            "rs": float((data_mean - data_flat).abs().max()),
            "tree": float((gathered["w"] - data_mean).abs().max()),
            "tree_psum_shape": tuple(summed["a"]["b"].shape),
            "calls": collectives.STATS.snapshot()["calls"],
            "dp": dp_step_checks(mesh)}


def _dp_loss(p, b):
    err = b["x"] @ p["w"] + p["b"] - b["y"]
    return (err ** 2).mean() + (p["odd"] ** 2).sum() * 1e-2, {
        "mse": (err ** 2).mean()}


def dp_step_checks(mesh, steps: int = 2) -> dict:
    """Two DP steps with ``reduce_scatter`` off and on, and two AdamW steps
    of the whole batch on this rank alone, from the same seeded tensors:
    the largest parameter gaps, and the reduce-scatter calls the step made
    (the ``odd`` leaf's 3 rows do not split over data=2: flat mean)."""
    from repro_torch.distributed import data_parallel as dp
    from repro_torch.optim import adamw
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(8, 6, generator=g),
              "b": torch.randn(6, generator=g),
              "odd": torch.randn(3, 5, generator=g)}
    batch = {"x": torch.randn(8, 8, generator=g),
             "y": torch.randn(8, 6, generator=g)}
    cfg = adamw.AdamWConfig(lr=1e-2)
    out, norms, calls = {}, {}, {}
    for rs in (False, True):
        clone = {k: v.clone() for k, v in params.items()}
        state = dp.init_state(clone, adamw.init(clone))
        step = dp.make_dp_train_step(_dp_loss, cfg, mesh,
                                     dp.DPConfig(reduce_scatter=rs))
        before = collectives.STATS.snapshot()["calls"]
        norms[rs] = []
        for _ in range(steps):
            state, metrics = step(state, batch)
            norms[rs].append(float(metrics["grad_norm"]))
        after = collectives.STATS.snapshot()["calls"]
        calls[rs] = {k: after[k] - before.get(k, 0) for k in after}
        out[rs] = state["params"]
    one = {k: v.clone() for k, v in params.items()}
    opt, norms["one"] = adamw.init(one), []
    for _ in range(steps):
        live = {k: v.detach().requires_grad_() for k, v in one.items()}
        grads = torch.autograd.grad(_dp_loss(live, batch)[0],
                                    list(live.values()))
        one, opt, m = adamw.update(cfg, dict(zip(live, grads)), opt, one)
        norms["one"].append(float(m["grad_norm"]))
    gap = lambda a, b: max(float((a[k] - b[k]).abs().max()) for k in a)
    # AdamW's step is nearly blind to a gradient's scale: the grad norms
    # (of the reduced gradients, before clipping) see a lost 1/n
    rel = lambda a, b: max(abs(x - y) / abs(y) for x, y in zip(a, b))
    return {"rs_vs_flat": gap(out[True], out[False]),
            "rs_vs_one": gap(out[True], one),
            "flat_vs_one": gap(out[False], one),
            "norm_rs_vs_one": rel(norms[True], norms["one"]),
            "norm_flat_vs_one": rel(norms[False], norms["one"]),
            "moved": gap(out[True], params),
            "rs_calls": calls[True].get("reduce_scatter_tensor", 0),
            "flat_rs_calls": calls[False].get("reduce_scatter_tensor", 0)}


@pytest.fixture(scope="module")
def collectives_run():
    return mesh_mod.spawn(collective_checks, 4, device="cpu", timeout=180)


def test_hierarchical_and_reduce_scatter_equal_the_flat_reduction(
        collectives_run):
    got = collectives_run
    assert got["hier"] == 0.0
    assert got["rs"] <= 1e-6
    assert got["tree"] == 0.0
    assert got["tree_psum_shape"] == (4, 6)
    assert got["calls"]["reduce_scatter_tensor"] == 1


def test_reduce_scatter_dp_step_equals_the_flat_mean_step(collectives_run):
    dp = collectives_run["dp"]
    # w and b reduce-scattered and gathered each step; odd on the flat mean
    assert dp["rs_calls"] == 2 * 2 and dp["flat_rs_calls"] == 0
    assert dp["moved"] > 1e-3
    assert dp["rs_vs_flat"] <= 1e-6
    assert dp["rs_vs_one"] <= 1e-5 and dp["flat_vs_one"] <= 1e-5
    assert dp["norm_rs_vs_one"] <= 1e-5 and dp["norm_flat_vs_one"] <= 1e-5


# ---------------------------------------------------------------------------
# The DP Trainer against the JAX DP trainer.
# ---------------------------------------------------------------------------

_JAX_DP = """
import json
from repro.launch import train as tr
out = {}
for compress in (False, True):
    tc = tr.TrainerConfig(arch="deepseek-7b", steps=%d, mode="xla",
                          data_parallel=True, compress=compress,
                          mesh_devices=2, batch_override=4, seq_override=32,
                          lr=3e-3, log_every=100)
    out[str(compress)] = [(h["loss"], h["grad_norm"]) for h in tr.train(tc)]
print(json.dumps(out))
""" % JAX_STEPS


@functools.lru_cache(maxsize=None)
def _jax_dp():
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": os.environ.get("XLA_FLAGS", "")
           + " --xla_force_host_platform_device_count=2"}
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX_DP)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@functools.lru_cache(maxsize=None)
def _np_params():
    cfg = jconfigs.get_config("deepseek-7b").reduced()
    return jax.tree_util.tree_map(
        np.asarray, jlm.init(jax.random.PRNGKey(0), cfg)[0])


def dp_runs(np_params, ckpt_dir):
    """In each of 2 ranks: uncompressed and compressed for LONG_STEPS from
    the JAX weights, then a compressed run killed at step 6 and resumed;
    the error-feedback state its step-4 checkpoint saved."""
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.launch.train import TrainerConfig, build_trainer
    from repro_torch.layers import base
    common = dict(COMMON, mode="brainslug", device="cpu", mesh_devices=2)
    got = mesh_checks.dp_train(
        [dict(steps=LONG_STEPS, compress=False),
         dict(steps=LONG_STEPS, compress=True)],
        np_params=np_params, common=common)
    resumed = mesh_checks.dp_train(
        [dict(steps=8, compress=True, ckpt_dir=ckpt_dir, ckpt_every=4,
              fail_at=6)], np_params=np_params, common=common)
    got["runs"] += resumed["runs"]
    # what the checkpoints hold: a residual that a restore must not replay
    fresh = build_trainer(TrainerConfig(data_parallel=True, compress=True,
                                        **common))
    tree = ckpt.restore_latest(ckpt_dir, {"params": fresh.params,
                                          "opt": fresh.opt_state})[0]
    got["saved_err"] = max(float(e.abs().max())
                           for e in base.tree_leaves(tree["opt"]["err"]))
    return got


@pytest.fixture(scope="module")
def port_dp(tmp_path_factory):
    return mesh_mod.spawn(dp_runs, 2, _np_params(),
                          str(tmp_path_factory.mktemp("dp_ckpt")),
                          device="cpu", timeout=300)


def _hist(run):
    return ([h["loss"] for h in run["history"]],
            [h["grad_norm"] for h in run["history"]])


@pytest.mark.parametrize("compress", [False, True])
def test_dp_trainer_matches_jax_dp_trainer(port_dp, compress):
    want = np.asarray(_jax_dp()[str(compress)])
    losses, gnorms = _hist(port_dp["runs"][int(compress)])
    np.testing.assert_allclose(losses[:JAX_STEPS], want[:, 0], rtol=1e-4)
    np.testing.assert_allclose(gnorms[:JAX_STEPS], want[:, 1], rtol=1e-3)
    run = port_dp["runs"][int(compress)]
    assert "data=2 x model=1" in run["mesh"]
    for c in run["ranks"]:
        # the kernels' plain versions on the CPU, every step, every rank
        assert c["launches"]["fused_ce"] == 0
        assert c["collectives"]["calls"]["all_reduce"] > 0


def test_dp_step_equals_the_single_device_step(port_dp):
    from repro_torch import convert
    from repro_torch.launch.train import TrainerConfig, train
    np_params = _np_params()
    one = train(TrainerConfig(**COMMON, mode="brainslug", device="cpu",
                              steps=JAX_STEPS),
                init_params=lambda cfg, dev: convert.lm_params_from_numpy(
                    np_params, dev))
    losses, gnorms = _hist(port_dp["runs"][0])
    np.testing.assert_allclose(losses[:JAX_STEPS], [h["loss"] for h in one],
                               rtol=1e-5)
    np.testing.assert_allclose(gnorms[:JAX_STEPS],
                               [h["grad_norm"] for h in one], rtol=1e-5)


def test_compressed_trajectory_tracks_uncompressed(port_dp):
    a = np.asarray(_hist(port_dp["runs"][0])[0])
    b = np.asarray(_hist(port_dp["runs"][1])[0])
    assert len(a) == len(b) == LONG_STEPS
    np.testing.assert_allclose(a, b, rtol=0.05, atol=0.05)
    assert a[-1] < a[0] and b[-1] < b[0]
    assert not np.array_equal(a, b)         # compression changed something


def test_kill_and_resume_resets_the_error_state(port_dp):
    run = port_dp["runs"][2]
    assert run["killed_at"] == 6
    steps = [h["step"] for h in run["history"]]
    assert steps == [5, 6, 7], steps
    assert run["err_after_build"] == 0.0
    assert port_dp["saved_err"] > 0.0
    assert all(np.isfinite(h["loss"]) for h in run["history"])
