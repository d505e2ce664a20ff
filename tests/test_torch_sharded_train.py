"""The port's sharded training step (``launch.steps.make_sharded_train_step``,
``TrainerConfig(mesh_devices=n)`` without ``data_parallel``) on gloo CPU
ranks against the JAX package's GSPMD step, every run from the JAX
``lm.init`` weights (``convert.lm_params_from_numpy``):

* the twin of ``tests/test_multidevice.py``'s sharded step: qwen2.5-14b
  ``reduced()``, ``ShapeConfig('t', 32, 4, 'train')``, lr 1e-3, 3 steps on
  4 ranks at (data 2, model 2): losses within rtol 2e-4 / atol 2e-4 of the
  JAX single-device step on the same weights and batches (the bar the JAX
  test holds GSPMD to), and of the port's one-device step; attention and
  the MLP computed on their "model" slices;
* granite-moe-3b ``reduced()`` at (2, 2) the same way, its experts
  gathered; zamba2-7b ``reduced()`` at (2, 2), the shared block split and
  the mamba mixers gathered, its first step's whole gradient leaf for leaf
  and its steps against the JAX step and the port's one-device step;
* the loss of a batch whose halves hold different label counts (the
  global masked mean, as GSPMD's), and ``moe_dispatch="global"`` refused
  under a split batch;
* ``Trainer(mesh_devices=2)`` on 2 ranks against the JAX
  ``Trainer(mesh_devices=2)`` on 2 forced host devices (a subprocess):
  reduced deepseek-7b, batch 4 x 32, lr 3e-3, losses rtol 1e-4 and grad
  norms 1e-3; each rank's element count the fraction its specs give;
  killed and resumed through its global checkpoints, which a one-device
  ``Trainer`` restores;
* the twin of ``tests/test_multidevice.py``'s elastic reshard: (2, 2) on
  4 ranks, a checkpoint at step 4, the mesh re-planned with
  ``fault_tolerance.plan_mesh(2, model_parallel=2)``, restored on 2
  ranks, continued: the 8 losses within rtol 2e-4 / atol 2e-5 of the
  uninterrupted run; the checkpoint restores into a one-device
  ``Trainer`` that continues the same way;
* two planted defects the same limits flag: the backward all-reduce of
  ``copy_to_model`` dropped, and a replicated leaf counted once a rank in
  the gradient norm."""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import RuntimeConfig as JRuntime, ShapeConfig as \
    JShape
from repro.data import pipeline as jdata
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch.core.partition import MeshAxes
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.distributed import sharding as shd
from repro_torch.examples import mesh_checks
from repro_torch.launch import mesh as mesh_mod
from repro_torch.layers import base

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
STEPS = 3
SEQ, BATCH, LR = 32, 4, 1e-3


@functools.lru_cache(maxsize=None)
def _np_params(arch: str):
    cfg = jconfigs.get_config(arch).reduced()
    return jax.tree_util.tree_map(
        np.asarray, jlm.init(jax.random.PRNGKey(0), cfg)[0])


def _jax_batch(cfg, i: int, uneven: bool = False) -> dict:
    batch = jdata.synth_batch(cfg, JShape("t", SEQ, BATCH, "train"), i, 7)
    if uneven:
        batch = mesh_checks.mask_unevenly(batch)
    return jax.tree_util.tree_map(jnp.asarray, batch)


@functools.lru_cache(maxsize=None)
def _jax_run(arch: str, steps: int = STEPS, uneven: bool = False):
    """The JAX single-device step (``xla`` mode) from the same weights on
    ``synth_batch(cfg, shape, i, 7)``, as ``steps.make_train_step``
    composes it (``value_and_grad`` of ``lm.loss_fn``, then
    ``adamw.update``): losses, grad norms, and the first step's gradient
    by ``/``-joined path."""
    cfg = jconfigs.get_config(arch).reduced()
    params = jax.tree_util.tree_map(jnp.asarray, _np_params(arch))
    opt = jadamw.init(params)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, b, cfg, JRuntime(mode="xla")),
        has_aux=True))
    update = jax.jit(functools.partial(jadamw.update,
                                       jadamw.AdamWConfig(lr=LR)))
    losses, norms, first = [], [], None
    for i in range(steps):
        (_, m), grads = grad_fn(params, _jax_batch(cfg, i, uneven))
        if first is None:
            first = {"/".join(str(k.key) for k in path): np.asarray(v)
                     for path, v in
                     jax.tree_util.tree_flatten_with_path(grads)[0]}
        params, opt, om = update(grads, opt, params)
        losses.append(float(m["loss"]))
        norms.append(float(om["grad_norm"]))
    return np.asarray(losses), np.asarray(norms), first


def _jax_steps(arch: str, uneven: bool = False):
    return _jax_run(arch, uneven=uneven)[:2]


def _kw(arch, **extra):
    return dict(arch=arch, device="cpu", np_params=_np_params(arch),
                lr=LR, seq=SEQ, batch=BATCH, **extra)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """One spawn of 4 ranks at (2, 2): qwen's 8 uninterrupted steps (a
    checkpoint after step 4), both planted defects, granite, zamba2 (and
    its first step's gradient), qwen on unevenly masked batches."""
    d = str(tmp_path_factory.mktemp("elastic"))
    q = "qwen2.5-14b"
    checks = [
        ("qwen", "sharded_steps", _kw(q, model_parallel=2, steps=8,
                                      save_at=4, ckpt_dir=d)),
        ("copy_backward", "sharded_steps", _kw(
            q, model_parallel=2, planted="copy_backward")),
        ("norm_replicas", "sharded_steps", _kw(
            q, model_parallel=2, planted="norm_replicas")),
        ("granite", "sharded_steps", _kw("granite-moe-3b-a800m",
                                         model_parallel=2)),
        ("zamba2", "sharded_steps", _kw("zamba2-7b", model_parallel=2,
                                        first_grads=True)),
        ("uneven", "sharded_steps", _kw(q, model_parallel=2, uneven=True)),
    ]
    got = mesh_mod.spawn(mesh_checks.run_checks, 4, checks, device="cpu",
                         timeout=240)
    got["ckpt_dir"] = d
    return got


def _within(got, want, rtol, atol) -> bool:
    return np.allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("arch,key", [("qwen2.5-14b", "qwen"),
                                      ("granite-moe-3b-a800m", "granite")])
def test_sharded_step_matches_the_jax_single_device_step(four_ranks, arch,
                                                         key):
    run = four_ranks[key]
    assert run["shape"] == {"data": 2, "model": 2}
    want_l, want_g = _jax_steps(arch)
    np.testing.assert_allclose(run["losses"][:STEPS], want_l, rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(run["grad_norms"][:STEPS], want_g,
                               rtol=1e-3)
    one = mesh_checks.one_device_steps(arch, device="cpu",
                                       np_params=_np_params(arch), lr=LR,
                                       seq=SEQ, batch=BATCH)
    np.testing.assert_allclose(run["losses"][:STEPS], one["losses"],
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(run["grad_norms"][:STEPS], one["grad_norms"],
                               rtol=1e-5)
    for c in run["ranks"]:
        calls = c["collectives"]["calls"]
        if key == "qwen":
            # 4 layers: attention and the MLP on their model slices
            assert run["kept"] == 10
            assert calls["copy_to_model"] == calls["reduce_from_model"] \
                == 2 * 4 * len(run["losses"])
        else:
            # granite's MoE layers: attention split, the experts gathered
            assert run["kept"] == 4
            assert calls["copy_to_model"] == 4 * len(run["losses"])
        assert calls["reduce_scatter_tensor"] > 0
        assert c["param_numel"] < run["global_numel"] / 2


def test_sharded_hybrid_step_matches_one_device(four_ranks):
    """zamba2-7b ``reduced()`` at (2, 2): the shared attention block and
    its MLP on their model slices, the mamba mixers gathered whole; held
    to the JAX step on the same weights and batches.

    The first step's gradient, gathered, equals ``jax.grad``'s leaf for
    leaf within 1e-3 of each leaf's largest entry, and its loss and grad
    norm meet the qwen case's bars.  Steps 2 and 3 follow AdamW's first
    updates, which move every entry by about lr whatever its gradient's
    size, so entries near zero (the mixers' out-projections hold some)
    turn the float32 difference between the two packages' SSD scans into
    whole-step differences: the port's one-device step reads 2.3e-4 of
    the loss and 2.5e-3 of the grad norm off JAX's at step 3 on these
    weights.  Those steps are held to JAX at 1e-3 (losses) and 1e-2 (grad
    norms), and to the port's one-device step at the Trainer bars."""
    run = four_ranks["zamba2"]
    want_l, want_g = _jax_steps("zamba2-7b")
    want = _jax_run("zamba2-7b")[2]
    got = run["first_grads"]
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        scale = float(np.abs(want[path]).max())
        err = float(np.abs(g - want[path]).max())
        assert err <= 1e-3 * scale + 1e-7, (path, err, scale)
    np.testing.assert_allclose(run["losses"][0], want_l[0], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(run["grad_norms"][0], want_g[0], rtol=1e-5)
    np.testing.assert_allclose(run["losses"], want_l, rtol=1e-3)
    np.testing.assert_allclose(run["grad_norms"], want_g, rtol=1e-2)
    one = mesh_checks.one_device_steps("zamba2-7b", device="cpu",
                                       np_params=_np_params("zamba2-7b"),
                                       lr=LR, seq=SEQ, batch=BATCH)
    np.testing.assert_allclose(run["losses"], one["losses"], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(run["grad_norms"][0], one["grad_norms"][0],
                               rtol=1e-5)
    np.testing.assert_allclose(run["grad_norms"], one["grad_norms"],
                               rtol=1e-3)
    assert run["kept"] == 7                  # wq wk wv wo, wg wu wd
    calls = run["ranks"][0]["collectives"]["calls"]
    assert calls["copy_to_model"] > 0


def test_uneven_label_masks_take_the_global_mean(four_ranks):
    """The batch's halves hold different label counts (every label of the
    first row but 4 masked): the loss is the global masked mean, not the
    mean of the shards' means, as the JAX single-device step has it."""
    run = four_ranks["uneven"]
    want_l, want_g = _jax_steps("qwen2.5-14b", uneven=True)
    np.testing.assert_allclose(run["losses"], want_l, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(run["grad_norms"], want_g, rtol=1e-3)


def test_global_moe_dispatch_is_refused_under_a_split_batch():
    """One sort over a shard's tokens would set the expert capacity per
    shard: the layer refuses it inside a region whose batch is split."""
    from repro_torch import configs as tconfigs
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.distributed import collectives
    from repro_torch.layers import moe
    cfg = tconfigs.get_config("granite-moe-3b-a800m").reduced()
    params = base.tree_map(lambda a: a[0], moe.init(
        torch.Generator().manual_seed(0), cfg, 1, torch.float32))
    x = torch.zeros(2, 8, cfg.d_model)
    rt = RuntimeConfig(mode="brainslug", moe_dispatch="global")
    moe.apply(params, x, cfg, rt)            # whole batch: allowed
    with collectives.region(MeshAxes(("data", "model"), (2, 1)),
                            ("data",)):
        with pytest.raises(ValueError, match="moe_dispatch='global'"):
            moe.apply(params, x, cfg, rt)


@pytest.mark.parametrize("planted", ["copy_backward", "norm_replicas"])
def test_planted_defects_are_flagged(four_ranks, planted):
    """Each defect leaves step 1's loss alone and moves the grad norms out
    of the bar the clean run meets."""
    run = four_ranks[planted]
    want_l, want_g = _jax_steps("qwen2.5-14b")
    assert _within(run["losses"][:1], want_l[:1], 2e-4, 2e-4)
    assert not _within(run["grad_norms"], want_g, 1e-3, 0.0)
    assert _within(four_ranks["qwen"]["grad_norms"][:STEPS], want_g, 1e-3,
                   0.0)


def test_elastic_reshard_resumes_the_trajectory(four_ranks):
    full = four_ranks["qwen"]["losses"]
    assert len(full) == 8
    plan = ft.plan_mesh(2, model_parallel=2)
    assert plan.shape == (1, 2), plan
    rest = mesh_mod.spawn(mesh_checks.run_checks, 2, [(
        "rest", "sharded_steps", _kw("qwen2.5-14b",
                                     model_parallel=plan.shape[1], start=4,
                                     steps=4,
                                     ckpt_dir=four_ranks["ckpt_dir"]))],
        device="cpu", timeout=180)["rest"]
    assert rest["shape"] == {"data": 1, "model": 2}
    np.testing.assert_allclose(full[:4] + rest["losses"], full, rtol=2e-4,
                               atol=2e-5)


def test_checkpoint_restores_into_a_one_device_trainer(four_ranks):
    """The (2, 2) run's checkpoint holds global tensors: a one-device
    ``Trainer`` resumes from it and continues the uninterrupted run."""
    from repro_torch.data import pipeline as data_mod
    from repro_torch.launch.train import TrainerConfig, build_trainer
    from repro_torch.optim import adamw
    tc = TrainerConfig(arch="qwen2.5-14b", mode="brainslug", device="cpu",
                       ckpt_dir=four_ranks["ckpt_dir"], log_every=100,
                       batch_override=BATCH, seq_override=SEQ)
    trainer = build_trainer(tc, opt_cfg=adamw.AdamWConfig(lr=LR))
    try:
        assert trainer.start_step == 4
        cfg = trainer.cfg
        shape = jconfigs.base.ShapeConfig("t", SEQ, BATCH, "train")
        losses = []
        for i in range(4, 8):
            batch = {k: torch.from_numpy(v) for k, v in
                     data_mod.synth_batch(cfg, shape, i, 7).items()}
            trainer.params, trainer.opt_state, m = trainer.step_fn(
                trainer.params, trainer.opt_state, batch)
            losses.append(float(m["loss"]))
    finally:
        trainer.checkpointer.close()
    np.testing.assert_allclose(losses, four_ranks["qwen"]["losses"][4:],
                               rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# The sharded Trainer against the JAX GSPMD Trainer.
# ---------------------------------------------------------------------------

COMMON = dict(arch="deepseek-7b", reduced=True, batch_override=4,
              seq_override=32, lr=3e-3, log_every=100)

# The JAX GSPMD Trainer's own loop (``Trainer.run``) stops at its second
# step in this jax release: the step's outputs come back in GSPMD's chosen
# layouts, and its ``jit`` refuses them against its ``in_shardings``.  So
# this drives the Trainer's pipeline and ``step_fn`` as ``run`` does, and
# puts the state back on the ``in_shardings`` the Trainer built
# (``src/repro/launch/train.py``: repaired param specs, their optimizer
# specs) before each step.
_JAX_TRAINER = """
import json
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.data import pipeline as data_mod
from repro.distributed import sharding as shd
from repro.launch import mesh as mesh_mod, train as tr
from repro.models import lm
tc = tr.TrainerConfig(arch="deepseek-7b", steps=%d, mode="xla",
                      mesh_devices=2, batch_override=4, seq_override=32,
                      lr=3e-3, log_every=100)
t = tr.build_trainer(tc)
mesh = mesh_mod.make_test_mesh(2)
axes = lm.init(jax.random.PRNGKey(tc.seed), t.cfg)[1]
pspecs = shd.repair_specs(t.params, shd.param_specs(
    axes, shd.ShardingRules(), mesh), mesh)
shardings = jax.tree_util.tree_map(
    lambda s: NamedSharding(mesh, s),
    (pspecs, shd.opt_state_specs(pspecs, mesh)),
    is_leaf=lambda x: isinstance(x, P))
pipe = data_mod.Pipeline(t.cfg, t.shape, data_mod.DataConfig(seed=tc.seed),
                         batch_override=t.shape.global_batch)
out = []
for step, batch in pipe:
    if step >= tc.steps:
        break
    params, opt = jax.device_put((t.params, t.opt_state), shardings)
    t.params, t.opt_state, m = t.step_fn(
        params, opt, jax.tree_util.tree_map(jnp.asarray, batch))
    out.append((float(m["loss"]), float(m["grad_norm"])))
pipe.close()
print(json.dumps(out))
""" % STEPS


@functools.lru_cache(maxsize=None)
def _jax_trainer():
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": os.environ.get("XLA_FLAGS", "")
           + " --xla_force_host_platform_device_count=2"}
    proc = subprocess.run([sys.executable, "-c",
                           textwrap.dedent(_JAX_TRAINER)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return np.asarray(json.loads(proc.stdout.strip().splitlines()[-1]))


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("gspmd_ckpt"))
    common = dict(COMMON, mode="brainslug", device="cpu", mesh_devices=2)
    got = mesh_mod.spawn(mesh_checks.run_checks, 2, [(
        "t", "gspmd_train", dict(
            runs=[dict(steps=6), dict(steps=6, ckpt_dir=d, ckpt_every=2,
                                      fail_at=4)],
            np_params=_np_params("deepseek-7b"), common=common))],
        device="cpu", timeout=240)["t"]
    got["ckpt_dir"] = d
    return got


def test_gspmd_trainer_matches_the_jax_gspmd_trainer(trainer_runs):
    want = _jax_trainer()
    run = trainer_runs["runs"][0]
    assert "data=2 x model=1" in run["mesh"]
    losses = [h["loss"] for h in run["history"]]
    norms = [h["grad_norm"] for h in run["history"]]
    np.testing.assert_allclose(losses[:STEPS], want[:, 0], rtol=1e-4)
    np.testing.assert_allclose(norms[:STEPS], want[:, 1], rtol=1e-3)
    assert losses[-1] < losses[0]


def test_each_rank_holds_its_shards_only(trainer_runs):
    from repro_torch import configs as tconfigs
    from repro_torch.models import lm
    cfg = tconfigs.get_config("deepseek-7b").reduced()
    params = lm.init(0, cfg, device="cpu")
    mesh = MeshAxes(("data", "model"), (2, 1))
    specs = shd.repair_specs(params, shd.param_specs(
        lm.param_axes(cfg), shd.ShardingRules(), mesh), mesh)

    def local(x, spec):
        n = 1
        for entry in spec:
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                n *= mesh.extent(a)
        return x.numel() // n

    from repro_torch.launch.steps import zip_map
    want = sum(base.tree_leaves(zip_map(local, params, specs)))
    total = sum(x.numel() for x in base.tree_leaves(params))
    assert want < total
    for shard in trainer_runs["runs"][0]["shard"]:
        assert shard["param_numel"] == want
        # float32 moments, two of them, shaped as the shards
        assert shard["opt_bytes"] == 2 * 4 * want


def test_gspmd_trainer_kill_and_resume(trainer_runs):
    """Killed at step 4, resumed from its step-2 checkpoint (global
    tensors): steps 3-5 repeat the uninterrupted run's; a one-device
    ``Trainer`` restores the last checkpoint."""
    from repro_torch.launch.train import TrainerConfig, build_trainer
    full, run = trainer_runs["runs"]
    assert run["killed_at"] == 4
    assert [h["step"] for h in run["history"]] == [3, 4, 5]
    np.testing.assert_allclose([h["loss"] for h in run["history"]],
                               [h["loss"] for h in full["history"][3:]],
                               rtol=1e-6)
    one = build_trainer(TrainerConfig(**COMMON, mode="brainslug",
                                      device="cpu", steps=6,
                                      ckpt_dir=trainer_runs["ckpt_dir"]))
    try:
        assert one.start_step == 6 and one.mesh is None
    finally:
        one.checkpointer.close()
