"""The port's training driver (``repro_torch.launch.train``) on the CPU: the
twins of ``tests/test_train_driver.py::TestTrainLoop`` for the dense
family, the port's ``Trainer`` against the JAX ``Trainer`` from the same
initial parameters, checkpoints read across the two packages, and the
fault-tolerance hooks.

Reduced deepseek-7b, batch 2 x 32 tokens, lr 3e-3 (the JAX tests'
configuration); the port runs the kernels' plain versions, JAX its Pallas
kernels in interpret mode.  Losses agree within 1e-4 relative over six
steps (float32 sums in another order, carried through AdamW)."""
from __future__ import annotations

import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import checkpointer as jckpt
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.checkpoint import checkpointer as tckpt
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.launch.train import TrainerConfig, build_trainer, train
from repro_torch.layers import base as tbase
from repro_torch.optim import adamw as tadamw

# one intra-op thread: these small tensors gain nothing from more, and
# under pytest-xdist several workers' thread pools on the same cores
# made a 0.6 s test take minutes
torch.set_num_threads(1)

REL = 1e-4


def _tc(**kw):
    base = dict(arch="deepseek-7b", reduced=True, batch_override=2,
                seq_override=32, steps=12, lr=3e-3, device="cpu")
    base.update(kw)
    return TrainerConfig(**base)


class TestTrainLoop:
    def test_loss_decreases(self):
        history = train(_tc(steps=30))
        assert len(history) == 30
        first = np.mean([h["loss"] for h in history[:5]])
        last = np.mean([h["loss"] for h in history[-5:]])
        assert last < first, (first, last)
        assert all(np.isfinite(h["loss"]) for h in history)

    def test_kill_and_resume_is_deterministic(self, tmp_path):
        """A run killed mid-flight and resumed from its checkpoint lands on
        the same final loss as an uninterrupted run."""
        d_uninterrupted = str(tmp_path / "a")
        d_killed = str(tmp_path / "b")
        full = train(_tc(steps=16, ckpt_dir=d_uninterrupted, ckpt_every=8))
        hook = ft.failure_injector({11})
        with pytest.raises(ft.SimulatedFailure):
            train(_tc(steps=16, ckpt_dir=d_killed, ckpt_every=8),
                  failure_hook=hook)
        resumed = train(_tc(steps=16, ckpt_dir=d_killed, ckpt_every=8))
        # the resumed run starts at step 9 (after the step-8 checkpoint)
        assert resumed[0]["step"] == 9
        np.testing.assert_allclose(resumed[-1]["loss"], full[-1]["loss"],
                                   rtol=1e-5)

    def test_brainslug_mode_trains(self):
        history = train(_tc(steps=6, mode="brainslug"))
        assert all(np.isfinite(h["loss"]) for h in history)

    def test_multi_device_options_raise(self):
        """The GSPMD-sharded step (``mesh_devices`` without
        ``data_parallel``) and ``data_parallel`` need an initialised group
        (the trainers themselves: ``test_torch_sharded_train.py`` and
        ``test_torch_dp_train.py``); ``compress`` alone is a misuse."""
        with pytest.raises(RuntimeError, match="torchrun"):
            build_trainer(_tc(mesh_devices=2))
        with pytest.raises(ValueError, match="data_parallel"):
            build_trainer(_tc(compress=True))
        with pytest.raises(RuntimeError, match="torchrun"):
            build_trainer(_tc(data_parallel=True))


def _jax_params(seed=0):
    cfg = jconfigs.get_config("deepseek-7b").reduced()
    return jax.tree_util.tree_map(
        np.asarray, jlm.init(jax.random.PRNGKey(seed), cfg)[0])


@pytest.mark.parametrize("mode", ["xla", "brainslug"])
def test_trainer_matches_jax_trainer(mode):
    """Six steps of the port's ``Trainer`` and the JAX ``Trainer`` from the
    same initial parameters (the JAX ``lm.init``'s, carried over) on the
    same synthetic batches: losses within 1e-4 relative."""
    kw = dict(arch="deepseek-7b", reduced=True, batch_override=2,
              seq_override=32, steps=6, lr=3e-3, mode=mode, log_every=100)
    want = jtrain.train(jtrain.TrainerConfig(**kw))
    np_params = _jax_params(0)
    got = train(TrainerConfig(**kw, device="cpu"),
                init_params=lambda cfg, dev: convert.lm_params_from_numpy(
                    np_params, dev))
    assert [h["step"] for h in got] == [h["step"] for h in want]
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in want], rtol=REL)
    np.testing.assert_allclose([h["grad_norm"] for h in got],
                               [h["grad_norm"] for h in want], rtol=1e-3)


def _states(seed):
    """The same AdamW state after one update, in both packages."""
    np_params = _jax_params(seed)
    jstate = jadamw.init(np_params)
    grads = jax.tree_util.tree_map(lambda a: np.full_like(a, 0.25),
                                   np_params)
    jp, jstate, _ = jadamw.update(jadamw.AdamWConfig(), grads, jstate,
                                  np_params)
    jtree = jax.tree_util.tree_map(np.asarray, {"params": jp, "opt": jstate})
    ttree = {"params": convert.lm_params_from_numpy(jtree["params"], "cpu"),
             "opt": convert.opt_state_from_numpy(jtree["opt"], "cpu")}
    return jtree, ttree


def _like(tree):
    return tbase.tree_map(torch.zeros_like, tree)


def _assert_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_equal(got[k], want[k])
        return
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.dtype == np.asarray(want).dtype
    np.testing.assert_array_equal(got, np.asarray(want))


def test_checkpoints_cross_between_packages(tmp_path):
    """A float32 checkpoint written by the JAX checkpointer restores in the
    port, and one the port writes restores in the JAX package, leaf for
    leaf equal: one layout, one manifest."""
    jtree, ttree = _states(3)
    jckpt.save(str(tmp_path / "j"), 5, jtree, extra={"next_step": 6})
    got, extra = tckpt.restore(str(tmp_path / "j"), 5, _like(ttree))
    assert extra == {"next_step": 6}
    assert got["opt"]["count"].dtype == torch.int32
    _assert_equal(got, jtree)
    tckpt.save(str(tmp_path / "t"), 5, ttree, extra={"next_step": 6})
    assert sorted(os.listdir(tmp_path / "t" / "step_00000005")) == sorted(
        os.listdir(tmp_path / "j" / "step_00000005"))
    back, extra = jckpt.restore(str(tmp_path / "t"), 5, jtree)
    assert extra == {"next_step": 6}
    _assert_equal(back, jtree)


def test_bf16_leaves_round_trip_exactly(tmp_path):
    rng = np.random.default_rng(4)
    tree = {"w": torch.from_numpy(rng.standard_normal((5, 7)).astype(
        np.float32)).to(torch.bfloat16), "n": torch.tensor(3, dtype=torch.int32)}
    tckpt.save(str(tmp_path), 1, tree)
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        assert json.load(f)["leaves"]["w"]["dtype"] == "bfloat16"
    got, _ = tckpt.restore(str(tmp_path), 1, _like(tree))
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), tree["w"].view(torch.int16))
    assert int(got["n"]) == 3


def test_jax_bf16_checkpoint_restores_bit_for_bit(tmp_path):
    """A bf16 tree written by the JAX checkpointer (its ``np.save`` stores
    the leaves as ``|V2`` records) restores in the port with the same bits;
    float32 and int leaves beside it keep theirs.  A leaf whose bytes do not
    match the manifest's dtype still raises."""
    import ml_dtypes
    rng = np.random.default_rng(6)
    w = rng.standard_normal((5, 7)).astype(ml_dtypes.bfloat16)
    tree = {"w": w, "a": rng.standard_normal(3).astype(np.float32),
            "n": np.asarray(3, np.int32)}
    jckpt.save(str(tmp_path), 2, tree)
    disk = np.load(tmp_path / "step_00000002" / "w.npy")
    assert disk.dtype == np.dtype("V2")
    like = {"w": torch.zeros((5, 7), dtype=torch.bfloat16),
            "a": torch.zeros(3), "n": torch.tensor(0, dtype=torch.int32)}
    got, _ = tckpt.restore(str(tmp_path), 2, like)
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].view(torch.int16).numpy(),
                                  w.view(np.int16))
    np.testing.assert_array_equal(got["a"].numpy(), tree["a"])
    assert int(got["n"]) == 3
    np.save(tmp_path / "step_00000002" / "a.npy",
            np.zeros(3, np.float32).view(np.dtype("V4")))
    with pytest.raises(tckpt.CheckpointError, match="manifest"):
        tckpt.restore(str(tmp_path), 2, like)


def test_truncated_latest_falls_back(tmp_path):
    """A truncated leaf in the newest checkpoint (and a crash orphan) make
    ``restore_latest`` sweep the orphan and take the previous step."""
    _, ttree = _states(5)
    d = str(tmp_path)
    tckpt.save(d, 1, ttree, extra={"next_step": 2})
    ttree["opt"]["count"] += 1
    tckpt.save(d, 2, ttree, extra={"next_step": 3})
    leaf = tmp_path / "step_00000002" / "params__embed.npy"
    leaf.write_bytes(leaf.read_bytes()[:100])
    os.makedirs(tmp_path / "step_00000003.tmp")
    restored = tckpt.restore_latest(d, _like(ttree))
    assert restored is not None
    tree, extra, step = restored
    assert step == 1 and extra == {"next_step": 2}
    assert int(tree["opt"]["count"]) == int(ttree["opt"]["count"]) - 1
    assert not os.path.exists(tmp_path / "step_00000003.tmp")
    with pytest.raises(tckpt.CheckpointError, match="truncated"):
        tckpt.restore(d, 2, _like(ttree))
    assert tckpt.available_steps(d) == [1, 2]
    assert tckpt.latest_step(d) == 2


def test_async_checkpointer_snapshots_at_submit(tmp_path):
    """``submit`` copies the leaves on the caller's thread: an in-place
    update right after does not reach the checkpoint."""
    w = torch.ones(4)
    ck = tckpt.AsyncCheckpointer(str(tmp_path))
    ck.submit(1, {"w": w})
    w.add_(1.0)
    ck.close()
    got, _ = tckpt.restore(str(tmp_path), 1, {"w": torch.zeros(4)})
    assert float(got["w"].sum()) == 4.0


def test_watchdog_flags_a_slow_step(monkeypatch):
    clock = {"t": 0.0}
    monkeypatch.setattr(ft.time, "monotonic", lambda: clock["t"])
    wd = ft.StragglerWatchdog(warmup_steps=3)
    flags = []
    for dt in (1.0, 1.0, 1.0, 1.1, 5.0, 1.0):
        wd.start()
        clock["t"] += dt
        flags.append(wd.stop())
    assert flags == [False, False, False, False, True, False]
    assert wd.slow_steps == 1


def test_adamw_state_converts_from_jax():
    np_params = _jax_params(1)
    jstate = jax.tree_util.tree_map(np.asarray, jadamw.init(np_params))
    tstate = convert.opt_state_from_numpy(jstate, "cpu")
    assert tstate["count"].dtype == torch.int32 and int(tstate["count"]) == 0
    like = tadamw.init(convert.lm_params_from_numpy(np_params, "cpu"))
    assert tbase.tree_map(lambda a: tuple(a.shape), tstate) == \
        tbase.tree_map(lambda a: tuple(a.shape), like)
