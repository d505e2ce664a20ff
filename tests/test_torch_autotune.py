"""The port's autotuner (``repro_torch.core.autotune``) against the JAX
package's ``tests/test_autotune.py``, case for case, on the CPU.

The never-slower guardrail (measured variant selection hard-floored at the
baseline), the crash-safe decision cache (warm hits skip every measurement
run; corrupt, truncated or stale entries are quarantined and silently
re-measured), the report surface, and a decision keyed on the torch
version and the device.  "Matches the reference" holds the autotuned port
net against the JAX function itself (the plain path the JAX package's
un-tuned net computes) on the same seeded numpy inputs, float32 within
1e-5; the kernel case within 2e-4, as the JAX test states."""
from __future__ import annotations

import glob
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import autotune, codegen
from repro_torch.core import api as core_api
from repro_torch.models import cnn as tcnn

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _clear_caches():
    codegen.clear_cache()
    autotune.clear_memory_cache()
    autotune.STATS.reset()
    yield
    codegen.clear_cache()
    autotune.clear_memory_cache()
    autotune.STATS.reset()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _norm_chain_fn(x, w):
    h = x @ w
    h = h + x
    y = h * torch.rsqrt(torch.mean(torch.square(h), dim=-1, keepdim=True)
                        + 1e-6)
    return torch.tanh(y) * y


def _jax_norm_chain_fn(x, w):
    h = x @ w
    h = h + x
    y = h * jax.lax.rsqrt(jnp.mean(jnp.square(h), axis=-1, keepdims=True)
                          + 1e-6)
    return jnp.tanh(y) * y


def _np_args(rng, rows=8):
    x = rng.standard_normal((rows, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 16)) * 0.25).astype(np.float32)
    return x, w


def _args(rng, rows=8):
    return tuple(torch.from_numpy(a) for a in _np_args(rng, rows))


def _cfg(tmp_path, **kw):
    kw.setdefault("mode", "brainslug")
    kw.setdefault("autotune", True)
    kw.setdefault("autotune_cache_dir", str(tmp_path / "atcache"))
    kw.setdefault("torch_device", "cpu")
    return api.OptimizeConfig(**kw)


def _jax_ref(args):
    return np.asarray(_jax_norm_chain_fn(*(jnp.asarray(a.numpy())
                                           for a in args)))


# ---------------------------------------------------------------------------
# decisions, parity, and the report surface
# ---------------------------------------------------------------------------

class TestDecisions:
    def test_autotuned_net_matches_reference(self, rng, tmp_path):
        args = _args(rng)
        net = api.optimize(_norm_chain_fn, *args, config=_cfg(tmp_path))
        np.testing.assert_allclose(net(*args).numpy(), _jax_ref(args),
                                   **TOL)

    def test_report_surfaces_decisions(self, rng, tmp_path):
        args = _args(rng)
        net = api.optimize(_norm_chain_fn, *args, config=_cfg(tmp_path))
        rep = net.report()
        assert rep.autotune                      # decisions are visible
        kinds = {a.kind for a in rep.autotune}
        assert "stack" in kinds and "function" in kinds
        for a in rep.autotune:
            assert a.source == "measured"
            assert a.chosen in {v for v, _, _ in a.measured_ms} \
                or a.failures
            assert a.baseline in ("barrier", "ref", "raw")
        stack = next(a for a in rep.autotune if a.kind == "stack")
        assert {v for v, _, _ in stack.measured_ms} >= {"barrier", "xla",
                                                         "brainslug"}
        # the committed variant text shows up in explain()
        text = net.explain()
        assert "autotune" in text and f"-> {stack.chosen}" in text

    def test_variant_never_slower_than_baseline(self, rng, tmp_path):
        """The hard floor: whatever was committed measured no slower than
        the baseline in every phase (modulo the declared slack)."""
        args = _args(rng)
        net = api.optimize(_norm_chain_fn, *args, config=_cfg(tmp_path))
        for a in net.report().autotune:
            times = {}
            for variant, phase, ms in a.measured_ms:
                times.setdefault(variant, {})[phase] = ms
            if a.chosen not in times or a.baseline not in times:
                continue
            for phase, base_ms in times[a.baseline].items():
                assert times[a.chosen][phase] \
                    <= base_ms * autotune.FLOOR_SLACK

    def test_autotune_off_is_static_dispatch(self, rng, tmp_path):
        """The escape hatch: autotune=False (default) must not measure,
        not touch the cache dir, and keep the static planner's choices."""
        args = _args(rng)
        before = autotune.STATS.snapshot()
        net = api.optimize(_norm_chain_fn, *args,
                           config=_cfg(tmp_path, autotune=False))
        delta = autotune.STATS.delta(before)
        assert all(v == 0 for v in delta.values())
        assert net.autotune_decisions == {}
        assert net.report().autotune == ()
        assert not os.path.exists(str(tmp_path / "atcache"))

    def test_kernel_dispatch_is_tuned(self, rng, tmp_path):
        """A registry-matched kernel (rmsnorm before matmul) gets a
        measured hopper-vs-ref decision; the committed backend is what
        the dispatch record reports."""
        x = rng.standard_normal((6, 16)).astype(np.float32)
        g = (1.0 + 0.1 * rng.standard_normal(16)).astype(np.float32)
        w = (rng.standard_normal((16, 16)) * 0.25).astype(np.float32)

        def fn(x, g, w):
            var = torch.mean(torch.square(x), dim=-1, keepdim=True)
            y = x * torch.rsqrt(var + 1e-6) * g
            return y @ w

        def jfn(x, g, w):
            var = jnp.mean(jnp.square(x), axis=-1, keepdims=True)
            return (x * jax.lax.rsqrt(var + 1e-6) * g) @ w

        args = tuple(torch.from_numpy(a) for a in (x, g, w))
        net = api.optimize(fn, *args, config=_cfg(tmp_path))
        kernel_decisions = [a for a in net.report().autotune
                            if a.kind == "kernel"]
        assert len(kernel_decisions) == 1
        (d,) = kernel_decisions
        assert d.requested == "hopper" and d.baseline == "ref"
        (dispatch,) = net.kernel_dispatches.values()
        assert dispatch.backend.value == d.chosen
        if d.chosen == "ref":                    # measured fallback
            assert "autotune" in dispatch.reason
        np.testing.assert_allclose(net(*args).numpy(),
                                   np.asarray(jfn(x, g, w)),
                                   rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# warm cache: zero measurement runs
# ---------------------------------------------------------------------------

class TestWarmCache:
    def test_second_optimize_skips_all_measurement(self, rng, tmp_path):
        args = _args(rng)
        cfg = _cfg(tmp_path)
        api.optimize(_norm_chain_fn, *args, config=cfg)

        autotune.clear_memory_cache()            # force the disk path
        before = autotune.STATS.snapshot()
        net2 = api.optimize(_norm_chain_fn, *args, config=cfg)
        delta = autotune.STATS.delta(before)
        assert delta["measure_runs"] == 0
        assert delta["cache_miss"] == 0
        assert delta["cache_hit_disk"] == len(net2.autotune_decisions)
        assert all(d.source == "cache-disk"
                   for d in net2.autotune_decisions.values())

        before = autotune.STATS.snapshot()       # third run: memory memo
        net3 = api.optimize(_norm_chain_fn, *args, config=cfg)
        delta = autotune.STATS.delta(before)
        assert delta["measure_runs"] == 0
        assert delta["cache_hit_mem"] == len(net3.autotune_decisions)

    def test_new_shapes_measure_fresh(self, rng, tmp_path):
        args = _args(rng)
        cfg = _cfg(tmp_path)
        api.optimize(_norm_chain_fn, *args, config=cfg)
        before = autotune.STATS.snapshot()
        x2 = torch.from_numpy(rng.standard_normal((16, 16))
                              .astype(np.float32))
        api.optimize(_norm_chain_fn, x2, args[1], config=cfg)
        delta = autotune.STATS.delta(before)
        assert delta["cache_miss"] > 0
        assert delta["measure_runs"] > 0

    def test_decision_keyed_on_torch_version_and_device(self, rng, tmp_path,
                                                        monkeypatch):
        """An entry measured under another torch is quarantined and
        re-measured; another card's name is another key (a miss that
        leaves this card's entries alone)."""
        args = _args(rng)
        cfg = _cfg(tmp_path)
        api.optimize(_norm_chain_fn, *args, config=cfg)
        n_files = len(_cache_files(tmp_path))
        blob = json.load(open(_cache_files(tmp_path)[0]))
        assert set(blob["versions"]) == {"torch", "triton", "cuda",
                                         "repro_torch"}
        assert blob["versions"]["torch"] == torch.__version__
        assert '"torch_device":"cpu"' in blob["key"]

        autotune.clear_memory_cache()
        monkeypatch.setattr(autotune, "device_key",
                            lambda device: "cuda:Another Card")
        before = autotune.STATS.snapshot()
        api.optimize(_norm_chain_fn, *args, config=cfg)
        delta = autotune.STATS.delta(before)
        assert delta["cache_hit_disk"] == 0
        assert delta["cache_miss"] == n_files
        assert delta["cache_quarantined"] == 0
        assert len(_cache_files(tmp_path)) == 2 * n_files
        monkeypatch.undo()

        autotune.clear_memory_cache()
        real = autotune._versions
        monkeypatch.setattr(autotune, "_versions",
                            lambda: {**real(), "torch": "0.0.0-other"})
        before = autotune.STATS.snapshot()
        api.optimize(_norm_chain_fn, *args, config=cfg)
        delta = autotune.STATS.delta(before)
        assert delta["cache_quarantined"] == n_files
        assert delta["cache_hit_disk"] == 0 and delta["measure_runs"] > 0


# ---------------------------------------------------------------------------
# cache robustness: corruption never raises
# ---------------------------------------------------------------------------

def _cache_files(tmp_path):
    return sorted(glob.glob(str(tmp_path / "atcache" / "*.json")))


class TestCacheRobustness:
    def _seed_cache(self, rng, tmp_path):
        args = _args(rng)
        cfg = _cfg(tmp_path)
        api.optimize(_norm_chain_fn, *args, config=cfg)
        files = _cache_files(tmp_path)
        assert files
        return args, cfg, files

    def _assert_recovers(self, args, cfg, n_bad):
        autotune.clear_memory_cache()
        before = autotune.STATS.snapshot()
        net = api.optimize(_norm_chain_fn, *args, config=cfg)
        delta = autotune.STATS.delta(before)
        assert delta["cache_quarantined"] == n_bad
        assert delta["measure_runs"] > 0              # re-measured
        rep = net.report()
        assert any("quarantined" in e
                   for a in rep.autotune for e in a.events)
        np.testing.assert_allclose(net(*args).numpy(), _jax_ref(args),
                                   **TOL)
        return net

    def test_corrupt_json_quarantined(self, rng, tmp_path):
        args, cfg, files = self._seed_cache(rng, tmp_path)
        for p in files:
            with open(p, "w") as fh:
                fh.write('{"schema": 1, "trunc')
        self._assert_recovers(args, cfg, len(files))
        assert glob.glob(str(tmp_path / "atcache" / "*.quarantined"))

    def test_truncated_entry_fails_checksum(self, rng, tmp_path):
        args, cfg, files = self._seed_cache(rng, tmp_path)
        blob = json.load(open(files[0]))
        blob["payload"]["measured_ms"] = blob["payload"][
            "measured_ms"][:1]                   # valid JSON, bad checksum
        json.dump(blob, open(files[0], "w"))
        self._assert_recovers(args, cfg, 1)

    def test_stale_schema_quarantined(self, rng, tmp_path):
        args, cfg, files = self._seed_cache(rng, tmp_path)
        blob = json.load(open(files[0]))
        blob["schema"] = autotune.SCHEMA_VERSION + 1
        json.dump(blob, open(files[0], "w"))
        self._assert_recovers(args, cfg, 1)

    def test_stale_version_quarantined(self, rng, tmp_path):
        args, cfg, files = self._seed_cache(rng, tmp_path)
        blob = json.load(open(files[0]))
        blob["versions"]["repro_torch"] = "0.0.0-ancient"
        json.dump(blob, open(files[0], "w"))
        self._assert_recovers(args, cfg, 1)

    def test_tampered_decision_payload_quarantined(self, rng, tmp_path):
        """A mis-dispatch attempt: rewriting the committed variant inside
        the payload breaks the checksum, so the poisoned entry can never
        steer dispatch."""
        args, cfg, files = self._seed_cache(rng, tmp_path)
        blob = json.load(open(files[0]))
        blob["payload"]["variant"] = "definitely-not-a-variant"
        json.dump(blob, open(files[0], "w"))
        self._assert_recovers(args, cfg, 1)

    def test_unwritable_cache_dir_never_raises(self, rng, tmp_path):
        args = _args(rng)
        bad = tmp_path / "file-not-dir"
        bad.write_text("i am a file, not a directory")
        cfg = _cfg(tmp_path, autotune_cache_dir=str(bad))
        net = api.optimize(_norm_chain_fn, *args, config=cfg)
        assert net.autotune_decisions
        np.testing.assert_allclose(net(*args).numpy(), _jax_ref(args),
                                   **TOL)


# ---------------------------------------------------------------------------
# measurement harness + pick_callable (benchmark-facing floor)
# ---------------------------------------------------------------------------

class TestHarness:
    def test_measure_ms_failure_is_reported_not_raised(self):
        def boom(x):
            raise RuntimeError("lowering exploded")
        ms, why = autotune.measure_ms(boom, (torch.zeros(4),))
        assert ms is None
        assert "lowering exploded" in why

    def test_samples_span_back_to_back_calls(self):
        """A call far under MIN_SAMPLE_MS is timed over back-to-back calls
        (MAX_CALLS_A_SAMPLE of them), each counted as a measure run."""
        calls = {"n": 0}

        def tiny(x):
            calls["n"] += 1
            return x

        before = autotune.STATS.snapshot()
        ms, why = autotune.measure_ms(tiny, (torch.zeros(4),), repeats=3,
                                      warmup=1)
        assert why is None and ms < autotune.MIN_SAMPLE_MS
        assert calls["n"] == 1 + 3 * autotune.MAX_CALLS_A_SAMPLE
        assert autotune.STATS.delta(before)["measure_runs"] == calls["n"]

    def test_must_run_errors_propagate(self, tmp_path):
        """A candidate named in ``must_run`` (a hand-written kernel on the
        card) raises out of the tuner, whether its build or its call
        fails; it is never recorded and floored to the plain version."""
        def base(x):
            return x + 1.0

        def boom(x):
            raise RuntimeError("kernel launch failed")

        with pytest.raises(RuntimeError, match="kernel launch failed"):
            autotune.pick_callable(
                "must-run-call", {"plain": base, "kernel": boom},
                (torch.zeros(4),), baseline="plain", requested="kernel",
                cache_dir=str(tmp_path), must_run={"kernel"})
        tuner = autotune.Autotuner(cache_dir=str(tmp_path))

        def broken_build():
            raise RuntimeError("nvcc failed")

        with pytest.raises(RuntimeError, match="nvcc failed"):
            tuner.decide({"k": "must-run-build"}, kind="stack", name="s",
                         requested="brainslug", baseline="barrier",
                         builders={"barrier": lambda: [
                                       ("fwd", base, (torch.zeros(4),))],
                                   "brainslug": broken_build},
                         must_run={"brainslug"})
        # not named: recorded and dropped, as before
        decision, _ = autotune.pick_callable(
            "must-run-off", {"plain": base, "kernel": boom},
            (torch.zeros(4),), baseline="plain", requested="kernel",
            cache_dir=str(tmp_path))
        assert decision.variant == "plain"
        assert any("kernel launch failed" in why
                   for _, why in decision.failures)

    def test_must_run_candidate_still_times_out(self, tmp_path):
        def slow(x):
            time.sleep(0.05)
            return x + 1.0

        decision, _ = autotune.pick_callable(
            "must-run-timeout", {"plain": lambda x: x + 1.0, "kernel": slow},
            (torch.zeros(4),), baseline="plain", requested="kernel",
            cache_dir=str(tmp_path), timeout_ms=5.0, must_run={"kernel"})
        assert decision.variant == "plain"
        assert any("timeout" in why for _, why in decision.failures)

    def test_hand_written_candidates_only_on_the_card(self):
        modes = {"barrier": "barrier", "xla": "xla",
                 "brainslug": "brainslug", "brainslug@rows128": "brainslug",
                 "hopper": "hopper", "ref": "ref"}
        assert autotune.hand_written(modes, torch.device("cuda", 0)) == {
            "brainslug", "brainslug@rows128", "hopper"}
        assert autotune.hand_written(modes, "cpu") == frozenset()

    def test_timeout_disqualifies_candidate(self, tmp_path):
        def slow(x):
            time.sleep(0.05)
            return x + 1.0

        def fast(x):
            return x + 1.0

        decision, chosen = autotune.pick_callable(
            "timeout-test", {"fast": fast, "slow": slow},
            (torch.zeros(4),), baseline="fast", requested="slow",
            cache_dir=str(tmp_path), timeout_ms=5.0)
        assert decision.variant == "fast"
        assert decision.guardrail_tripped
        assert any("timeout" in why for _, why in decision.failures)

    def test_pick_callable_floors_slow_requested(self, tmp_path):
        calls = {"n": 0}

        def slow(x):
            time.sleep(0.01)
            return x * 2.0

        def fast(x):
            calls["n"] += 1
            return x * 2.0

        decision, chosen = autotune.pick_callable(
            "floor-test", {"base": fast, "fused": slow},
            (torch.zeros(8),), baseline="base", requested="fused",
            cache_dir=str(tmp_path))
        assert decision.variant == "base"
        assert decision.guardrail_tripped
        assert chosen is fast

    def test_pick_callable_warm_cache(self, tmp_path):
        def a(x):
            return x + 1.0

        def b(x):
            return x + 1.0

        args = (torch.zeros(8),)
        autotune.pick_callable("warm", {"a": a, "b": b}, args,
                               baseline="a", cache_dir=str(tmp_path))
        autotune.clear_memory_cache()
        before = autotune.STATS.snapshot()
        decision, _ = autotune.pick_callable(
            "warm", {"a": a, "b": b}, args, baseline="a",
            cache_dir=str(tmp_path))
        delta = autotune.STATS.delta(before)
        assert delta["measure_runs"] == 0
        assert decision.source == "cache-disk"

    def test_config_validates_autotune_fields(self):
        with pytest.raises(ValueError, match="autotune_repeats"):
            api.OptimizeConfig(autotune_repeats=0)
        with pytest.raises(ValueError, match="autotune_warmup"):
            api.OptimizeConfig(autotune_warmup=-1)
        with pytest.raises(ValueError, match="autotune"):
            api.OptimizeConfig(autotune=1)


# ---------------------------------------------------------------------------
# optimize_graph: the CNN path, forward and training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("differentiable", [False, True])
def test_optimize_graph_autotuned_block_net(tmp_path, differentiable):
    """``optimize_graph`` of the bn block network with ``autotune=True``
    commits one decision a stack, every candidate measured (none failed),
    and the chosen net agrees with the plain interpreter (``barrier``)
    within 1e-5; with ``differentiable=True`` the candidates are timed on
    their gradients too."""
    graph, params = tcnn.block_net(2, 4, generator=torch.Generator()
                                   .manual_seed(0), device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 16, 16, 4)).astype(np.float32))
    cfg = _cfg(tmp_path, differentiable=differentiable)
    net = core_api.optimize_graph(graph, tuple(x.shape), cfg)
    plain = core_api.optimize_graph(graph, tuple(x.shape), api.OptimizeConfig(
        mode="barrier", torch_device="cpu"))
    rep = net.report()
    assert len(rep.autotune) == net.n_stacks > 0
    assert autotune.STATS.counts["candidate_failures"] == 0
    phases = {p for a in rep.autotune for _, p, _ in a.measured_ms}
    assert phases == ({"fwd", "grad"} if differentiable else {"fwd"})
    np.testing.assert_allclose(net(x, params).numpy(),
                               plain(x, params).numpy(), **TOL)
