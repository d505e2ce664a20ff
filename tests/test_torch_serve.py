"""The port's static serving driver (``repro_torch.launch.serve``) against
the JAX package's, on the CPU.

The same weights (the JAX ``Server``'s, carried across) serve the same
prompts with ragged stop lengths at ``deepseek-7b`` ``reduced()``: greedy
tokens, ``ServeStats`` (all but the wall time) and the per-run dispatch
counts are identical in every mode, and so are the validation errors."""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro_torch import convert
from repro_torch.kernels.attention import ops as tattn_ops
from repro_torch.kernels.rmsnorm import ops as trms_ops
from repro_torch.kernels.swiglu import ops as tsw_ops
from repro_torch.launch import serve as tserve

MODES = ("brainslug", "xla", "barrier")
SC = dict(arch="deepseek-7b", batch=4, prompt_len=6, new_tokens=8,
          max_len=16)
STOPS = np.array([8, 3, 0, 5])


def _stats(s):
    d = dataclasses.asdict(s)
    d.pop("wall_s")
    return d


@pytest.fixture(scope="module")
def served():
    """Per mode: the JAX server, its greedy generations, stats and
    dispatches, and the port's server over the same weights."""
    prompts = np.random.default_rng(2).integers(0, 512, (4, 6)).astype(
        np.int32)
    out = {}
    params = None
    for mode in MODES:
        js = jserve.Server(jserve.ServeConfig(mode=mode, **SC))
        gen = js.generate(prompts, stop_lengths=STOPS)
        if params is None:
            params = convert.lm_params_from_numpy(
                jax.tree_util.tree_map(np.asarray, js.params), "cpu")
        ts = tserve.Server(tserve.ServeConfig(mode=mode, torch_device="cpu",
                                              **SC), params=params)
        out[mode] = dict(js=js, gen=gen, stats=_stats(js.last_stats),
                         dispatch=dict(js.last_dispatch), ts=ts)
    return prompts, out


@pytest.mark.parametrize("mode", MODES)
def test_generate_matches_jax_server(served, mode):
    prompts, out = served
    m = out[mode]
    ts = m["ts"]
    before = (tattn_ops.STATS.snapshot(), trms_ops.STATS.snapshot(),
              tsw_ops.STATS.snapshot())
    gen = ts.generate(prompts, stop_lengths=STOPS)
    np.testing.assert_array_equal(gen, m["gen"])
    assert _stats(ts.last_stats) == m["stats"]
    assert ts.last_dispatch == m["dispatch"]
    # prompt positions and the decode steps after the first sampled token
    steps = SC["prompt_len"] + int(STOPS.max()) - 1
    layers = ts.cfg.n_layers
    attn = tattn_ops.STATS.delta(before[0])
    if mode == "brainslug":
        assert attn == {"decode_kernel": 0, "decode_plain": steps * layers,
                        "decode_ref": 0, "paged_decode_kernel": 0,
                        "paged_decode_plain": 0, "paged_decode_ref": 0}
        assert trms_ops.STATS.delta(before[1])["plain"] == steps * (
            2 * layers + 1)
        assert tsw_ops.STATS.delta(before[2])["plain"] == steps * layers
    else:
        assert attn["decode_ref"] == steps * layers


def test_generate_twice_reports_each_call(served):
    prompts, out = served
    ts = out["xla"]["ts"]
    first = ts.generate(prompts, stop_lengths=STOPS)
    np.testing.assert_array_equal(ts.generate(prompts, stop_lengths=STOPS),
                                  first)
    assert ts.last_dispatch == out["xla"]["dispatch"]


def test_all_stops_zero_dispatches_nothing(served):
    prompts, out = served
    ts, js = out["xla"]["ts"], out["xla"]["js"]
    zero = np.zeros(4, np.int64)
    np.testing.assert_array_equal(ts.generate(prompts, stop_lengths=zero),
                                  js.generate(prompts, stop_lengths=zero))
    assert ts.last_dispatch == js.last_dispatch == {
        "prefill": 0, "decode": 0, "decode_slot_steps": 0,
        "generated_tokens": 0}
    assert _stats(ts.last_stats) == _stats(js.last_stats)


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_validation_errors_match_jax(served):
    prompts, out = served
    ts, js = out["xla"]["ts"], out["xla"]["js"]
    for bad in (prompts[:, :5], prompts[:3], prompts[0]):
        assert _error(lambda: ts.generate(bad)) == _error(
            lambda: js.generate(bad))
    assert _error(lambda: ts.generate(prompts, stop_lengths=STOPS[:3])) == \
        _error(lambda: js.generate(prompts, stop_lengths=STOPS[:3]))
    long = np.zeros((4, 17), np.int32)
    assert _error(lambda: ts.prefill(long)) == _error(
        lambda: js.prefill(long))
    small = dict(SC, max_len=10)
    tsm = tserve.Server(tserve.ServeConfig(mode="xla", torch_device="cpu",
                                           **small), params=ts.params)
    jsm = jserve.Server(jserve.ServeConfig(mode="xla", **small))
    assert _error(lambda: tsm.generate(prompts)) == _error(
        lambda: jsm.generate(prompts))


def test_engine_and_default_device(served):
    """``Server.engine()`` serves the static driver's prompts to the same
    greedy tokens as ``generate``; the entry points run on the card unless
    asked for the CPU."""
    prompts, out = served
    from repro_torch.launch.engine import Request
    ts = out["xla"]["ts"]
    eng = ts.engine()
    comps = eng.run([Request(request_id=i, prompt=prompts[i],
                             max_new_tokens=int(STOPS[i]))
                     for i in range(len(prompts))])
    gen = ts.generate(prompts, stop_lengths=STOPS)
    for i, c in enumerate(comps):
        assert c.status == "ok"
        np.testing.assert_array_equal(c.tokens, gen[i, :STOPS[i]])
    assert eng.slots == SC["batch"] and eng.max_len == SC["max_len"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.Server(tserve.ServeConfig(**SC))


def test_main_serves_on_the_cpu(capsys):
    assert tserve.main(["--arch", "deepseek-7b", "--reduced", "--device",
                        "cpu", "--mode", "brainslug", "--batch", "2",
                        "--prompt-len", "3", "--new-tokens", "2"]) == 0
    text = capsys.readouterr().out
    assert "2 requests x 2 tokens" in text and "first generation" in text
