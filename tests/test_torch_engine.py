"""The port's continuous-batching engine (``repro_torch.launch.engine``)
against the JAX package's, on the CPU.

The same weights (the JAX ``Server``'s, carried across by
``convert.lm_params_from_numpy``) serve the same queues at
``deepseek-7b`` ``reduced()`` (float32) in ``xla`` and ``brainslug`` mode,
dense and paged: greedy tokens, statuses, admission order, the order of
the streamed ``TokenEvent``s and the deterministic ``ServeStats`` fields
are identical.  The queues carry shared prefixes, an oversubscribed block
pool, a copy-on-write divergence, an invalid request, a request that times
out in the queue and mixed priorities.  Sampling (temperature > 0) draws
from ``torch.Generator``s, so it is held only to its own reproducibility."""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.launch import engine as jengine
from repro.launch import serve as jserve
from repro_torch import convert
from repro_torch.kernels.attention import ops as tattn_ops
from repro_torch.launch import engine as tengine
from repro_torch.launch import serve as tserve

MODES = ("xla", "brainslug")
# max_len 24 / block size 4: 6 blocks per worst-case request
SC = dict(arch="deepseek-7b", batch=4, prompt_len=14, new_tokens=6,
          max_len=24)
#: the ServeStats fields that do not depend on the clock
DETERMINISTIC = ("step_dispatches", "prefill_tokens", "generated_tokens",
                 "decode_slot_steps", "idle_slot_steps", "admitted",
                 "completed", "failed", "timed_out", "prefix_hit_tokens",
                 "cow_forks", "blocks_in_use", "kv_block_utilization")


def _shared_prefix_queue(vocab, n=12, prefix_len=8, max_new=4, seed=0):
    """``test_paged_kv.py``'s queue: every third prompt a bare tail, the
    rest a common 8-token prefix and a 0-3-token tail."""
    rng = np.random.default_rng(seed)
    common = rng.integers(1, vocab, prefix_len).tolist()
    out = []
    for i in range(n):
        tail = rng.integers(1, vocab, int(rng.integers(0, 4))).tolist()
        out.append(dict(request_id=i, prompt=(common + tail) if i % 3
                        else tail, max_new_tokens=max_new))
    return out


def _mixed_queue(vocab):
    """Priorities, an invalid request (prompt + new tokens past max_len),
    one whose deadline has passed when it is first popped, a zero-token
    request, an empty prompt and a repeated prompt (a prefix hit whose
    first write lands in a shared block: a copy-on-write fork)."""
    rng = np.random.default_rng(3)
    rep = rng.integers(1, vocab, 8).tolist()
    return [
        dict(request_id=0, prompt=rep, max_new_tokens=3, priority=0),
        dict(request_id=1, prompt=rng.integers(1, vocab, 5).tolist(),
             max_new_tokens=5, priority=2),
        dict(request_id=2, prompt=np.zeros(20, np.int32).tolist(),
             max_new_tokens=10),                               # invalid
        dict(request_id=3, prompt=rng.integers(1, vocab, 3).tolist(),
             max_new_tokens=2, deadline_ms=-1.0),              # timeout
        dict(request_id=4, prompt=rep, max_new_tokens=4, priority=1),
        dict(request_id=5, prompt=rng.integers(1, vocab, 6).tolist(),
             max_new_tokens=0, priority=3),
        dict(request_id=6, prompt=[], max_new_tokens=3),
        dict(request_id=7, prompt=rep, max_new_tokens=2, priority=1),
    ]


#: name: (queue builder, engine kwargs)
QUEUES = {
    "shared_prefix_dense": (_shared_prefix_queue, dict(prefill_chunk=4)),
    "shared_prefix_paged_oversubscribed": (_shared_prefix_queue, dict(
        prefill_chunk=4, kv_layout="paged", kv_block_size=4,
        kv_num_blocks=12, verify_mode="strict")),
    "mixed_dense": (_mixed_queue, dict(slots=2, prefill_chunk=3)),
    "mixed_paged": (_mixed_queue, dict(slots=2, prefill_chunk=3,
                                       kv_layout="paged", kv_block_size=4,
                                       verify_mode="strict")),
}


@pytest.fixture(scope="module")
def servers():
    out, params = {}, None
    for mode in MODES:
        js = jserve.Server(jserve.ServeConfig(mode=mode, **SC))
        if params is None:
            params = convert.lm_params_from_numpy(
                jax.tree_util.tree_map(np.asarray, js.params), "cpu")
        ts = tserve.Server(tserve.ServeConfig(mode=mode, torch_device="cpu",
                                              **SC), params=params)
        out[mode] = (js, ts)
    return out


def _serve(server, request_cls, queue, kw):
    """Run one engine over ``queue``; returns (engine, completions,
    events as (request_id, token, index, done, status))."""
    eng = server.engine(**kw)
    events = []
    comps = eng.run([request_cls(**r) for r in queue],
                    on_token=lambda ev: events.append((
                        ev.request_id, ev.token, ev.index, ev.done,
                        ev.completion.status if ev.done else None)))
    return eng, comps, events


@pytest.mark.parametrize("queue", sorted(QUEUES))
@pytest.mark.parametrize("mode", MODES)
def test_engine_matches_jax_engine(servers, mode, queue):
    js, ts = servers[mode]
    build, kw = QUEUES[queue]
    reqs = build(ts.cfg.vocab_size)
    je, jc, jev = _serve(js, jengine.Request, reqs, kw)
    before = tattn_ops.STATS.snapshot()
    te, tc, tev = _serve(ts, tengine.Request, reqs, kw)
    attn = tattn_ops.STATS.delta(before)
    for a, b in zip(jc, tc):
        assert (b.request_id, b.status, b.prompt_len) == (
            a.request_id, a.status, a.prompt_len)
        np.testing.assert_array_equal(b.tokens, a.tokens)
        if a.status == "invalid":
            assert b.reason == a.reason
    assert te.last_admission_order == je.last_admission_order
    assert tev == jev
    for f in DETERMINISTIC:
        assert getattr(te.last_stats, f) == getattr(je.last_stats, f), f
    assert te.last_dispatch == je.last_dispatch
    paged = kw.get("kv_layout") == "paged"
    key = ("paged_" if paged else "") + (
        "decode_plain" if mode == "brainslug" else "decode_ref")
    # every lane of every model evaluation is a slot-unit of work, so the
    # evaluations are (prefill + decode + idle) / slots; each runs every
    # layer's decode attention once
    st = te.last_stats
    evals, rem = divmod(st.prefill_tokens + st.decode_slot_steps
                        + st.idle_slot_steps, st.n_slots)
    assert rem == 0 and evals > 0
    assert attn[key] == evals * ts.cfg.n_layers
    assert sum(attn.values()) == attn[key]
    if paged:
        alloc = te.last_allocator
        assert alloc.n_free == alloc.num_blocks
        assert all(r == 0 for r in alloc.refcount) and alloc.stored == 0
    if queue.startswith("mixed"):
        assert [c.status for c in tc] == ["ok", "ok", "invalid", "timeout",
                                          "ok", "ok", "ok", "ok"]
        if paged:
            assert te.last_stats.cow_forks >= 1
            assert te.last_stats.prefix_hit_tokens > 0
    if queue == "shared_prefix_paged_oversubscribed":
        assert te.last_stats.blocks_in_use <= 12
        footprint = sum(len(r["prompt"]) + r["max_new_tokens"]
                        for r in reqs)
        assert footprint > SC["batch"] * SC["max_len"]


def test_paged_tokens_equal_dense_tokens(servers):
    """The paged layout is greedy-token identical to the dense one on a
    shared-prefix queue, prefills fewer tokens, and returns every block."""
    _, ts = servers["brainslug"]
    reqs = [tengine.Request(**r) for r in _shared_prefix_queue(
        ts.cfg.vocab_size, n=9, seed=5)]
    e_d = ts.engine(prefill_chunk=4)
    out_d = e_d.run(reqs)
    e_p = ts.engine(prefill_chunk=4, kv_layout="paged", kv_block_size=4,
                    verify_mode="strict")
    out_p = e_p.run(reqs)
    for a, b in zip(out_d, out_p):
        assert a.status == b.status == "ok"
        np.testing.assert_array_equal(a.tokens, b.tokens)
    sp, sd = e_p.last_stats, e_d.last_stats
    assert sp.prefix_hit_tokens > 0
    assert sp.prefill_tokens + sp.prefix_hit_tokens == sd.prefill_tokens
    alloc = e_p.last_allocator
    assert alloc.n_free == alloc.num_blocks and alloc.stored == 0


def test_sampled_stream_is_the_same_alone_and_in_a_queue(servers):
    """A temperature request draws the same tokens alone and in a mixed
    queue (another slot, other traffic), for one run seed; another seed
    draws another stream."""
    _, ts = servers["xla"]
    rng = np.random.default_rng(21)
    vocab = ts.cfg.vocab_size
    hot = tengine.Request(request_id=42, prompt=rng.integers(
        1, vocab, 5).tolist(), max_new_tokens=6, temperature=0.8)
    others = [tengine.Request(request_id=i, prompt=rng.integers(
        1, vocab, int(rng.integers(2, 9))).tolist(), max_new_tokens=4)
        for i in range(3)]
    for layout in ("dense", "paged"):
        alone = ts.engine(slots=2, kv_layout=layout).run([hot], key=7)
        mixed = ts.engine(slots=2, kv_layout=layout).run(
            [others[0], others[1], hot, others[2]], key=7)
        np.testing.assert_array_equal(alone[0].tokens, mixed[2].tokens)
    other = ts.engine(slots=2).run([hot], key=8)
    assert not np.array_equal(other[0].tokens, alone[0].tokens)
    eng = ts.engine(slots=2)
    first, second = eng.run([hot]), eng.run([hot])
    assert not np.array_equal(first[0].tokens, second[0].tokens)


def test_report_and_the_parts_left_to_later_slices(servers):
    _, ts = servers["brainslug"]
    eng = ts.engine(slots=2, kv_layout="paged", kv_block_size=4)
    eng.run([tengine.Request(request_id=0, prompt=[3, 4, 5],
                             max_new_tokens=2)])
    rep = eng.report()
    assert rep["decode_path"] == "plain-paged-decode"
    assert rep["mesh_axes"] == {} and rep["serve_partition"] == {}
    assert rep["attn_dispatch"]["paged_decode_plain"] > 0
    _, tx = servers["xla"]
    eng = tx.engine(slots=2)
    eng.run([tengine.Request(request_id=0, prompt=[3], max_new_tokens=2)])
    assert eng.report()["decode_path"] == "ref-decode"
    assert "brainslug" in eng.report()["decode_fallback"]
    # Engine(mesh=...) on a mesh of one rank, (data 1, model 1): no split
    # engages, and tokens, plan and report are the JAX mesh engine's on a
    # one-device mesh (tests/test_torch_serve_mesh.py holds the splits)
    from jax.sharding import Mesh as JMesh

    from repro_torch.launch import mesh as tmesh
    js, tx = servers["xla"]
    jmesh = JMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                  ("data", "model"))
    one = tmesh.Mesh(axis_names=("data", "model"), shape=(1, 1),
                     device=torch.device("cpu"), backend="gloo",
                     reason="one rank", groups={},
                     coords={"data": 0, "model": 0})
    reqs = _shared_prefix_queue(tx.cfg.vocab_size, n=5, seed=2)
    je = js.engine(slots=2, prefill_chunk=3, mesh=jmesh)
    te = tx.engine(slots=2, prefill_chunk=3, mesh=one)
    for a, b in zip(je.run([jengine.Request(**r) for r in reqs]),
                    te.run([tengine.Request(**r) for r in reqs])):
        np.testing.assert_array_equal(b.tokens, a.tokens)
    jrep, trep = je.report(), te.report()
    assert trep["mesh_axes"] == jrep["mesh_axes"] == {"data": 1, "model": 1}
    assert trep["serve_partition"] == jrep["serve_partition"] == {
        "partition": "both", "data": False, "model": False, "notes": []}
    assert te.local_slots == 2 and te.local_cfg == tx.cfg


def test_engine_validation_matches_jax(servers):
    js, ts = servers["xla"]
    for kw in (dict(kv_layout="paged", kv_block_size=4, kv_num_blocks=2),
               dict(slots=0), dict(prefill_chunk=0),
               dict(verify_mode="loud")):
        with pytest.raises(ValueError) as want:
            js.engine(**kw)
        with pytest.raises(ValueError) as got:
            ts.engine(**kw)
        assert str(got.value) == str(want.value)


def test_stream_yields_commit_order(servers):
    js, ts = servers["xla"]
    reqs = _shared_prefix_queue(ts.cfg.vocab_size, n=5, seed=9)
    want = [(ev.request_id, ev.token, ev.index, ev.done) for ev in
            js.engine(slots=2).stream([jengine.Request(**r) for r in reqs])]
    eng = ts.engine(slots=2)
    got = [(ev.request_id, ev.token, ev.index, ev.done) for ev in
           eng.stream([tengine.Request(**r) for r in reqs])]
    assert got == want
    assert eng.last_stats.completed == 5
    assert eng.last_stats.ttft_p50_ms > 0.0


def test_serve_batch_example_runs_on_the_cpu(capsys):
    from repro_torch.examples import serve_batch
    assert serve_batch.main(["--device", "cpu", "--reduced", "--requests",
                             "3", "--new-tokens", "4", "--prompt-len",
                             "6"]) == 0
    text = capsys.readouterr().out
    assert "[engine] 3 requests" in text
    assert "plain-paged-decode" in text
    assert serve_batch.main(["--device", "cpu", "--reduced", "--static",
                             "--new-tokens", "3", "--prompt-len", "4"]) == 0
    assert "[static]" in capsys.readouterr().out


def test_engine_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.Server(tserve.ServeConfig(**SC)).engine()
    assert dataclasses.fields(tengine.Request) and tengine.STATS.counts
