"""Mesh serving through the port on gloo CPU ranks: the decode-cache
planner (``partition.plan_decode_cache``), its verifier family
(``verify.check_decode_plan``, ``dist.serve-*``) and ``Engine(mesh=...)``
against the JAX package.

* The plans equal JAX's on the same cache shapes (JAX's through
  ``jax.eval_shape``, the port's on the ``meta`` device): every case of
  ``tests/test_partition.py::TestDecodeCachePlan`` on qwen2.5-32b
  ``reduced()`` and mamba2's cache.
* The checker's findings equal JAX's on the lint's mutants.
* The engine: ``tests/test_serve_mesh.py``'s queue served under a mesh of
  2 ranks at (data 2, model 1) and (1, 2) and of 4 at (2, 2), through
  ``Server.engine(mesh=...)`` with the JAX weights: greedy tokens
  identical to the JAX single-device engine (run here) and to the port's
  single-device engine (run in each rank), the last-position logits of
  every tick held to the latter (bit for bit under the slot split, within
  1e-5 of max|logit| under the head split), each rank's share of the
  cache, and the plan's splits and notes.  mamba2 ``reduced()`` splits its
  slots.  A planted defect, the head split without the all-reduce after
  ``wo``, fails the parity.

Two launches: two ranks (every two-rank case in one), then four."""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jget_config
from repro.core import partition as jpartition
from repro.core import verify as jverify
from repro.launch.engine import Request as JRequest
from repro.launch.serve import ServeConfig as JServeConfig
from repro.launch.serve import Server as JServer
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.core import partition, verify
from repro_torch.examples import mesh_checks
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import lm

#: The JAX suite's mesh skeleton and its serving setup.
AXES = partition.MeshAxes(("data", "model"), (4, 2))
JAXES = jpartition.MeshAxes(("data", "model"), (4, 2))
SC = dict(batch=8, prompt_len=12, new_tokens=6, max_len=20)
CHUNK, BLOCK = 4, 4
TP_REL = 1e-5


# ---------------------------------------------------------------------------
# The planner and the checker against JAX's.
# ---------------------------------------------------------------------------

def _shapes(arch="qwen2.5-32b", slots=8, **kw):
    jcfg = jget_config(arch).reduced()
    want = jax.eval_shape(lambda: jlm.init_decode_cache(
        jcfg, slots, 64, dtype=jnp.float32, **kw))
    got = lm.init_decode_cache(get_config(arch).reduced(), slots, 64,
                               dtype=torch.float32, device="meta", **kw)
    return jcfg, want, got


def _plan_key(plan):
    return (plan.partition, plan.slots, plan.use_data, plan.use_model,
            plan.notes, tuple(
                (lf.path, lf.kind, tuple(lf.shape), tuple(lf.spec),
                 lf.slot_dim, lf.model_dim) for lf in plan.leaves))


PAGED = dict(kv_layout="paged", kv_num_blocks=16, kv_block_size=4)
#: name: (arch, slots, cache kwargs, partition, head extents or "config")
PLAN_CASES = {
    "dense_auto": ("qwen2.5-32b", 8, {}, "auto", "config"),
    "paged_auto": ("qwen2.5-32b", 8, PAGED, "auto", "config"),
    "six_slots": ("qwen2.5-32b", 6, {}, "auto", "config"),
    "heads_3": ("qwen2.5-32b", 8, {}, "auto", (3,)),
    "data": ("qwen2.5-32b", 8, {}, "data", "config"),
    "tensor": ("qwen2.5-32b", 8, {}, "tensor", "config"),
    "none": ("qwen2.5-32b", 8, {}, "none", "config"),
    "both_paged": ("qwen2.5-32b", 8, PAGED, "both", "config"),
    "mamba2": ("mamba2-2.7b", 8, {}, "auto", ()),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_matches_jax(case):
    arch, slots, kw, part, heads = PLAN_CASES[case]
    jcfg, want_shapes, got_shapes = _shapes(arch, slots, **kw)
    if heads == "config":
        heads = (jcfg.n_heads, jcfg.n_kv_heads)
    want = jpartition.plan_decode_cache(want_shapes, part, JAXES,
                                        slots=slots, head_extents=heads)
    got = partition.plan_decode_cache(got_shapes, part, AXES, slots=slots,
                                      head_extents=heads)
    assert _plan_key(got) == _plan_key(want)
    assert got.active == want.active
    assert verify.check_decode_plan(got) == []
    # the spec tree mirrors the cache, a declared dataclass per node
    tree = got.spec_tree(got_shapes)["blocks"]["sub0"]
    jtree = want.spec_tree(want_shapes)["blocks"]["sub0"]
    assert type(tree).__name__ == type(jtree).__name__
    for f in type(tree).CACHE_AXES:
        assert tuple(getattr(tree, f)) == tuple(getattr(jtree, f))
    for rank, slot_dim in ((1, 0), (2, 0), (1, None)):
        assert tuple(got.operand_spec(rank, slot_dim=slot_dim)) == tuple(
            want.operand_spec(rank, slot_dim=slot_dim))


def test_unknown_partition_raises_as_in_jax():
    _, want_shapes, got_shapes = _shapes()
    with pytest.raises(ValueError, match="unknown serve partition") as e:
        partition.plan_decode_cache(got_shapes, "bogus", AXES, slots=8)
    with pytest.raises(ValueError) as j:
        jpartition.plan_decode_cache(want_shapes, "bogus", JAXES, slots=8)
    assert str(e.value) == str(j.value)


def _mutants(plan, P):
    def mutate(field, **changes):
        leaves = tuple(dataclasses.replace(lf, **changes)
                       if lf.path.rsplit("/", 1)[-1] == field else lf
                       for lf in plan.leaves)
        return dataclasses.replace(plan, leaves=leaves)

    rank = len(next(lf for lf in plan.leaves
                    if lf.path.endswith("/k")).shape)
    return {
        "pool-write": mutate("k", kind="pool"),
        "spec-rank": mutate("k", spec=P(*([None] * (rank + 1)))),
        "mesh-axis": mutate("k", spec=P("pod")),
        "slot-axis": mutate("length", spec=P(None)),
        "length-over-rank": mutate("length",
                                   spec=P(*["data"] + [None] * 8)),
    }


@pytest.mark.parametrize("mutant", ["pool-write", "spec-rank", "mesh-axis",
                                    "slot-axis", "length-over-rank"])
def test_checker_findings_match_jax(mutant):
    jcfg, want_shapes, got_shapes = _shapes()
    heads = (jcfg.n_heads, jcfg.n_kv_heads)
    want = jverify.check_decode_plan(_mutants(jpartition.plan_decode_cache(
        want_shapes, "auto", JAXES, slots=8, head_extents=heads), JP)[mutant])
    got = verify.check_decode_plan(_mutants(partition.plan_decode_cache(
        got_shapes, "auto", AXES, slots=8, head_extents=heads),
        partition.PartitionSpec)[mutant])
    key = lambda fs: sorted((f.invariant, f.severity, f.subject) for f in fs)
    assert got and key(got) == key(want)
    with pytest.raises(verify.VerifyError):
        verify.enforce(got, "strict", subject="serve mutant")


# ---------------------------------------------------------------------------
# The engine under a mesh of gloo ranks.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax():
    """The JAX servers' weights (numpy), the queue, and the JAX
    single-device engine's greedy tokens per engine layout."""
    out = {}
    for arch in ("qwen2.5-32b", "mamba2-2.7b"):
        server = JServer(JServeConfig(arch=arch, **SC))
        queue = mesh_checks.serve_queue(server.cfg.vocab_size)
        reqs = [JRequest(**r) for r in queue]
        layouts = ({"dense8": dict(slots=8), "dense3": dict(slots=3),
                    "paged8": dict(slots=8, kv_layout="paged",
                                   kv_block_size=BLOCK)}
                   if arch == "qwen2.5-32b" else {"dense8": dict(slots=8)})
        out[arch] = {
            "np_params": jax.tree_util.tree_map(np.asarray, server.params),
            "queue": queue,
            "tokens": {k: [c.tokens.tolist() for c in server.engine(
                prefill_chunk=CHUNK, **kw).run(reqs)]
                for k, kw in layouts.items()}}
    return out


def _case(label, qwen, **kw):
    """A ``mesh_checks.run_checks`` entry: ``serve_engine`` on the queue
    with the JAX weights, brainslug (the kernels' plain versions here)."""
    return (label, "serve_engine", dict(
        device="cpu", requests=qwen["queue"], np_params=qwen["np_params"],
        mode="brainslug", max_len=SC["max_len"], prefill_chunk=CHUNK,
        kv_block_size=BLOCK, **kw))


def _strip(d):
    return {k: v for k, v in d.items() if k != "tokens"}


@functools.lru_cache(maxsize=None)
def _two():
    """Every two-rank case in one launch (the rank processes import
    ``mesh_checks``, not this module, so they start without JAX)."""
    qwen, mamba = (_strip(_jax()[a]) for a in ("qwen2.5-32b", "mamba2-2.7b"))
    checks = [
        _case("data", qwen, model_parallel=1),
        _case("tensor", qwen, model_parallel=2),
        _case("paged", qwen, model_parallel=2, kv_layout="paged"),
        _case("slots3", qwen, model_parallel=1, slots=3),
        _case("stream", qwen, model_parallel=1, stream=True),
        _case("planted", qwen, model_parallel=2, planted="no_wo_reduce"),
        _case("mamba", mamba, arch="mamba2-2.7b", model_parallel=1),
        # a request whose deadline has passed when it is first popped:
        # every rank reads rank 0's clock, so every rank times it out
        _case("deadline", dict(qwen, queue=qwen["queue"] + [dict(
            request_id=10, prompt=[1, 2, 3], max_new_tokens=2,
            deadline_ms=-1.0)]), model_parallel=1)]
    return mesh_mod.spawn(mesh_checks.run_checks, 2, checks, device="cpu",
                          timeout=300)


@functools.lru_cache(maxsize=None)
def _four():
    qwen = _strip(_jax()["qwen2.5-32b"])
    checks = [_case("both", qwen, model_parallel=2),
              _case("paged", qwen, model_parallel=2, kv_layout="paged"),
              _case("slots3", qwen, model_parallel=2, slots=3)]
    return mesh_mod.spawn(mesh_checks.run_checks, 4, checks, device="cpu",
                          timeout=300)


def _kv_bytes(slots, kv_heads, layers=4, s=SC["max_len"], hd=32):
    """Bytes of a dense float32 cache's k and v, and of its lengths."""
    return 2 * layers * slots * kv_heads * s * hd * 4, layers * slots * 4


def _assert_parity(got, want_tokens, *, axes, data, model, bitwise):
    """Tokens equal to the JAX and the port's single-device engines, the
    plan's splits, and every rank's ticks, kernels and share."""
    assert got["statuses"] == ["ok"] * len(want_tokens)
    assert got["tokens"] == want_tokens == got["ref_tokens"]
    rep = got["report"]
    assert rep["mesh_axes"] == axes
    assert (rep["serve_partition"]["data"],
            rep["serve_partition"]["model"]) == (data, model), rep
    d = axes["data"] if data else 1
    m = axes["model"] if model else 1
    for r in got["ranks"]:
        assert r["tokens_equal"]
        assert {k: r["report"][k] for k in ("mesh_axes", "serve_partition",
                                            "decode_path")} == {
            k: rep[k] for k in ("mesh_axes", "serve_partition",
                                "decode_path")}
        g = r["gaps"]
        assert g["flips"] == [] and g["compared"] == g["ticks"] > 0, g
        assert g["bitwise"] if bitwise else g["rel"] <= TP_REL, g
        if rep["decode_path"] != "ssm-recurrent":
            # the decode kernels' plain versions on the CPU
            assert rep["decode_path"].startswith("plain-"), rep
        calls = r["collectives"]["calls"]
        assert calls.get("all_reduce", 0) > 0 if m > 1 else \
            "all_reduce" not in calls
        assert calls.get("all_gather_into_tensor", 0) > 0 if d > 1 else \
            "all_gather_into_tensor" not in calls


def _assert_dense_share(r, slots, d, m):
    kv, lengths = _kv_bytes(slots, 2)
    assert r["ref_cache_bytes"] == kv + lengths
    # k and v split over data x model; the lengths only over data
    assert r["cache_bytes"] == kv // (d * m) + lengths // d
    assert r["local_slots"] == slots // d
    assert r["local_heads"] == (4 // m, 2 // m)


def test_data_split_matches_jax_and_one_device_bit_for_bit():
    got = _two()["data"]
    _assert_parity(got, _jax()["qwen2.5-32b"]["tokens"]["dense8"],
                   axes={"data": 2, "model": 1}, data=True, model=False,
                   bitwise=True)
    for r in got["ranks"]:
        _assert_dense_share(r, 8, 2, 1)


def test_head_split_matches_jax_and_one_device():
    got = _two()["tensor"]
    _assert_parity(got, _jax()["qwen2.5-32b"]["tokens"]["dense8"],
                   axes={"data": 1, "model": 2}, data=False, model=True,
                   bitwise=False)
    for r in got["ranks"]:
        _assert_dense_share(r, 8, 1, 2)
        # one all-reduce of (8, 1, 128) float32 a layer a model
        # evaluation, after wo: the MLP computes whole, with none
        calls = r["collectives"]["calls"]["all_reduce"]
        assert calls == 4 * r["evaluations"] > 0
        assert r["collectives"]["bytes"]["all_reduce"] == calls * 8 * 128 * 4


def test_paged_pool_fences_data_and_splits_heads():
    got = _two()["paged"]
    _assert_parity(got, _jax()["qwen2.5-32b"]["tokens"]["paged8"],
                   axes={"data": 1, "model": 2}, data=False, model=True,
                   bitwise=False)
    notes = got["report"]["serve_partition"]["notes"]
    assert notes == []             # (1, 2): no data split to fence
    four = _four()["paged"]
    _assert_parity(four, _jax()["qwen2.5-32b"]["tokens"]["paged8"],
                   axes={"data": 2, "model": 2}, data=False, model=True,
                   bitwise=False)
    assert any("pool" in n for n in four["report"]["serve_partition"]
               ["notes"])


def test_indivisible_slots_degrade_with_a_note():
    for got, axes, model in ((_two()["slots3"], {"data": 2, "model": 1},
                              False),
                             (_four()["slots3"], {"data": 2, "model": 2},
                              True)):
        _assert_parity(got, _jax()["qwen2.5-32b"]["tokens"]["dense3"],
                       axes=axes, data=False, model=model,
                       bitwise=not model)
        assert any("not divisible" in n for n in got["report"]
                   ["serve_partition"]["notes"])


def test_streaming_through_the_mesh_engine():
    """``Request.on_token`` and ``Engine.stream`` under the slot split:
    every request's events are its tokens, then its completion."""
    got = _two()["stream"]
    assert got["stream_ok"]
    _assert_parity(got, _jax()["qwen2.5-32b"]["tokens"]["dense8"],
                   axes={"data": 2, "model": 1}, data=True, model=False,
                   bitwise=True)


def test_both_axes_at_four_ranks():
    got = _four()["both"]
    _assert_parity(got, _jax()["qwen2.5-32b"]["tokens"]["dense8"],
                   axes={"data": 2, "model": 2}, data=True, model=True,
                   bitwise=False)
    for r in got["ranks"]:
        _assert_dense_share(r, 8, 2, 2)


def test_mamba_slots_split():
    """The recurrent state splits with its slots.  On the CPU the mixer's
    products over 4 slots and over 8 round apart by float32 ulps, so the
    logits are held at the head split's bar, not bit for bit."""
    got = _two()["mamba"]
    _assert_parity(got, _jax()["mamba2-2.7b"]["tokens"]["dense8"],
                   axes={"data": 2, "model": 1}, data=True, model=False,
                   bitwise=False)
    assert got["report"]["decode_path"] == "ssm-recurrent"


def test_planted_missing_wo_all_reduce_fails_the_parity():
    """Each model rank keeps its half of the out-projection: the logits
    leave the single-device engine's at the first tick, and the tokens
    with them."""
    got = _two()["planted"]
    assert got["tokens"] != got["ref_tokens"]
    for r in got["ranks"]:
        assert not r["tokens_equal"]
        assert r["gaps"]["rel"] > 1e-2 and r["gaps"]["flips"]
        assert "all_reduce" not in r["collectives"]["calls"]


def test_a_passed_deadline_times_out_on_every_rank():
    got = _two()["deadline"]
    want = _jax()["qwen2.5-32b"]["tokens"]["dense8"]
    assert got["statuses"] == ["ok"] * len(want) + ["timeout"]
    assert got["tokens"] == want + [[]] == got["ref_tokens"]
    assert all(r["tokens_equal"] for r in got["ranks"])


def test_tp_shard_params_slices_attention_only():
    """Each model rank's slice: q/k/v projections and biases by columns,
    ``wo`` by rows; every other leaf is the whole tensor itself.  The
    ranks' slices put back together are the whole parameters."""
    cfg = get_config("qwen2.5-32b").reduced()
    params = lm.init(0, cfg, device="cpu")
    parts = [lm.tp_shard_params(params, 2, i) for i in range(2)]
    attn = params["blocks"]["sub0"]["attn"]
    for name in ("wq", "wk", "wv", "bq", "bk", "bv", "wo"):
        dim = -2 if name == "wo" else -1
        got = [p["blocks"]["sub0"]["attn"][name] for p in parts]
        assert got[0].shape[dim] * 2 == attn[name].shape[dim]
        assert torch.equal(torch.cat(got, dim), attn[name])
    for p in parts:
        assert p["blocks"]["sub0"]["mlp"]["wu"] is \
            params["blocks"]["sub0"]["mlp"]["wu"]
        assert p["embed"] is params["embed"]
    local = lm.tp_local_config(cfg, 2)
    assert parts[0]["blocks"]["sub0"]["attn"]["wq"].shape[-1] == \
        local.n_heads * local.head_dim
    with pytest.raises(ValueError, match="model rank"):
        lm.tp_shard_params(params, 2, 2)
