"""Measured autotuning with a crash-safe decision cache — the never-slower
guardrail, ported from ``repro/core/autotune.py``.

The planner's static cost model picks a schedule per segment; this module
checks that choice against the clock.  At ``optimize()`` compile time each
tunable segment enumerates candidate execution variants — the hand-written
kernels (``brainslug``), the compiled plain path (``xla``) and ``barrier``
for stacks (plus tile-size and sequence-split variants from the collapse
plan), ``hopper`` against ``ref`` for registry kernels — and times every
candidate on the traced shapes (warmup + median of ``repeats``).  The
winner is committed, and every decision is **hard-floored at the
baseline**: a candidate is eligible only when it measures no slower than
the barrier / ref / raw baseline in every measured phase, so a losing
variant degrades gracefully instead of shipping a regression.

Decisions persist in an on-disk cache so long-lived servers and repeat jobs
skip the search entirely:

* location — ``OptimizeConfig.autotune_cache_dir``, else
  ``$REPRO_TORCH_AUTOTUNE_CACHE``, else ``~/.cache/repro_torch/autotune/``
  (never the JAX package's cache);
* key — sha256 over the canonical JSON of (kind, structural signature,
  shapes, dtypes / itemsize, requested mode, device type and name); the
  torch, Triton, CUDA and ``repro_torch`` versions ride inside the entry
  and are verified on load;
* write — the checkpointer's atomic tmp-then-rename idiom (fsync before
  rename), so a killed process never leaves a half-written entry;
* defense in depth — schema version + per-entry checksum; corrupt,
  truncated or version-stale entries are quarantined (renamed to
  ``*.quarantined``) and silently re-measured.  A bad cache file never
  crashes or mis-dispatches ``optimize()``.

Candidates that fail to build or exceed the per-candidate timeout are
recorded as failures with reasons, not fatal errors; the baseline is exempt
from the timeout (the floor must always exist).  The one exception is a
hand-written kernel on the card (``brainslug`` stacks, ``hopper`` kernels,
the rewritten function): there an error is a fault, not a slow candidate,
and it propagates (``must_run``); only the timeout, or losing the measured
floor, drops such a candidate.  All counters live in
:data:`STATS` (snapshot / delta protocol), so tests can assert "a warm
cache performs zero measurement runs".
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.metadata
import json
import math
import os
import time
from typing import Any, Callable, Collection, Mapping

import numpy as np
import torch
import torch.utils._pytree as pytree

from repro_torch.core import codegen
from repro_torch.core import collapse as collapse_mod
from repro_torch.core import ir
from repro_torch.core import registry as registry_mod
from repro_torch.kernels.fused_stack.ops import DispatchStats

#: On-disk entry format version; a bump invalidates (quarantines) every
#: older entry on first contact.
SCHEMA_VERSION = 1

#: A non-baseline candidate must measure within this factor of the baseline
#: in every phase to stay eligible — small enough that the committed choice
#: cannot ship a visible regression, large enough to absorb timer noise.
FLOOR_SLACK = 1.02

#: Each timed sample spans back-to-back calls worth at least this many
#: milliseconds (at most :data:`MAX_CALLS_A_SAMPLE` calls), so a phase
#: under a millisecond is not read from one call's worth of host jitter.
MIN_SAMPLE_MS = 1.0
MAX_CALLS_A_SAMPLE = 64

STATS = DispatchStats(keys=(
    "measure_runs",        # timed candidate invocations (warmup + repeats)
    "decisions",           # decide() calls that ran the measurement path
    "cache_hit_mem",       # served from the in-process memo
    "cache_hit_disk",      # served from the on-disk cache
    "cache_miss",          # no usable cached entry: measured
    "cache_quarantined",   # corrupt/truncated/stale entries set aside
    "guardrail_trips",     # requested variant lost to the floor
    "candidate_failures",  # candidates that failed to build/measure
))

#: In-process decision memo (key hash -> Decision).  Sits in front of the
#: disk cache; cleared by :func:`clear_memory_cache` (benchmark scripts).
_MEM_CACHE: dict[str, "Decision"] = {}


def clear_memory_cache() -> None:
    _MEM_CACHE.clear()


def default_cache_dir() -> str:
    env = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "autotune")


def _canonical(obj: Any) -> str:
    """Deterministic JSON for hashing/checksums (``default=str`` absorbs
    dtypes and anything else JSON does not know)."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      default=str)


def _key_hash(key_obj: Any) -> str:
    return hashlib.sha256(_canonical(key_obj).encode()).hexdigest()[:32]


def _versions() -> dict[str, str]:
    """The versions an entry was measured under (Triton's read from its
    package metadata, never imported here)."""
    import repro_torch
    try:
        triton = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton = "none"
    return {"torch": torch.__version__, "triton": triton,
            "cuda": str(torch.version.cuda),
            "repro_torch": getattr(repro_torch, "__version__", "0")}


def device_key(device: torch.device | str) -> str:
    """The measured device in a cache key: its type, and the card's name
    on CUDA (in place of the JAX package's ``jax.default_backend()``)."""
    device = torch.device(device)
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return device.type


# ---------------------------------------------------------------------------
# Decision record.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Decision:
    """One committed autotune decision (what ``report()`` surfaces)."""

    kind: str                 # 'stack' | 'kernel' | 'function' | 'callable'
    name: str                 # segment / kernel / function label
    requested: str            # the statically configured variant
    baseline: str             # the never-slower floor variant
    variant: str              # what was committed
    measured_ms: tuple = ()   # ((variant, phase, ms), ...)
    failures: tuple = ()      # ((variant, reason), ...)
    guardrail_tripped: bool = False   # requested variant was not committed
    source: str = "measured"  # 'measured' | 'cache-mem' | 'cache-disk'
    events: tuple = ()        # cache/measurement notes for report()
    autotune_ms: float = 0.0  # wall time this decision cost (0 on warm hit)

    def to_payload(self) -> dict:
        return {
            "kind": self.kind, "name": self.name,
            "requested": self.requested, "baseline": self.baseline,
            "variant": self.variant,
            "measured_ms": [list(m) for m in self.measured_ms],
            "failures": [list(f) for f in self.failures],
            "guardrail_tripped": bool(self.guardrail_tripped),
        }

    @classmethod
    def from_payload(cls, payload: Any) -> "Decision":
        if not isinstance(payload, dict):
            raise ValueError("payload is not a mapping")
        for k in ("kind", "name", "requested", "baseline", "variant"):
            if not isinstance(payload.get(k), str):
                raise ValueError(f"payload field {k!r} missing or not str")
        measured = tuple(
            (str(v), str(p), float(ms))
            for v, p, ms in payload.get("measured_ms", ()))
        failures = tuple((str(v), str(r))
                         for v, r in payload.get("failures", ()))
        return cls(kind=payload["kind"], name=payload["name"],
                   requested=payload["requested"],
                   baseline=payload["baseline"],
                   variant=payload["variant"], measured_ms=measured,
                   failures=failures,
                   guardrail_tripped=bool(
                       payload.get("guardrail_tripped", False)))

    def ms_for(self, variant: str) -> float | None:
        """Summed measured phases for one variant (None if unmeasured)."""
        vals = [ms for v, _, ms in self.measured_ms if v == variant]
        return float(sum(vals)) if vals else None


# ---------------------------------------------------------------------------
# Disk cache: atomic writes, checksum + schema + version validation,
# quarantine on any defect.  No method ever raises.
# ---------------------------------------------------------------------------

class DecisionCache:
    """Crash-safe decision store.  ``load``/``store`` swallow every IO and
    format defect: the worst outcome of a bad cache is a re-measurement."""

    def __init__(self, cache_dir: str | None = None) -> None:
        self.dir = cache_dir or default_cache_dir()

    def _path(self, key_hash: str) -> str:
        return os.path.join(self.dir, key_hash + ".json")

    def _quarantine(self, path: str, reason: str,
                    events: list[str]) -> None:
        STATS.record("cache_quarantined")
        events.append(f"cache: quarantined {os.path.basename(path)} "
                      f"({reason})")
        try:
            os.replace(path, path + ".quarantined")
        except OSError:
            try:
                os.remove(path)
            except OSError:
                pass

    def load(self, key_obj: Any
             ) -> tuple["Decision | None", tuple[str, ...]]:
        """Returns (decision, events).  Any defect quarantines the entry
        and returns ``(None, events)`` — never raises."""
        events: list[str] = []
        path = self._path(_key_hash(key_obj))
        try:
            if not os.path.exists(path):
                return None, ()
            with open(path, "r", encoding="utf-8") as fh:
                blob = json.load(fh)
        except (OSError, ValueError, UnicodeDecodeError):
            self._quarantine(path, "unreadable or corrupt JSON", events)
            return None, tuple(events)
        try:
            if not isinstance(blob, dict):
                raise ValueError("entry is not a mapping")
            if blob.get("schema") != SCHEMA_VERSION:
                raise ValueError(
                    f"stale schema {blob.get('schema')!r} "
                    f"(want {SCHEMA_VERSION})")
            if blob.get("key") != _canonical(key_obj):
                raise ValueError("key mismatch (hash collision or tamper)")
            payload = blob.get("payload")
            checksum = hashlib.sha256(
                _canonical(payload).encode()).hexdigest()
            if blob.get("checksum") != checksum:
                raise ValueError("checksum mismatch (truncated entry)")
            if blob.get("versions") != _versions():
                raise ValueError(
                    f"stale versions {blob.get('versions')!r}")
            decision = Decision.from_payload(payload)
        except (ValueError, TypeError, KeyError) as e:
            self._quarantine(path, str(e), events)
            return None, tuple(events)
        return decision, tuple(events)

    def store(self, key_obj: Any, decision: "Decision") -> None:
        """Atomic tmp-then-rename write (the checkpointer idiom); failures
        are swallowed — a read-only cache dir only costs re-measurement."""
        path = self._path(_key_hash(key_obj))
        blob = {
            "schema": SCHEMA_VERSION,
            "key": _canonical(key_obj),
            "versions": _versions(),
            "payload": decision.to_payload(),
        }
        blob["checksum"] = hashlib.sha256(
            _canonical(blob["payload"]).encode()).hexdigest()
        tmp = path + f".tmp.{os.getpid()}"
        try:
            os.makedirs(self.dir, exist_ok=True)
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(blob, fh)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass


# ---------------------------------------------------------------------------
# Measurement harness.
# ---------------------------------------------------------------------------

def _on_cuda(args: Any) -> bool:
    return any(isinstance(t, torch.Tensor) and t.is_cuda
               for t in pytree.tree_leaves(args))


def measure_ms(fn: Callable, args: tuple, *, repeats: int = 3,
               warmup: int = 1, timeout_ms: float | None = None,
               reraise: bool = False
               ) -> tuple[float | None, str | None]:
    """Time ``fn(*args)``: warmup calls, then the median of ``repeats``
    samples, in milliseconds a call.

    The first call is timed on the host clock between two synchronisations
    of the card and checked against ``timeout_ms``: a candidate whose first
    call misses the budget is disqualified rather than allowed to stall
    compile time.  Builders of the stack and kernel candidates compile
    before they hand their phases over (see :func:`tune_stack`), so the
    budget holds steady-state calls.  Each sample then times back-to-back
    calls, as many as make :data:`MIN_SAMPLE_MS` at the first call's pace
    (at most :data:`MAX_CALLS_A_SAMPLE`): on the card between two CUDA
    events, so a sample reads the stream's time, host gaps between the
    launches included; on the CPU with ``perf_counter``.  There is no
    ``jit`` here: callers pass what they want timed, compiled or not.

    Returns ``(ms, None)`` or ``(None, reason)``.  An error in ``fn`` is
    a reason too, unless ``reraise``: then it propagates."""
    try:
        cuda = _on_cuda(args)
        sync = torch.cuda.synchronize if cuda else (lambda: None)
        sync()
        t0 = time.perf_counter()
        fn(*args)
        sync()
        first_ms = (time.perf_counter() - t0) * 1e3
        STATS.record("measure_runs")
        if timeout_ms is not None and first_ms > timeout_ms:
            return None, (f"timeout: first call took {first_ms:.1f}ms "
                          f"(> {timeout_ms:.0f}ms budget)")
        for _ in range(max(0, warmup - 1)):
            fn(*args)
            STATS.record("measure_runs")
        calls = min(MAX_CALLS_A_SAMPLE,
                    max(1, math.ceil(MIN_SAMPLE_MS / max(first_ms, 1e-3))))
        sync()
        times = []
        for _ in range(max(1, repeats)):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(calls):
                    fn(*args)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / calls)
            else:
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn(*args)
                times.append((time.perf_counter() - t0) * 1e3 / calls)
            STATS.record("measure_runs", calls)
        return float(np.median(times)), None
    except Exception as e:                     # build/shape/OOM failure
        if reraise:
            raise
        return None, f"{type(e).__name__}: {e}"


def _torch_dtype(dtype: Any) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype).rsplit(".", 1)[-1])


def synth_array(shape: tuple[int, ...], dtype: Any = torch.float32,
                seed: int = 0, device: torch.device | str = "cpu"
                ) -> torch.Tensor:
    """Deterministic measurement operand of the traced shape / dtype, from
    a seeded numpy generator."""
    dt = _torch_dtype(dtype)
    if not dt.is_floating_point:
        return torch.zeros(shape, dtype=dt, device=device)
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(device, dt)


# ---------------------------------------------------------------------------
# The tuner.
# ---------------------------------------------------------------------------

class Autotuner:
    """Measure-then-commit variant selection with memo + disk cache."""

    def __init__(self, *, cache_dir: str | None = None, repeats: int = 3,
                 warmup: int = 1, timeout_ms: float | None = 2000.0) -> None:
        self.cache = DecisionCache(cache_dir)
        self.repeats = repeats
        self.warmup = warmup
        self.timeout_ms = timeout_ms

    @classmethod
    def from_config(cls, config) -> "Autotuner":
        return cls(cache_dir=config.autotune_cache_dir,
                   repeats=config.autotune_repeats,
                   warmup=config.autotune_warmup,
                   timeout_ms=config.autotune_timeout_ms)

    def decide(self, key_obj: Any, *, kind: str, name: str, requested: str,
               baseline: str,
               builders: Mapping[str, Callable[[], list]],
               must_run: Collection[str] = ()) -> Decision:
        """Commit a variant.  ``builders[variant]()`` returns the list of
        measurement phases for that variant; building and measuring may
        fail (recorded, not raised), except for the variants in
        ``must_run``, whose errors propagate: a timeout alone drops one of
        them.  The baseline variant is exempt from the timeout and is the
        floor of every decision."""
        t0 = time.perf_counter()
        key = _key_hash(key_obj)

        cached = _MEM_CACHE.get(key)
        if cached is not None and cached.variant in builders:
            STATS.record("cache_hit_mem")
            return dataclasses.replace(
                cached, source="cache-mem",
                autotune_ms=(time.perf_counter() - t0) * 1e3)

        disk, load_events = self.cache.load(key_obj)
        if disk is not None and disk.variant in builders:
            STATS.record("cache_hit_disk")
            decision = dataclasses.replace(
                disk, source="cache-disk",
                events=disk.events + load_events + ("cache: disk hit",),
                autotune_ms=(time.perf_counter() - t0) * 1e3)
            _MEM_CACHE[key] = decision
            return decision

        STATS.record("cache_miss")
        events: list[str] = list(load_events)
        if disk is not None:
            events.append(
                f"cache: entry variant {disk.variant!r} no longer a "
                f"candidate; re-measured")
        failures: list[tuple[str, str]] = []
        measured: list[tuple[str, str, float]] = []
        totals: dict[str, float] = {}

        def run_variant(label: str, timeout: float | None
                        ) -> dict[str, float] | None:
            try:
                phases = builders[label]()
            except Exception as e:             # build failure
                if label in must_run:
                    raise
                failures.append((label, f"{type(e).__name__}: {e}"))
                STATS.record("candidate_failures")
                return None
            out: dict[str, float] = {}
            for phase, fn, args in phases:
                ms, why = measure_ms(fn, args, repeats=self.repeats,
                                     warmup=self.warmup, timeout_ms=timeout,
                                     reraise=label in must_run)
                if ms is None:
                    failures.append((label, f"{phase}: {why}"))
                    STATS.record("candidate_failures")
                    return None
                out[phase] = ms
                measured.append((label, phase, ms))
            return out

        base_phases = run_variant(baseline, None)
        if base_phases is not None:
            totals[baseline] = sum(base_phases.values())
        else:
            events.append(
                f"baseline {baseline!r} failed to measure; fail-open to "
                f"the requested variant")
        for label in builders:
            if label == baseline:
                continue
            phases = run_variant(label, self.timeout_ms)
            if phases is None:
                continue
            if base_phases is not None:
                slower = [p for p, ms in phases.items()
                          if p in base_phases
                          and ms > base_phases[p] * FLOOR_SLACK]
                if slower:
                    events.append(
                        f"{label}: floored by {baseline} on "
                        f"phase(s) {', '.join(sorted(slower))}")
                    continue
            totals[label] = sum(phases.values())

        if totals:
            chosen = min(totals, key=lambda lb: totals[lb])
        else:                                  # nothing measured at all
            chosen = requested if requested in builders else baseline
            events.append("no candidate measured; committing the "
                          "requested variant unverified")
        tripped = chosen != requested
        if tripped:
            STATS.record("guardrail_trips")
        STATS.record("decisions")
        decision = Decision(
            kind=kind, name=name, requested=requested, baseline=baseline,
            variant=chosen, measured_ms=tuple(measured),
            failures=tuple(failures), guardrail_tripped=tripped,
            source="measured", events=tuple(events),
            autotune_ms=(time.perf_counter() - t0) * 1e3)
        _MEM_CACHE[key] = decision
        self.cache.store(key_obj, decision)
        return decision


# ---------------------------------------------------------------------------
# Stack-segment tuning (compile_stacks hook).
# ---------------------------------------------------------------------------

_ITEMSIZE_DTYPES = {2: torch.bfloat16, 4: torch.float32, 8: torch.float64}


def _stack_operands(stack: ir.StackProgram,
                    in_shapes: Mapping[str, tuple[int, ...]],
                    param_shapes: Mapping[str, tuple[int, ...]] | None,
                    itemsize: int, device: torch.device,
                    dtypes: Mapping[str, Any] | None = None
                    ) -> tuple[dict, dict]:
    """Synthesize executor operands on the traced shapes.  Param shapes
    come from the trace when available; otherwise a param broadcasts over
    the trailing (feature) dim of the op that consumes it.  Dtypes come
    from the trace when given, else from ``itemsize``."""
    fallback = _ITEMSIZE_DTYPES.get(itemsize, torch.float32)
    dtypes = dtypes or {}
    inputs = {k: synth_array(tuple(v), dtypes.get(k, fallback), seed=i,
                             device=device)
              for i, (k, v) in enumerate(sorted(in_shapes.items()))}
    all_shapes = ir.infer_shapes(stack, dict(in_shapes))
    params: dict[str, torch.Tensor] = {}
    for op in stack.ops:
        for p in op.params:
            if p in params:
                continue
            if param_shapes and p in param_shapes:
                shape = tuple(param_shapes[p])
            else:
                shape = (tuple(all_shapes[op.inputs[0]]) or (1,))[-1:]
            params[p] = synth_array(shape, dtypes.get(p, fallback),
                                    seed=len(params) + 7, device=device)
    return inputs, params


def _plan_variants(stack: ir.StackProgram,
                   in_shapes: Mapping[str, tuple[int, ...]],
                   config) -> dict[str, tuple[str, Any]]:
    """Candidate (mode, plan) pairs per variant label.  'barrier' is the
    floor; compiled xla always competes; the hand-written schedule (plus
    tile-size and sequence-split variants) competes only when
    requested."""
    plan = collapse_mod.collapse(
        stack, in_shapes, config.device, itemsize=config.itemsize,
        max_steps_per_sequence=config.max_steps_per_sequence,
        differentiable=config.differentiable)
    variants: dict[str, tuple[str, Any]] = {"barrier": ("barrier", plan)}
    if config.mode != "barrier":
        variants["xla"] = ("xla", plan)
    if config.mode == "brainslug":
        variants["brainslug"] = ("brainslug", plan)
        if plan.sequences and all(s.tile_rows for s in plan.sequences):
            halved = dataclasses.replace(plan, sequences=tuple(
                dataclasses.replace(s, tile_rows=max(8, s.tile_rows // 2))
                for s in plan.sequences))
            if halved.sequences != plan.sequences:
                rows = halved.sequences[0].tile_rows
                variants[f"brainslug@rows{rows}"] = ("brainslug", halved)
        if len(stack.ops) > 1 and len(plan.sequences) == 1:
            split = collapse_mod.collapse(
                stack, in_shapes, config.device, itemsize=config.itemsize,
                max_steps_per_sequence=max(1, len(stack.ops) // 2),
                differentiable=config.differentiable)
            if len(split.sequences) > 1:
                variants[f"brainslug@seq{len(split.sequences)}"] = \
                    ("brainslug", split)
    return variants


def hand_written(modes: Mapping[str, str], device: torch.device
                 ) -> frozenset[str]:
    """The candidates, of ``{label: mode or backend}``, that run hand-
    written kernels on ``device``: the ``brainslug`` and ``hopper`` ones on
    the card.  Their errors propagate out of :meth:`Autotuner.decide`
    instead of handing the decision to the plain version.  On the CPU the
    wrappers run their kernels' plain versions, and a failure there is
    recorded like any other."""
    if torch.device(device).type != "cuda":
        return frozenset()
    return frozenset(label for label, mode in modes.items()
                     if mode in ("brainslug", "hopper"))


def _grad_phase(ex: Callable) -> Callable:
    """The training phase of a candidate: autograd of the sum of squares
    of its outputs with respect to every floating operand."""
    def grad(inputs: dict, params: dict):
        with torch.enable_grad():
            leaves = {k: v.detach().requires_grad_(v.is_floating_point())
                      for k, v in {**inputs, **params}.items()}
            out = ex({k: leaves[k] for k in inputs},
                     {k: leaves[k] for k in params})
            loss = sum(torch.sum(torch.square(v.float()))
                       for v in out.values())
            wrt = [t for t in leaves.values() if t.requires_grad]
            return torch.autograd.grad(loss, wrt, allow_unused=True)
    return grad


def tune_stack(tuner: Autotuner, stack: ir.StackProgram,
               in_shapes: Mapping[str, tuple[int, ...]], config,
               param_shapes: Mapping[str, tuple[int, ...]] | None = None,
               dtypes: Mapping[str, Any] | None = None
               ) -> tuple[Decision, str, Any]:
    """Measure the stack's execution variants; returns
    ``(decision, mode, plan)`` for codegen.  A candidate that fails is
    recorded and dropped, except the hand-written ones on the card
    (:func:`hand_written`), whose errors propagate.

    Each builder compiles its candidate and runs it once before handing
    its phases over, untimed: a cold inductor compile (``xla``) or a
    Triton / CUDA build (``brainslug``) takes longer than any per-call
    budget, and the budget (``autotune_timeout_ms``) is there to drop a
    candidate that is slow to run, not one that is slow to build."""
    from repro_torch.core.api import resolve_device
    device = resolve_device(config)
    variants = _plan_variants(stack, in_shapes, config)
    requested = config.mode if config.mode in variants else "barrier"
    stack_params = {p for op in stack.ops for p in op.params}
    key_obj = {
        "kind": "stack", "sig": repr(stack.signature()),
        "shapes": sorted((k, list(v)) for k, v in in_shapes.items()),
        "param_shapes": sorted((k, list(v))
                               for k, v in (param_shapes or {}).items()
                               if k in stack_params),
        "dtypes": sorted((k, str(v)) for k, v in (dtypes or {}).items()
                         if k in stack_params or k in in_shapes),
        "itemsize": config.itemsize,
        "device": getattr(config.device, "name", str(config.device)),
        "mode": requested,
        "differentiable": config.differentiable,
        "max_steps": config.max_steps_per_sequence,
        "torch_device": device_key(device),
    }
    inputs, params = _stack_operands(stack, in_shapes, param_shapes,
                                     config.itemsize, device, dtypes)

    def make_builder(mode: str, plan: Any) -> Callable[[], list]:
        def build() -> list:
            ex = codegen.compile_plan(plan, mode=mode,
                                      cache_size=config.code_cache_size)
            phases: list = [("fwd", ex, (inputs, params))]
            if config.differentiable:
                phases.append(("grad", _grad_phase(ex), (inputs, params)))
            for _, fn, args in phases:        # compile, untimed
                fn(*args)
            return phases
        return build

    builders = {label: make_builder(mode, plan)
                for label, (mode, plan) in variants.items()}
    decision = tuner.decide(
        key_obj, kind="stack", name=stack.name, requested=requested,
        baseline="barrier", builders=builders,
        must_run=hand_written({label: mode for label, (mode, _)
                               in variants.items()}, device))
    mode, plan = variants.get(decision.variant, variants["barrier"])
    return decision, mode, plan


# ---------------------------------------------------------------------------
# Registry-kernel tuning (HOPPER vs REF, extending plan_dispatch).
# ---------------------------------------------------------------------------

def tune_kernel(tuner: Autotuner, op: ir.OpNode, config
                ) -> tuple[Decision, Any, str | None] | None:
    """Measure the hand-written kernel (``hopper``) against its plain
    version (``ref``) for one registry KERNEL op.  Returns ``(decision,
    backend, reason)`` or None when there is nothing to tune (the static
    planner already chose the plain version).  On CPU operands the
    ``hopper`` wrapper runs its kernel's plain version."""
    static_dispatch = registry_mod.plan_dispatch(op, config.mode)
    if static_dispatch.backend is not registry_mod.KernelType.HOPPER:
        return None
    from repro_torch.core.api import resolve_device
    device = resolve_device(config)
    shapes = tuple(tuple(s) for s in op.attrs["arg_shapes"])
    dtypes = op.attrs.get("arg_dtypes", ("float32",) * len(shapes))
    key_obj = {
        "kind": "kernel", "kernel": op.attrs["kernel"],
        "arg_shapes": [list(s) for s in shapes],
        "arg_dtypes": [str(d) for d in dtypes],
        "static": repr(ir._freeze(
            {k: v for k, v in op.attrs.items()
             if k not in codegen._KERNEL_PLUMBING_ATTRS})),
        "torch_device": device_key(device),
    }
    args = tuple(synth_array(s, d, seed=i, device=device)
                 for i, (s, d) in enumerate(zip(shapes, dtypes)))

    def make_builder(backend) -> Callable[[], list]:
        def build() -> list:
            inner = codegen.kernel_inner(op, backend=backend,
                                         cache_size=config.code_cache_size)
            inner(*args)                      # build and launch, untimed
            return [("fwd", inner, args)]
        return build

    builders = {
        "hopper": make_builder(registry_mod.KernelType.HOPPER),
        "ref": make_builder(registry_mod.KernelType.REF),
    }
    decision = tuner.decide(
        key_obj, kind="kernel", name=op.name, requested="hopper",
        baseline="ref", builders=builders,
        must_run=hand_written({"hopper": "hopper"}, device))
    if decision.variant == "hopper":
        return decision, registry_mod.KernelType.HOPPER, None
    hopper_ms = decision.ms_for("hopper")
    ref_ms = decision.ms_for("ref")
    if hopper_ms is not None and ref_ms is not None:
        reason = (f"autotune: ref {ref_ms:.3f}ms beat hopper "
                  f"{hopper_ms:.3f}ms on measured shapes")
    else:
        why = "; ".join(r for v, r in decision.failures if v == "hopper")
        reason = f"autotune: hopper candidate dropped ({why or 'unmeasured'})"
    return decision, registry_mod.KernelType.REF, reason


# ---------------------------------------------------------------------------
# Whole-callable tuning: the benchmark/facade-level floor.
# ---------------------------------------------------------------------------

def pick_callable(name: str, candidates: Mapping[str, Callable],
                  args: tuple, *, baseline: str,
                  requested: str | None = None,
                  cache_dir: str | None = None, key_extra: Any = None,
                  repeats: int = 3, warmup: int = 1,
                  timeout_ms: float | None = None,
                  must_run: Collection[str] = ()
                  ) -> tuple[Decision, Callable]:
    """Measure whole callables on real args and commit the fastest one
    that is never slower than ``candidates[baseline]``.  Returns
    ``(decision, chosen callable)``.  Used by the benchmark scripts and
    the ``optimize()`` function-level floor; callers pass the callables as
    they want them timed (compiled or eager), and name in ``must_run`` the
    ones whose errors must propagate (those that launch hand-written
    kernels on the card: see :func:`hand_written`)."""
    if baseline not in candidates:
        raise ValueError(f"baseline {baseline!r} not in candidates "
                         f"{sorted(candidates)}")
    requested = requested if requested in candidates else baseline
    leaves = [x for x in pytree.tree_leaves(args)
              if isinstance(x, torch.Tensor)]
    key_obj = {
        "kind": "callable", "name": name,
        "avals": [[list(x.shape), str(x.dtype)] for x in leaves],
        "candidates": sorted(candidates),
        "requested": requested, "baseline": baseline,
        "extra": key_extra,
        "torch_device": device_key(leaves[0].device if leaves else "cpu"),
    }
    tuner = Autotuner(cache_dir=cache_dir, repeats=repeats, warmup=warmup,
                      timeout_ms=timeout_ms)
    builders = {label: (lambda fn=fn: [("fwd", fn, args)])
                for label, fn in candidates.items()}
    decision = tuner.decide(key_obj, kind="callable", name=name,
                            requested=requested, baseline=baseline,
                            builders=builders, must_run=must_run)
    return decision, candidates.get(decision.variant,
                                    candidates[baseline])
