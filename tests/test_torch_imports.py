"""The port's import hygiene, at run time: in a fresh interpreter, importing
every module of ``repro_torch`` loads no ``jax*`` module and nothing of the
JAX package (``repro`` / ``repro.*``)."""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"modules": names, "bad": bad}))
"""


@functools.lru_cache(maxsize=None)
def _probe() -> dict:
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    proc = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                          capture_output=True, text=True, timeout=300,
                          check=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_port_modules_import_neither_jax_nor_repro():
    result = _probe()
    assert "repro_torch.kernels.fused_stack.rows_bwd" in result["modules"]
    assert "repro_torch.kernels.fused_stack.nhwc_bwd" in result["modules"]
    assert "repro_torch.core.autodiff" in result["modules"]
    for name in ("configs", "configs.base", "configs.deepseek_7b",
                 "kernels.rmsnorm.rmsnorm", "kernels.swiglu.swiglu",
                 "kernels.attention.flash", "kernels.attention.decode",
                 "kernels.attention.ops", "layers.base", "layers.dense",
                 "layers.attention", "models.lm", "core.scheduler",
                 "launch.serve", "core.verify", "launch.engine",
                 "examples.serve_batch"):
        assert f"repro_torch.{name}" in result["modules"]
    assert result["bad"] == []


def test_training_slice_modules_import_neither_jax_nor_repro():
    """The LM training slice keeps its own copies of the JAX package's
    numpy-only modules (the data pipeline, the fault-tolerance hooks)."""
    result = _probe()
    for name in ("kernels.vocab_ce.ref", "kernels.vocab_ce.ce",
                 "kernels.vocab_ce.ops", "optim.adamw", "optim.schedule",
                 "data.pipeline", "checkpoint.checkpointer",
                 "distributed.fault_tolerance", "launch.steps",
                 "launch.train", "examples.train_lm"):
        assert f"repro_torch.{name}" in result["modules"]
    assert result["bad"] == []


def test_ssm_slice_modules_import_neither_jax_nor_repro():
    """The SSM slice: the SSD kernels, their dispatch and the mamba2
    layer."""
    result = _probe()
    for name in ("kernels.ssd.ref", "kernels.ssd.chunked", "kernels.ssd.ssd",
                 "kernels.ssd.ops", "layers.mamba2", "configs.mamba2_2p7b"):
        assert f"repro_torch.{name}" in result["modules"]
    assert result["bad"] == []


def test_slice_f_modules_import_neither_jax_nor_repro():
    """Slice F: the autotuner and the compiled ``xla`` path (``torch``'s
    dynamo and inductor are imported when a stack first compiles)."""
    result = _probe()
    for name in ("core.autotune", "core.api", "api",
                 "kernels.fused_stack.ops"):
        assert f"repro_torch.{name}" in result["modules"]
    assert result["bad"] == []
