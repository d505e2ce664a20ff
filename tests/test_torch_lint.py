"""``python -m repro_torch.lint`` on the CPU: every default arch lints clean
on the H100 spec; on the tiny device the port's lint and the JAX
package's ``repro.lint`` agree arch by arch on the status and the set of
invariants, the ``dist.*`` family included; ``main``'s exit status and
``--out`` report; the ``dist-partition`` self-test lints clean, and the
serving one (``serve-dist``) raises ``NotImplementedError`` until mesh
serving is ported."""
from __future__ import annotations

import json

import pytest
import torch

from repro import lint as jlint
from repro.core import resource as jresource
from repro_torch import lint
from repro_torch.configs import ARCH_IDS
from repro_torch.core import resource, verify

torch.set_num_threads(1)

ARCHS = [*ARCH_IDS, "brainslug-cnn", "paged-kv", "dist-partition"]


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_lints_clean_on_the_h100(arch):
    findings = lint.lint_arch(arch, resource.H100)
    assert verify.errors(findings) == [], [str(f) for f in findings]


def _status(findings):
    errs = verify.errors(findings)
    return "error" if errs else ("warning" if findings else "clean")


@pytest.mark.parametrize("arch", ARCHS)
def test_tiny_device_agrees_with_jax(arch):
    want = jlint.lint_arch(arch, jresource.TINY_DEVICE)
    got = lint.lint_arch(arch, resource.TINY_DEVICE)
    assert _status(got) == _status(want)
    assert {f.invariant for f in got} == {f.invariant for f in want}


def test_main_exit_status_and_report(tmp_path, capsys):
    assert lint.main(["--arch", "deepseek-7b", "--arch", "paged-kv"]) == 0
    out = tmp_path / "lint" / "report.json"
    assert lint.main(["--device", "tiny", "--arch", "deepseek-7b",
                      "--arch", "brainslug-cnn", "--out", str(out)]) == 1
    report = json.loads(out.read_text())
    assert report["device"] == "tiny"
    assert report["n_errors"] > 0 and report["n_warnings"] == 0
    assert report["archs"]["deepseek-7b"]["status"] == "error"
    assert report["archs"]["brainslug-cnn"] == {"status": "clean",
                                                "findings": []}
    assert "total:" in capsys.readouterr().out


@pytest.mark.parametrize("arch", lint.MESH_ARCHS)
def test_mesh_self_tests_wait_for_the_multi_device_slice(arch):
    """Both mesh self-tests are ported (``dist-partition``, and
    ``serve-dist``, the serving decode-cache partition's): clean on the
    H100 and, on the tiny device, the same status and findings as
    ``repro.lint``."""
    assert lint.lint_arch(arch, resource.H100) == []
    assert lint.main(["--arch", arch]) == 0
    got = lint.lint_arch(arch, resource.TINY_DEVICE)
    want = jlint.lint_arch(arch, jresource.TINY_DEVICE)
    assert _status(got) == _status(want) == "clean"
    assert got == want == []
