"""chip_smoke.py off the card: it refuses a CPU platform and a directory
without the package, its result line holds exactly the contract's keys,
and its phases run end to end at a tiny size on the CPU."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


def _run(script: pathlib.Path, cwd: pathlib.Path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_on_cpu_exits_nonzero():
    r = _run(REPO / "chip_smoke.py", REPO)
    assert r.returncode != 0
    assert "JAX platform is cpu" in r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(tmp_path / "chip_smoke.py", tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_result_line_has_exactly_the_contract_keys():
    import chip_smoke
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert "\n" not in line
    got = json.loads(line)
    assert got == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def test_layer_spans_sum_by_layer():
    import chip_smoke
    log = "\n".join([
        "[device] c0: encode 0.100s extract 1.500s",
        "[device] c1: encode 0.050s extract 0.500s",
        "[core] generate     0.000s",
        "[core]   anchored.consume  0.300s",
        "[core] anchored     0.400s",
        "[core] perfect seeds: 12",
        "[host] c0: replay 0.700s refine 2.000s",
        "Processing sequence c0",
    ])
    spans = chip_smoke.layer_spans(log)
    assert spans == pytest.approx({"device.encode": 0.15, "device.extract": 2.0,
                     "core.generate": 0.0, "core.anchored": 0.4,
                     "host.replay": 0.7, "host.refine": 2.0})


def test_chip_smoke_phases_at_tiny_size_on_cpu(cpu_jax, tmp_path):
    """Kernel, golden and real-size phases end to end on the CPU platform
    at tiny sizes: exact streams, oracle BEDs, device == host."""
    import chip_smoke
    chip_smoke.phase_kernel(window_bp=30_000, bench=False)
    chip_smoke.phase_golden(tmp_path)
    chip_smoke.phase_real_size(tmp_path, chrom_bp=40_000,
                               multi_mb=(0.03, 0.01))
