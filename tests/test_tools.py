"""Smoke tests for the analysis tools (bed_diff, evaluate)."""

import subprocess
import sys
import pathlib

TOOLS = pathlib.Path(__file__).parent.parent / "tools"


def test_bed_diff_identical_and_jitter(tmp_path):
    a = tmp_path / "a.bed"
    b = tmp_path / "b.bed"
    lines = [f"c\t{i*100}\t{i*100+50}\tAC\t2 | 2\t50\t25\t1\t+\tSEED-5\t50="
             for i in range(10)]
    a.write_text("\n".join(lines) + "\n")
    b.write_text("\n".join(lines) + "\n")
    r = subprocess.run([sys.executable, str(TOOLS / "bed_diff.py"),
                        str(a), str(b)], capture_output=True, text=True)
    assert r.returncode == 0 and "IDENTICAL" in r.stdout

    jit = [l.split("\t") for l in lines]
    jit[3][1] = str(int(jit[3][1]) + 2)
    b.write_text("\n".join("\t".join(c) for c in jit) + "\n")
    r = subprocess.run([sys.executable, str(TOOLS / "bed_diff.py"),
                        str(a), str(b), "--summary-only"],
                       capture_output=True, text=True)
    assert r.returncode == 1
    assert "coord-jitter(<= 5bp): 1" in r.stdout


def test_evaluate_recall_precision(tmp_path):
    truth = tmp_path / "t.bed"
    calls = tmp_path / "c.bed"
    truth.write_text("c\t100\t200\tR0\t100\t2\tAC\t\nc\t500\t600\tR1\t100\t2\tAC\t\n")
    calls.write_text("c\t95\t205\tAC\t2 | 2\t110\t55\t1\t+\tSEED-5\t110=\n")
    r = subprocess.run([sys.executable, str(TOOLS / "evaluate.py"),
                        str(truth), str(calls)], capture_output=True, text=True)
    assert r.returncode == 0
    assert "recall: 0.500" in r.stdout
    assert "precision: 1.000" in r.stdout


def test_bench_parity_gate_is_order_sensitive(tmp_path):
    """The bench gate must compare output IN ORDER (emission order is part
    of the byte-parity contract): a shuffled result reports parity_mismatch
    and zeroes the score; the unshuffled run reports a clean number."""
    import json
    import os
    repo = TOOLS.parent
    env = dict(os.environ,
               RIBBIT_BENCH_LOCI="8", RIBBIT_BENCH_CONTIGS="2",
               # the gate logic under test lives on the small fixture; the
               # chromosome-scale workload and the device legs are off
               RIBBIT_BENCH_CHROM_MB="0", RIBBIT_BENCH_DEVICE="0")
    r = subprocess.run([sys.executable, str(repo / "bench.py")],
                       capture_output=True, text=True, env=env, cwd=repo)
    ok = json.loads(r.stdout.strip().splitlines()[-1])
    assert ok.get("error") is None and ok["value"] > 0

    env["RIBBIT_BENCH_SHUFFLE"] = "1"
    r = subprocess.run([sys.executable, str(repo / "bench.py")],
                       capture_output=True, text=True, env=env, cwd=repo)
    bad = json.loads(r.stdout.strip().splitlines()[-1])
    assert bad.get("error") == "parity_mismatch" and bad["value"] == 0.0
