"""End-to-end throughput benchmark.

Runs the full pipeline (FASTA -> BED) on a seeded simulated genome and
reports Mbp/s.  Baseline is the reference ribbit binary (single-core C++)
timed on the same input in the same process environment; vs_baseline is the
throughput ratio (ours / reference).  Prints ONE JSON line.

Metric notes:
  * `value` / `vs_baseline`: WALL-clock on the small fixture — the
    user-visible speedup, but it swings with host contention because ours
    uses all cores while the oracle is single-threaded.
  * `*_cpu` co-metrics: getrusage CPU-seconds (ours: RUSAGE_SELF across
    all threads incl. the native core's pthreads; oracle: RUSAGE_CHILDREN
    delta).  CPU time is the contention-robust work measure on a shared
    host; `chrom_vs_baseline_cpu` is its at-scale twin.
  * device legs (only when JAX's default platform is a GPU): the
    extractor's device-resident time per window (bench_device), and a
    measured --backend device run on a fixed two-contig fixture,
    parity-gated against the host path.  Every device number is printed
    beside the device it ran on.

Env knobs:
  RIBBIT_BENCH_LOCI       locus count for the simulated genome (default 120)
  RIBBIT_BENCH_BACKEND    'host' | 'device' scan backend for the main
                          fixtures (default host)
  RIBBIT_BENCH_CHROM_MB   chromosome-scale fixture size (default 21.4; 0 = skip)
  RIBBIT_BENCH_DEVICE     0 disables the device legs
  RIBBIT_BENCH_REF        force a fresh oracle timing run on the chrom fixture
                          (otherwise the cached timing+output in TMPDIR are reused)
"""

import json
import os
import resource
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ribbit_tpu.config import RibbitConfig
from ribbit_tpu.pipeline import process_fasta
from ribbit_tpu.sim import simulate

TMP = tempfile.gettempdir()


def _self_cpu_s() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def _child_cpu_s() -> float:
    r = resource.getrusage(resource.RUSAGE_CHILDREN)
    return r.ru_utime + r.ru_stime


def _write_fasta(path: str, contigs) -> int:
    total = 0
    with open(path, "w") as fh:
        for name, seq in contigs:
            fh.write(f">{name}\n")
            for i in range(0, len(seq), 80):
                fh.write(seq[i:i + 80] + "\n")
            total += len(seq)
    return total


def main() -> None:
    loci = int(os.environ.get("RIBBIT_BENCH_LOCI", "120"))
    contigs = int(os.environ.get("RIBBIT_BENCH_CONTIGS", "4"))
    backend = os.environ.get("RIBBIT_BENCH_BACKEND", "host")

    # multi-contig genome (real genomes are; contigs are the reference's
    # independent unit of work, ribbit.cpp:269-280)
    fa = TMP + "/ribbit_bench.fa"
    total_bp = _write_fasta(fa, (
        (f"bench{ci}",
         simulate(num_loci=loci // contigs, seed=42 + ci,
                  name=f"bench{ci}").sequence)
        for ci in range(contigs)))
    mbp = total_bp / 1e6

    # --- ours (best of 3 by wall; CPU time reported from the same run) ---
    cfg = RibbitConfig.create()
    ours_s, ours_cpu_s = float("inf"), None
    for _ in range(3):
        c0 = _self_cpu_s()
        t0 = time.perf_counter()
        lines = process_fasta(fa, cfg, scan_backend=backend)
        wall = time.perf_counter() - t0
        if wall < ours_s:
            ours_s, ours_cpu_s = wall, _self_cpu_s() - c0
    ours_mbps = mbp / ours_s

    if os.environ.get("RIBBIT_BENCH_SHUFFLE"):
        # test hook: deliberately break emission order so the parity gate's
        # order sensitivity is itself testable
        lines = lines[::-1]

    # --- reference baseline (single-core C++ oracle) ---
    oracle = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tools", "oracle", "ribbit_oracle")
    vs_baseline = None
    cpu = {}
    if not os.path.exists(oracle):
        subprocess.run(["bash", os.path.join(os.path.dirname(oracle),
                                             "build.sh")],
                       capture_output=True)
    if os.path.exists(oracle):
        ref_s, ref_cpu_s = float("inf"), None
        for _ in range(2):
            c0 = _child_cpu_s()
            t0 = time.perf_counter()
            res = subprocess.run([oracle, "-i", fa,
                                  "-o", TMP + "/ribbit_bench_ref.bed"],
                                 capture_output=True)
            wall = time.perf_counter() - t0
            if wall < ref_s:
                ref_s, ref_cpu_s = wall, _child_cpu_s() - c0
        if res.returncode == 0:
            vs_baseline = round((mbp / ours_s) / (mbp / ref_s), 4)
            # sanity: outputs must match BYTE-FOR-BYTE IN ORDER (emission
            # order is part of the parity contract) or the speed is
            # meaningless
            ref = open(TMP + "/ribbit_bench_ref.bed").read().splitlines()
            if lines != ref:
                print(json.dumps({"metric": "e2e_throughput", "value": 0.0,
                                  "unit": "Mbp/s", "vs_baseline": 0.0,
                                  "error": "parity_mismatch"}))
                return
            if ours_cpu_s and ref_cpu_s:
                cpu = {"ours_cpu_s": round(ours_cpu_s, 3),
                       "oracle_cpu_s": round(ref_cpu_s, 3),
                       "vs_baseline_cpu": round(ref_cpu_s / ours_cpu_s, 4)}

    # --- chromosome-scale workload (single 21.4 Mb chromosome-like contig:
    # repeats + random + 10% N gaps, same recipe as tools/capstone.py).
    # The small fixture above catches the reference at its slowest
    # (~0.10 Mbp/s); at scale it runs 0.20-0.28 Mbp/s, so the at-scale
    # ratio must be measured at scale.  Parity gate: ordered byte-exact. ---
    chrom = {}
    c_ours_s = None
    cbp = 0
    chrom_mb = float(os.environ.get("RIBBIT_BENCH_CHROM_MB", "21.4"))
    if chrom_mb > 0 and os.path.exists(oracle):
        cfa = f"{TMP}/ribbit_bench_chrom_{chrom_mb:g}.fa"
        if not os.path.exists(cfa):
            # ~2660 bp/locus measured with n_block_rate=0.1 (includes
            # inter-locus random sequence and N gaps)
            sim = simulate(num_loci=int(chrom_mb * 1e6) // 2660, seed=38,
                           n_block_rate=0.1, name="chr1")
            _write_fasta(cfa + ".tmp", [("chr1", sim.sequence)])
            os.replace(cfa + ".tmp", cfa)
        cbp = sum(len(l.strip()) for l in open(cfa) if not l.startswith(">"))

        c0 = _self_cpu_s()
        t0 = time.perf_counter()
        clines = process_fasta(cfa, cfg, scan_backend=backend)
        c_ours_s = time.perf_counter() - t0
        c_ours_cpu_s = _self_cpu_s() - c0

        # oracle output + timings cached beside the fixture (deterministic
        # input); CPU seconds cached alongside wall so the contention-robust
        # ratio survives oracle-run reuse
        cref = cfa + ".oracle.bed"
        c_ref_s = c_ref_cpu_s = None
        if not os.path.exists(cref) or os.environ.get("RIBBIT_BENCH_REF"):
            cc0 = _child_cpu_s()
            t0 = time.perf_counter()
            res = subprocess.run([oracle, "-i", cfa, "-o", cref + ".tmp"],
                                 capture_output=True)
            c_ref_s = time.perf_counter() - t0
            c_ref_cpu_s = _child_cpu_s() - cc0
            if res.returncode == 0:
                os.replace(cref + ".tmp", cref)
                with open(cfa + ".oracle.secs", "w") as fh:
                    fh.write(f"{c_ref_s} {c_ref_cpu_s}")
        elif os.path.exists(cfa + ".oracle.secs"):
            parts = open(cfa + ".oracle.secs").read().split()
            c_ref_s = float(parts[0])
            c_ref_cpu_s = float(parts[1]) if len(parts) > 1 else None

        if os.path.exists(cref):
            if clines != open(cref).read().splitlines():
                print(json.dumps({"metric": "e2e_throughput", "value": 0.0,
                                  "unit": "Mbp/s", "vs_baseline": 0.0,
                                  "error": "chrom_parity_mismatch"}))
                return
            chrom = {"chrom_mb": round(cbp / 1e6, 2),
                     "chrom_mbps": round(cbp / 1e6 / c_ours_s, 4)}
            if c_ref_s:
                chrom["chrom_vs_baseline"] = round(c_ref_s / c_ours_s, 4)
            if c_ref_cpu_s and c_ours_cpu_s:
                chrom["chrom_ours_cpu_s"] = round(c_ours_cpu_s, 2)
                chrom["chrom_oracle_cpu_s"] = round(c_ref_cpu_s, 2)
                chrom["chrom_vs_baseline_cpu"] = round(
                    c_ref_cpu_s / c_ours_cpu_s, 4)

    # --- device legs: the extractor on device-resident data, then a
    # measured --backend device run on a fixed fixture, parity-gated
    # against the host path ---
    device = {}
    if os.environ.get("RIBBIT_BENCH_DEVICE", "1") != "0":
        from ribbit_tpu.backend import gpu_present, start_device
        if gpu_present():
            start_device()
            from ribbit_tpu.bench_device import bench_events
            device = bench_events()
            dfa = TMP + "/ribbit_bench_device.fa"
            dbp = _write_fasta(dfa, (
                (f"t{ci}",
                 simulate(num_loci=4_000_000 // 2660, seed=77 + ci,
                          n_block_rate=0.1, name=f"t{ci}").sequence)
                for ci in range(2)))
            host_lines = process_fasta(dfa, cfg, scan_backend="host")
            process_fasta(dfa, cfg, scan_backend="device")   # compile
            t0 = time.perf_counter()
            dlines = process_fasta(dfa, cfg, scan_backend="device")
            t_dev_s = time.perf_counter() - t0
            if dlines != host_lines:
                print(json.dumps({"metric": "e2e_throughput", "value": 0.0,
                                  "unit": "Mbp/s", "vs_baseline": 0.0,
                                  "error": "device_backend_parity_mismatch"}))
                return
            device.update({"e2e_device_mbps": round(dbp / 1e6 / t_dev_s, 4),
                           "e2e_device_fixture_mb": round(dbp / 1e6, 3)})

    print(json.dumps({"metric": "e2e_throughput",
                      "value": round(ours_mbps, 4),
                      "unit": "Mbp/s",
                      "vs_baseline": vs_baseline,
                      "e2e_host_mbps": round(ours_mbps, 4),
                      **cpu,
                      **chrom,
                      **device}))


if __name__ == "__main__":
    main()
