"""Multi-host efficiency accounting.

Produces the per-rank work/comm table and the projected scaling
efficiency for the cooperative single-contig multi-host mode
(parallel/multihost.py), from terms MEASURED on this host:

  scan_s     threaded event capture (parallelizable, /N across ranks)
  replay_s   ONE exact global lattice replay — REDUNDANT on every rank
             (the byte-exactness design; chunk-split replay is not exact,
             see ARCHITECTURE.md), so it does NOT shrink with N
  refine_s   per-seed refinement (parallelizable, /N)
  comm_MB    allgathered payload per contig: 24 B/event fragment + output
             lines; the stacked allgather moves N * payload on the wire

Projection (per contig of this fixture's composition):

    T(N) = scan_s/N + replay_s + refine_s/N + N*comm_MB/BW
    eff(N) = T(1) / (N * T(N))

The redundant replay is an Amdahl term: it caps cooperative-mode
efficiency regardless of interconnect.  WHOLE-GENOME runs distribute
CONTIGS across hosts instead (independent units, ribbit.cpp:269-280) —
no redundant work, efficiency ~= 1 - imbalance — so cooperative mode is
the long-single-contig fallback, not the genome-scale path.

Optionally cross-checks the accounting against a REAL 2-process CPU-sim
run (--check: per-rank [p*] timing lines + comm MB from the
instrumented _gather_blobs).

    python tools/multihost_accounting.py [--mb 8] [--check]
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def measure_terms(mb: float) -> dict:
    import numpy as np

    from ribbit_tpu.config import RibbitConfig
    from ribbit_tpu.core import CoreSession
    from ribbit_tpu.encode import encode
    from ribbit_tpu.eventstitch import capture_runs_host
    from ribbit_tpu.sim import simulate

    cfg = RibbitConfig.create()
    sim = simulate(num_loci=int(mb * 1e6) // 2660, seed=38,
                   n_block_rate=0.1, name="mh")
    seq = sim.sequence
    code, n_mask = encode(seq)
    mbp = len(seq) / 1e6

    t0 = time.perf_counter()
    perf, q7, q6 = capture_runs_host(code, n_mask, cfg)
    scan_s = time.perf_counter() - t0
    nevents = int(perf[0].shape[0] + q7[0].shape[0] + q6[0].shape[0])

    sess = CoreSession(code, n_mask, cfg, nthreads=os.cpu_count() or 1)
    try:
        sess.set_events(perf, q7, q6)
        t0 = time.perf_counter()
        seeds = sess.scan()
        replay_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        lines = sess.refine(seeds, seq, "mh")
        refine_s = time.perf_counter() - t0
    finally:
        sess.close()

    out_mb = sum(len(l) + 1 for l in lines) / 1e6
    return {"mbp": round(mbp, 2), "nevents": nevents,
            "scan_s": round(scan_s, 2), "replay_s": round(replay_s, 2),
            "refine_s": round(refine_s, 2),
            "event_comm_mb": round(24 * nevents / 1e6, 1),
            "output_comm_mb": round(out_mb, 1)}


def projection(t: dict, ranks=(1, 2, 4, 8), bw_gbps: float = 12.5) -> list:
    """Efficiency table; bw_gbps is the per-host interconnect budget
    (a 100 Gb/s network by default; NVLink within a host makes comm
    negligible)."""
    comm_mb = t["event_comm_mb"] + t["output_comm_mb"]
    t1 = t["scan_s"] + t["replay_s"] + t["refine_s"]
    rows = []
    for n in ranks:
        comm_s = n * comm_mb / 1e3 / bw_gbps
        tn = t["scan_s"] / n + t["replay_s"] + t["refine_s"] / n + comm_s
        rows.append({"ranks": n, "t_s": round(tn, 2),
                     "comm_s": round(comm_s, 3),
                     "efficiency": round(t1 / (n * tn), 3)})
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=float, default=8)
    ap.add_argument("--bw-gbps", type=float, default=12.5)
    ap.add_argument("--check", action="store_true",
                    help="also run the real 2-process CPU-sim multihost "
                         "path and print its per-rank timing/comm lines")
    args = ap.parse_args()

    terms = measure_terms(args.mb)
    print(json.dumps({"terms": terms,
                      "projection": projection(terms,
                                               bw_gbps=args.bw_gbps)}))

    if args.check:
        import subprocess
        sys.stderr.write("--- real 2-process CPU-sim run ---\n")
        subprocess.run([sys.executable,
                        os.path.join(REPO, "tools", "multihost_bench.py"),
                        "--processes", "2"], check=True)


if __name__ == "__main__":
    main()
