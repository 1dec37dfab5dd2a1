"""Diagonal-voter placement measurement.

The large-motif refiner's diagonal voter (mostFrequentLongerMotif,
parse_seed.cpp:153-256) walks candidate rows in greedy ±2 bp jitter steps —
per-row data-dependent gathers, so the voter stays on the host.  This
harness puts numbers behind that call: it times, on identical real seed
workloads,

  - the AVX-512BW C voter (csrc/ribbit_vote.c) used by refinement, and
  - the vectorized numpy spec (refine.py fallback),

and reports the voter's share of total refinement wall time.

    python tools/voter_bench.py [--loci 40] [--min-motif 11]
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--loci", type=int, default=40)
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args()

    from ribbit_tpu import native, refine
    from ribbit_tpu.config import RibbitConfig
    from ribbit_tpu.core import CoreSession
    from ribbit_tpu.encode import encode
    from ribbit_tpu.sim import simulate

    cfg = RibbitConfig.create()
    sim = simulate(num_loci=args.loci, seed=args.seed, name="voter",
                   max_motif=100)
    code, n_mask = encode(sim.sequence)

    # collect the real large-motif voter call sites by running the seed scan
    sess = CoreSession(code, n_mask, cfg)
    try:
        seeds = sess.scan()
    finally:
        sess.close()
    calls = [(int(s), int(e) - int(s), int(m))
             for s, e, m, r in seeds.tolist()
             if r != -1 and m > 10 and (e - s) >= 0.9 * m]
    if not calls:
        raise SystemExit("fixture produced no large-motif seeds")

    lib = native.get_vote_lib()
    assert lib is not None, "native voter unavailable"

    def time_voter(fn, reps):
        t0 = time.perf_counter()
        out = []
        for _ in range(reps):
            out = [fn(s, sl, m) for s, sl, m in calls]
        return (time.perf_counter() - t0) / reps, out

    import ctypes
    cptr = code.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))
    nptr = n_mask.view(np.uint8).ctypes.data_as(
        ctypes.POINTER(ctypes.c_uint8))
    L = code.shape[0]

    t_avx, r_avx = time_voter(
        lambda s, sl, m: lib.ribbit_vote_longer(cptr, nptr, L, s, sl, m), 5)

    # numpy spec fallback (force the pure path)
    native._vote_lib, native._vote_tried = None, True
    try:
        t_np, r_np = time_voter(
            lambda s, sl, m: refine.most_frequent_longer_motif(
                code, n_mask, s, sl, m, L), 1)
    finally:
        native._vote_tried = False

    # exactness: the numpy path returns packed units; re-derive from indices
    units_avx = []
    for (s, sl, m), mm in zip(calls, r_avx):
        unit = 0
        for c in code[mm:mm + m].tolist():
            unit = (unit << 2) | int(c)
        units_avx.append(unit & ((1 << 256) - 1))
    assert units_avx == r_np, "voter outputs diverge"

    # voter share of total refinement: native refine timed with/without
    sess = CoreSession(code, n_mask, cfg)
    try:
        seeds = sess.scan()
        t0 = time.perf_counter()
        sess.refine(seeds, sim.sequence, "voter")
        t_refine = time.perf_counter() - t0
    finally:
        sess.close()

    print(json.dumps({
        "large_motif_voter_calls": len(calls),
        "avx512_voter_s": round(t_avx, 4),
        "numpy_spec_voter_s": round(t_np, 4),
        "avx512_speedup": round(t_np / t_avx, 1),
        "total_refine_s": round(t_refine, 4),
        "voter_share_of_refine": round(t_avx / t_refine, 3),
        "outputs": "identical",
    }))


if __name__ == "__main__":
    main()
