"""Device-vs-host measurement for the diagonal voter on the REAL workload.

Replays the exact vote-kernel call set of a pipeline run (captured with
RIBBIT_VOTE_DUMP=<path>: one `seed_start ssl m cycles` line per
most_frequent_longer_motif memo miss) through

  - the native AVX-512 host voter (csrc/ribbit_vote.c), single-threaded
    and with a thread pool (ctypes releases the GIL), and
  - the device-batched voter (ribbit_tpu/vote_device.py), with all input
    batches pre-uploaded so the timed region measures kernels + on-device
    dispatch, not host-to-device transfer.

Also cross-checks the device winner indices against the host voter on a
sample (or all runs with --check-all).

    python tools/voter_device_bench.py --dump /tmp/vdump.txt \
        --fixture /tmp/ribbit_bench_chrom_21.4.fa [--check 2000]
"""

import argparse
import json
import os
import sys
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


def host_all(code, n_mask, runs, threads):
    import ctypes
    from ribbit_tpu.native import get_vote_lib
    lib = get_vote_lib()
    cp = code.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))
    npp = n_mask.view(np.uint8).ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    L = code.shape[0]

    def one(r):
        return int(lib.ribbit_vote_longer(cp, npp, L, r[0], r[1], r[2]))

    t0 = time.perf_counter()
    if threads == 1:
        out = [one(r) for r in runs]
    else:
        with ThreadPoolExecutor(max_workers=threads) as ex:
            out = list(ex.map(one, runs, chunksize=64))
    return out, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dump", default="/tmp/vdump_r5.txt")
    ap.add_argument("--fixture", default="/tmp/ribbit_bench_chrom_21.4.fa")
    ap.add_argument("--check", type=int, default=2000,
                    help="device runs to cross-check against the host "
                         "(0 = none, -1 = all)")
    ap.add_argument("--limit", type=int, default=0,
                    help="cap the number of runs (0 = all)")
    ap.add_argument("--sample-batches", type=int, default=0,
                    help="time at most this many batches per bucket and "
                         "extrapolate the bucket's total (0 = run all)")
    ap.add_argument("--w-band", type=int, default=128)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from ribbit_tpu.encode import encode
    from ribbit_tpu import vote_device as vd

    seq = []
    with open(args.fixture) as fh:
        for line in fh:
            if not line.startswith(">"):
                seq.append(line.strip())
    code, n_mask = encode("".join(seq))
    del seq

    d = np.loadtxt(args.dump, dtype=np.int64)
    runs = [(int(a), int(b), int(c)) for a, b, c in d[:, :3]]
    dump_gc = float(d[:, 3].sum()) / 1e9
    if args.limit:
        runs = runs[:args.limit]
    print(f"{len(runs)} vote runs, host dump {dump_gc:.1f} Gc", file=sys.stderr)

    # --- host ---
    host1, host1_s = host_all(code, n_mask, runs, 1)
    ncpu = os.cpu_count() or 1
    _, hostN_s = host_all(code, n_mask, runs, ncpu)

    # --- device: pack every batch, pre-upload, then timed dispatch ---
    buckets = defaultdict(list)
    for idx, (ss, ssl, m) in enumerate(runs):
        if ssl - m + 1 <= 0:
            continue
        buckets[vd.bucket_of(ssl, m)].append(idx)

    staged = []   # (key, part_idxs, device arrays, kw, bucket_batches)
    t0 = time.perf_counter()
    for (ssl_pad, m_pad), idxs in sorted(buckets.items()):
        R_pad, B_pad = ssl_pad, ssl_pad + 8
        mb = vd.batch_size_of(ssl_pad)
        kw = dict(m_pad=m_pad, R_pad=R_pad, B_pad=B_pad, w_band=args.w_band)
        nbatches = (len(idxs) + mb - 1) // mb
        taken = 0
        for at in range(0, len(idxs), mb):
            if args.sample_batches and taken >= args.sample_batches:
                break
            taken += 1
            part = idxs[at:at + mb]
            padded = [runs[i] for i in part]
            padded += [padded[0]] * (mb - len(padded))
            arrs = vd._pack_bucket(code, n_mask, padded, ssl_pad, m_pad)
            dev = tuple(jax.device_put(jnp.asarray(a)) for a in arrs)
            staged.append(((ssl_pad, m_pad), part, dev, kw,
                           nbatches / max(taken, 1)))
    jax.block_until_ready([s[2] for s in staged])
    upload_s = time.perf_counter() - t0
    print(f"staged {len(staged)} batches in {upload_s:.1f}s", file=sys.stderr)

    # compile pass (one per bucket geometry): run the first batch of each
    # (a warm-up execution rides along; harmless, amortized)
    seen = set()
    t0 = time.perf_counter()
    for key, _part, dev, kw, _x in staged:
        if key in seen:
            continue
        seen.add(key)
        out = vd._vote_bucket(*dev, **kw)
        float(out[0][0].sum().astype(jnp.float32))
    compile_s = time.perf_counter() - t0

    # timed region, PER BUCKET: dispatch the bucket's sampled batches and
    # wait for completion with one scalar fetch.  Sampled buckets
    # extrapolate by batch count.
    outs = []
    bucket_rows = {}
    device_s = 0.0
    device_extrap_s = 0.0
    i = 0
    while i < len(staged):
        key = staged[i][0]
        jend = i
        while jend < len(staged) and staged[jend][0] == key:
            jend += 1
        group = staged[i:jend]
        t0 = time.perf_counter()
        acc = jnp.float32(0)
        for _key, _part, dev, kw, _x in group:
            out = vd._vote_bucket(*dev, **kw)
            outs.append(out)
            acc = acc + out[0][0].sum().astype(jnp.float32)
        float(acc)
        dt = time.perf_counter() - t0
        nrun_sampled = sum(len(p) for _k, p, _d, _kw, _x in group)
        nb_total = (len(buckets[key]) + vd.batch_size_of(key[0]) - 1) \
            // vd.batch_size_of(key[0])
        scale = nb_total / len(group)
        device_s += dt
        device_extrap_s += dt * scale
        bucket_rows[str(key)] = {
            "runs": len(buckets[key]), "sampled_runs": nrun_sampled,
            "sampled_s": round(dt, 3), "extrap_s": round(dt * scale, 3),
            "ms_per_run": round(dt / nrun_sampled * 1e3, 3)}
        i = jend

    # fetch + host finish (prefix + winner); untimed vs the kernel number
    # but reported so the host-side share is visible
    t0 = time.perf_counter()
    nover = 0
    dev_idx = {}
    for (_key, part, _dev, _kw, _x), (rc, w_up, ovf) in zip(staged, outs):
        rc = np.asarray(rc)
        w_up = np.asarray(w_up)
        ovf = np.asarray(ovf)
        for j, idx in enumerate(part):
            ss, ssl, m = runs[idx]
            if ovf[j]:
                nover += 1
                dev_idx[idx] = vd._host_index(code, n_mask, ss, ssl, m)
                continue
            R = ssl - m + 1
            counts = rc[j, :R].astype(np.int64)
            us = (w_up[j, :R] + ss - 2).astype(np.int64)
            counts += vd._prefix_counts(code, n_mask, ss, ssl, m, us)
            dev_idx[idx] = ss + int(np.argmax(counts)) if counts.max() > 0 \
                else 0
    finish_s = time.perf_counter() - t0

    # --- cross-check ---
    mism = 0
    if args.check:
        ids = list(dev_idx)
        if 0 < args.check < len(ids):
            rng = np.random.default_rng(0)
            ids = [ids[i] for i in
                   rng.choice(len(ids), args.check, replace=False)]
        mism = sum(dev_idx[i] != host1[i] for i in ids)

    print(json.dumps({
        "runs": len(runs),
        "host_dump_gc": round(dump_gc, 2),
        "host_1t_s": round(host1_s, 3),
        f"host_{ncpu}t_s": round(hostN_s, 3),
        "device_kernel_sampled_s": round(device_s, 3),
        "device_kernel_extrap_s": round(device_extrap_s, 3),
        "device_finish_s": round(finish_s, 3),
        "device_upload_s": round(upload_s, 1),
        "device_compile_s": round(compile_s, 1),
        "batches": len(staged),
        "band_overflows": nover,
        "checked": args.check if args.check >= 0 else len(dev_idx),
        "mismatches": mism,
        "buckets": bucket_rows,
    }))


if __name__ == "__main__":
    main()
