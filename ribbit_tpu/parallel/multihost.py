"""Multi-host distributed contig processing (SURVEY §5 distributed backend).

The reference holds a whole chromosome resident in one process
(fasta_utils.cpp:59-250); this module is the multi-host redesign: every
process calls `jax.distributed.initialize`, the contig's halo-extended
chunk windows shard over a GLOBAL 1-D mesh spanning all processes'
devices, each process's chips run the compact event-extraction kernel for
the chunk rows they own (the O(nshifts * L) scan never leaves the
devices), the clipped per-chunk event fragments are exchanged with a
cross-process allgather (NVLink within a host, the network across hosts),
every process stitches the SAME exact whole-contig streams and replays
the order-dependent scanner/lattice core once (O(events), cheap,
redundant by design), and refinement fans out across processes by seed
slice with a final allgather of the output lines.

Output is BYTE-IDENTICAL to the single-process whole-contig run (the old
per-chunk replay's positional-vote-quirk exposure is gone; see
eventstitch.py).  Launch (one command per host / process):

    ribbit-tpu -i g.fa -o out.bed --coordinator host0:8476 \
               --num-processes 2 --process-id {0,1}

Only process 0 writes output.  Tested by tests/test_multihost.py with two
CPU subprocesses (Gloo collectives) proving byte-identical output vs the
single-process path.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from ..config import RibbitConfig
from ..encode import encode
from ..eventstitch import SEG_SIZE


def ensure_initialized(coordinator: str, num_processes: int,
                       process_id: int) -> None:
    """Idempotent jax.distributed.initialize wrapper."""
    import jax

    if getattr(ensure_initialized, "_done", False):
        return
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    ensure_initialized._done = True


def _with_deadline(fn, *args, what: str = "collective"):
    """Failure DETECTION for cross-process collectives (SURVEY §5): a dead
    or stalled peer rank leaves process_allgather blocked forever — the
    reference has no distributed mode at all, and elastic recovery is out
    of scope, but turning an indefinite hang into a diagnosable error is
    cheap.  With RIBBIT_COLLECTIVE_TIMEOUT=<seconds> set, the collective
    runs under a watchdog; on expiry a TimeoutError names the stalled
    step and points at `--resume` (output flushed so far is recorded in
    the resume manifest, so a relaunch skips completed contigs)."""
    import os
    import queue as _queue
    import threading

    t = float(os.environ.get("RIBBIT_COLLECTIVE_TIMEOUT", "0") or 0)
    if t <= 0:
        return fn(*args)
    # DAEMON thread, not ThreadPoolExecutor: concurrent.futures' atexit
    # hook joins non-daemon workers, so an abandoned stalled worker would
    # re-hang the process at interpreter exit — the hang this watchdog
    # exists to prevent.
    q: _queue.Queue = _queue.Queue(maxsize=1)

    def run():
        try:
            q.put((True, fn(*args)))
        except BaseException as e:  # noqa: BLE001 — relayed to caller
            q.put((False, e))

    threading.Thread(target=run, daemon=True,
                     name=f"ribbit-{what}").start()
    try:
        ok, val = q.get(timeout=t)
    except _queue.Empty:
        raise TimeoutError(
            f"multihost {what} exceeded RIBBIT_COLLECTIVE_TIMEOUT="
            f"{t:g}s — a peer process is stalled or dead; relaunch "
            "the same command with --resume to continue from the "
            "last recorded contig") from None
    if not ok:
        raise val
    return val


# cumulative allgather payload bytes this process has seen (comm-volume
# accounting, printed with --timing); the stacked allgather moves
# nproc * payload bytes per rank
COMM_BYTES = 0


def _gather_blobs(local: dict, total: int) -> List[bytes]:
    """Allgather per-slot byte blobs across processes.

    `local` maps slot index -> bytes (only slots this process owns).
    Contributions are disjoint across processes, so a stacked allgather +
    sum reconstructs the global blobs on every process."""
    from jax.experimental import multihost_utils

    lens = np.zeros(total, dtype=np.int64)
    for i, b in local.items():
        lens[i] = len(b)
    lens = np.asarray(_with_deadline(multihost_utils.process_allgather,
                                     lens, what="length allgather")
                      ).sum(axis=0)

    global COMM_BYTES
    offs = np.zeros(total + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    COMM_BYTES += int(offs[-1])
    payload = np.zeros(int(offs[-1]), dtype=np.uint8)
    for i, b in local.items():
        payload[offs[i]:offs[i] + len(b)] = np.frombuffer(b, dtype=np.uint8)
    payload = np.asarray(
        _with_deadline(multihost_utils.process_allgather, payload,
                       what="payload allgather")).sum(axis=0,
                                                      dtype=np.uint8)
    return [payload[offs[i]:offs[i + 1]].tobytes() for i in range(total)]


def _pack_clipped(ch: np.ndarray, s: np.ndarray, e: np.ndarray) -> bytes:
    return np.concatenate([ch, s, e]).astype("<i8").tobytes()


def _unpack_clipped(blob: bytes):
    a = np.frombuffer(blob, dtype="<i8")
    n = a.shape[0] // 3
    return a[:n], a[n:2 * n], a[2 * n:]


def multihost_process_contig(sequence_id: str, sequence: str,
                             cfg: RibbitConfig,
                             chunk_size: int = SEG_SIZE,
                             workers: Optional[int] = None,
                             timing: bool = False) -> List[str]:
    """Process one contig cooperatively across all initialized processes.

    Every process must call this with identical arguments (the chunk plan
    and the collective schedule are derived deterministically from them).
    Returns the full ordered line list on every process.
    """
    import os

    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..core import MAX_CONTIG, CoreSession
    from ..eventstitch import clip_stream, merge_clipped, segment_bounds
    from .distributed import (_stack_windows, _sharded_extract,
                              distributed_process_contig)
    from .sharded_scan import make_mesh

    L = len(sequence)
    if L >= MAX_CONTIG:
        # the exact global replay needs a whole-contig native session;
        # past the i32 cap every process runs the single-process over-cap
        # path redundantly (deterministic, so all ranks agree) — slow but
        # correct, and a contig this size is already exceptional
        import sys as _sys
        from ..pipeline import process_sequence
        print(f"ribbit-tpu: {sequence_id} exceeds 2^31-64 bp; multihost "
              "replay unavailable — every process runs the auto-chunk "
              "path redundantly", file=_sys.stderr)
        return process_sequence(sequence_id, sequence, cfg)
    code, n_mask = encode(sequence)
    bounds = segment_bounds(L, chunk_size)
    nchunks = len(bounds) - 1
    nproc = jax.process_count()
    if nchunks <= 1 or nproc == 1:
        if nproc == 1:
            return distributed_process_contig(sequence_id, sequence, cfg,
                                              chunk_size=chunk_size,
                                              workers=workers)
        # tiny contig: every process computes redundantly
        from ..pipeline import process_sequence
        return process_sequence(sequence_id, sequence, cfg)

    t0 = time.perf_counter()
    mesh = make_mesh()                       # GLOBAL mesh: all processes
    axis = mesh.axis_names[0]
    windows, codes, nmasks, lens, Lp = _stack_windows(
        code, n_mask, bounds, mesh.devices.size)

    # every process holds the full arrays; materialize only the shards
    # addressable from this process
    row_sh = NamedSharding(mesh, P(axis, None))
    vec_sh = NamedSharding(mesh, P(axis))
    g_codes = jax.make_array_from_callback(
        codes.shape, row_sh, lambda idx: codes[idx])
    g_nmasks = jax.make_array_from_callback(
        nmasks.shape, row_sh, lambda idx: nmasks[idx])
    g_lens = jax.make_array_from_callback(
        lens.shape, vec_sh, lambda idx: lens[idx])

    perf_b, q7_b, q6_b = _sharded_extract(mesh, cfg, g_codes, g_nmasks,
                                          g_lens, Lp)
    t_scan = time.perf_counter() - t0

    # pull only the addressable (locally owned) chunk rows off the devices
    def local_rows(arr):
        rows = {}
        for sh in arr.addressable_shards:
            r0 = sh.index[0].start or 0
            data = np.asarray(sh.data)
            for k in range(data.shape[0]):
                rows[r0 + k] = data[k]
        return rows

    groups = []
    owned: set = set()
    for grp in (perf_b, q7_b, q6_b):
        g = tuple(local_rows(x) for x in grp)
        groups.append(g)
        owned |= set(g[0].keys())
    owned = sorted(i for i in owned if i < nchunks)

    nm = cfg.nmotifs

    def stream_from_rows(ch, s, e, cnt):
        n = int(cnt)
        ch = np.asarray(ch[:n]).astype(np.int64)
        offsets = np.searchsorted(ch, np.arange(nm + 1)).astype(np.int64)
        return (np.asarray(s[:n]).astype(np.int64),
                np.asarray(e[:n]).astype(np.int64), offsets)

    # clip owned chunks to their cores and allgather the fragments; every
    # process then stitches the SAME whole-contig streams (3 slots/chunk)
    local_blobs: dict = {}
    for i in owned:
        wlo, _whi = windows[i]
        for j, grp in enumerate(groups):
            st = stream_from_rows(grp[0][i], grp[1][i], grp[2][i],
                                  grp[3][i])
            ch, s, e = clip_stream(st, bounds[i], bounds[i + 1], wlo)
            local_blobs[3 * i + j] = _pack_clipped(ch, s, e)

    blobs = _gather_blobs(local_blobs, 3 * nchunks)
    parts = [[], [], []]
    for i in range(nchunks):
        for j in range(3):
            parts[j].append(_unpack_clipped(blobs[3 * i + j]))
    perf, q7, q6 = (merge_clipped(p, nm) for p in parts)
    t_events = time.perf_counter() - t0 - t_scan

    # exact global replay, redundant on every process (O(events), cheap)
    ncpu = os.cpu_count() or 1
    sess = CoreSession(code, n_mask, cfg, nthreads=ncpu)
    try:
        sess.set_events(perf, q7, q6)
        seeds = sess.scan()

        # refinement fans out by contiguous seed slice; per-seed output is
        # independent (tests/test_units.py refine-slice invariance), so the
        # gathered slices concatenate to the whole-run byte stream
        pid, n = jax.process_index(), seeds.shape[0]
        lo = pid * n // nproc
        hi = (pid + 1) * n // nproc
        lines = sess.refine(seeds[lo:hi], sequence, sequence_id)
    finally:
        sess.close()
    t_replay = time.perf_counter() - t0 - t_scan - t_events

    blob = ("\n".join(lines) + "\n" if lines else "").encode()
    out_blobs = _gather_blobs({pid: blob}, nproc)
    t_gather = time.perf_counter() - t0 - t_scan - t_events - t_replay
    if timing:
        import sys
        print(f"[p{pid}] {sequence_id}: {len(owned)}/{nchunks} chunks  "
              f"scan {t_scan:.2f}s  events {t_events:.2f}s  "
              f"replay+refine {t_replay:.2f}s  gather {t_gather:.2f}s  "
              f"comm {COMM_BYTES / 1e6:.1f}MB", file=sys.stderr)

    out: List[str] = []
    for b in out_blobs:
        if b:
            out.extend(b.decode().split("\n")[:-1])
    return out
