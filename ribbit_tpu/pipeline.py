"""End-to-end per-sequence pipeline.

Mirrors processSequence (fasta_utils.cpp:59-250):
  encode -> shift-XOR scan -> perfect/substitution/anchored scanners ->
  merge lattices -> 3-pointer seed merge -> per-seed refinement -> BED.

Engines:
  core   (default) — native event-driven core (csrc/ribbit_core.c): the
         O(NSHIFTS*L) scan streams into compact events consumed by C
         scanners/lattices; overlay range queries are recomputed on demand.
         Events can also come from the device extractor (scan_backend=
         "device": scan_events_tpu through XLA, stitched per segment).
  python — the oracle-validated pure-Python reference engine over full
         bitmaps (scan_host / events / lattice); used for cross-checking.
"""

from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np

from .config import (RibbitConfig, RANK_P, RANK_S, RANK_A, RANK_N,
                     WINDOW_BITCOUNT_SUBSTITUTION, WINDOW_BITCOUNT_ANCHORED)
from . import scan_host
from .encode import encode
from .eventstitch import SEG_SIZE
from .refine import (process_seed, process_seed_motifwise,
                     longest_continuous_matches)

# the lattices and processSeed recurse proportionally to local seed structure
sys.setrecursionlimit(1_000_000)


class _BitmapCounter:
    """bitcount(midx, start, end) over a bool [NSHIFTS, L] matrix."""

    def __init__(self, bitmaps: np.ndarray):
        self.bitmaps = bitmaps

    def __call__(self, midx: int, start: int, end: int) -> int:
        if start < 0:
            start = 0
        return int(np.count_nonzero(self.bitmaps[midx, start:end]))


def _refine_seeds(seeds, sequence_id: str, sequence: str, L: int,
                  code: np.ndarray, n_mask: np.ndarray, cfg: RibbitConfig,
                  emit, longest_run_for_channel) -> None:
    """Dispatch the merged seed stream into the two refinement paths
    (fasta_utils.cpp:224-240).  seeds: iterable of (start, end, mlen, rank);
    longest_run_for_channel(midx) -> callable(a, b) -> longest overlay run."""
    for seed_start, seed_end, seed_mlen, seed_type in seeds:
        if seed_type == RANK_N:
            continue
        if seed_end - seed_start >= 0.9 * seed_mlen:
            clr = longest_run_for_channel(cfg.motif_channel(seed_mlen))
            if seed_mlen <= 10:
                process_seed_motifwise(seed_start, seed_end, seed_mlen,
                                       seed_type, sequence_id, sequence, L,
                                       clr, code, n_mask, cfg, emit)
            else:
                process_seed(seed_start, seed_end, seed_mlen, seed_type,
                             sequence_id, sequence, L, clr, code, n_mask,
                             cfg, emit)


def _process_core(sequence_id: str, sequence: str, cfg: RibbitConfig,
                  emit, scan_backend: str, nthreads: int = 0) -> None:
    import os
    from .core import CoreSession
    L = len(sequence)
    code, n_mask = encode(sequence)
    sess = CoreSession(code, n_mask, cfg, nthreads=nthreads)
    try:
        drop_min = int(os.environ.get("RIBBIT_OVERLAY_DROP_MIN", 64_000_000))
        if (scan_backend == "host"
                and not os.environ.get("RIBBIT_PY_REFINE")
                and os.environ.get("RIBBIT_STREAM", "1") != "0"):
            # streaming path: the serial anchored-consume walk overlaps the
            # refinement pool (ribbit_scan_refine); byte-identical to
            # scan()+refine().  Large contigs release the packed overlay at
            # a quiescent point between the scan and the refine tail (same
            # memory profile as the two-phase path's drop).
            for line in sess.scan_refine(sequence, sequence_id,
                                         drop_overlay=L >= drop_min):
                emit(line)
            return
        if scan_backend == "device":
            # long contigs stream through the device in segments with
            # exact event stitching (bounds device memory at any L); a
            # device error ends the run
            from .eventstitch import scan_events_segmented
            sess.set_events(*scan_events_segmented(code, n_mask, cfg))
        seeds = sess.scan()

        if os.environ.get("RIBBIT_PY_REFINE"):
            # python refinement over the native seed stream (debug/cross-check)
            def longest_run_for_channel(midx: int):
                return lambda a, b: sess.overlay_longest_run(midx, a, b)
            _refine_seeds(seeds.tolist(), sequence_id, sequence, L, code,
                          n_mask, cfg, emit, longest_run_for_channel)
        else:
            # large contigs: hand back the packed overlay cache (~12.4 B/bp)
            # before refinement — its only remaining consumer is the
            # has-run-of-3 gate, which recomputes with early exit
            if L >= drop_min:
                sess.drop_overlay()
            for line in sess.refine(seeds, sequence, sequence_id):
                emit(line)
    finally:
        sess.close()


def _process_python(sequence_id: str, sequence: str, cfg: RibbitConfig,
                    emit, scan_backend: str) -> None:
    from .events import (run_perfect_scan, run_substitution_scan,
                         run_anchored_scan)
    L = len(sequence)
    code, n_mask = encode(sequence)

    if scan_backend == "device":
        from . import scan_tpu
        eq, anchors, overlay, qual7, qual6 = scan_tpu.scan_arrays(
            code, n_mask, cfg)
    else:
        eq = scan_host.match_bitmaps(code, cfg)
        anchors = scan_host.anchor_bitmaps(eq, cfg)
        overlay = scan_host.overlay_bitmaps(eq, anchors, cfg)
        qual7 = scan_host.window_qualified(eq, n_mask,
                                           WINDOW_BITCOUNT_SUBSTITUTION)
        qual6 = scan_host.window_qualified(overlay, n_mask,
                                           WINDOW_BITCOUNT_ANCHORED)

    raw_bitcount = _BitmapCounter(eq)
    overlay_bitcount = _BitmapCounter(overlay)

    perfect = run_perfect_scan(eq, n_mask, raw_bitcount, cfg)
    substut = run_substitution_scan(qual7, n_mask, raw_bitcount, perfect, cfg)
    anchored = run_anchored_scan(qual6, n_mask, overlay_bitcount,
                                 perfect, substut, cfg)

    # final 3-pointer merge by seed start; P wins ties over S over A
    # (fasta_utils.cpp:181-242)
    def merged():
        pi = si = ai = 0
        smallest_type = -1
        while pi < len(perfect) or si < len(substut) or ai < len(anchored):
            smallest = (1 << 64) - 1
            if pi < len(perfect) and smallest > perfect[pi][0]:
                smallest = perfect[pi][0]
                smallest_type = RANK_P
            if si < len(substut) and smallest > substut[si][0]:
                smallest = substut[si][0]
                smallest_type = RANK_S
            if ai < len(anchored) and smallest > anchored[ai][0]:
                smallest = anchored[ai][0]
                smallest_type = RANK_A
            if smallest_type == RANK_P:
                seed = perfect[pi]
                pi += 1
            elif smallest_type == RANK_S:
                seed = substut[si]
                si += 1
            else:
                seed = anchored[ai]
                ai += 1
            yield seed

    def longest_run_for_channel(midx: int):
        ch = overlay[midx]
        return lambda a, b: longest_continuous_matches(ch[a:b])

    _refine_seeds(merged(), sequence_id, sequence, L, code, n_mask, cfg,
                  emit, longest_run_for_channel)


def process_sequence(sequence_id: str, sequence: str, cfg: RibbitConfig,
                     out: Optional[List[str]] = None,
                     scan_backend: str = "host",
                     engine: str = "core",
                     nthreads: int = 0) -> List[str]:
    """Returns the BED lines for one sequence (11 tab-separated columns,
    matching ribbit.cpp:199-204 / parse_seed.cpp:434-437)."""
    lines: List[str] = out if out is not None else []
    emit = lines.append
    if len(sequence) == 0:
        return lines

    if engine == "core":
        from .core import MAX_CONTIG
        if len(sequence) >= MAX_CONTIG:
            # past the native core's i32 position range: auto-chunk at
            # big-N-run midpoints (exact splits) instead of erroring out
            print(f"ribbit-tpu: {sequence_id} exceeds 2^31-64 bp; "
                  "auto-chunking", file=sys.stderr)
            # chunk_size/halo relative to the contig so chunk spans stay
            # well under the cap and never route back here
            over_chunk = min(SEG_SIZE, len(sequence) // 8)
            lines.extend(process_sequence_chunked(
                sequence_id, sequence, cfg, chunk_size=over_chunk,
                halo=min(1 << 16, over_chunk // 4), strict=True))
            return lines
        try:
            _process_core(sequence_id, sequence, cfg, emit, scan_backend,
                          nthreads=nthreads)
            return lines
        except RuntimeError:
            # native core unavailable (no compiler / build failure): the
            # Python engine is ~50-100x slower, so never fall back silently
            print("ribbit-tpu: WARNING: native core unavailable, falling "
                  "back to the (much slower) Python engine", file=sys.stderr)
    _process_python(sequence_id, sequence, cfg, emit, scan_backend)
    return lines


def _choose_splits(n_mask: np.ndarray, chunk_size: int,
                   min_gap: int = 512, strict: bool = False) -> List[int]:
    """Split points for chunked processing, preferentially at the midpoints
    of N-runs >= min_gap.

    Rationale (exactness): no seed, window, or qualified run crosses an N
    position, and anchor-qualifying eq-runs are < 2*max_shift ~ 204 bp — a
    run crossing the midpoint of an N-run >= 512 is itself >= 410 long and
    can never be an anchor.  Chunks that overlap by >= half the N-run
    therefore reproduce the whole-contig scan exactly around the split; the
    only possible divergence is the reference's positional-index quirk in
    the anchored coverage votes (parse_anchored_shiftxor.cpp:441-526),
    which reads unrelated early list entries.  Splits away from N-runs
    (dense contigs) fall back to raw offsets and rely on the halo."""
    L = n_mask.shape[0]
    splits = []
    target = chunk_size
    # N-runs >= min_gap
    idx = np.flatnonzero(n_mask)
    runs = []
    if idx.size:
        brk = np.flatnonzero(np.diff(idx) > 1)
        starts = np.concatenate(([idx[0]], idx[brk + 1]))
        ends = np.concatenate((idx[brk] + 1, [idx[-1] + 1]))
        runs = [(int(s), int(e)) for s, e in zip(starts, ends)
                if e - s >= min_gap]
    while target < L - chunk_size // 2:
        # nearest qualifying N-run midpoint within +-chunk_size/2
        best = None
        for s, e in runs:
            mid = (s + e) // 2
            if abs(mid - target) <= chunk_size // 2:
                if best is None or abs(mid - target) < abs(best - target):
                    best = mid
        if best is not None:
            splits.append(best)
        elif not strict:
            splits.append(target)
        # strict mode: no qualifying N-run -> no split here (stay exact)
        splits_last = splits[-1] if splits else 0
        nxt = max(target, splits_last) + chunk_size
        if nxt <= target:
            break
        target = nxt
    return splits


def process_sequence_chunked(sequence_id: str, sequence: str,
                             cfg: RibbitConfig,
                             chunk_size: int = SEG_SIZE,
                             halo: int = 1 << 16,
                             workers: Optional[int] = None,
                             strict: bool = False) -> List[str]:
    """Chunked processing of one long contig, BYTE-IDENTICAL to the
    whole-contig run at ANY split points.

    Chunks are halo-extended windows; each window runs the threaded native
    generation in run-capture mode (eventstitch.capture_runs_host), the
    per-chunk event streams are clipped/stitched into the exact whole-
    contig streams, and the order-dependent scanner/lattice replay runs
    ONCE globally (O(events), cheap) before threaded refinement.  This
    removes the old per-chunk replay's exposure to the reference's
    positional-index vote quirk (parse_anchored_shiftxor.cpp:441-526) and
    the big-N-run split-point requirement; memory stays bounded (the
    packed overlay cache is never built: capture mode skips it and the
    injected-events session recomputes range queries on demand).

    `workers` bounds this path's native thread count; `halo` and `strict`
    apply only to the over-cap split fallback below (the stitched path's
    capture halo is the fixed, exactness-validated eventstitch.HALO).

    Contigs past the native core's i32 position range cannot hold a global
    session and fall back to independent split processing
    (_process_chunked_split; exact only at big-N-run splits)."""
    from .core import MAX_CONTIG, CoreSession
    from .eventstitch import capture_runs_host, scan_events_segmented

    L = len(sequence)
    if L <= chunk_size + chunk_size // 2:
        return process_sequence(sequence_id, sequence, cfg)
    if L >= MAX_CONTIG:
        # strict=True: prefer exact big-N-run splits; the no-N-run branch
        # inside prints the best-effort warning before degrading, keeping
        # the documented byte-identical contract honest for over-cap input
        return _process_chunked_split(sequence_id, sequence, cfg,
                                      chunk_size=chunk_size, halo=halo,
                                      workers=workers, strict=True)
    import os
    ncpu = workers or os.cpu_count() or 1
    code, n_mask = encode(sequence)
    perf, q7, q6 = scan_events_segmented(
        code, n_mask, cfg, extractor=capture_runs_host,
        seg_size=chunk_size)
    sess = CoreSession(code, n_mask, cfg, nthreads=ncpu)
    try:
        sess.set_events(perf, q7, q6)
        seeds = sess.scan()
        return sess.refine(seeds, sequence, sequence_id)
    finally:
        sess.close()


def _process_chunked_split(sequence_id: str, sequence: str,
                           cfg: RibbitConfig,
                           chunk_size: int = SEG_SIZE,
                           halo: int = 1 << 16,
                           workers: Optional[int] = None,
                           strict: bool = False) -> List[str]:
    """Independent-chunk processing (the pre-stitch design): splits at
    big-N-run midpoints when possible, raw offsets otherwise; each chunk
    replays its own lattices.  Only used for contigs past the native
    core's i32 range; exact at N-run splits, best-effort within +-halo of
    raw cuts."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    L = len(sequence)
    if L <= chunk_size + chunk_size // 2:
        return process_sequence(sequence_id, sequence, cfg)

    from .core import MAX_CONTIG
    _code, n_mask = encode(sequence)
    splits = _choose_splits(n_mask, chunk_size, strict=strict)
    if strict and not splits and L >= MAX_CONTIG:
        # over-cap contig with no big-N-run split points: raw-offset splits
        # with halo are the only way through the native core's i32 range.
        # Output can differ from a (hypothetical) whole-contig run within
        # +-halo of each cut; real genomes always have qualifying N runs.
        import sys as _sys
        print(f"ribbit-tpu: {sequence_id}: no N-run split points; using "
              "raw-offset chunking (output near cut points is best-effort)",
              file=_sys.stderr)
        strict = False
        splits = _choose_splits(n_mask, chunk_size, strict=False)
    if not splits:
        return process_sequence(sequence_id, sequence, cfg)
    if strict:
        # N-run-midpoint splits need no halo: no seed, window, qualified
        # run, or anchor-eligible eq-run can span the midpoint of an N-run
        # >= 512 (runs through it are >= 410 long, above the 2*max_shift
        # anchor bound), so each chunk reproduces the whole-contig scan on
        # its own interval exactly; extending into foreign context would
        # instead perturb the order-dependent lattices
        halo = 0
    bounds = [0] + splits + [L]

    tasks = []
    for i in range(len(bounds) - 1):
        core_lo, core_hi = bounds[i], bounds[i + 1]
        lo = max(0, core_lo - halo)
        hi = min(L, core_hi + halo)
        tasks.append((lo, hi, core_lo, core_hi))

    ncpu = os.cpu_count() or 1
    if workers is None:
        workers = min(ncpu, len(tasks))

    def run_chunk(t):
        lo, hi, core_lo, core_hi = t
        sub = sequence[lo:hi]
        lines = process_sequence(sequence_id, sub, cfg, nthreads=ncpu)
        out = []
        for line in lines:
            cols = line.split("\t")
            start = int(cols[1]) + lo
            if core_lo <= start < core_hi:
                cols[1] = str(start)
                cols[2] = str(int(cols[2]) + lo)
                out.append("\t".join(cols))
        return out

    with ThreadPoolExecutor(max_workers=workers) as ex:
        results = list(ex.map(run_chunk, tasks))
    lines: List[str] = []
    for r in results:
        lines.extend(r)
    return lines


def process_fasta_records(path: str, cfg: RibbitConfig,
                          scan_backend: str = "host", engine: str = "core",
                          workers: Optional[int] = None,
                          chunk_size: Optional[int] = None,
                          skip=None):
    """Stream (name, length, lines) per FASTA record, in file order.

    Contigs are independent units in the reference (ribbit.cpp:269-280), so
    they fan out over a thread pool with byte-identical output.  The native
    core releases the GIL, so Python threads scale.  `skip` is an optional
    set of contig names to pass over (resume support) — skipped records
    yield (name, length, None)."""
    import os
    from concurrent.futures import ThreadPoolExecutor
    from .fasta import read_fasta

    records = list(read_fasta(path))
    ncpu = os.cpu_count() or 1
    todo = [(i, sid, seq) for i, (sid, seq) in enumerate(records)
            if not (skip and sid in skip)]
    if workers is None:
        workers = min(ncpu, len(todo)) or 1

    if (engine == "core" and scan_backend == "device"
            and not os.environ.get("RIBBIT_PY_REFINE")):
        # device-producer / host-consumer overlap: ONE thread drives the
        # device (extraction for contig k+1 proceeds while the host replays
        # and refines contig k); the host side uses all cores per contig
        yield from _fasta_records_device_overlap(records, todo, cfg)
        return

    # the device is a serial resource: device runs outside the overlap
    # path (the Python engine or Python refinement) stay serial so pool
    # threads never interleave device extraction
    serial = (engine != "core" or workers <= 1 or len(todo) <= 1
              or scan_backend == "device")

    def run_one(rec):
        _i, sid, seq = rec
        if engine == "core" and scan_backend == "host" and chunk_size \
                and len(seq) > chunk_size + chunk_size // 2:
            # long contigs: bounded-memory chunked processing, byte-exact
            # at any cut (per-chunk event capture + stitch + one global
            # lattice replay)
            return process_sequence_chunked(sid, seq, cfg,
                                            chunk_size=chunk_size)
        # deliberately oversubscribe: contig sizes are highly imbalanced
        # and work-conserving scheduling beats static core partitioning
        return process_sequence(sid, seq, cfg, scan_backend=scan_backend,
                                engine=engine,
                                nthreads=0 if serial else ncpu)

    if serial:
        todo_ids = {t[0] for t in todo}
        for i, (sid, seq) in enumerate(records):
            yield sid, len(seq), (run_one((i, sid, seq))
                                  if i in todo_ids else None)
    else:
        # yield incrementally in file order so callers can checkpoint each
        # contig as it completes
        with ThreadPoolExecutor(max_workers=workers) as ex:
            futs = {t[0]: ex.submit(run_one, t) for t in todo}
            for i, (sid, seq) in enumerate(records):
                f = futs.get(i)
                yield sid, len(seq), (f.result() if f is not None else None)


def _fasta_records_device_overlap(records, todo, cfg: RibbitConfig):
    """--backend device pipeline: a single device thread streams contigs
    through the event extractor (the device is a serial resource) while
    the calling thread replays/refines the previous contig's events on all
    host cores.  Output order and bytes match the serial host path exactly
    (events are bit-identical; the replay is per contig).  A device error
    propagates out of the generator and ends the run."""
    import os
    import time
    from concurrent.futures import ThreadPoolExecutor
    from .core import MAX_CONTIG, CoreSession
    from .eventstitch import scan_events_segmented

    ncpu = os.cpu_count() or 1
    timing = bool(os.environ.get("RIBBIT_CORE_TIMING"))
    _OVERCAP = object()           # consume via process_sequence instead

    def extract(rec):
        _i, sid, seq = rec
        if not seq:
            return None
        if len(seq) >= MAX_CONTIG:
            # past the native core's i32 range: process_sequence routes
            # through the over-cap chunked path
            return _OVERCAP
        t0 = time.perf_counter()
        code, n_mask = encode(seq)
        t1 = time.perf_counter()
        events = scan_events_segmented(code, n_mask, cfg)
        if timing:
            print(f"[device] {sid}: encode {t1 - t0:.3f}s "
                  f"extract {time.perf_counter() - t1:.3f}s", file=sys.stderr)
        return code, n_mask, events

    # bounded prefetch: at most PREFETCH contigs' extracted events are held
    # beyond the one being consumed (an eager submit-all would accumulate
    # every contig's event streams — ~50 B/bp — before the host catches up)
    PREFETCH = 2
    with ThreadPoolExecutor(max_workers=1) as dev:
        futs = {}
        submitted = 0
        consumed = 0

        def top_up():
            nonlocal submitted
            while submitted < len(todo) and submitted - consumed <= PREFETCH:
                t = todo[submitted]
                futs[t[0]] = dev.submit(extract, t)
                submitted += 1

        top_up()
        for i, (sid, seq) in enumerate(records):
            f = futs.pop(i, None)
            if f is None:
                yield sid, len(seq), None
                continue
            res = f.result()
            consumed += 1
            top_up()
            if res is None:                  # empty record
                yield sid, 0, []
                continue
            if res is _OVERCAP:
                yield sid, len(seq), process_sequence(sid, seq, cfg,
                                                      scan_backend="device")
                continue
            code, n_mask, events = res
            try:
                sess = CoreSession(code, n_mask, cfg, nthreads=ncpu)
            except RuntimeError:
                # native core unavailable: process_sequence degrades to the
                # Python engine with a warning (same as the serial path)
                yield sid, len(seq), process_sequence(sid, seq, cfg,
                                                      scan_backend="device")
                continue
            try:
                t0 = time.perf_counter()
                sess.set_events(*events)
                seeds = sess.scan()
                t1 = time.perf_counter()
                lines = sess.refine(seeds, seq, sid)
                if timing:
                    print(f"[host] {sid}: replay {t1 - t0:.3f}s refine "
                          f"{time.perf_counter() - t1:.3f}s", file=sys.stderr)
            finally:
                sess.close()
            yield sid, len(seq), lines


def process_fasta(path: str, cfg: RibbitConfig,
                  scan_backend: str = "host", engine: str = "core",
                  workers: Optional[int] = None,
                  chunk_size: Optional[int] = None) -> List[str]:
    """Whole-FASTA convenience wrapper: flat BED line list in file order."""
    lines: List[str] = []
    for _sid, _n, r in process_fasta_records(path, cfg, scan_backend, engine,
                                             workers, chunk_size):
        if r:
            lines.extend(r)
    return lines
