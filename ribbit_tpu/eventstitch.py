"""Exact segment-wise event extraction: halo windows + event stitching.

The event extractors (scan_events_tpu on the device, capture_runs_host on
the host) produce,
for one sequence, the three compact event streams the native core replays
(perfect runs, threshold-7 window runs, threshold-6 overlay runs; see
scan_events_tpu.py and csrc/ribbit_core.c).  Whole-contig extraction
materializes O(NSHIFTS * L) intermediates on the device, which caps contig
length by HBM; this module removes the cap by extracting events per
SEGMENT and stitching the per-segment streams into the exact whole-contig
streams.

Exactness argument (the reason no N-run split points are needed, unlike
pipeline._choose_splits): every per-position mask value the extractor
computes has a bounded dependency cone in the sequence —

  eq[s][p]        depends on code[p], code[p+s], s <= max_shift (~102)
                  (fasta_utils.cpp:120-122)
  anchors[s][p]   additionally on the run containing p; anchor runs are
                  < 2*max_shift long and run-length saturation at 256
                  decides longer runs as non-anchors, so the cone is
                  +-(256 + max_shift) (parse_anchored_shiftxor.cpp:20-56)
  qual7/qual6[p]  window [p, p+8) of the above (window_length=8)
  perfect ps/pe   run-length tests saturate at >= 128 >= every cutoff
                  (parse_perfect_shiftxor.cpp:193: max cutoff = m <= 100)

so with HALO >= 512 every mask value inside a segment's core interval is
identical to the whole-contig value.  Runs are then reconstructed exactly:
each segment emits its mask-runs clipped to its core interval, and
adjacent segments' fragments that touch at a core boundary are merged.
For the length-filtered perfect stream, a globally-qualifying run whose
fragment intersects a core always has observed (in-window) length
>= min(true_length, HALO) >= cutoff, so the kernel-level filter already
keeps exactly the right fragments.

The stitched streams are bit-identical to whole-contig extraction
(tests/test_eventstitch.py), which makes BOTH the long-contig single-chip
device path and the distributed chunk path byte-exact: events are gathered
globally and the order-dependent scanner/lattice replay runs ONCE per
contig (O(events)), eliminating the chunk-local replay divergence through
the reference's positional-index vote quirk
(parse_anchored_shiftxor.cpp:441-526).
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np

from .config import RibbitConfig

# minimum exact halo is ~512 (see module doc); 2048 adds margin for free
HALO = 2048

# core length of one extraction window (plus HALO on each side).  On an
# H100 the XLA extractor's compiled peak at this window is ~8.7 GB, well
# under JAX's default preallocation; nmotifs * padded window stays below
# 2^31 so the kernel's flat indices fit int32.  Also the default chunk of
# the multi-device and host chunked paths.
SEG_SIZE = 8 << 20

Stream = Tuple[np.ndarray, np.ndarray, np.ndarray]   # starts, ends, offsets


def _channels_of(offsets: np.ndarray, n: int) -> np.ndarray:
    """Per-event channel ids from the channel-major offsets vector."""
    nm = offsets.shape[0] - 1
    return np.repeat(np.arange(nm, dtype=np.int64), np.diff(offsets))[:n]


def clip_stream(stream: Stream, lo: int, hi: int, base: int) -> Tuple[
        np.ndarray, np.ndarray, np.ndarray]:
    """Clip one segment's stream (window-local coordinates, window starts
    at global position `base`) to the core interval [lo, hi) and shift to
    global coordinates.  Returns flat (ch, starts, ends) arrays,
    channel-major sorted."""
    s, e, off = stream
    n = s.shape[0]
    ch = _channels_of(off, n)
    gs = s.astype(np.int64) + base
    ge = e.astype(np.int64) + base
    cs = np.maximum(gs, lo)
    ce = np.minimum(ge, hi)
    keep = cs < ce
    return ch[keep], cs[keep], ce[keep]


def merge_clipped(parts: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                  nmotifs: int) -> Stream:
    """Merge per-segment clipped fragments into the whole-contig stream.

    parts are in segment order; within a part events are channel-major and
    position-sorted.  A global run split at a core boundary appears as
    touching fragments (prev.end == next.start on the same channel) — they
    merge back into one event.  Everything re-sorts to channel-major."""
    if not parts:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy(), np.zeros(nmotifs + 1, dtype=np.int64)
    ch = np.concatenate([p[0] for p in parts])
    s = np.concatenate([p[1] for p in parts])
    e = np.concatenate([p[2] for p in parts])
    order = np.lexsort((s, ch))               # stable (ch, start) order
    ch, s, e = ch[order], s[order], e[order]
    if s.shape[0]:
        # fragments are non-overlapping maximal-run pieces, so touching
        # (e[k-1] == s[k]) only happens across a segment boundary
        new = np.ones(s.shape[0], dtype=bool)
        new[1:] = (ch[1:] != ch[:-1]) | (s[1:] != e[:-1])
        g = np.flatnonzero(new)
        last = np.append(g[1:], s.shape[0]) - 1
        ch, s, e = ch[g], s[g], e[last]
    offsets = np.searchsorted(ch, np.arange(nmotifs + 1)).astype(np.int64)
    return s, e, offsets


def segment_bounds(L: int, seg_size: int) -> List[int]:
    """Core-interval boundaries for segment streaming: [0, ..., L]."""
    if L <= seg_size:
        return [0, L]
    nseg = (L + seg_size - 1) // seg_size
    step = (L + nseg - 1) // nseg
    return list(range(0, L, step)) + [L]


def capture_runs_host(code: np.ndarray, n_mask: np.ndarray,
                      cfg: RibbitConfig, nthreads: int = 0) -> Tuple[
                          Stream, Stream, Stream]:
    """Host event extractor: the native core's threaded generation pass in
    run-capture mode (csrc/ribbit_core.c ribbit_core_capture_runs).  Same
    contract and bit-identical streams as the device extractors; used as
    the per-chunk extractor for the exact host chunked path."""
    from .core import CoreSession
    sess = CoreSession(code, n_mask, cfg, nthreads=nthreads)
    try:
        return sess.capture_runs()
    finally:
        sess.close()


def scan_events_segmented(code: np.ndarray, n_mask: np.ndarray,
                          cfg: RibbitConfig,
                          extractor: Callable = None,
                          seg_size: int = SEG_SIZE,
                          halo: int = HALO) -> Tuple[Stream, Stream, Stream]:
    """Whole-contig event streams via per-segment extraction + stitching.

    `extractor(code, n_mask, cfg) -> (perf, q7, q6)` runs on each halo-
    extended segment (defaults to the XLA device extractor).  Output is
    bit-identical to running the extractor on the whole contig, with
    device memory bounded by the segment size."""
    if extractor is None:
        from .scan_events_tpu import scan_events
        extractor = scan_events
    L = code.shape[0]
    bounds = segment_bounds(L, seg_size)
    if len(bounds) == 2:
        return extractor(code, n_mask, cfg)

    parts: List[List[Tuple[np.ndarray, np.ndarray, np.ndarray]]] = \
        [[], [], []]
    for i in range(len(bounds) - 1):
        lo, hi = bounds[i], bounds[i + 1]
        wlo, whi = max(0, lo - halo), min(L, hi + halo)
        streams = extractor(np.ascontiguousarray(code[wlo:whi]),
                            np.ascontiguousarray(n_mask[wlo:whi]), cfg)
        for j, st in enumerate(streams):
            parts[j].append(clip_stream(st, lo, hi, wlo))
    nm = cfg.nmotifs
    return tuple(merge_clipped(p, nm) for p in parts)
