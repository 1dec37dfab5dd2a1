"""Distributed contig processing over a device mesh: the chunk axis of
the sequence-parallel design IS the mesh axis.

A long contig splits into halo-extended windows at raw offsets (no N-run
split points needed), the windows pad to a common bucket and stack into
[nchunks, Lp] arrays sharded over a 1-D mesh; every device runs the
compact event-extraction kernel for its chunks via shard_map — the
O(NSHIFTS * L) scan stays on the devices, only sparse events come back.  The
per-chunk streams are clipped to their core intervals and stitched into
the exact whole-contig streams (eventstitch), and the order-dependent
scanner/lattice replay runs ONCE globally (O(events), cheap) before
threaded refinement.

Output is BYTE-IDENTICAL to the single-process whole-contig run — the
old per-chunk replay's exposure to the reference's positional-index vote
quirk (parse_anchored_shiftxor.cpp:441-526) is gone.  Event capacities
autotune: the kernel reports true counts past the cap, so an overflowing
attempt retries once with learned pow2 caps; a second overflow raises.
Tested on virtual CPU meshes of 1, 2, 4 and 8 devices against the
single-process path.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..config import RibbitConfig
from ..encode import encode
from ..eventstitch import (HALO, SEG_SIZE, clip_stream, merge_clipped,
                           segment_bounds)
from ..scan_events_tpu import _event_kernel, _next_cap, default_caps
from .sharded_scan import make_mesh

# learned event capacities per padded window length (shared across contigs;
# an overflow on one chunk trains every later same-bucket call)
_learned_caps: dict = {}


def _stack_windows(code: np.ndarray, n_mask: np.ndarray, bounds: List[int],
                   ndev: int, halo: int = HALO):
    """Halo-extended chunk windows padded to a common bucket and stacked;
    dummy all-N rows pad the chunk count to a device multiple."""
    L = code.shape[0]
    nchunks = len(bounds) - 1
    windows = [(max(0, bounds[i] - halo), min(L, bounds[i + 1] + halo))
               for i in range(nchunks)]
    npad = (-nchunks) % ndev
    total = nchunks + npad
    bucket = 1 << 14
    Lp_max = max(b - a for a, b in windows)
    Lp = ((Lp_max + bucket - 1) // bucket) * bucket

    codes = np.zeros((total, Lp), dtype=np.int8)
    nmasks = np.ones((total, Lp), dtype=bool)
    lens = np.zeros((total,), dtype=np.int32)
    for i, (a, b) in enumerate(windows):
        codes[i, :b - a] = code[a:b]
        nmasks[i, :b - a] = n_mask[a:b]
        lens[i] = b - a
    return windows, codes, nmasks, lens, Lp


def _sharded_extract(mesh, cfg: RibbitConfig, codes, nmasks, lens, Lp):
    """shard_map the event kernel over the chunk axis; autotune caps by
    retrying with learned pow2 capacities when a chunk overflows."""
    axis = mesh.axis_names[0]
    caps = _learned_caps.get(Lp, default_caps(Lp))
    codes_d, nmasks_d, lens_d = (jnp.asarray(codes), jnp.asarray(nmasks),
                                 jnp.asarray(lens))
    for _attempt in range(2):
        cap_p, cap_q7, cap_q6 = caps

        def one_chunk(c, n, ln):
            return _event_kernel(
                c, n, ln, min_shift=cfg.min_shift, nshifts=cfg.nshifts,
                min_motif=cfg.min_motif, max_motif=cfg.max_motif,
                cap_p=cap_p, cap_q7=cap_q7, cap_q6=cap_q6)

        sharded = jax.jit(jax.shard_map(
            jax.vmap(one_chunk), mesh=mesh,
            in_specs=(P(axis, None), P(axis, None), P(axis)),
            out_specs=(
                (P(axis), P(axis), P(axis), P(axis)),
                (P(axis), P(axis), P(axis), P(axis)),
                (P(axis), P(axis), P(axis), P(axis)),
            )))
        out = sharded(codes_d, nmasks_d, lens_d)

        # per-chunk true counts: reachable only via addressable shards in
        # multi-process mode; processes then agree on the retry decision
        # with an allgather of the three maxima
        def counts_max(arr):
            vals = [int(np.asarray(sh.data).max())
                    for sh in arr.addressable_shards if sh.data.size]
            return max(vals) if vals else 0

        maxima = tuple(counts_max(grp[3]) for grp in out)
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils
            maxima = tuple(int(x) for x in np.asarray(
                multihost_utils.process_allgather(
                    np.asarray(maxima))).max(axis=0))
        if all(mx <= cap for mx, cap in zip(maxima, caps)):
            return out
        caps = tuple(cap if mx <= cap else _next_cap(mx)
                     for mx, cap in zip(maxima, caps))
        _learned_caps[Lp] = caps
    raise OverflowError("event capacity autotune failed to converge")


def _chunk_streams(groups, i: int, nm: int):
    """Per-chunk (starts, ends, offsets) triple from the stacked arrays."""
    out = []
    for ch_b, s_b, e_b, cnt_b in groups:
        n = int(cnt_b[i])
        ch = ch_b[i, :n].astype(np.int64)
        s = s_b[i, :n].astype(np.int64)
        e = e_b[i, :n].astype(np.int64)
        offsets = np.searchsorted(ch, np.arange(nm + 1)).astype(np.int64)
        out.append((s, e, offsets))
    return out


def distributed_process_contig(sequence_id: str, sequence: str,
                               cfg: RibbitConfig,
                               chunk_size: int = SEG_SIZE,
                               n_devices: Optional[int] = None,
                               workers: Optional[int] = None) -> List[str]:
    """Process one contig: device-sharded scan + ONE exact global replay."""
    import os
    import sys
    from ..core import MAX_CONTIG, CoreSession
    from ..pipeline import process_sequence

    L = len(sequence)
    if L >= MAX_CONTIG:
        # the single exact global replay needs one whole-contig native
        # session; past the i32 cap fall back to the single-process
        # over-cap chunked path rather than raising
        print(f"ribbit-tpu: {sequence_id} exceeds 2^31-64 bp; distributed "
              "replay unavailable — using the single-process auto-chunk "
              "path", file=sys.stderr)
        return process_sequence(sequence_id, sequence, cfg)
    code, n_mask = encode(sequence)
    bounds = segment_bounds(L, chunk_size)
    nchunks = len(bounds) - 1
    if nchunks <= 1:
        return process_sequence(sequence_id, sequence, cfg)

    mesh = make_mesh(n_devices)
    windows, codes, nmasks, lens, Lp = _stack_windows(
        code, n_mask, bounds, mesh.devices.size)
    perf_b, q7_b, q6_b = _sharded_extract(mesh, cfg, codes, nmasks, lens, Lp)

    groups = [tuple(np.asarray(x) for x in grp)
              for grp in (perf_b, q7_b, q6_b)]
    nm = cfg.nmotifs
    parts = [[], [], []]
    for i in range(nchunks):
        wlo, _whi = windows[i]
        streams = _chunk_streams(groups, i, nm)
        for j, st in enumerate(streams):
            parts[j].append(clip_stream(st, bounds[i], bounds[i + 1], wlo))
    perf, q7, q6 = (merge_clipped(p, nm) for p in parts)

    ncpu = workers or os.cpu_count() or 1
    sess = CoreSession(code, n_mask, cfg, nthreads=ncpu)
    try:
        sess.set_events(perf, q7, q6)
        seeds = sess.scan()
        return sess.refine(seeds, sequence, sequence_id)
    finally:
        sess.close()
