"""Device event extraction (plain XLA): the producer for the native core.

Instead of shipping full [NSHIFTS, L] bitmaps to the host (scan_tpu.py), this
kernel computes the scan AND compacts it into the sparse event streams the
C consumers (csrc/ribbit_core.c) replay:

  - perfect runs: maximal runs of eq & ~N per motif channel with length >=
    the per-channel minimum branch cutoff (12-m for m<=6 else m) — a strict
    superset of what the perfect scanner emits; the host replay re-applies
    the exact branch rules (parse_perfect_shiftxor.cpp:146-226)
  - qualified-window runs at threshold 7 over raw eq (substitution scan) and
    threshold 6 over the anchored overlay (anchored scan)

Everything is fixed-shape prefix/suffix scans + one nonzero compaction per
stream, all int32/bool (results are exact on any backend); events transfer
as ~int32-sized arrays (MBs) instead of the O(NSHIFTS*L) bitmaps (GBs at
genome scale).  Compaction capacities autotune: the kernel reports true
counts even past the cap, so an overflow retries once with exactly-sized
caps and the learned sizes persist per length bucket (see scan_events).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .config import RibbitConfig, ANCHOR_SIZE, WINDOW_LENGTH
from .scan_tpu import _pad_to_bucket

I32 = jnp.int32


def _run_fields(mask, pos):
    """For a bool [C, L] mask: (start_flags, run_start, next_zero) where
    next_zero[p] = smallest q >= p with mask[q] == 0 (or L)."""
    Lp = mask.shape[1]
    prev = jnp.pad(mask[:, :-1], ((0, 0), (1, 0)))
    starts = mask & ~prev
    run_start = jax.lax.cummax(jnp.where(starts, pos[None, :], -1), axis=1)
    nz_src = jnp.where(~mask, pos[None, :], Lp)
    next_zero = jnp.flip(jax.lax.cummin(jnp.flip(nz_src, axis=1), axis=1),
                         axis=1)
    return starts, run_start, next_zero


def _compact_runs(start_flags, next_zero, cap):
    """(channels, starts, ends, count) for flagged run starts; rows are
    emitted channel-major so the host gets per-channel-sorted events."""
    count = start_flags.sum(dtype=I32)
    ch, pos = jnp.nonzero(start_flags, size=cap, fill_value=(-1, 0))
    ends = next_zero[jnp.clip(ch, 0, None), pos]
    return ch.astype(I32), pos.astype(I32), ends.astype(I32), count


@functools.partial(jax.jit,
                   static_argnames=("min_shift", "nshifts", "min_motif",
                                    "max_motif", "cap_p", "cap_q7", "cap_q6"))
def _event_kernel(code, n_mask, L, *, min_shift, nshifts, min_motif,
                  max_motif, cap_p, cap_q7, cap_q6):
    Lp = code.shape[0]
    pos = jnp.arange(Lp, dtype=I32)
    shifts = jnp.arange(min_shift, min_shift + nshifts, dtype=I32)
    nmotifs = max_motif - min_motif + 1
    motif_shifts = jnp.arange(min_motif, max_motif + 1, dtype=I32)

    # --- match bitmaps for all shifts (zero-tail rule; pads are N) ---
    max_shift = min_shift + nshifts - 1
    padded = jnp.concatenate([code, jnp.zeros(max_shift, dtype=code.dtype)])
    eq = (code[None, :] == padded[pos[None, :] + shifts[:, None]]) \
        & (pos[None, :] < L)

    # --- anchors per shift channel (parse_anchored_shiftxor.cpp:20-56) ---
    hi = (L - shifts)[:, None]
    b = eq & (pos[None, :] < hi)
    _, run_start_b, next_zero_b = _run_fields(b, pos)
    run_len_b = next_zero_b - run_start_b
    anchors = (b & (next_zero_b < hi) & (run_len_b >= ANCHOR_SIZE)
               & (run_len_b < 2 * shifts[:, None]))

    # --- per-motif views ---
    mch = motif_shifts - min_shift                      # channel idx per motif
    meq = eq[mch]                                       # [nmotifs, Lp]

    # anchored overlay: eq | anchors of neighbor shifts {m±1, m±2} clipped
    # to shift >= 1 (fasta_utils.cpp:145-161)
    overlay = meq
    for off in (-2, -1, 1, 2):
        nch = mch + off
        valid = (motif_shifts + off >= 1) & (nch >= 0) & (nch < nshifts)
        rolled = anchors[jnp.clip(nch, 0, nshifts - 1)]
        overlay = overlay | (rolled & valid[:, None])

    # --- perfect runs: eq & ~N, min branch cutoff per channel ---
    pmask = meq & ~n_mask[None, :]
    p_starts, p_run_start, p_next_zero = _run_fields(pmask, pos)
    p_len = p_next_zero - p_run_start
    cutoffs = jnp.where(motif_shifts <= 6, 12 - motif_shifts, motif_shifts)
    keep = p_starts & (p_len >= cutoffs[:, None])
    perf = _compact_runs(keep, p_next_zero, cap_p)

    # --- qualified-window runs (window 8; N windows never qualify) ---
    W = WINDOW_LENGTH
    ncs = jnp.cumsum(n_mask.astype(I32))
    nwin = ncs[W - 1:] - jnp.pad(ncs[:Lp - W], (1, 0))
    n_free = nwin == 0
    wpos = jnp.arange(Lp - W + 1, dtype=I32)
    in_range = wpos[None, :] < jnp.maximum(L - W + 1, 0)

    def qual_runs(bits, thr, cap):
        cs = jnp.cumsum(bits.astype(I32), axis=1)
        win = cs[:, W - 1:] - jnp.pad(cs[:, :Lp - W], ((0, 0), (1, 0)))
        q = (win >= thr) & n_free[None, :] & in_range
        starts, _, next0 = _run_fields(q, wpos)
        return _compact_runs(starts, next0, cap)

    q7 = qual_runs(meq, 7, cap_q7)
    q6 = qual_runs(overlay, 6, cap_q6)

    return perf, q7, q6


def _to_host(group, nmotifs):
    """(ch, starts, ends, count) device arrays -> (starts, ends, offsets)."""
    ch, s, e, count = group
    n = int(count)
    cap = ch.shape[0]
    if n > cap:
        raise OverflowError(f"event capacity exceeded: {n} > {cap}")
    ch = np.asarray(ch[:n]).astype(np.int64)
    s = np.asarray(s[:n]).astype(np.int64)
    e = np.asarray(e[:n]).astype(np.int64)
    offsets = np.searchsorted(ch, np.arange(nmotifs + 1)).astype(np.int64)
    return s, e, offsets


# learned event capacities per padded length: an overflow on one sequence
# trains the caps for every later sequence of that bucket (repeat-dense
# genomes pay the retry once)
_learned_caps: dict = {}


def default_caps(Lp: int):
    """Starting (perfect, q7, q6) compaction capacities for padded length
    Lp, before any overflow has taught larger ones."""
    return (max(Lp // 8, 1 << 14), max(Lp // 2, 1 << 14),
            max(3 * Lp, 1 << 15))


def _next_cap(count: int) -> int:
    """Power-of-two >= 1.25*count (pow2 rounding bounds recompilations)."""
    need = max(int(count * 1.25), 1 << 14)
    return 1 << (need - 1).bit_length()


def scan_events(code: np.ndarray, n_mask: np.ndarray, cfg: RibbitConfig):
    """Device scan -> ((perf_s, perf_e, perf_off), (q7...), (q6...)) for
    CoreSession.set_events.

    Capacities autotune: the kernel returns true event counts even when
    they exceed the compaction capacity, so an overflowing attempt is
    retried once with exactly-sized (pow2-rounded) caps and the learned
    sizes persist for subsequent sequences.  Raises OverflowError if the
    retry still overflows."""
    L = code.shape[0]
    Lp = _pad_to_bucket(L)
    code_p = np.zeros(Lp, dtype=np.int8)
    code_p[:L] = code
    n_p = np.ones(Lp, dtype=bool)
    n_p[:L] = n_mask

    caps = _learned_caps.get(Lp, default_caps(Lp))

    code_d, n_d = jnp.asarray(code_p), jnp.asarray(n_p)
    for _attempt in range(2):
        perf, q7, q6 = _event_kernel(
            code_d, n_d, jnp.int32(L),
            min_shift=cfg.min_shift, nshifts=cfg.nshifts,
            min_motif=cfg.min_motif, max_motif=cfg.max_motif,
            cap_p=caps[0], cap_q7=caps[1], cap_q6=caps[2])
        counts = (int(perf[3]), int(q7[3]), int(q6[3]))
        if all(c <= cap for c, cap in zip(counts, caps)):
            nm = cfg.nmotifs
            return _to_host(perf, nm), _to_host(q7, nm), _to_host(q6, nm)
        caps = tuple(cap if c <= cap else _next_cap(c)
                     for c, cap in zip(counts, caps))
        _learned_caps[Lp] = caps
    raise OverflowError(f"event capacity autotune did not converge: "
                        f"counts {counts} > caps {caps}")
