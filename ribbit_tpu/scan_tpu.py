"""Device (JAX/XLA) backend for the shift-XOR periodicity scan.

Computes, entirely on device, the same arrays as scan_host (the semantics
reference): match bitmaps for every shift channel, anchor bitmaps (closed
match runs of length in [ANCHOR_SIZE, 2*shift)), the per-motif anchored
overlay, and the qualified-window masks for the substitution (>=7 bits per
8-window) and anchored (>=6) scanners.  Reference semantics: fasta_utils.cpp
:120-161, parse_anchored_shiftxor.cpp:20-56, parse_substitute_shiftxor.cpp
:460-475.

Device mapping: everything is fixed-shape elementwise / gather / prefix-scan
work over a [NSHIFTS, L] lattice — XLA fuses the compare+mask chains and
lowers the (reverse) cumulative scans; there is no data-dependent control
flow.  Sequences are padded to LANE-multiple buckets so compilations are
cached per bucket, with the true length threaded as a traced scalar (padding
behaves as N).  Run/interval compaction for the host-side scanners lives in
scan_events_tpu.py; this module's full-bitmap outputs back the parity tests
against scan_host and the python engine's device backend.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .config import (RibbitConfig, ANCHOR_SIZE, WINDOW_LENGTH,
                     WINDOW_BITCOUNT_SUBSTITUTION, WINDOW_BITCOUNT_ANCHORED)

LANE = 8192  # padding bucket; compilations are cached per padded length


def _pad_to_bucket(L: int) -> int:
    return max(LANE, ((L + LANE - 1) // LANE) * LANE)


@functools.partial(jax.jit, static_argnames=("min_shift", "nshifts",
                                             "min_motif", "max_motif"))
def _scan_kernel(code: jax.Array, n_mask: jax.Array, L: jax.Array, *,
                 min_shift: int, nshifts: int, min_motif: int, max_motif: int):
    """code: int8[Lp] zero-padded; n_mask: bool[Lp] True on pads; L: true length.

    Returns (eq, anchors, overlay, qual7, qual6) at padded shapes; callers
    slice to the true length on the host."""
    Lp = code.shape[0]
    pos = jnp.arange(Lp, dtype=jnp.int32)
    shifts = jnp.arange(min_shift, min_shift + nshifts,
                        dtype=jnp.int32)            # [S]

    # --- match bitmaps (fasta_utils.cpp:120-122) ---
    # tail rule for p+shift >= L: the reference compares against shifted-in
    # zero bits; zero-padded code reproduces it because N also encodes 0.
    max_shift = min_shift + nshifts - 1
    padded = jnp.concatenate([code, jnp.zeros(max_shift, dtype=code.dtype)])
    gathered = padded[pos[None, :] + shifts[:, None]]          # [S, Lp]
    eq = (code[None, :] == gathered) & (pos[None, :] < L)

    # --- anchors (parse_anchored_shiftxor.cpp:20-56) ---
    # per channel: runs of matches restricted to positions [0, L-1-shift],
    # kept only when the run closes at a real 0 inside the range and its
    # length lies in [ANCHOR_SIZE, 2*shift)
    hi = (L - shifts)[:, None]                                  # [S, 1]
    b = eq & (pos[None, :] < hi)
    prev = jnp.pad(b[:, :-1], ((0, 0), (1, 0)))
    start_flag = b & ~prev
    run_start = jax.lax.cummax(jnp.where(start_flag, pos[None, :], -1), axis=1)
    # next_zero[p]: smallest q >= p with b[q] == 0 (suffix min scan)
    nz_src = jnp.where(~b, pos[None, :], Lp)
    next_zero = jnp.flip(jax.lax.cummin(jnp.flip(nz_src, axis=1), axis=1),
                         axis=1)
    run_len = next_zero - run_start
    anchors = (b & (next_zero < hi)
               & (run_len >= ANCHOR_SIZE) & (run_len < 2 * shifts[:, None]))

    # --- anchored overlay (fasta_utils.cpp:145-161) ---
    # motif channel m: eq | anchors of neighbor shifts {m-2, m-1, m+1, m+2}
    # clipped to shift >= 1; non-motif (padding) channels keep raw eq
    overlay = eq
    is_motif = (shifts >= min_motif) & (shifts <= max_motif)
    for off in (-2, -1, 1, 2):
        neighbor_ok = (shifts + off >= 1) & is_motif            # [S]
        rolled = jnp.roll(anchors, -off, axis=0)
        # channels rolled past the edge would wrap; mask them out
        ch = jnp.arange(nshifts)
        in_range = (ch + off >= 0) & (ch + off < nshifts)
        use = (neighbor_ok & in_range)[:, None]
        overlay = overlay | (rolled & use)

    # --- qualified windows (parse_substitute_shiftxor.cpp:433-475) ---
    # +1 window N-free and popcount >= threshold, 0 evaluated below
    # threshold, -1 window overlaps an N (scanner skips it)
    W = WINDOW_LENGTH
    nw = Lp - W + 1

    def window_quals(bits, threshold):
        cs = jnp.cumsum(bits.astype(jnp.int32), axis=1)
        win = cs[:, W - 1:] - jnp.pad(cs[:, :nw - 1], ((0, 0), (1, 0)))
        ncs = jnp.cumsum(n_mask.astype(jnp.int32))
        nwin = ncs[W - 1:] - jnp.pad(ncs[:nw - 1], (1, 0))
        out = jnp.where(win >= threshold, jnp.int8(1), jnp.int8(0))
        return jnp.where((nwin == 0)[None, :], out, jnp.int8(-1))

    qual7 = window_quals(eq, WINDOW_BITCOUNT_SUBSTITUTION)
    qual6 = window_quals(overlay, WINDOW_BITCOUNT_ANCHORED)

    return eq, anchors, overlay, qual7, qual6


def scan_arrays(code: np.ndarray, n_mask: np.ndarray, cfg: RibbitConfig):
    """Device scan -> host numpy arrays matching scan_host's contract:
    (eq, anchors, overlay) bool[NSHIFTS, L]; qual7/qual6 int8[NSHIFTS, L-7]
    (empty second dim when L < 8)."""
    L = code.shape[0]
    Lp = _pad_to_bucket(L)
    code_p = np.zeros(Lp, dtype=np.int8)
    code_p[:L] = code
    n_p = np.ones(Lp, dtype=bool)                   # pads behave as N
    n_p[:L] = n_mask

    eq, anchors, overlay, qual7, qual6 = _scan_kernel(
        jnp.asarray(code_p), jnp.asarray(n_p), jnp.int32(L),
        min_shift=cfg.min_shift, nshifts=cfg.nshifts,
        min_motif=cfg.min_motif, max_motif=cfg.max_motif)

    nq = max(L - WINDOW_LENGTH + 1, 0)
    return (np.asarray(eq)[:, :L], np.asarray(anchors)[:, :L],
            np.asarray(overlay)[:, :L], np.asarray(qual7)[:, :nq],
            np.asarray(qual6)[:, :nq])
