"""Device-batched diagonal voting for large-motif inference.

Brute-force device formulation of `mostFrequentLongerMotif`
(/root/reference/parse_seed.cpp:153-256; validated Python spec:
refine.py:_most_frequent_longer_motif_scalar, host AVX-512 production
implementation: csrc/ribbit_vote.c:ribbit_vote_longer).

The host voter's greedy +-2-jitter walk is a per-row sequential chain of
data-dependent gathers, a poor fit for wide vector hardware.  This module
changes the decomposition instead of fighting the gather:

  1. ALL match counts the walk could ever query are precomputed as one
     dense table per run,  C[row, cursor] = sum_{i<m} eq(code[row+i],
     code[cursor+i]) & !n[cursor+i] & [cursor+i < seed_end],  via a
     one-hot matmul: A[row, (i,base)] x B[cursor, (i,base)] contracted
     over 4*m — a [R, 4m] x [B, 4m]^T matrix product (exact: 0/1 bf16
     operands, f32 accumulation).  The b-side one-hot absorbs the
     n-mask and every clamp of the scalar spec:
       - downstream lim = min(m, seed_end-base, L-base, L-row) == zeroing
         b-side one-hots at positions >= min(seed_end, L) and a-side
         one-hots at positions >= L (parse_seed.cpp:163-181);
       - upstream lim never reaches seed_end for m > 2 so the same table
         serves both walks (parse_seed.cpp:184-202).
  2. Per-direction best-jitter tables  BestC/BestX[row, w] = strict-max
     over x in [-2,2] of C[row, w+x]  (first-max-wins scan order, the
     upstream c0 >= 0 gate folded in) are built once, vectorized over all
     cursors — so each greedy step of the walk needs ONE table lookup,
     not five match counts.
  3. The walks run for ALL candidate rows in parallel (rows are
     independent): state [nruns, R] cursors/counts/active in a
     lax.while_loop; the data-dependent lookup BestC[row, w_row] is a
     masked one-hot reduction over the cursor axis (no gather).
  4. The partial-prefix vote (parse_seed.cpp:205-233) and the
     first-strictly-highest-row winner rule run on the host from the
     returned (count, final_ustream) pairs: the prefix's reversed windows
     reduce to plain forward `match_count` calls (order-independent
     counting), so the host share is O(R * 5) AVX-512 counts per run.

Runs batch by (ssl, m) pow2 buckets; each bucket is one jit.  Exactness
is differential-tested against the scalar spec and the native voter
(tests/test_vote_device.py); tools/voter_device_bench.py times it
against the AVX-512 host voter on the chromosome-fixture workload
(RIBBIT_VOTE_DUMP).

Not on the production path: refinement uses the host voter.  Structural
reasons: the median vote run costs the host microseconds thanks to the
early-abort greedy walk, below any device dispatch + table-build
granularity, and the big runs pay O(ssl^2) table materialization plus
~2*ssl/m sequential banded-walk iterations against the host's
early-aborted O(visited * m/64) popcounts.  The module stays as the
reference device formulation.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


def _pow2_at_least(x: int, lo: int) -> int:
    p = lo
    while p < x:
        p <<= 1
    return p


def bucket_of(ssl: int, m: int) -> Tuple[int, int]:
    """(ssl_pad, m_pad) bucket for one run."""
    return _pow2_at_least(ssl, 128), _pow2_at_least(m, 16)


def _count_table(codew, nmaskw, m_n, ssl_n, *, m_pad, R_pad, B_pad):
    """The dense count table C[n, r, b] as a one-hot MXU matmul.

    codew[n, 0] is absolute position seed_start-2 of run n; out-of-contig
    positions carry sentinel code 4 (one-hot zero) with n-mask set.
    """
    # --- the dense count table C[n, r, b] (one-hot matmul) ---
    a_sl = [lax.dynamic_slice_in_dim(codew, 2 + i, R_pad, 1)
            for i in range(m_pad)]
    b_sl = [lax.dynamic_slice_in_dim(codew, i, B_pad, 1)
            for i in range(m_pad)]
    n_sl = [lax.dynamic_slice_in_dim(nmaskw, i, B_pad, 1)
            for i in range(m_pad)]
    A = jnp.stack(a_sl, axis=2)                       # [N, R, m_pad]
    B = jnp.stack(b_sl, axis=2)                       # [N, B, m_pad]
    NM = jnp.stack(n_sl, axis=2)

    i_iota = jnp.arange(m_pad, dtype=jnp.int32)
    base = jnp.arange(4, dtype=jnp.int32)
    m_b = m_n[:, None, None]                          # [N, 1, 1]
    # a-side: zero i >= m (the contraction runs to m, not m_pad); the L
    # clamp rides the sentinel (code 4 one-hots to zero)
    a_valid = i_iota[None, None, :] < m_b
    Aoh = ((A[..., None] == base) & a_valid[..., None])
    # b-side: n-mask + position < seed_end (window index w+i < ssl+2)
    w_iota = jnp.arange(B_pad, dtype=jnp.int32)
    b_valid = ((~NM) & ((w_iota[None, :, None] + i_iota[None, None, :])
                        < (ssl_n[:, None, None] + 2))
               & a_valid)
    Boh = ((B[..., None] == base) & b_valid[..., None])
    N = codew.shape[0]
    Af = Aoh.reshape(N, R_pad, 4 * m_pad).astype(jnp.bfloat16)
    Bf = Boh.reshape(N, B_pad, 4 * m_pad).astype(jnp.bfloat16)
    return jnp.einsum("nrk,nbk->nrb", Af, Bf,
                      preferred_element_type=jnp.float32).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("m_pad", "R_pad", "B_pad"))
def _vote_bucket_spec(codew, nmaskw, m_n, ssl_n, ss_n, *, m_pad, R_pad,
                      B_pad):
    """Reference bucket kernel: full-width walk over the unsheared table.

    Simple and obviously faithful to the spec; quadratic walk traffic
    (every step reduces over the whole cursor axis), so production uses
    _vote_bucket's sheared banded walk and this stays as the cross-check
    (tests/test_vote_device.py runs both)."""
    C = _count_table(codew, nmaskw, m_n, ssl_n,
                     m_pad=m_pad, R_pad=R_pad, B_pad=B_pad)
    w_iota = jnp.arange(B_pad, dtype=jnp.int32)

    # --- per-direction best-jitter tables over cursor position w ---
    # BestC[n, r, w] = strict max over x in -2..2 of gated C[n, r, w+x],
    # BestX the winning jitter (ties + all-zero keep -2): the scan order
    # IS the spec's strict-> update (parse_seed.cpp:169/190).
    ss_b = ss_n[:, None, None]

    def best_tables(gate_lo):
        bc = jnp.zeros_like(C)
        bx = jnp.full_like(C, -2)
        for x in range(-2, 3):
            if x < 0:
                cx = jnp.pad(C[:, :, :x], ((0, 0), (0, 0), (-x, 0)))
            elif x > 0:
                cx = jnp.pad(C[:, :, x:], ((0, 0), (0, 0), (0, x)))
            else:
                cx = C
            if gate_lo is not None:
                ok = (w_iota[None, None, :] + x) >= gate_lo
                cx = jnp.where(ok, cx, 0)
            upd = cx > bc
            bc = jnp.where(upd, cx, bc)
            bx = jnp.where(upd, x, bx)
        return bc, bx

    bc_dn, bx_dn = best_tables(None)
    # upstream gate: absolute cursor >= 0  <=>  w + x >= 2 - seed_start
    bc_up, bx_up = best_tables(2 - ss_b)

    r_iota = jnp.arange(R_pad, dtype=jnp.int32)[None, :]
    m_r = m_n[:, None]
    ssl_r = ssl_n[:, None]
    R_r = ssl_r - m_r + 1

    def lookup(tab, w):
        sel = w_iota[None, None, :] == w[:, :, None]
        return jnp.sum(jnp.where(sel, tab, 0), axis=2)

    def walk(bc_t, bx_t, w0, act0, step_sign):
        def cond(st):
            return jnp.any(st[2])

        def body(st):
            rc, w, act = st
            c = lookup(bc_t, w)
            x = lookup(bx_t, w)
            # inactive rows' lookups may miss (w out of range) -> x reads
            # 0; guard every update with act
            rc = rc + jnp.where(act, c, 0)
            w = w + jnp.where(act, x + step_sign * m_r, 0)
            if step_sign > 0:
                act = act & (w < ssl_r + 2)
            else:
                act = act & (w > 2)
            return rc, w, act

        rc0 = jnp.zeros_like(w0)
        return lax.while_loop(cond, body, (rc0, w0, act0))

    # downstream: first cursor row+m, active while cursor < seed_end
    w0_dn = r_iota + m_r + 2
    act0_dn = (r_iota < R_r - 1)
    rc_dn, _, _ = walk(bc_dn, bx_dn, w0_dn, act0_dn, +1)

    # upstream: first cursor row-m, active while cursor > seed_start
    w0_up = r_iota - m_r + 2
    act0_up = (w0_up > 2) & (r_iota < R_r)
    rc_up, w_up, _ = walk(bc_up, bx_up, w0_up, act0_up, -1)

    return rc_dn + rc_up, w_up, jnp.zeros(codew.shape[0], dtype=bool)


@functools.partial(jax.jit,
                   static_argnames=("m_pad", "R_pad", "B_pad", "w_band"))
def _vote_bucket(codew, nmaskw, m_n, ssl_n, ss_n, *, m_pad, R_pad, B_pad,
                 w_band=128):
    """Production bucket kernel: sheared lag-space tables + banded walk.

    The spec kernel's walk reduces over the whole cursor axis every step
    (O(R*B) traffic per step).  Key observation: in LAG space
    (j = cursor - row) every row starts a walk at the SAME column
    (row+m -> lag m), and each greedy step moves a row's lag by at most
    +-2 — so the rows' lags stay clustered and each step only needs a
    narrow band of the table.  This kernel:

      1. shears the count table to T[r, j] = C[r, r + j - LAM0] with the
         pad-flatten-reshape diagonal trick (one regular copy, no gather);
      2. builds the per-direction best-jitter tables in lag space, int8
         (counts <= m <= 100);
      3. walks with a re-centred dynamic band: per step the band start is
         the minimum active lag (clamped), a static w_band-wide slice of
         the tables is fetched, and the per-row lookup is a one-hot
         reduction over w_band instead of B;
      4. rows whose lag spread ever exceeds the band raise the run's
         overflow flag — the caller re-votes those runs on the host voter
         (exact fallback, counted by the bench).
    """
    N = codew.shape[0]
    C = _count_table(codew, nmaskw, m_n, ssl_n,
                     m_pad=m_pad, R_pad=R_pad, B_pad=B_pad)

    # --- shear: T[n, r, j] = C[n, r, r + j - LAM0] ---
    LAM0 = R_pad + 2
    Wd = LAM0 + B_pad
    D = Wd + 1
    Cp = jnp.pad(C.astype(jnp.int8), ((0, 0), (0, 0), (LAM0, 0)))
    flat = jnp.pad(Cp.reshape(N, R_pad * Wd), ((0, 0), (0, R_pad)))
    T = flat.reshape(N, R_pad, D)

    # --- best-jitter tables in lag space ---
    r_col = jnp.arange(R_pad, dtype=jnp.int32)[None, :, None]
    j_row = jnp.arange(D, dtype=jnp.int32)[None, None, :]
    ss_b = ss_n[:, None, None]

    def best_tables(upstream):
        bc = jnp.zeros_like(T)
        bx = jnp.full_like(T, -2)
        for x in range(-2, 3):
            if x < 0:
                tx = jnp.pad(T[:, :, :x], ((0, 0), (0, 0), (-x, 0)))
            elif x > 0:
                tx = jnp.pad(T[:, :, x:], ((0, 0), (0, 0), (0, x)))
            else:
                tx = T
            if upstream:
                # absolute cursor >= 0  <=>  r + (j - LAM0) + x >= 2 - ss
                ok = (r_col + j_row + x - LAM0) >= (2 - ss_b)
                tx = jnp.where(ok, tx, 0)
            upd = tx > bc
            bc = jnp.where(upd, tx, bc)
            bx = jnp.where(upd, jnp.int8(x), bx)
        return bc, bx

    bc_dn, bx_dn = best_tables(False)
    bc_up, bx_up = best_tables(True)

    r_iota = jnp.arange(R_pad, dtype=jnp.int32)[None, :]
    m_r = m_n[:, None]
    ssl_r = ssl_n[:, None]
    R_r = ssl_r - m_r + 1
    band_iota = jnp.arange(w_band, dtype=jnp.int32)[None, None, :]

    def slice_band(tab, start):
        return jax.vmap(
            lambda t, s: lax.dynamic_slice(t, (0, s), (R_pad, w_band))
        )(tab, start)

    def walk(bc_t, bx_t, j0, act0, step_sign):
        def cond(st):
            return jnp.any(st[2])

        def body(st):
            rc, j, act, ovf = st
            big = jnp.int32(1) << 30
            jmin = jnp.min(jnp.where(act, j, big), axis=1)
            start = jnp.clip(jmin, 0, D - w_band)
            off = j - start[:, None]
            ovf = ovf | jnp.any(act & ((off < 0) | (off >= w_band)), axis=1)
            offc = jnp.clip(off, 0, w_band - 1)
            sel = band_iota == offc[:, :, None]
            c = jnp.sum(jnp.where(sel, slice_band(bc_t, start), 0),
                        axis=2, dtype=jnp.int32)
            x = jnp.sum(jnp.where(sel, slice_band(bx_t, start), 0),
                        axis=2, dtype=jnp.int32)
            rc = rc + jnp.where(act, c, 0)
            j = j + jnp.where(act, x + step_sign * m_r, 0)
            w = r_iota + j - LAM0
            if step_sign > 0:
                act = act & (w < ssl_r + 2)
            else:
                act = act & (w > 2)
            return rc, j, act, ovf

        rc0 = jnp.zeros((N, R_pad), jnp.int32)
        ovf0 = jnp.zeros(N, dtype=bool)
        j0b = jnp.broadcast_to(j0, (N, R_pad))
        return lax.while_loop(cond, body, (rc0, j0b, act0, ovf0))

    # downstream: first cursor row+m (lag m+2+LAM0 for every row)
    j0_dn = m_r + (LAM0 + 2)
    act0_dn = r_iota < R_r - 1
    rc_dn, _, _, ovf_dn = walk(bc_dn, bx_dn, j0_dn, act0_dn, +1)

    # upstream: first cursor row-m
    j0_up = (LAM0 + 2) - m_r
    act0_up = (r_iota > m_r) & (r_iota < R_r)
    rc_up, j_up, _, ovf_up = walk(bc_up, bx_up, j0_up, act0_up, -1)

    w_up = r_iota + j_up - LAM0
    return rc_dn + rc_up, w_up, ovf_dn | ovf_up


def _prefix_counts_np(code: np.ndarray, n_mask: np.ndarray, seed_start: int,
                      ssl: int, m: int, ustream: np.ndarray) -> np.ndarray:
    """Partial-prefix votes (parse_seed.cpp:205-233) for all rows, numpy
    fallback for the native helper; `ustream` is each row's final upstream
    cursor.  Counting is order-independent, so the spec's reversed windows
    (rows/cols decreasing with i) are summed as forward ranges."""
    L = code.shape[0]
    seed_end = seed_start + ssl
    R = ustream.shape[0]
    out = np.zeros(R, dtype=np.int64)
    for r in range(R):
        us = int(ustream[r])
        if not (us < seed_start and seed_start - us < m):
            continue
        lastrow = seed_start + r + m - 1
        prefix_rows = m + (us - seed_start)
        best = 0
        for x in (-2, -1, 0, 1, 2):
            pc = us + m - 1 + x
            if pc >= seed_end or pc >= L or lastrow >= L:
                continue
            lim = min(prefix_rows, pc - seed_start + 1)
            if lim <= 0:
                continue
            a = code[lastrow - lim + 1:lastrow + 1]
            b = code[pc - lim + 1:pc + 1]
            nn = n_mask[pc - lim + 1:pc + 1]
            dc = int(((a == b) & ~nn).sum())
            if dc > best:
                best = dc
        out[r] = best
    return out


def _prefix_counts(code: np.ndarray, n_mask: np.ndarray, seed_start: int,
                   ssl: int, m: int, ustream: np.ndarray) -> np.ndarray:
    from .native import get_vote_lib
    lib = get_vote_lib()
    if lib is None or not hasattr(lib, "ribbit_vote_prefix_batch"):
        return _prefix_counts_np(code, n_mask, seed_start, ssl, m, ustream)
    import ctypes
    R = ustream.shape[0]
    out = np.zeros(R, dtype=np.int32)
    us = np.ascontiguousarray(ustream.astype(np.int32))
    lib.ribbit_vote_prefix_batch(
        code.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        n_mask.view(np.uint8).ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        code.shape[0], seed_start, ssl, m,
        us.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), R,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out.astype(np.int64)


def _pack_bucket(code: np.ndarray, n_mask: np.ndarray,
                 runs: Sequence[Tuple[int, int, int]],
                 ssl_pad: int, m_pad: int):
    """Stack one bucket's runs into padded window arrays."""
    L = code.shape[0]
    N = len(runs)
    W = ssl_pad + m_pad + 8
    codew = np.full((N, W), 4, dtype=np.int32)
    nmaskw = np.ones((N, W), dtype=bool)
    for j, (ss, ssl, m) in enumerate(runs):
        lo = ss - 2
        hi = min(ss + ssl + m + 2, L)
        src_lo = max(lo, 0)
        dst = src_lo - lo
        codew[j, dst:dst + hi - src_lo] = code[src_lo:hi]
        nmaskw[j, dst:dst + hi - src_lo] = n_mask[src_lo:hi]
    m_n = np.asarray([r[2] for r in runs], dtype=np.int32)
    ssl_n = np.asarray([r[1] for r in runs], dtype=np.int32)
    ss_n = np.asarray([r[0] for r in runs], dtype=np.int32)
    return codew, nmaskw, m_n, ssl_n, ss_n


def _host_index(code: np.ndarray, n_mask: np.ndarray,
                ss: int, ssl: int, m: int) -> int:
    """Exact host winner (band-overflow fallback): the native AVX-512
    voter, or the numpy spec when the native lib is unavailable."""
    from .native import get_vote_lib
    lib = get_vote_lib()
    if lib is not None:
        import ctypes
        return int(lib.ribbit_vote_longer(
            code.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            n_mask.view(np.uint8).ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint8)),
            code.shape[0], ss, ssl, m))
    # the numpy/scalar spec returns the packed unit, not the index;
    # recover the index by rescanning rows for the winning unit
    from .refine import most_frequent_longer_motif
    unit = most_frequent_longer_motif(code, n_mask, ss, ssl, m)
    for row in range(ss, ss + ssl - m + 1):
        u = 0
        for c in code[row:row + m].tolist():
            u = (u << 2) | int(c)
        if (u & ((1 << 256) - 1)) == unit:
            return row
    return 0


def batch_size_of(ssl_pad: int, bytes_cap: int = 384 << 20) -> int:
    """Runs per device batch, bounded by the sheared tables' footprint
    (~3 int8 tables of [R_pad, 2*R_pad+code]); fixed per bucket so each
    bucket compiles once."""
    per_run = ssl_pad * (2 * ssl_pad + 16) * 3
    return max(1, min(64, bytes_cap // max(per_run, 1)))


def vote_longer_batch(code: np.ndarray, n_mask: np.ndarray,
                      runs: Sequence[Tuple[int, int, int]],
                      impl: str = "banded", w_band: int = 128) -> List[int]:
    """Winning mmotif_index for each (seed_start, ssl, m) run.

    Semantics are exactly mostFrequentLongerMotif's: the device computes
    every row's downstream+upstream greedy vote totals, the host adds the
    partial-prefix vote and applies the first-strictly-highest-row rule
    (all-zero totals leave the index at 0, parse_seed.cpp:238-244).
    Runs whose banded walk overflows w_band re-vote on the host (exact).
    """
    out = [0] * len(runs)
    buckets: dict = {}
    for idx, (ss, ssl, m) in enumerate(runs):
        if ssl - m + 1 <= 0:
            continue                       # no candidate rows: index 0
        buckets.setdefault(bucket_of(ssl, m), []).append(idx)

    kern = _vote_bucket if impl == "banded" else _vote_bucket_spec
    for (ssl_pad, m_pad), idxs in sorted(buckets.items()):
        R_pad = ssl_pad
        B_pad = ssl_pad + 8
        max_batch = batch_size_of(ssl_pad)
        kw = dict(m_pad=m_pad, R_pad=R_pad, B_pad=B_pad)
        if impl == "banded":
            kw["w_band"] = w_band
        for at in range(0, len(idxs), max_batch):
            part = idxs[at:at + max_batch]
            # fixed batch shape per bucket: pad with repeats of run 0
            padded = [runs[i] for i in part]
            padded = padded + [padded[0]] * (max_batch - len(padded))
            codew, nmaskw, m_n, ssl_n, ss_n = _pack_bucket(
                code, n_mask, padded, ssl_pad, m_pad)
            rc, w_up, ovf = kern(
                jnp.asarray(codew), jnp.asarray(nmaskw), jnp.asarray(m_n),
                jnp.asarray(ssl_n), jnp.asarray(ss_n), **kw)
            rc = np.asarray(rc)
            w_up = np.asarray(w_up)
            ovf = np.asarray(ovf)
            for j, idx in enumerate(part):
                ss, ssl, m = runs[idx]
                if ovf[j]:
                    vote_longer_batch.overflows += 1
                    out[idx] = _host_index(code, n_mask, ss, ssl, m)
                    continue
                R = ssl - m + 1
                counts = rc[j, :R].astype(np.int64)
                ustream = (w_up[j, :R] + ss - 2).astype(np.int64)
                counts += _prefix_counts(code, n_mask, ss, ssl, m, ustream)
                if counts.max() > 0:
                    out[idx] = ss + int(np.argmax(counts))
    return out


vote_longer_batch.overflows = 0
