"""Exact-semantics re-implementation of the vendored SSW aligner
(ssw.c / ssw_cpp.cpp) used by the reference for CIGAR refinement.

The reference path is: striped SW forward pass (byte lanes, escalating to word
lanes on saturation) -> reverse pass to locate the alignment begin ->
banded affine-gap DP with doubling band width for the traceback ->
ConvertAlignment (soft clips) -> CalculateNumberMismatch ('M' -> '='/'X').

This module reproduces the same outputs with numpy:

  * forward/reverse passes are plain affine-gap local DP; byte-mode saturation
    is observable only via the escalate-at->=253 rule, and word mode saturates
    at 32767 — both reproduced by clamping H at 32767 (ssw.c:327-329, 844-854)
  * tie-breaking: end_ref = first column achieving a strictly larger max
    (ssw.c:321-334); end_read = smallest read index reaching the max within
    that column (ssw.c:342-351)
  * banded_sw ports the direction-preference and band-boundary quirks
    one-for-one (ssw.c:590-774)

Scoring is the reference default: match 2, mismatch -2, gapO 3, gapE 1,
N scores -2 against everything (ssw_cpp.cpp:27-52, 230-242).

The native aligner (csrc/ribbit_align.c) runs this in production; this
module is the semantics reference and the traceback engine.
"""

from __future__ import annotations

import dataclasses

import numpy as np

GAP_O = 3
GAP_E = 1
WORD_MAX = 32767

# 5x5 score matrix incl. N (ssw_cpp.cpp:27-52)
SCORE_MAT = np.full((5, 5), -2, dtype=np.int32)
for _i in range(4):
    SCORE_MAT[_i, _i] = 2

_TRANSLATE = np.full(128, 4, dtype=np.int8)
for _c, _v in zip("ACGTacgt", [0, 1, 2, 3, 0, 1, 2, 3]):
    _TRANSLATE[ord(_c)] = _v
# QUIRK: the reference's translation table maps 'U'/'u' to 0 (ssw_cpp.cpp:20,24)
_TRANSLATE[ord("U")] = 0
_TRANSLATE[ord("u")] = 0


def translate(seq: str) -> np.ndarray:
    raw = np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)
    return _TRANSLATE[raw & 0x7F]


@dataclasses.dataclass
class Alignment:
    sw_score: int = 0
    ref_begin: int = 0
    ref_end: int = 0
    query_begin: int = 0
    query_end: int = 0
    cigar_string: str = ""
    mismatches: int = 0


def _forward_pass(read: np.ndarray, ref: np.ndarray,
                  terminate: int = -1, record_best_col: bool = True):
    """One SW scan over ref columns.  Returns (max, end_ref, best_col_H,
    max_columns).  H is clamped at WORD_MAX, reproducing word-mode saturation;
    when max < 253 this equals the byte-mode exact result (see module doc).

    terminate >= 0 reproduces the reverse pass's early stop: break after the
    first column whose column-max equals `terminate` (ssw.c:339)."""
    R = read.shape[0]
    score_rows = SCORE_MAT[:, read]          # [5, R] per-ref-base score rows

    H = np.zeros(R, dtype=np.int32)
    E = np.zeros(R, dtype=np.int32)
    best = 0
    end_ref = -1
    best_col = H.copy()
    max_columns = np.zeros(ref.shape[0], dtype=np.int32)

    idx = np.arange(R, dtype=np.int32)
    for i in range(ref.shape[0]):
        diag = np.empty(R, dtype=np.int32)
        diag[0] = 0
        diag[1:] = H[:-1]
        diag += score_rows[ref[i]]
        np.minimum(diag, WORD_MAX, out=diag)

        h0 = np.maximum(diag, E)
        np.maximum(h0, 0, out=h0)
        # F via prefix-max: F[j] = max_{k<j} (h0[k] - GAP_O - (j-1-k)*GAP_E)
        # (opening from a gap-derived H never wins with GAP_O >= GAP_E)
        A = h0 + idx * GAP_E
        P = np.maximum.accumulate(A)
        F = np.empty(R, dtype=np.int32)
        F[0] = 0
        F[1:] = P[:-1] - GAP_O - (idx[1:] - 1) * GAP_E
        np.maximum(F, 0, out=F)
        Hn = np.maximum(h0, F)

        E = np.maximum(E - GAP_E, Hn - GAP_O)
        np.maximum(E, 0, out=E)
        H = Hn

        colmax = int(H.max()) if R else 0
        max_columns[i] = colmax
        if colmax > best:
            best = colmax
            end_ref = i
            if record_best_col:
                best_col = H.copy()
        if terminate >= 0 and colmax == terminate:
            break

    return best, end_ref, best_col, max_columns


def ssw_align(read: np.ndarray, ref: np.ndarray) -> Alignment | None:
    """ssw_align with flag=0x0f (always report begin + cigar), maskLen=15.

    read/ref: int8 arrays of translated codes (0..4)."""
    al = Alignment()
    R = read.shape[0]
    if R == 0 or ref.shape[0] == 0:
        return None

    score1, end_ref, best_col, _ = _forward_pass(read, ref)
    if end_ref < 0:
        # no positive-scoring cell; reference would emit cigarLen==0
        al.sw_score = 0
        al.ref_end = -1
        al.query_end = R - 1
        return al

    # end_read: smallest read index achieving the max in the best column
    end_read = int(np.flatnonzero(best_col == score1)[0])

    al.sw_score = score1
    al.ref_end = end_ref
    al.query_end = end_read

    # reverse pass over reversed prefixes with early termination at score1
    read_rev = read[:end_read + 1][::-1].copy()
    ref_rev = ref[:end_ref + 1][::-1].copy()
    _, end_ref_rev, best_col_rev, _ = _forward_pass(read_rev, ref_rev,
                                                    terminate=score1)
    # scanning order i=end_ref..0 maps to reversed index t = end_ref - i
    al.ref_begin = end_ref - end_ref_rev
    rev_read_idx = int(np.flatnonzero(best_col_rev == score1)[0])
    al.query_begin = end_read - rev_read_idx

    # banded traceback on the located subsequences (ssw.c:898-902)
    sub_ref = ref[al.ref_begin:al.ref_end + 1]
    sub_read = read[al.query_begin:al.query_end + 1]
    band_width = abs(sub_ref.shape[0] - sub_read.shape[0]) + 1
    ops = banded_sw(sub_ref, sub_read, score1, band_width)

    # ConvertAlignment (ssw_cpp.cpp:54-90) + CalculateNumberMismatch
    # (ssw_cpp.cpp:126-210)
    al.cigar_string, al.mismatches = _mark_mismatch(
        al, ref, read, R, ops)
    return al


def banded_sw(ref: np.ndarray, read: np.ndarray, score: int,
              band_width: int) -> list[tuple[int, str]]:
    """Literal port of banded_sw (ssw.c:590-774): banded global-ish affine DP
    with doubling band width, 3-plane direction tape, and the reference's
    direction tie-breaking.  Returns [(length, op)] with ops M/I/D.

    Row DP is vectorized over the band; the traceback is scalar."""
    refLen = ref.shape[0]
    readLen = read.shape[0]
    length = max(refLen, readLen)
    best = 0  # QUIRK: accumulates across band-doubling iterations (ssw.c:602)

    score_cols = SCORE_MAT[ref]              # [refLen, 5]

    while True:
        w = band_width
        width = w * 2 + 3
        width_d = w * 2 + 1

        # direction planes per row: [readLen, width_d, 3] int8
        # plane 0 = E ('I' moves), 1 = F ('D' moves), 2 = H
        dirs = np.zeros((readLen, width_d, 3), dtype=np.int8)

        # h_b / e_b persist across rows; the reference only writes back the
        # current band slice (ssw.c:668) and zeroes h_b[0]/e_b[0] and the
        # `edge` cell each row (ssw.c:634-635) — stale cells elsewhere are
        # part of the semantics.
        h_b = np.zeros(width, dtype=np.int64)
        e_b = np.zeros(width, dtype=np.int64)

        for i in range(readLen):
            beg = max(0, i - w)
            end = min(refLen - 1, i + w)
            # QUIRK: edge is min(end+1, width-1) in RAW j units, not band
            # coordinates (ssw.c:634) — for off==0 rows it happens to zero the
            # out-of-band neighbor; replicated as-is.
            edge = min(end + 1, width - 1)
            h_b[0] = e_b[0] = 0
            h_b[edge] = e_b[edge] = 0
            n = end - beg + 1
            js = np.arange(beg, end + 1)
            # band coordinate: u(i,j) = j - max(i-w,0) + 1  (set_u, ssw.c:92)
            off_i = max(i - w, 0)
            u = js - off_i + 1                       # current row coordinates
            off_im1 = max(i - 1 - w, 0)
            e_coord = js - off_im1 + 1               # (i-1, j)
            d_coord = js - 1 - off_im1 + 1           # (i-1, j-1)

            if i == 0:
                temp1 = np.full(n, -GAP_O, dtype=np.int64)
                temp2 = np.full(n, -GAP_E, dtype=np.int64)
            else:
                temp1 = h_b[e_coord] - GAP_O
                temp2 = e_b[e_coord] - GAP_E
            e_new = np.maximum(temp1, temp2)
            de = np.where(temp1 > temp2, 3, 2).astype(np.int8)

            diag = h_b[d_coord] + score_cols[js, read[i]]
            e1 = np.maximum(e_new, 0)

            # F along the row: f[j] = max(f[j-1]-GAP_E, h_c[j-1]-GAP_O) with
            # f=0 at row start and the h_c[0]=0 boundary for j==beg; a prefix
            # max computes the chain because opening from a gap-derived cell
            # never beats extending when GAP_O > GAP_E.
            h0 = np.maximum(e1, diag)
            hf = np.maximum(h0, 0)                   # h_c with its f1>=0 floor
            hprev = np.empty(n, dtype=np.int64)
            hprev[0] = 0
            hprev[1:] = hf[:-1]
            ar = np.arange(n, dtype=np.int64)
            A = hprev - GAP_O + ar * GAP_E
            Pm = np.maximum.accumulate(A)
            chain0 = -GAP_E * (ar + 1)               # from the f=0 row init
            f = np.maximum(Pm - ar * GAP_E, chain0)
            # direction: df[j] = 5 iff h_c[j-1]-GAP_O > f[j-1]-GAP_E
            f_prev = np.empty(n, dtype=np.int64)
            f_prev[0] = 0
            f_prev[1:] = f[:-1]
            df = np.where(hprev - GAP_O > f_prev - GAP_E, 5, 4).astype(np.int8)

            f1 = np.maximum(f, 0)
            tmp1 = np.maximum(e1, f1)
            h_c = np.maximum(tmp1, diag)

            rowmax = int(h_c.max()) if n else 0
            if rowmax > best:
                best = rowmax

            dh = np.where(tmp1 <= diag, np.int8(1),
                          np.where(e1 > f1, de, df))

            dcol = js - off_i                        # set_d coordinate = j - x
            dirs[i, dcol, 0] = de
            dirs[i, dcol, 1] = df
            dirs[i, dcol, 2] = dh

            # write back only the band slice (stale cells persist)
            e_b[u] = e_new
            h_b[u] = h_c

        band_width *= 2
        if not (best < score and band_width <= length):
            band_width //= 2
            break

    # ---- traceback (ssw.c:674-753) ----
    w = band_width
    i = readLen - 1
    j = refLen - 1
    e = 0
    ops: list[tuple[int, str]] = []
    op = prev_op = "M"
    plane = 2
    while i >= 0 and j > 0:
        dcol = j - max(i - w, 0)
        d = int(dirs[i, dcol, plane])
        if d == 1:
            i -= 1
            j -= 1
            plane = 2
            op = "M"
        elif d == 2:
            i -= 1
            plane = 0
            op = "I"
        elif d == 3:
            i -= 1
            plane = 2
            op = "I"
        elif d == 4:
            j -= 1
            plane = 1
            op = "D"
        elif d == 5:
            j -= 1
            plane = 2
            op = "D"
        else:
            return []  # trace back error; reference returns 0
        if op == prev_op:
            e += 1
        else:
            ops.append((e, prev_op))
            prev_op = op
            e = 1
    if op == "M":
        ops.append((e + 1, op))
    else:
        ops.append((e, op))
        ops.append((1, "M"))

    ops.reverse()
    return ops


def _mark_mismatch(al: Alignment, ref: np.ndarray, read: np.ndarray,
                   read_len: int, ops: list[tuple[int, str]]) -> tuple[str, int]:
    """CalculateNumberMismatch (ssw_cpp.cpp:126-210): split M into '='/'X' by
    re-walking the bases; soft-clip the unaligned read ends."""
    parts: list[str] = []
    if not ops:
        return "", 0
    if al.query_begin > 0:
        parts.append(f"{al.query_begin}S")

    rp = al.ref_begin
    qp = al.query_begin
    mismatches = 0
    run_len = 0
    run_op = ""

    def flush():
        nonlocal run_len, run_op
        if run_len:
            parts.append(f"{run_len}{run_op}")
        run_len = 0
        run_op = ""

    for length, op in ops:
        if op == "M":
            for _ in range(length):
                ch = "=" if ref[rp] == read[qp] else "X"
                if ch == "X":
                    mismatches += 1
                if run_op == ch:
                    run_len += 1
                else:
                    flush()
                    run_op = ch
                    run_len = 1
                rp += 1
                qp += 1
        elif op == "I":
            flush()
            parts.append(f"{length}I")
            qp += length
            mismatches += length
        elif op == "D":
            flush()
            parts.append(f"{length}D")
            rp += length
            mismatches += length
    flush()

    end = read_len - al.query_end - 1
    if end > 0:
        parts.append(f"{end}S")
    return "".join(parts), mismatches


def _ssw_align_native(read: np.ndarray, ref: np.ndarray, lib) -> Alignment | None:
    import ctypes
    out = (ctypes.c_int32 * 6)()
    cap = 4 * (read.shape[0] + ref.shape[0]) + 64
    buf = ctypes.create_string_buffer(cap)
    read = np.ascontiguousarray(read, dtype=np.int8)
    ref = np.ascontiguousarray(ref, dtype=np.int8)
    rc = lib.ribbit_align(
        read.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), read.shape[0],
        ref.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), ref.shape[0],
        out, buf, cap)
    if rc < 0 and read.shape[0] and ref.shape[0]:
        # capacity overflow or internal error: fall back to the Python engine
        return ssw_align(read, ref)
    if rc < 0:
        return None
    al = Alignment(sw_score=out[0], ref_begin=out[1], ref_end=out[2],
                   query_begin=out[3], query_end=out[4],
                   cigar_string=buf.value.decode("ascii"), mismatches=out[5])
    return al


def align_strings(query: str, ref: str) -> Alignment | None:
    """Aligner::Align(query, ref, ref_len, ...) (ssw_cpp.cpp:358-397).

    Uses the native C engine (csrc/ribbit_align.c) when available; the
    numpy implementation above is the semantics spec and fallback."""
    from .native import get_align_lib
    read, ref_t = translate(query), translate(ref)
    lib = get_align_lib()
    if lib is not None:
        return _ssw_align_native(read, ref_t, lib)
    return ssw_align(read, ref_t)
