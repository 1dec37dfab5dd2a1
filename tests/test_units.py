"""Unit/property tests for the semantics-bearing building blocks:
shift-XOR scan arrays, bit utilities, the vectorized motif voter, the SSW
port, and CIGAR trimming (SURVEY.md §4 test strategy, items 3)."""

import numpy as np
import pytest

from ribbit_tpu import bitutils, scan_host
from ribbit_tpu.align import align_strings, ssw_align, translate
from ribbit_tpu.cigarproc import process_cigar_with_pruning
from ribbit_tpu.config import RibbitConfig
from ribbit_tpu.encode import encode, decode
from ribbit_tpu.refine import (most_frequent_longer_motif,
                               _most_frequent_longer_motif_scalar)


# ---------------------------------------------------------------------------
# encode / scan
# ---------------------------------------------------------------------------

def test_encode_roundtrip():
    seq = "ACGTNacgtRYK"
    code, n_mask = encode(seq)
    assert decode(code[:4]).upper() == "ACGT"
    assert n_mask.tolist() == [False] * 4 + [True] + [False] * 4 + [True] * 3
    # N behaves like code 0 in the bit-planes
    assert code[4] == 0


def test_match_bitmaps_vs_naive():
    rng = np.random.default_rng(1)
    cfg = RibbitConfig.create(min_motif=2, max_motif=12)
    L = 300
    code = rng.integers(0, 4, L).astype(np.int8)
    eq = scan_host.match_bitmaps(code, cfg)
    for c in range(cfg.nshifts):
        shift = cfg.min_shift + c
        for p in range(L):
            # reference semantics: positions past L-shift compare against
            # shifted-in zero bits (fasta_utils.cpp:120-122)
            want = (code[p] == code[p + shift]) if p + shift < L else (code[p] == 0)
            assert eq[c, p] == want, (shift, p)


def test_anchor_bitmaps_run_semantics():
    cfg = RibbitConfig.create(min_motif=2, max_motif=8)
    L = 60
    eq = np.zeros((cfg.nshifts, L), dtype=bool)
    shift = 5
    ch = shift - cfg.min_shift
    eq[ch, 3:6] = True        # run of 3 -> anchor (>= ANCHOR_SIZE)
    eq[ch, 10:12] = True      # run of 2 -> too short
    eq[ch, 20:31] = True      # run of 11 >= 2*shift -> too long
    eq[ch, 40:44] = True      # run of 4 -> anchor
    anchors = scan_host.anchor_bitmaps(eq, cfg)
    got = np.flatnonzero(anchors[ch]).tolist()
    assert got == [3, 4, 5, 40, 41, 42, 43]


def test_window_qualified_threshold_and_n_skip():
    bits = np.ones((1, 20), dtype=bool)
    bits[0, 4] = False
    n_mask = np.zeros(20, dtype=bool)
    n_mask[12] = True
    q = scan_host.window_qualified(bits, n_mask, 7)
    # windows covering position 12 are skipped (-1)
    assert set(q[0, 5:13].tolist()) == {-1}
    # window [0..7] has 7 set bits -> qualified
    assert q[0, 0] == 1


# ---------------------------------------------------------------------------
# bitutils
# ---------------------------------------------------------------------------

def test_repeat_class_rotation_invariance():
    rng = np.random.default_rng(2)
    for _ in range(200):
        m = int(rng.integers(2, 11))
        motif = int(rng.integers(0, 1 << (2 * m)))
        rc = bitutils.repeat_class(motif, m)
        mask = (1 << (2 * m)) - 1
        rots = []
        cur = motif
        for _ in range(m):
            cur = ((cur << 2) | (cur >> (2 * (m - 1)))) & mask
            rots.append(cur)
        assert rc == min(rots)
        for r in rots:
            assert bitutils.repeat_class(r, m) == rc


def test_atomicity():
    acac = bitutils.string_to_motif("ACAC")
    assert bitutils.atomicity(acac, 4) == 2
    acgt = bitutils.string_to_motif("ACGT")
    assert bitutils.atomicity(acgt, 4) == 4
    aaa = bitutils.string_to_motif("AAAAAA")
    assert bitutils.atomicity(aaa, 6) == 1
    # long variant: no divisibility requirement
    m = bitutils.string_to_motif("ACGACGACGAC")   # period 3, len 11
    assert bitutils.atomicity_long(m, 11) == 3


# ---------------------------------------------------------------------------
# motif voter: vectorized == scalar port
# ---------------------------------------------------------------------------

def test_motif_voter_vector_equals_scalar():
    rng = np.random.default_rng(3)
    for _ in range(60):
        L = int(rng.integers(60, 250))
        m = int(rng.integers(11, 35))
        motif = rng.integers(0, 4, m)
        seq = np.tile(motif, (L // m) + 2)[:L].astype(np.int8)
        muts = rng.integers(0, L, max(1, L // 8))
        seq[muts] = rng.integers(0, 4, muts.shape[0])
        n_mask = rng.random(L) < 0.03
        seq[n_mask] = 0
        ss = int(rng.integers(0, L - m))
        ssl = int(rng.integers(1, L - ss + 1))
        assert (most_frequent_longer_motif(seq, n_mask, ss, ssl, m, L)
                == _most_frequent_longer_motif_scalar(seq, n_mask, ss, ssl, m, L))


# ---------------------------------------------------------------------------
# SSW port
# ---------------------------------------------------------------------------

def _full_sw_score(read, ref, match=2, mismatch=-2, gapo=3, gape=1):
    """Brute-force full-matrix affine-gap local alignment score."""
    R, C = len(read), len(ref)
    NEG = -10 ** 9
    H = np.zeros((C + 1, R + 1), dtype=np.int64)
    E = np.full((C + 1, R + 1), NEG, dtype=np.int64)   # gap in ref (I)
    F = np.full((C + 1, R + 1), NEG, dtype=np.int64)   # gap in read (D)
    best = 0
    for i in range(1, C + 1):
        for j in range(1, R + 1):
            s = match if (ref[i - 1] == read[j - 1] and ref[i - 1] < 4
                          and read[j - 1] < 4) else mismatch
            E[i][j] = max(E[i][j - 1] - gape, H[i][j - 1] - gapo)
            F[i][j] = max(F[i - 1][j] - gape, H[i - 1][j] - gapo)
            H[i][j] = max(0, H[i - 1][j - 1] + s, E[i][j], F[i][j])
            best = max(best, H[i][j])
    return int(best)


def test_ssw_score_vs_bruteforce():
    rng = np.random.default_rng(4)
    bases = "ACGT"
    for _ in range(40):
        n1 = int(rng.integers(5, 60))
        n2 = int(rng.integers(5, 60))
        q = "".join(bases[i] for i in rng.integers(0, 4, n1))
        r = "".join(bases[i] for i in rng.integers(0, 4, n2))
        al = ssw_align(translate(q), translate(r))
        want = _full_sw_score(translate(q), translate(r))
        got = al.sw_score if al else 0
        assert got == want, (q, r)


def test_ssw_cigar_consistency():
    """CIGAR must consume the whole query (S+I+=+X == len) and the aligned
    reference span (D+=+X == ref_end-ref_begin+1)."""
    import re
    rng = np.random.default_rng(5)
    bases = "ACGT"
    for _ in range(40):
        motif = "".join(bases[i] for i in rng.integers(0, 4, 7))
        q = list(motif * 8)
        for k in rng.integers(0, len(q), 6):
            q[k] = bases[int(rng.integers(0, 4))]
        q = "".join(q)
        r = motif * 9
        al = align_strings(q, r)
        assert al is not None and al.cigar_string
        consumed_q = consumed_r = 0
        for ln, op in re.findall(r"(\d+)([MIDSX=])", al.cigar_string):
            ln = int(ln)
            if op in "SI=XM":
                consumed_q += ln
            if op in "D=XM":
                consumed_r += ln
        assert consumed_q == len(q)
        assert consumed_r == al.ref_end - al.ref_begin + 1


def test_perfect_repeat_alignment_is_all_match():
    al = align_strings("ACGACGACGACG", "ACGACGACGACGACG")
    assert al.cigar_string == "12="
    assert al.mismatches == 0


# ---------------------------------------------------------------------------
# CIGAR trim search
# ---------------------------------------------------------------------------

def test_cigar_pruning_pure():
    cfg = RibbitConfig.create()
    values, cigar, purity = process_cigar_with_pruning(
        100, 24, "24=", 4, cfg.minimum_length)
    start, end, alen, _ = values
    assert (start, end) == (100, 124)
    assert cigar == "24="
    assert float(purity) == 1.0


def test_cigar_pruning_trims_impure_edges():
    # 4 mismatches at the left edge of a 40-col alignment: purity 36/40=0.9
    # stays above 0.85 -> no trim; then push below threshold and expect a trim
    cfg = RibbitConfig.create()
    _, cigar, purity = process_cigar_with_pruning(
        0, 40, "6X34=", 4, cfg.minimum_length)
    assert float(purity) < 0.86
    assert cigar.endswith("=")


def test_refine_slice_invariance():
    """Refining the merged seed stream in contiguous slices and
    concatenating must equal one whole refine call (the property the
    multi-host seed fan-out relies on; per-seed independence)."""
    from ribbit_tpu.config import RibbitConfig
    from ribbit_tpu.core import CoreSession
    from ribbit_tpu.encode import encode
    from ribbit_tpu.sim import simulate

    cfg = RibbitConfig.create()
    seq = simulate(num_loci=10, seed=321, name="sl").sequence
    code, n_mask = encode(seq)

    def run(parts):
        sess = CoreSession(code, n_mask, cfg)
        try:
            seeds = sess.scan()
            if parts == 1:
                return sess.refine(seeds, seq, "sl")
            n = seeds.shape[0]
            out = []
            for k in range(parts):
                lo, hi = k * n // parts, (k + 1) * n // parts
                out.extend(sess.refine(seeds[lo:hi], seq, "sl"))
            return out
        finally:
            sess.close()

    assert run(3) == run(1)


def test_makefile_sources_match_core_compile_list():
    """The sanitizer targets install their instrumented .so under the
    SAME content hash native.py computes; a csrc file added to core.py's
    _compile list but not the Makefile silently breaks make asan/tsan/
    ubsan."""
    import pathlib
    import re

    repo = pathlib.Path(__file__).resolve().parents[1]
    core = (repo / "ribbit_tpu" / "core.py").read_text()
    m = re.search(r"_compile\(\[(.*?)\]\)", core, re.S)
    core_files = re.findall(r'"(ribbit_\w+\.c)"', m.group(1))

    mk = (repo / "Makefile").read_text()
    srcs = re.findall(r"csrc/(ribbit_\w+\.c)", mk.split("SRCS =")[1]
                      .split("\n\n")[0])
    assert sorted(srcs) == sorted(core_files), (srcs, core_files)

    for hash_list in re.findall(r"files=\[(.*?)\]", mk):
        files = re.findall(r"'(ribbit_\w+\.c)'", hash_list)
        assert files == core_files, (files, core_files)


def test_anch_vote_counter_fires_on_repeats():
    """The anchored coverage-vote counter (ribbit_core_anch_votes) must
    observe the positional j-indexed quirk sites firing on ordinary
    repeat-dense input — the measured evidence behind rejecting exact
    chunk-parallel lattice replay (NOTES_ROUND6.md: ~4,000 votes/Mb on
    the chromosome fixture, ~1,400/Mb even on uniform random DNA)."""
    from ribbit_tpu.config import RibbitConfig
    from ribbit_tpu.core import CoreSession
    from ribbit_tpu.encode import encode
    from ribbit_tpu.sim import simulate

    cfg = RibbitConfig.create()
    sim = simulate(num_loci=20, seed=31, name="votes")
    code, n_mask = encode(sim.sequence)
    sess = CoreSession(code, n_mask, cfg)
    try:
        assert sess.anch_votes() == 0          # fresh session
        sess.scan()
        assert sess.anch_votes() > 0           # quirk sites are pervasive
    finally:
        sess.close()
