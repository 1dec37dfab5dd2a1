/* ribbit_core: event-driven native core for the ribbit_tpu pipeline.
 *
 * Exact-semantics C implementation of the parity-critical sequential layers,
 * ported from the oracle-validated Python modules (which are themselves
 * rule-for-rule ports of the reference, citations inline):
 *
 *   - scan generation        <- ribbit_tpu/scan_host.py   (fasta_utils.cpp:120-161)
 *   - scanner state machines <- ribbit_tpu/events.py      (parse_*_shiftxor.cpp)
 *   - merge lattices         <- ribbit_tpu/lattice.py     (parse_*_shiftxor.cpp,
 *                                                          merge_types.cpp)
 *   - final 3-pointer merge  <- ribbit_tpu/pipeline.py    (fasta_utils.cpp:181-242)
 *
 * Design: the O(NSHIFTS * L) bitmap work is streamed channel-by-channel into
 * COMPACT EVENTS (perfect runs, qualified-window runs); the sequential
 * scanner/lattice replay then costs O(events), not O(L).  The same event
 * arrays can be produced by the device extractor (scan_events_tpu.py) and
 * injected, in which case generation here is skipped — the consumers are
 * identical.  Range popcount / longest-run queries (the lattices' retain
 * rules and refinement's guards) recompute bits on demand from the 2-bit
 * code, so no full bitmap is ever materialized or transferred.
 *
 * Python ints are modeled as int64_t; deliberate uint32_t wraparound quirks
 * from the reference are kept and marked QUIRK.
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>
#include <pthread.h>
#include <unistd.h>
#include <malloc.h>
#ifdef __AVX2__
#include <immintrin.h>
#endif

typedef int64_t i64;
typedef int32_t i32;

/* growth-path allocations have no recovery that preserves the output
 * contract; fail loudly instead of dereferencing NULL */
static void *xrealloc(void *p, size_t sz) {
    void *q = realloc(p, sz ? sz : 1);
    if (!q) { fprintf(stderr, "ribbit_core: out of memory\n"); abort(); }
    return q;
}

static void *xmalloc(size_t sz) {
    void *q = malloc(sz ? sz : 1);
    if (!q) { fprintf(stderr, "ribbit_core: out of memory\n"); abort(); }
    return q;
}

static void *xcalloc(size_t n, size_t sz) {
    void *q = calloc(n ? n : 1, sz ? sz : 1);
    if (!q) { fprintf(stderr, "ribbit_core: out of memory\n"); abort(); }
    return q;
}

/* Back large long-lived buffers with transparent huge pages (advisory; THP
 * 'madvise' mode).  The packed overlay cache alone is ~12.4 B/bp (~3 GB at
 * 250 Mb): with 4 KB pages its first-touch fault storm lands inside the
 * threaded generation pass (mmap_sem contention was the prime suspect for
 * the 15-59 s generate wall variance at fixed work, NOTES_ROUND2 queue #4);
 * 2 MB pages cut the fault count 512x and the dTLB miss rate on every
 * later overlay query. */
#include <sys/mman.h>
static void advise_huge(void *p, size_t n) {
#ifdef MADV_HUGEPAGE
    const uintptr_t HP = (uintptr_t)2 << 20;
    uintptr_t a = ((uintptr_t)p + HP - 1) & ~(HP - 1);
    uintptr_t e = ((uintptr_t)p + n) & ~(HP - 1);
    if (e > a) madvise((void *)a, e - a, MADV_HUGEPAGE);
#else
    (void)p; (void)n;
#endif
}

/* phase-boundary RSS snapshot (diagnostics; RIBBIT_CORE_MEM) */
static void print_rss(const char *label) {
    FILE *st = fopen("/proc/self/status", "r");
    if (!st) return;
    char ln[256];
    while (fgets(ln, sizeof ln, st))
        if (!strncmp(ln, "VmRSS", 5))
            fprintf(stderr, "[core] rss.%-10s %s", label, ln + 6);
    fclose(st);
}

/* rank constants (global_variables.cpp:29-35) */
#define RANK_P 5
#define RANK_Q 4
#define RANK_S 3
#define RANK_F 2
#define RANK_C 1
#define RANK_A 0
#define RANK_N (-1)

#define ANCHOR_SIZE 3
#define WINDOW_LENGTH 8

/* ------------------------------------------------------------------ */
/* small vectors                                                      */
/* ------------------------------------------------------------------ */

typedef struct { i64 start, end, mlen, rank; } Seed;

typedef struct { Seed *d; i64 n, cap; } SeedList;

static void sl_init(SeedList *s) { s->d = NULL; s->n = 0; s->cap = 0; }
static void sl_free(SeedList *s) { free(s->d); s->d = NULL; s->n = s->cap = 0; }
static void sl_push(SeedList *s, Seed v) {
    if (s->n == s->cap) {
        s->cap = s->cap ? s->cap * 2 : 64;
        s->d = (Seed *)xrealloc(s->d, (size_t)s->cap * sizeof(Seed));
    }
    s->d[s->n++] = v;
}
static void sl_remove(SeedList *s, i64 idx) {
    memmove(s->d + idx, s->d + idx + 1,
            (size_t)(s->n - idx - 1) * sizeof(Seed));
    s->n--;
}

typedef struct { i64 *d; i64 n, cap; } IVec;
static void iv_init(IVec *v) { v->d = NULL; v->n = 0; v->cap = 0; }
static void iv_free(IVec *v) { free(v->d); v->d = NULL; v->n = v->cap = 0; }
static void iv_push(IVec *v, i64 x) {
    if (v->n == v->cap) {
        v->cap = v->cap ? v->cap * 2 : 64;
        v->d = (i64 *)xrealloc(v->d, (size_t)v->cap * sizeof(i64));
    }
    v->d[v->n++] = x;
}

/* event-run storage: positions fit i32 (create() requires L < 2^31-64;
 * chromosome-scale inputs are far below it) — halves the dominant
 * O(events) memory term at 250 Mb scale */
typedef struct { int32_t *d; i64 n, cap; } IV32;
static void iv32_free(IV32 *v) { free(v->d); v->d = NULL; v->n = v->cap = 0; }
static void iv32_push(IV32 *v, i64 x) {
    if (v->n == v->cap) {
        v->cap = v->cap ? v->cap * 2 : 64;
        v->d = (int32_t *)xrealloc(v->d, (size_t)v->cap * sizeof(int32_t));
    }
    v->d[v->n++] = (int32_t)x;
}

/* emissions from the scanner state machines: 16-byte record, positions
 * are i32 (per-contig limit 2^31 bp — an order of magnitude above the
 * longest real chromosome); within-channel order is the array order. */
typedef struct { i32 pos; i32 s, e; int16_t didx; uint8_t sub; uint8_t _pad; } Emis;
typedef struct { Emis *d; i64 n, cap; } EVec;
static void ev_init(EVec *v) { v->d = NULL; v->n = 0; v->cap = 0; }
static void ev_free(EVec *v) { free(v->d); v->d = NULL; v->n = v->cap = 0; }
static void ev_push(EVec *v, Emis e) {
    if (v->n == v->cap) {
        v->cap = v->cap ? v->cap * 2 : 256;
        v->d = (Emis *)xrealloc(v->d, (size_t)v->cap * sizeof(Emis));
    }
    v->d[v->n++] = e;
}
typedef struct { Emis e; i64 k; } EmisIdx;   /* k = generation order */

static int emis_cmp_idx(const void *pa, const void *pb) {
    const EmisIdx *a = (const EmisIdx *)pa, *b = (const EmisIdx *)pb;
    if (a->e.pos != b->e.pos) return a->e.pos < b->e.pos ? -1 : 1;
    if (a->e.didx != b->e.didx) return a->e.didx < b->e.didx ? -1 : 1;
    if (a->e.sub != b->e.sub) return a->e.sub < b->e.sub ? -1 : 1;
    return a->k < b->k ? -1 : (a->k > b->k ? 1 : 0);
}

/* stable (pos, didx, sub, generation) sort via an index-decorated temp */
static void emis_sort_stable(Emis *d, i64 n) {
    EmisIdx *t = (EmisIdx *)xmalloc((size_t)n * sizeof(EmisIdx));
    for (i64 k = 0; k < n; k++) { t[k].e = d[k]; t[k].k = k; }
    qsort(t, (size_t)n, sizeof(EmisIdx), emis_cmp_idx);
    for (i64 k = 0; k < n; k++) d[k] = t[k].e;
    free(t);
}

/* Streaming k-way merge of per-channel event vectors in global
 * (pos, didx, sub) order.  Per-channel vectors are chronological, which is
 * already (pos, sub)-sorted in practice; a per-channel stable qsort runs
 * only if a monotonicity violation is detected.  Equivalent to the global
 * stable sort events.py does (within-channel ties keep generation order),
 * but events stream straight into the lattices — the merged copy of the
 * (potentially multi-GB) event array is never materialized. */
typedef struct {
    EVec *per;
    i32 nch;
    i64 *head;
    uint64_t *heap;             /* (pos << 16) | channel: one compare per sift */
    i32 hn;
} EvMerge;

static void evm_sift_down(EvMerge *m) {
    i32 i = 0;
    uint64_t *h = m->heap;
    for (;;) {
        i32 l = 2 * i + 1, r = 2 * i + 2, sm = i;
        if (l < m->hn && h[l] < h[sm]) sm = l;
        if (r < m->hn && h[r] < h[sm]) sm = r;
        if (sm == i) break;
        uint64_t tmp = h[i]; h[i] = h[sm]; h[sm] = tmp;
        i = sm;
    }
}

/* per-channel chronological-order guarantee shared by the merge consumers:
 * vectors are generation-ordered, which is (pos, sub)-sorted in practice; a
 * stable-keyed qsort runs only on a detected monotonicity violation. */
static void ev_ensure_sorted(EVec *per, i32 nch) {
    for (i32 d = 0; d < nch; d++) {
        EVec *v = &per[d];
        int sorted = 1;
        for (i64 k = 1; k < v->n; k++) {
            if (v->d[k].pos < v->d[k - 1].pos ||
                (v->d[k].pos == v->d[k - 1].pos &&
                 v->d[k].sub < v->d[k - 1].sub)) {
                sorted = 0;
                break;
            }
        }
        if (!sorted)
            emis_sort_stable(v->d, v->n);
    }
}

static void u64heap_sift_down(uint64_t *h, i32 hn) {
    i32 i = 0;
    for (;;) {
        i32 l = 2 * i + 1, r = 2 * i + 2, sm = i;
        if (l < hn && h[l] < h[sm]) sm = l;
        if (r < hn && h[r] < h[sm]) sm = r;
        if (sm == i) break;
        uint64_t tmp = h[i]; h[i] = h[sm]; h[sm] = tmp;
        i = sm;
    }
}

static void u64heap_push(uint64_t *h, i32 *hn, uint64_t key) {
    i32 i = (*hn)++;
    h[i] = key;
    while (i > 0) {
        i32 parent = (i - 1) >> 1;
        if (h[i] < h[parent]) {
            uint64_t tmp = h[i]; h[i] = h[parent]; h[parent] = tmp;
            i = parent;
        } else break;
    }
}

static void evm_init(EvMerge *m, EVec *per, i32 nch) {
    m->per = per;
    m->nch = nch;
    m->head = (i64 *)calloc((size_t)nch, sizeof(i64));
    m->heap = (uint64_t *)malloc((size_t)nch * sizeof(uint64_t));
    m->hn = 0;
    ev_ensure_sorted(per, nch);
    for (i32 d = 0; d < nch; d++) {
        if (per[d].n == 0) continue;
        uint64_t key = ((uint64_t)per[d].d[0].pos << 16) | (uint64_t)d;
        i32 i = m->hn++;
        m->heap[i] = key;
        while (i > 0) {
            i32 parent = (i - 1) >> 1;
            if (m->heap[i] < m->heap[parent]) {
                uint64_t tmp = m->heap[i];
                m->heap[i] = m->heap[parent];
                m->heap[parent] = tmp;
                i = parent;
            } else break;
        }
    }
}

/* pop the global-minimum event; returns 0 when drained */
static int evm_next(EvMerge *m, Emis *out) {
    if (m->hn == 0) return 0;
    i32 d = (i32)(m->heap[0] & 0xFFFF);
    *out = m->per[d].d[m->head[d]];
    m->head[d]++;
    if (m->head[d] >= m->per[d].n) {
        m->heap[0] = m->heap[--m->hn];
    } else {
        m->heap[0] = ((uint64_t)m->per[d].d[m->head[d]].pos << 16)
                     | (uint64_t)d;
    }
    evm_sift_down(m);
    return 1;
}

/* peek the next event without consuming (for the EOF from_index quirk) */
static int evm_peek(EvMerge *m, Emis *out) {
    if (m->hn == 0) return 0;
    i32 d = (i32)(m->heap[0] & 0xFFFF);
    *out = m->per[d].d[m->head[d]];
    return 1;
}

static void evm_free(EvMerge *m) {
    free(m->head);
    free(m->heap);
}

/* ------------------------------------------------------------------ */
/* core handle                                                        */
/* ------------------------------------------------------------------ */

typedef struct RibbitCore {
    const int8_t *code;
    const uint8_t *nmask;
    i64 L;
    i32 min_motif, max_motif, min_shift, max_shift, nshifts, nmotifs;

    /* per-motif-channel events (index didx = m - min_motif) */
    IV32 *perf_s, *perf_e;      /* perfect runs of eq & ~n (len-filtered)   */
    IV32 *q7_s, *q7_e;          /* injected runs, threshold 7 (device path) */
    IV32 *q6_s, *q6_e;          /* injected runs, threshold 6 (device path) */
    EVec *q7_emis;              /* per-channel emissions streamed during
                                 * generation (host path; runs never
                                 * materialize) */
    EVec *q6_emis;              /* only in the disorder-fallback mode */
    struct Q6Sink *q6_sink;     /* classified anchored emissions */
    struct WinSM *q7_sm, *q6_sm;
    int q6_evec_mode;           /* fallback: plain vectors instead of sinks */
    int capture_runs;           /* generation captures raw qualified runs
                                 * into q7_s/q7_e/q6_s/q6_e (the injected-
                                 * events representation) instead of
                                 * feeding the scanner state machines;
                                 * used by the exact chunked/distributed
                                 * paths (extract -> stitch -> one global
                                 * replay) */
    i64 *eval_lo, *eval_hi, *evseg_b;   /* wide-segment windows (shared) */
    i64 n_wide;
    int events_ready;

    /* N-free segments [a, b) */
    IVec seg_a, seg_b;

    SeedList perfect, substut, anchored;
    SeedList final_seeds;

    int overlay_phase;          /* bitcount source: 0 raw eq, 1 overlay     */

    /* reusable scratch vectors for the lattice hot paths (no recursion
     * during use: the tail-recursive rules are loops via goto restart) */
    IVec scr[19];

    /* packed overlay bitmaps per motif channel (bit p of word p>>6), built
     * during host generation; queries fall back to recompute when absent
     * (device-event path or very long sequences) */
    uint64_t **ov_pack;
    i64 ov_words;

    i32 nthreads;               /* 0 = auto (env RIBBIT_THREADS or ncpu) */

    /* streaming scan (ribbit_core_scan_stream): finalized merged seeds are
     * delivered to stream_cb during the anchored consume so refinement can
     * overlap the serial walk.  sm_* are the incremental 3-pointer merge
     * cursors (== count of entries already consumed from each list);
     * stream_poisoned flips when a positional RANK_C retag (the
     * parse_anchored_shiftxor.cpp:511-522 quirk) rewrites a list entry the
     * merge already emitted — the caller then discards streamed output and
     * re-merges/refines from the final lists (exact fallback). */
    void (*stream_cb)(void *arg, const i64 *seeds4, i64 n);
    void *stream_arg;
    int stream_poisoned;
    i64 sm_pi, sm_si, sm_ai;
    i64 sm_type;                /* persists like final_merge's smallest_type */

    /* count of anchored coverage-vote block executions (the positional
     * j-indexed quirk sites, parse_anchored_shiftxor.cpp:441-526).  These
     * are the ONLY lattice reads that reach back to the list heads; a
     * chunk-split replay is exact iff no chunk after the first executes
     * one (see parallel-replay notes in pipeline.py) */
    i64 anch_votes;
} RibbitCore;

static void iv_reset(IVec *v) { v->n = 0; }

/* ------------------------------------------------------------------ */
/* bit primitives (recompute-on-demand; fasta_utils.cpp:120-161)      */
/* ------------------------------------------------------------------ */

/* eq bit at position p for shift s: seq[p]==seq[p+s], tail compares the
 * shifted-in zero bits (N also encodes 0) */
static inline int eq_bit(const RibbitCore *c, i64 s, i64 p) {
    if (p + s < c->L) return c->code[p] == c->code[p + s];
    return c->code[p] == 0;
}

/* fill buf[0..len) with eq bits for positions [off, off+len) */
static void eq_fill(const RibbitCore *c, i64 shift, i64 off, i64 len,
                    uint8_t *buf) {
    i64 tail = c->L - shift;        /* positions >= tail use the zero rule */
    if (tail < off) tail = off;
    if (tail > off + len) tail = off + len;
    const int8_t *a = c->code + off, *b = c->code + off + shift;
    i64 n1 = tail - off;
    for (i64 i = 0; i < n1; i++) buf[i] = (a[i] == b[i]);
    for (i64 i = n1; i < len; i++) buf[i] = (c->code[off + i] == 0);
}

/* raw popcount of channel midx over [a, b) (pipeline._BitmapCounter:
 * start clamped at 0; numpy slicing clamps the end) */
static i64 bitcount_raw(const RibbitCore *c, i32 midx, i64 a, i64 b) {
    i64 shift = (i64)midx + c->min_shift;
    if (midx < 0) shift += c->nshifts;      /* python negative-index wrap */
    if (a < 0) a = 0;
    if (b > c->L) b = c->L;
    i64 cnt = 0;
    i64 tail = c->L - shift;
    if (tail < a) tail = a;
    if (tail > b) tail = b;
    const int8_t *p = c->code + a, *q = c->code + a + shift;
    i64 n1 = tail - a;
    for (i64 i = 0; i < n1; i++) cnt += (p[i] == q[i]);
    for (i64 i = n1; i < b - a; i++) cnt += (c->code[a + i] == 0);
    return cnt;
}

/* mark anchor bits of shift channel `shift` intersecting [a, b) into
 * buf[0..b-a) (OR-ing).  Anchors: maximal eq-runs within positions
 * [0, L-1-shift] that close at a real 0 inside the range, with length in
 * [ANCHOR_SIZE, 2*shift) — parse_anchored_shiftxor.cpp:20-56. */
static void anchors_mark(const RibbitCore *c, i64 shift, i64 a, i64 b,
                         uint8_t *buf) {
    i64 hi = c->L - shift;          /* exclusive scan bound */
    if (hi <= 0) return;
    i64 lo = a - 2 * shift;         /* a run covering `a` starts after this */
    if (lo < 0) lo = 0;
    i64 scan_end = b + 2 * shift;   /* a run covering b-1 closes before this */
    if (scan_end > hi) scan_end = hi;

    i64 p = lo;
    /* align to a run boundary: skip a possibly-straddled run prefix */
    if (p > 0 && eq_bit(c, shift, p - 1)) {
        while (p < scan_end && eq_bit(c, shift, p)) p++;
    }
    while (p < scan_end) {
        while (p < scan_end && !eq_bit(c, shift, p)) p++;
        if (p >= scan_end) break;
        i64 rs = p;
        while (p < hi && eq_bit(c, shift, p)) p++;
        if (p >= hi) break;         /* run hit the scan boundary: dropped */
        i64 re = p;                 /* closed at a real 0 (position re < hi) */
        i64 len = re - rs;
        if (len >= ANCHOR_SIZE && len < 2 * shift) {
            i64 ms = rs > a ? rs : a;
            i64 me = re < b ? re : b;
            for (i64 q = ms; q < me; q++) buf[q - a] = 1;
        }
    }
}

/* overlay bits of motif channel m over [a, b) into buf:
 * eq_m | anchors of neighbor shifts (fasta_utils.cpp:145-161) */
static void overlay_fill(const RibbitCore *c, i64 m, i64 a, i64 b,
                         uint8_t *buf) {
    eq_fill(c, m, a, b - a, buf);
    i64 lo = m > 2 ? m - 2 : 1;
    for (i64 i = lo; i <= m + 2; i++) {
        if (i == m) continue;
        anchors_mark(c, i, a, b, buf);
    }
}

static i64 pack_popcount(const uint64_t *w, i64 a, i64 b) {
    i64 wa = a >> 6, wb = (b - 1) >> 6;
    uint64_t first_mask = ~0ULL << (a & 63);
    uint64_t last_mask = (b & 63) ? ((1ULL << (b & 63)) - 1) : ~0ULL;
    if (wa == wb)
        return (i64)__builtin_popcountll(w[wa] & first_mask & last_mask);
    i64 cnt = (i64)__builtin_popcountll(w[wa] & first_mask);
    for (i64 i = wa + 1; i < wb; i++)
        cnt += (i64)__builtin_popcountll(w[i]);
    cnt += (i64)__builtin_popcountll(w[wb] & last_mask);
    return cnt;
}

/* longest run of 1-bits in packed words over [a, b) */
static i64 pack_longest_run(const uint64_t *words, i64 a, i64 b) {
    i64 best = 0, carry = 0;
    i64 wa = a >> 6, wb = (b - 1) >> 6;
    for (i64 i = wa; i <= wb; i++) {
        uint64_t w = words[i];
        if (i == wa && (a & 63)) w &= ~0ULL << (a & 63);
        if (i == wb && (b & 63)) w &= (1ULL << (b & 63)) - 1;
        if (w == ~0ULL) {
            carry += 64;
            if (carry > best) best = carry;
            continue;
        }
        if (w == 0) { carry = 0; continue; }
        i64 pre = (i64)__builtin_ctzll(~w);           /* ones at the bottom */
        if (carry + pre > best) best = carry + pre;
        uint64_t x = w;
        i64 len = 0;
        while (x) { x &= x << 1; len++; }
        if (len > best) best = len;
        carry = (i64)__builtin_clzll(~w);             /* ones at the top */
    }
    if (carry > best) best = carry;
    return best;
}

static i64 overlay_bitcount(const RibbitCore *c, i32 midx, i64 a, i64 b) {
    i64 shift = (i64)midx + c->min_shift;
    if (midx < 0) shift += c->nshifts;
    /* non-motif (padding) channels keep the raw bitmap in the overlay
     * array (scan_host.overlay_bitmaps overlays motif channels only) */
    if (shift < c->min_motif || shift > c->max_motif)
        return bitcount_raw(c, midx, a, b);
    if (a < 0) a = 0;
    if (b > c->L) b = c->L;
    if (b <= a) return 0;
    if (c->ov_pack && c->ov_pack[shift - c->min_motif])
        return pack_popcount(c->ov_pack[shift - c->min_motif], a, b);
    uint8_t *buf = (uint8_t *)malloc((size_t)(b - a));
    overlay_fill(c, shift, a, b, buf);
    i64 cnt = 0;
    for (i64 i = 0; i < b - a; i++) cnt += buf[i];
    free(buf);
    return cnt;
}

/* longest run of 1s in overlay channel over [a, b) (refine.py:
 * longest_continuous_matches over the sliced channel) */
static i64 overlay_longest_run(const RibbitCore *c, i32 midx, i64 a, i64 b) {
    i64 shift = (i64)midx + c->min_shift;
    if (midx < 0) shift += c->nshifts;
    if (a < 0) a = 0;
    if (b > c->L) b = c->L;
    if (b <= a) return 0;
    if (shift >= c->min_motif && shift <= c->max_motif
        && c->ov_pack && c->ov_pack[shift - c->min_motif])
        return pack_longest_run(c->ov_pack[shift - c->min_motif], a, b);
    uint8_t *buf = (uint8_t *)malloc((size_t)(b - a));
    if (shift < c->min_motif || shift > c->max_motif)
        eq_fill(c, shift, a, b - a, buf);
    else
        overlay_fill(c, shift, a, b, buf);
    i64 best = 0, cur = 0;
    for (i64 i = 0; i < b - a; i++) {
        if (buf[i]) { cur++; if (cur > best) best = cur; }
        else cur = 0;
    }
    free(buf);
    return best;
}

/* has-run-of->=3 query (the only longest-run question refinement asks:
 * parse_seed.cpp gates on CONTINUOUS_ONES_THRESHOLD == 3).  With the
 * packed overlay present it defers to the exact kernel; without it the
 * recompute runs in small chunks with early exit, so dropping the
 * ~12.4 B/bp overlay cache before refinement costs ~nothing. */
static int overlay_has_run3(const RibbitCore *c, i32 midx, i64 a, i64 b) {
    i64 shift = (i64)midx + c->min_shift;
    if (midx < 0) shift += c->nshifts;
    if (a < 0) a = 0;
    if (b > c->L) b = c->L;
    if (b <= a) return 0;
    if (shift >= c->min_motif && shift <= c->max_motif
        && c->ov_pack && c->ov_pack[shift - c->min_motif])
        return pack_longest_run(c->ov_pack[shift - c->min_motif], a, b) >= 3;
    uint8_t buf[512];
    i64 cur = 0;
    for (i64 p = a; p < b; p += (i64)sizeof(buf)) {
        i64 hi = p + (i64)sizeof(buf) < b ? p + (i64)sizeof(buf) : b;
        if (shift < c->min_motif || shift > c->max_motif)
            eq_fill(c, shift, p, hi - p, buf);
        else
            overlay_fill(c, shift, p, hi, buf);
        for (i64 i = 0; i < hi - p; i++) {
            if (buf[i]) { if (++cur >= 3) return 1; }
            else cur = 0;
        }
    }
    return 0;
}

static i64 core_bitcount(const RibbitCore *c, i32 midx, i64 a, i64 b) {
    return c->overlay_phase ? overlay_bitcount(c, midx, a, b)
                            : bitcount_raw(c, midx, a, b);
}

/* ------------------------------------------------------------------ */
/* event generation (scan_host.py semantics, streamed per channel)    */
/* ------------------------------------------------------------------ */

/* Generation is organized for compiler auto-vectorization: per-window sums
 * come from three log-shift byte-add passes, run candidates from log-shift
 * byte-AND passes, and only the (sparse) candidates are expanded by scalar
 * walks.  Motif channels are partitioned into contiguous blocks processed
 * by a thread pool; each worker recomputes the few boundary anchor
 * channels it needs, and writes only its own per-channel event vectors. */

#define GEN_PAD 16

/* s8[p] = popcount of b[p..p+7]; buffers padded with zeros past L.
 * One fused pass: the 8-term add vectorizes and touches 2 arrays instead
 * of the 6 a log-shift ladder streams (memory-bound at genome scale). */
static void win8_sums(const uint8_t *restrict b, uint8_t *restrict s2,
                      uint8_t *restrict s4, uint8_t *restrict s8, i64 L) {
    (void)s2;
    (void)s4;
    for (i64 p = 0; p < L; p++)
        s8[p] = (uint8_t)(b[p] + b[p + 1] + b[p + 2] + b[p + 3]
                          + b[p + 4] + b[p + 5] + b[p + 6] + b[p + 7]);
}

/* runs of q[0..n)==1 with zero-chunk skipping (qualified bytes are rare) */
static void byte_runs_skip(const uint8_t *q, i64 n, IVec *ss, IVec *ee) {
    i64 p = 0;
    while (p < n) {
        while (p + 8 <= n) {
            uint64_t w;
            memcpy(&w, q + p, 8);
            if (w) break;
            p += 8;
        }
        while (p < n && !q[p]) p++;
        if (p >= n) break;
        i64 s = p;
        while (p < n && q[p]) p++;
        iv_push(ss, s);
        iv_push(ee, p);
    }
}

/* one channel of the windowed scanner state machine
 * (events.py:_windowed_emissions) as a FEED-BASED state machine so the
 * generation pass can stream qualified runs straight into emissions
 * without materializing the run arrays (the dominant O(events) memory
 * term).  Qual runs are [ws, we) half-open over window indices and must
 * arrive in ascending order (they do: the tile pass closes runs left to
 * right and each channel is owned by one worker). */
/* Classified anchored-emission storage.  add_seed_anchored rejects any
 * emission with e - s < cutoff right after its cursor advance, and the
 * consume loop folds those (the ~16x majority on repeat-dense input)
 * into a running max of eligible end positions.  Classifying at
 * generation time stores the rejected majority as 8-byte (pos, end)
 * records instead of full emissions — the largest O(emissions) memory
 * term drops ~2x — while the surviving minority keeps full records plus
 * the two lookahead-dependent flags the consume loop needs. */
typedef struct { i32 pos, s, e; uint32_t nrej;  /* #rejected generated
                                                 * before this entry */
                 uint8_t sub, updates; uint16_t _pad; } SEmis;
/* surviving emissions: also consumed sequentially per channel (the merge
 * heap holds only the current head key), so stored as a varint stream:
 * varint((dpos << 2) | (sub << 1) | updates), varint(pos - e),
 * varint(e - s), varint(nrej - prev_nrej).  All four deltas are
 * nonnegative (pos and nrej are nondecreasing per channel; s <= e <= pos
 * at every emission site). */
typedef struct { uint8_t *d; i64 n, cap; i64 cnt; i32 prev_pos;
                 i64 prev_nrej; i64 prev_s; int s_desc; } SVec;
/* rejected emissions: consumed strictly sequentially per channel, so they
 * are stored as a delta/varint byte stream instead of 8-byte records —
 * varint(pos - prev_pos), varint(((pos - e) << 1) | eligible).  Both
 * deltas are nonnegative: (pos, sub) is monotone per channel and every
 * emission site sets pos >= e (pos = wf + W - 1 with wf > le = e; EOF
 * flushes use pos = L >= e). ~2.5 B/record vs 8 (15 -> ~4 B/bp). */
typedef struct { uint8_t *d; i64 n, cap; i64 cnt; i32 prev_pos;
                 i64 prev_e; int e_desc; } RVec;

static inline void sv_put(SVec *v, uint64_t x) {
    if (v->n + 10 > v->cap) {
        v->cap = v->cap ? v->cap + (v->cap >> 1) + 16 : 64;
        v->d = (uint8_t *)xrealloc(v->d, (size_t)v->cap);
    }
    while (x >= 0x80) { v->d[v->n++] = (uint8_t)(x | 0x80); x >>= 7; }
    v->d[v->n++] = (uint8_t)x;
}

static void sv_push(SVec *v, SEmis e) {
    sv_put(v, ((uint64_t)(e.pos - v->prev_pos) << 2)
              | ((uint64_t)e.sub << 1) | (uint64_t)e.updates);
    sv_put(v, (uint64_t)((i64)e.pos - e.e));
    sv_put(v, (uint64_t)((i64)e.e - e.s));
    sv_put(v, (uint64_t)(e.nrej - v->prev_nrej));
    v->prev_pos = e.pos;
    v->prev_nrej = e.nrej;
    /* the streaming merge watermark (min over channel heads of the next
     * surviving seed start) is only a valid bound on ALL future seed
     * starts when s is nondecreasing per channel; verified here, any
     * violation disables mid-consume streaming (exact, just unoverlapped) */
    if ((i64)e.s < v->prev_s) v->s_desc = 1;
    v->prev_s = e.s;
    v->cnt++;
}

typedef struct { const uint8_t *p, *end; i32 pos; i64 s, e, nrej;
                 int sub, updates, valid; } SDec;

static inline void sdec_next(SDec *r) {
    if (r->p >= r->end) { r->valid = 0; return; }
    uint64_t h, x = 0; int sh = 0; uint8_t b;
#define SDEC_GET(dst) do { x = 0; sh = 0; \
    do { b = *r->p++; x |= (uint64_t)(b & 0x7F) << sh; sh += 7; } \
    while (b & 0x80); (dst) = x; } while (0)
    SDEC_GET(h);
    r->pos += (i32)(h >> 2);
    r->sub = (int)((h >> 1) & 1);
    r->updates = (int)(h & 1);
    SDEC_GET(x); r->e = (i64)r->pos - (i64)x;
    SDEC_GET(x); r->s = r->e - (i64)x;
    SDEC_GET(x); r->nrej += (i64)x;
#undef SDEC_GET
}

static void sdec_init(SDec *r, const SVec *v) {
    r->p = v->d; r->end = v->d + v->n;
    r->pos = 0; r->s = 0; r->e = 0; r->nrej = 0;
    r->sub = 0; r->updates = 0; r->valid = 1;
    sdec_next(r);
}
static inline void rv_put(RVec *v, uint64_t x) {
    if (v->n + 10 > v->cap) {
        v->cap = v->cap ? v->cap + (v->cap >> 1) + 16 : 64;
        v->d = (uint8_t *)xrealloc(v->d, (size_t)v->cap);
    }
    while (x >= 0x80) { v->d[v->n++] = (uint8_t)(x | 0x80); x >>= 7; }
    v->d[v->n++] = (uint8_t)x;
}

static void rv_push(RVec *v, i32 pos, i64 e, int elig) {
    rv_put(v, (uint64_t)(pos - v->prev_pos));
    rv_put(v, ((uint64_t)(pos - e) << 1) | (uint64_t)elig);
    v->prev_pos = pos;
    /* e is nondecreasing per channel by construction (le never moves
     * back); verified here so the consume drain may fold only the LAST
     * eligible record of an episode.  A violation flips the channel to
     * the exact per-record fallback. */
    if (e < v->prev_e) v->e_desc = 1;
    v->prev_e = e;
    v->cnt++;
}

/* sequential decoder; `idx` = index of the current record, `p` points at
 * its SECOND varint (the (pos - e, elig) field), which is decoded lazily:
 * drains only need the LAST eligible record's e (per-channel e
 * monotonicity, verified at encode time), so the common path just scans
 * continuation bits.  elig is bit 0 of the second varint's first byte. */
typedef struct { const uint8_t *p, *end; i64 idx; i32 pos;
                 int valid, fast; } RDec;

static inline uint64_t vget(const uint8_t **pp) {
    uint64_t x = 0; int sh = 0; uint8_t b;
    do { b = *(*pp)++; x |= (uint64_t)(b & 0x7F) << sh; sh += 7; }
    while (b & 0x80);
    return x;
}

static inline void vskip(const uint8_t **pp) {
    while (*(*pp)++ & 0x80) { }
}

static inline void rdec_next(RDec *r) {
    vskip(&r->p);                      /* past current record's 2nd varint */
    if (r->p >= r->end) { r->valid = 0; return; }
    r->pos += (i32)vget(&r->p);
    r->idx++;
}

static void rdec_init(RDec *r, const RVec *v) {
    r->p = v->d; r->end = v->d + v->n;
    r->idx = 0; r->pos = 0;
    r->valid = v->n > 0;
    r->fast = !v->e_desc;
    if (r->valid) r->pos = (i32)vget(&r->p);
}

/* decode the saved record's e and fold it into *pend */
static inline void rdec_fold_saved(const uint8_t *save, i64 save_pos,
                                   i64 *pend) {
    if (save) {
        uint64_t de = vget(&save);
        i64 e = save_pos - (i64)(de >> 1);
        if (e > *pend) *pend = e;
    }
}

/* exact per-record fold for a channel whose e order was flagged */
static inline void rdec_fold_one(RDec *r, i64 *pend) {
    const uint8_t *q = r->p;
    uint64_t de = vget(&q);
    if ((de & 1) && (i64)r->pos - (i64)(de >> 1) > *pend)
        *pend = (i64)r->pos - (i64)(de >> 1);
}

typedef struct Q6Sink {
    i64 cutoff, L;
    SVec sv;
    RVec rj;
    Emis pend;                  /* one-entry lookahead (flags need the
                                 * next generated emission's sub) */
    int has_pend;
    i64 last_pos; int last_sub; /* (pos, sub) monotonicity check */
    int disorder;
} Q6Sink;

static void q6sink_final(Q6Sink *k, Emis em, int next_exists, int next_sub) {
    if (em.pos < k->last_pos ||
        (em.pos == k->last_pos && em.sub < k->last_sub))
        k->disorder = 1;        /* never expected; triggers regeneration */
    k->last_pos = em.pos; k->last_sub = em.sub;
    int follow = next_exists && next_sub == 1;
    if ((i64)em.e - em.s < k->cutoff) {
        /* QUIRK (EOF flush): only the sub=0 emission of a "save both
         * separately" pair advances from_indices
         * (parse_anchored_shiftxor.cpp:713 vs 688-717) */
        int elig = em.pos < k->L ? 1 : (em.sub == 0 && follow);
        rv_push(&k->rj, em.pos, (i64)em.e, elig);
    } else {
        SEmis s = {em.pos, em.s, em.e, (uint32_t)k->rj.cnt,
                   em.sub, (uint8_t)(em.sub == 0 && follow), 0};
        sv_push(&k->sv, s);
    }
}

static void q6sink_push(Q6Sink *k, Emis em) {
    if (k->has_pend) q6sink_final(k, k->pend, 1, em.sub);
    k->pend = em;
    k->has_pend = 1;
}

static void q6sink_flush(Q6Sink *k) {
    if (k->has_pend) q6sink_final(k, k->pend, 0, 0);
    k->has_pend = 0;
}

typedef struct WinSM {
    i64 cur, ls, le;            /* tracked seed state (window indices) */
    i64 k1, k2;                 /* monotone segment cursors */
    i64 m;
    i32 didx;
    int fed;                    /* zero runs -> zero emissions */
    EVec *out;                  /* plain sink (q7 / injected paths) */
    Q6Sink *q6;                 /* classified sink (anchored host path) */
    IV32 *cap_s, *cap_e;        /* capture mode: raw runs recorded here,
                                 * state machine bypassed */
} WinSM;

static inline void winsm_emit(WinSM *sm, Emis em) {
    if (sm->q6) q6sink_push(sm->q6, em);
    else ev_push(sm->out, em);
}

#define WIN_SENTINEL ((i64)1 << 60)

/* first_eval_after(x): smallest evaluated window index >= x+1.  Query
 * arguments (le) and run ends (we) are nondecreasing within a channel,
 * so both segment lookups advance monotone cursors instead of bisecting
 * per run. */
#define FIRST_EVAL_AFTER(sm, x, res) do { \
    while ((sm)->k1 < c->n_wide && c->eval_hi[(sm)->k1] < (x) + 1) (sm)->k1++; \
    if ((sm)->k1 >= c->n_wide) (res) = WIN_SENTINEL; \
    else (res) = ((x) + 1 > c->eval_lo[(sm)->k1]) ? (x) + 1 \
                                                  : c->eval_lo[(sm)->k1]; \
} while (0)

static void winsm_init(WinSM *sm, i64 m, i32 didx, EVec *out, Q6Sink *q6) {
    sm->cur = -1; sm->ls = -1; sm->le = -1;
    sm->k1 = 0; sm->k2 = 0;
    sm->m = m; sm->didx = didx; sm->fed = 0;
    sm->out = out;
    sm->q6 = q6;
    sm->cap_s = sm->cap_e = NULL;
}

/* shared evaluated-window intervals per wide segment: w in
 * [segA, segB - W]; channel-independent, built once after the N-free
 * segments are known */
static void build_eval_segments(RibbitCore *c) {
    const i64 W = WINDOW_LENGTH;
    c->eval_lo = (i64 *)xmalloc((size_t)(c->seg_a.n ? c->seg_a.n : 1)
                                * sizeof(i64));
    c->eval_hi = (i64 *)xmalloc((size_t)(c->seg_a.n ? c->seg_a.n : 1)
                                * sizeof(i64));
    c->evseg_b = (i64 *)xmalloc((size_t)(c->seg_a.n ? c->seg_a.n : 1)
                                * sizeof(i64));
    c->n_wide = 0;
    for (i64 i = 0; i < c->seg_a.n; i++) {
        if (c->seg_b.d[i] - c->seg_a.d[i] >= W) {
            c->eval_lo[c->n_wide] = c->seg_a.d[i];
            c->eval_hi[c->n_wide] = c->seg_b.d[i] - W;
            c->evseg_b[c->n_wide] = c->seg_b.d[i];
            c->n_wide++;
        }
    }
}

static void winsm_feed(RibbitCore *c, WinSM *sm, i64 ws, i64 we_excl) {
    if (sm->cap_s) {            /* capture mode: record the raw run */
        iv32_push(sm->cap_s, (i32)ws);
        iv32_push(sm->cap_e, (i32)we_excl);
        return;
    }
    const i64 W = WINDOW_LENGTH;
    i64 L = c->L;
    i32 didx = sm->didx;
    i64 we = we_excl - 1;         /* inclusive last qualified window */
    sm->fed = 1;

    if (sm->le != -1) {
        i64 wf;
        FIRST_EVAL_AFTER(sm, sm->le, wf);
        if (wf < ws) {
            Emis em = {.pos = (i32)(wf + W - 1), .s = (i32)(sm->ls), .e = (i32)(sm->le), .didx = (int16_t)didx, .sub = 0, ._pad = 0};
            winsm_emit(sm, em);
            sm->ls = sm->le = -1;
        }
    }
    if (sm->le != -1 && sm->le < ws) {
        Emis em = {.pos = (i32)(ws + W - 1), .s = (i32)(sm->ls), .e = (i32)(sm->le), .didx = (int16_t)didx, .sub = 0, ._pad = 0};
        winsm_emit(sm, em);
        sm->ls = sm->le = -1;
    }
    sm->cur = ws;

    /* locate this run's segment (monotone: we ascends across feeds) */
    while (sm->k2 < c->n_wide && c->eval_hi[sm->k2] < we) sm->k2++;
    i64 si = sm->k2;
    i64 seg_last_eval = c->eval_hi[si];
    if (we < seg_last_eval) {
        if (sm->ls == -1) sm->ls = sm->cur;
        sm->le = we + W;
        sm->cur = -1;
    } else {
        i64 sB = c->evseg_b[si];
        if (sB < L) {
            if (sm->le != -1 && sm->le < sB - (W - 1)) {
                Emis em = {.pos = (i32)(sB), .s = (i32)(sm->ls), .e = (i32)(sm->le), .didx = (int16_t)didx, .sub = 0, ._pad = 0};
                winsm_emit(sm, em);
                sm->ls = sm->le = -1;
            }
            sm->cur = -1;
        }
        /* else: sequence end with cur still tracking -> EOF in finish */
    }
}

static void winsm_finish(RibbitCore *c, WinSM *sm) {
    if (sm->cap_s) return;      /* capture mode: no emissions */
    const i64 W = WINDOW_LENGTH;
    i64 L = c->L;
    i32 didx = sm->didx;
    if (!sm->fed) return;         /* zero runs: no emissions at all */

    if (sm->le != -1 && sm->cur == -1) {
        i64 wf;
        FIRST_EVAL_AFTER(sm, sm->le, wf);
        if (wf < WIN_SENTINEL) {
            Emis em = {.pos = (i32)(wf + W - 1), .s = (i32)(sm->ls), .e = (i32)(sm->le), .didx = (int16_t)didx, .sub = 0, ._pad = 0};
            winsm_emit(sm, em);
            sm->ls = sm->le = -1;
        }
    }

    /* end-of-sequence flush (parse_substitute_shiftxor.cpp:534-574) */
    if (sm->le == -1) {
        if (sm->cur != -1) {
            Emis em = {.pos = (i32)(L), .s = (i32)(sm->cur), .e = (i32)(L), .didx = (int16_t)didx, .sub = 0, ._pad = 0};
            winsm_emit(sm, em);
        }
    } else {
        if (sm->cur == -1) {
            Emis em = {.pos = (i32)(L), .s = (i32)(sm->ls), .e = (i32)(sm->le), .didx = (int16_t)didx, .sub = 0, ._pad = 0};
            winsm_emit(sm, em);
        } else {
            if (sm->le >= sm->cur - sm->m) {
                Emis em = {.pos = (i32)(L), .s = (i32)(sm->ls), .e = (i32)(L), .didx = (int16_t)didx, .sub = 0, ._pad = 0};
                winsm_emit(sm, em);
            } else {
                Emis em1 = {.pos = (i32)(L), .s = (i32)(sm->ls), .e = (i32)(sm->le), .didx = (int16_t)didx, .sub = 0, ._pad = 0};
                winsm_emit(sm, em1);
                Emis em2 = {.pos = (i32)(L), .s = (i32)(sm->cur), .e = (i32)(L), .didx = (int16_t)didx, .sub = 1, ._pad = 0};
                winsm_emit(sm, em2);
            }
        }
    }
}

/* run-array front end for the injected-events path (scan_events_tpu) */
static void windowed_emissions(RibbitCore *c, const IV32 *qs, const IV32 *qe,
                               i64 m, i32 didx, EVec *out) {
    if (qs->n == 0) return;
    WinSM sm;
    winsm_init(&sm, m, didx, out, NULL);
    for (i64 r = 0; r < qs->n; r++)
        winsm_feed(c, &sm, qs->d[r], qe->d[r]);
    winsm_finish(c, &sm);
}

/* byte_runs_skip restricted to window tile [T0, W1) of the full domain
 * [0, nw), with the cross-tile open run carried in *open.  qb is
 * tile-local (qb[0] = window T0).  Emits exactly the runs the full-domain
 * pass emits, each in the tile where it is seen to close (a run closing
 * exactly at a tile boundary is emitted by the next tile — same values,
 * same per-channel order). */
static void tile_byte_runs(const uint8_t *qb, i64 T0, i64 W1, i64 nw,
                           i64 *open, RibbitCore *c, WinSM *sm) {
    i64 n = W1 - T0;
    i64 j = 0;
    if (*open >= 0) {
        while (j < n && qb[j]) j++;
        if (j < n) {
            winsm_feed(c, sm, *open, T0 + j);
            *open = -1;
        } else if (W1 == nw) {
            winsm_feed(c, sm, *open, nw);
            *open = -1;
            return;
        } else {
            return;                     /* run spans the whole tile */
        }
    }
    i64 p = j;
    while (p < n) {
        while (p + 8 <= n) {
            uint64_t w;
            memcpy(&w, qb + p, 8);
            if (w) break;
            p += 8;
        }
        while (p < n && !qb[p]) p++;
        if (p >= n) break;
        i64 s = p;
        while (p < n && qb[p]) p++;
        if (p == n && W1 < nw) {        /* may continue into the next tile */
            *open = T0 + s;
            return;
        }
        winsm_feed(c, sm, T0 + s, T0 + p); /* p==n with W1==nw: e = nw */
    }
}

/* next set byte at index >= p with zero-chunk skipping; returns n if none */
static inline i64 next_set_byte(const uint8_t *b, i64 p, i64 n) {
    while (p + 8 <= n) {
        uint64_t w;
        memcpy(&w, b + p, 8);
        if (w) break;
        p += 8;
    }
    while (p < n && !b[p]) p++;
    return p;
}

typedef struct {
    RibbitCore *c;
    i32 m_lo, m_hi;             /* motif block [m_lo, m_hi] inclusive */
    const uint8_t *n8;          /* shared per-window N counts */
} GenTask;

/* Tile size for the cache-blocked generation pass.  The 1-byte-per-
 * position working set of one worker (5 eq slots + 5 anchor slots +
 * overlay/pm/ladder/window temps, each ~TS + halo) is ~1 MB at 64 KB, so
 * every per-channel pass after the first runs out of L2/L3 instead of
 * streaming the whole chromosome through DRAM ~15x per channel.  Must be
 * a multiple of 64 (overlay pack words align to tile bounds). */
#define GEN_TS ((i64)1 << 16)

/* generation section profile (RIBBIT_CORE_PROF): eqfill, anchors, perfect,
 * q7 windows, overlay(+q6), packing — cycles summed across workers */
static inline int prof_on(void);            /* defined with the consume prof */
#if defined(__x86_64__)
#include <x86intrin.h>
#endif
static _Atomic long long g_genprof[6];
static const char *g_genprof_names[6] =
    {"eq", "anch", "perf", "q7", "ovl", "pack"};

static void *gen_worker(void *arg) {
    GenTask *t = (GenTask *)arg;
    long long gp[6] = {0, 0, 0, 0, 0, 0};
    int gp_on = prof_on();
#if defined(__x86_64__)
#define GP_T0(v) uint64_t v = gp_on ? __rdtsc() : 0
#define GP_ADD(slot, v) do { if (gp_on) gp[slot] += \
    (long long)(__rdtsc() - (v)); } while (0)
#else
#define GP_T0(v) uint64_t v = 0; (void)v; (void)gp_on
#define GP_ADD(slot, v) (void)(v)
#endif
    RibbitCore *c = t->c;
    i64 L = c->L;
    i64 nw = L - WINDOW_LENGTH + 1;
    i32 nm = c->nmotifs;
    const uint8_t *n8 = t->n8;

    i64 shift_lo = t->m_lo - 2;
    if (shift_lo < 1) shift_lo = 1;
    if (shift_lo < c->min_shift) shift_lo = c->min_shift;
    i64 maxs = (i64)t->m_hi + 2;

    /* halos: anchors scan [T0 - 2s - 1, T1 + 8 + 2s); windows read +7;
     * ladders look ahead +8.  One uniform halo for every shift keeps all
     * buffers on a single base offset. */
    const i64 TS = GEN_TS;
    const i64 HB = 2 * maxs + 1, HF = 2 * maxs + 8;
    const size_t BUFT = (size_t)(TS + HB + HF + 16);
    const size_t TBUF = (size_t)(TS + 24);

    uint8_t *ebuf[5], *abuf[5];
    i64 atag[5];
    for (int i = 0; i < 5; i++) {
        ebuf[i] = (uint8_t *)xcalloc(BUFT, 1);
        abuf[i] = (uint8_t *)xcalloc(TBUF, 1);
    }
    uint8_t *r3b = (uint8_t *)xcalloc(BUFT, 1);
    uint8_t *pmb = (uint8_t *)xcalloc(TBUF, 1);   /* pmb[0]: [T0-1] guard */
    uint8_t *r6b = (uint8_t *)xcalloc(TBUF, 1);
    uint8_t *obb = (uint8_t *)xcalloc(TBUF, 1);
    uint8_t *t8b = (uint8_t *)xcalloc(TBUF, 1);
    uint8_t *qbb = (uint8_t *)xcalloc(TBUF, 1);

    /* cross-tile open-run carry per channel */
    i64 *perf_open = (i64 *)xmalloc((size_t)nm * sizeof(i64));
    i64 *q7_open = (i64 *)xmalloc((size_t)nm * sizeof(i64));
    i64 *q6_open = (i64 *)xmalloc((size_t)nm * sizeof(i64));
    for (i32 d = 0; d < nm; d++) perf_open[d] = q7_open[d] = q6_open[d] = -1;

    for (i64 T0 = 0; T0 < L || T0 == 0; T0 += TS) {
        i64 T1 = T0 + TS < L ? T0 + TS : L;
        i64 base = T0 - HB;
        for (int i = 0; i < 5; i++) atag[i] = -1;

        for (i64 shift = shift_lo; shift <= maxs; shift++) {
            int slot = (int)(shift % 5);
            uint8_t *restrict eb = ebuf[slot];
            /* eq bytes for [glo, ghi) at offset `base`; zero elsewhere */
            i64 glo = base < 0 ? 0 : base;
            i64 ghi = T1 + HF < L ? T1 + HF : L;
            GP_T0(tg0);
            if (glo > base) memset(eb, 0, (size_t)(glo - base));
            memset(eb + (ghi - base), 0, (size_t)(T1 + HF + 8 - ghi));
            eq_fill(c, shift, glo, ghi - glo, eb + (glo - base));
            GP_ADD(0, tg0);
#define EQ(g) (eb[(g) - base])

            /* anchors intersecting [T0, T1+8): candidate 3-runs expanded
             * with closure + length rules (parse_anchored_shiftxor.cpp:
             * 20-56).  Exact tile restriction: a qualifying run has
             * len < 2*shift, so any run marking [T0, T1+8) starts after
             * T0 - 2*shift and closes before T1 + 8 + 2*shift; longer
             * runs are disqualified the moment the scan proves len >=
             * 2*shift, and a run still open at scan_end either lies
             * beyond the marking range or is disqualified by length. */
            GP_T0(ta0);
            uint8_t *restrict ab = abuf[slot];
            memset(ab, 0, TBUF);
            atag[slot] = shift;
            i64 hi = L - shift;
            if (hi > 0) {
                i64 a = T0, b = T1 + 8;
                i64 rlo = a - 2 * shift; if (rlo < 0) rlo = 0;
                i64 scan_end = b + 2 * shift; if (scan_end > hi) scan_end = hi;
                for (i64 g = rlo; g < scan_end; g++)
                    r3b[g - base] = EQ(g) & EQ(g + 1) & EQ(g + 2);
                i64 p = rlo;
                if (rlo > 0 && EQ(rlo - 1)) {     /* skip straddled run */
                    while (p < scan_end && EQ(p)) p++;
                }
                while (p < scan_end) {
                    i64 pl = next_set_byte(r3b, p - base, scan_end - base);
                    if (pl >= scan_end - base) break;
                    p = pl + base;
                    i64 s = p;
                    while (s > 0 && EQ(s - 1)) s--;
                    i64 e = p + 3;
                    while (e < scan_end && EQ(e)) e++;
                    if (e >= scan_end) break;     /* hit hi (dropped) or
                                                   * past relevance */
                    i64 len = e - s;
                    if (len >= ANCHOR_SIZE && len < 2 * shift) {
                        i64 ms = s > a ? s : a;
                        i64 me = e < b ? e : b;
                        if (me > ms)
                            memset(ab + (ms - T0), 1, (size_t)(me - ms));
                    }
                    p = e + 1;
                }
            }
            GP_ADD(1, ta0);

            i64 m = shift - 2;
            if (m < t->m_lo || m > t->m_hi) {
#undef EQ
                continue;
            }
#undef EQ
            i32 didx = (i32)(m - c->min_motif);
            const uint8_t *restrict ebm = ebuf[m % 5];
#define EQM(g) (ebm[(g) - base])

            /* perfect runs of eq & ~N with len >= min branch cutoff
             * (>= 6): candidate 6-runs + cross-tile carry
             * (parse_perfect_shiftxor.cpp:146-226) */
            i64 cutoff = m <= 6 ? 12 - m : m;
            {
                GP_T0(tp0);
                i64 P1 = T1 + 8 < L ? T1 + 8 : L;
                uint8_t *restrict pm = pmb + 1;
                pmb[0] = 0;
                for (i64 g = T0; g < P1; g++)
                    pm[g - T0] = EQM(g) & !c->nmask[g];
                memset(pm + (P1 - T0), 0, (size_t)(T1 + 8 - P1 + 8));
#define PM(g) (pm[(g) - T0])
                i64 j = T0;
                i64 open = perf_open[didx];
                if (open >= 0) {
                    while (j < T1 && PM(j)) j++;
                    if (j < T1 || T1 == L || !PM(T1)) {
                        if (j - open >= cutoff) {
                            iv32_push(&c->perf_s[didx], open);
                            iv32_push(&c->perf_e[didx], j);
                        }
                        perf_open[didx] = -1;
                    }
                    /* else: run spans the whole tile; stays open */
                }
                if (perf_open[didx] < 0) {
                    for (i64 g = j; g < T1; g++)
                        r6b[g - T0] = PM(g) & PM(g + 1) & PM(g + 2)
                                      & PM(g + 3) & PM(g + 4) & PM(g + 5);
                    i64 p = j;
                    while (p < T1) {
                        i64 pl = next_set_byte(r6b, p - T0, T1 - T0);
                        if (pl >= T1 - T0) break;
                        p = pl + T0;
                        i64 s = p;
                        while (s > 0 && PM(s - 1)) s--;   /* guard stops at T0 */
                        /* a 6-run starting within 6 of T1 reaches T1 and
                         * so crosses the tile: e must stop there for the
                         * carry below (past T1 it would drop the run's
                         * start, and the next tile would clip it to T0) */
                        i64 e = p + 6 < T1 ? p + 6 : T1;
                        while (e < T1 && PM(e)) e++;
                        if (e == T1 && T1 < L && PM(T1)) {
                            perf_open[didx] = s;          /* crosses the tile */
                            break;
                        }
                        if (e - s >= cutoff) {
                            iv32_push(&c->perf_s[didx], s);
                            iv32_push(&c->perf_e[didx], e);
                        }
                        p = e + 1;
                    }
                }
#undef PM
                GP_ADD(2, tp0);
            }

            /* substitution windows over raw eq (threshold 7) */
            if (nw > 0 && T0 < nw) {
                GP_T0(tq0);
                i64 W1 = T1 < nw ? T1 : nw;
                win8_sums(ebm + (T0 - base), t8b, t8b, t8b, W1 - T0);
                for (i64 w = 0; w < W1 - T0; w++)
                    qbb[w] = (t8b[w] >= 7) & (n8[T0 + w] == 0);
                tile_byte_runs(qbb, T0, W1, nw, &q7_open[didx],
                               c, &c->q7_sm[didx]);
                GP_ADD(3, tq0);
            }

            /* anchored windows over the overlay (threshold 6,
             * fasta_utils.cpp:145-165) */
            {
                GP_T0(to0);
                i64 O1 = T1 + 7;
                memcpy(obb, ebm + (T0 - base), (size_t)(O1 - T0));
                i64 nlo = m > 2 ? m - 2 : 1;
                for (i64 i2 = nlo; i2 <= m + 2; i2++) {
                    if (i2 == m) continue;
                    int nslot = (int)(i2 % 5);
                    if (atag[nslot] == i2) {
                        const uint8_t *restrict ab2 = abuf[nslot];
                        uint8_t *restrict ob = obb;
                        for (i64 k = 0; k < O1 - T0; k++) ob[k] |= ab2[k];
                    }
                }
                if (nw > 0 && T0 < nw) {
                    i64 W1 = T1 < nw ? T1 : nw;
                    win8_sums(obb, t8b, t8b, t8b, W1 - T0);
                    for (i64 w = 0; w < W1 - T0; w++)
                        qbb[w] = (t8b[w] >= 6) & (n8[T0 + w] == 0);
                    tile_byte_runs(qbb, T0, W1, nw, &q6_open[didx],
                                   c, &c->q6_sm[didx]);
                }
                GP_ADD(4, to0);
                GP_T0(tk0);

                /* pack the overlay for O(range/64) popcount / longest-run
                 * queries (lattice retain rules, refinement's
                 * continuous-ones guard) */
                if (c->ov_pack) {
                    uint64_t *dst = c->ov_pack[didx];
                    i64 wi = T0 >> 6;
                    i64 wend = (T1 + 63) >> 6;
#ifdef __AVX2__
                    for (; (wi + 1) << 6 <= T1; wi++) {
                        const uint8_t *src = obb + ((wi << 6) - T0);
                        __m256i z = _mm256_setzero_si256();
                        __m256i va = _mm256_loadu_si256((const __m256i *)src);
                        __m256i vb = _mm256_loadu_si256(
                            (const __m256i *)(src + 32));
                        uint32_t wlo = (uint32_t)_mm256_movemask_epi8(
                            _mm256_cmpgt_epi8(va, z));
                        uint32_t whi = (uint32_t)_mm256_movemask_epi8(
                            _mm256_cmpgt_epi8(vb, z));
                        dst[wi] = (uint64_t)wlo | ((uint64_t)whi << 32);
                    }
#endif
                    for (; wi < wend; wi++) {
                        i64 gb = wi << 6;
                        i64 lim = T1 - gb < 64 ? T1 - gb : 64;
                        uint64_t word = 0;
                        for (i64 bit = 0; bit < lim; bit++)
                            word |= (uint64_t)(obb[gb - T0 + bit] & 1) << bit;
                        dst[wi] = word;
                    }
                }
                GP_ADD(5, tk0);
            }
#undef EQM
        }
        if (L == 0) break;
    }

    /* all tiles done: flush the emission state machines of the owned
     * channels (EOF rules, parse_substitute_shiftxor.cpp:534-574) */
    for (i64 m = t->m_lo; m <= t->m_hi; m++) {
        i32 didx = (i32)(m - c->min_motif);
        winsm_finish(c, &c->q7_sm[didx]);
        winsm_finish(c, &c->q6_sm[didx]);
        if (c->q6_sink) q6sink_flush(&c->q6_sink[didx]);
    }

    for (int i = 0; i < 5; i++) { free(ebuf[i]); free(abuf[i]); }
    free(r3b); free(pmb); free(r6b); free(obb); free(t8b); free(qbb);
    free(perf_open); free(q7_open); free(q6_open);
    if (gp_on)
        for (int i = 0; i < 6; i++)
            __atomic_fetch_add(&g_genprof[i], gp[i], __ATOMIC_RELAXED);
#undef GP_T0
#undef GP_ADD
    return NULL;
}

static void generate_events(RibbitCore *c) {
    i64 L = c->L;
    i32 nm = c->nmotifs;
    if (!c->perf_s) {
        c->perf_s = (IV32 *)xcalloc(nm, sizeof(IV32));
        c->perf_e = (IV32 *)xcalloc(nm, sizeof(IV32));
    }

    /* N-free segments + shared wide-segment windows, then per-channel
     * emission state machines: qualified runs stream straight into
     * emissions inside the generation pass (no run arrays) */
    if (!c->eval_lo) {
        iv_init(&c->seg_a);
        iv_init(&c->seg_b);
        i64 p = 0;
        while (p < L) {
            while (p < L && c->nmask[p]) p++;
            if (p >= L) break;
            i64 s = p;
            while (p < L && !c->nmask[p]) p++;
            iv_push(&c->seg_a, s);
            iv_push(&c->seg_b, p);
        }
        build_eval_segments(c);
    }
    if (!c->q7_emis)
        c->q7_emis = (EVec *)xcalloc((size_t)nm, sizeof(EVec));
    if (c->q6_evec_mode) {
        c->q6_emis = (EVec *)xcalloc((size_t)nm, sizeof(EVec));
    } else {
        c->q6_sink = (Q6Sink *)xcalloc((size_t)nm, sizeof(Q6Sink));
        for (i32 d = 0; d < nm; d++) {
            i64 m = c->min_motif + d;
            i64 cut = m > 6 ? m : 10;
            if (m >= 10) cut = (i64)(0.9 * (double)m);
            c->q6_sink[d].cutoff = cut;
            c->q6_sink[d].L = L;
            c->q6_sink[d].last_pos = -1;
        }
    }
    c->q7_sm = (WinSM *)xmalloc((size_t)nm * sizeof(WinSM));
    c->q6_sm = (WinSM *)xmalloc((size_t)nm * sizeof(WinSM));
    for (i32 d = 0; d < nm; d++) {
        winsm_init(&c->q7_sm[d], c->min_motif + d, d, &c->q7_emis[d], NULL);
        winsm_init(&c->q6_sm[d], c->min_motif + d, d,
                   c->q6_evec_mode ? &c->q6_emis[d] : NULL,
                   c->q6_evec_mode ? NULL : &c->q6_sink[d]);
    }
    if (c->capture_runs) {
        /* record raw qualified runs in the injected-events representation
         * instead of feeding the scanner state machines (channels are
         * worker-partitioned, so per-channel pushes never contend) */
        c->q7_s = (IV32 *)xcalloc(nm, sizeof(IV32));
        c->q7_e = (IV32 *)xcalloc(nm, sizeof(IV32));
        c->q6_s = (IV32 *)xcalloc(nm, sizeof(IV32));
        c->q6_e = (IV32 *)xcalloc(nm, sizeof(IV32));
        for (i32 d = 0; d < nm; d++) {
            c->q7_sm[d].cap_s = &c->q7_s[d];
            c->q7_sm[d].cap_e = &c->q7_e[d];
            c->q6_sm[d].cap_s = &c->q6_s[d];
            c->q6_sm[d].cap_e = &c->q6_e[d];
        }
    }

    /* shared per-window N counts */
    uint8_t *n8 = (uint8_t *)calloc((size_t)(L + GEN_PAD), 1);
    if (n8) advise_huge(n8, (size_t)(L + GEN_PAD));
    {
        uint8_t *nb = (uint8_t *)calloc((size_t)(L + GEN_PAD), 1);
        uint8_t *s2 = (uint8_t *)calloc((size_t)(L + GEN_PAD), 1);
        uint8_t *s4 = (uint8_t *)calloc((size_t)(L + GEN_PAD), 1);
        for (i64 p = 0; p < L; p++) nb[p] = c->nmask[p];
        win8_sums(nb, s2, s4, n8, L);
        free(nb); free(s2); free(s4);
    }

    /* packed overlay cache: ~nmotifs * L/8 bytes; skipped for very long
     * sequences (queries then recompute per range) */
    const char *cache_env = getenv("RIBBIT_OVERLAY_CACHE_MAX");
    /* ~12.4 bytes/base (nmotifs * L/8): a 250 Mb chromosome costs ~3.1 GB,
     * cheap against the O(events) query savings on any genome-scale host */
    i64 cache_max = cache_env ? atoll(cache_env) : (i64)256 << 20;
    if (L <= cache_max && !c->ov_pack && !c->capture_runs) {
        c->ov_words = (L + 63) >> 6;
        c->ov_pack = (uint64_t **)calloc((size_t)nm, sizeof(uint64_t *));
        for (i32 d = 0; d < nm; d++) {
            c->ov_pack[d] = (uint64_t *)calloc((size_t)c->ov_words, 8);
            if (c->ov_pack[d])
                advise_huge(c->ov_pack[d], (size_t)c->ov_words * 8);
        }
    }

    i64 nthreads = c->nthreads;
    if (nthreads <= 0) {
        const char *env = getenv("RIBBIT_THREADS");
        if (env) nthreads = atoll(env);
        else nthreads = (i64)sysconf(_SC_NPROCESSORS_ONLN);
    }
    if (nthreads < 1) nthreads = 1;
    if (nthreads > nm) nthreads = nm;

    GenTask *tasks = (GenTask *)malloc((size_t)nthreads * sizeof(GenTask));
    pthread_t *tids = (pthread_t *)malloc((size_t)nthreads * sizeof(pthread_t));
    for (i64 t = 0; t < nthreads; t++) {
        tasks[t].c = c;
        tasks[t].m_lo = c->min_motif + (i32)(t * nm / nthreads);
        tasks[t].m_hi = c->min_motif + (i32)((t + 1) * nm / nthreads) - 1;
        tasks[t].n8 = n8;
    }
    if (nthreads == 1) {
        gen_worker(&tasks[0]);
    } else {
        /* resolve the profile env gate on this thread before workers read
         * it (pthread_create gives the happens-before edge) — same
         * pre-resolution pattern as amemo/vcmemo in ribbit_refine.c */
        (void)prof_on();
        for (i64 t = 0; t < nthreads; t++)
            pthread_create(&tids[t], NULL, gen_worker, &tasks[t]);
        for (i64 t = 0; t < nthreads; t++)
            pthread_join(tids[t], NULL);
    }
    free(tasks);
    free(tids);
    free(n8);
    free(c->q7_sm); free(c->q6_sm);
    c->q7_sm = NULL; c->q6_sm = NULL;
    if (prof_on()) {
        /* cumulative across the process (multi-contig runs overlap their
         * generation passes, so per-call attribution would race) */
        fprintf(stderr, "[core] genprof(cum)");
        for (int i = 0; i < 6; i++)
            fprintf(stderr, " %s=%.2fGc", g_genprof_names[i],
                    g_genprof[i] / 1e9);
        fprintf(stderr, "\n");
    }
    c->events_ready = 1;
}

/* ------------------------------------------------------------------ */
/* perfect lattice (lattice.py:add_seed_perfect,                      */
/* parse_perfect_shiftxor.cpp:47-142)                                 */
/* ------------------------------------------------------------------ */

static void add_seed_perfect(RibbitCore *c, i64 seed_start, i64 seed_end,
                             i64 motif_length) {
restart:;
    SeedList *sp = &c->perfect;
    i64 seed_rlen = seed_end - seed_start + motif_length;

    IVec removes = c->scr[18];
    iv_reset(&removes);

    for (i64 i = sp->n - 1; i >= 0; i--) {
        i64 last_start = sp->d[i].start, last_end = sp->d[i].end;
        i64 last_mlen = sp->d[i].mlen;
        i64 last_length = last_end - last_start;
        i64 last_rlen = last_length + last_mlen;

        if (last_end < seed_start) break;

        if (last_start == seed_start && last_end == seed_end) {
            if (last_mlen < motif_length) { c->scr[18] = removes; return; }
            iv_push(&removes, i);
        } else if (last_start <= seed_start && last_end >= seed_end) {
            if (seed_rlen < last_mlen / 3) continue;
            c->scr[18] = removes;
            return;
        } else if (seed_start <= last_start && seed_end >= last_end) {
            if (last_rlen < motif_length / 3) continue;
            iv_push(&removes, i);
        } else {
            i64 overlap_length, merge_start, merge_end;
            if (last_start < seed_start) {
                overlap_length = last_end - seed_start + last_mlen;
                merge_start = last_start;
                merge_end = seed_end;
            } else {
                overlap_length = seed_end - last_start + motif_length;
                merge_start = seed_start;
                merge_end = last_end;
            }
            if (last_mlen == motif_length) {
                c->scr[18] = removes;
                seed_start = merge_start;
                seed_end = merge_end;
                motif_length = last_mlen;
                goto restart;
            } else if (last_mlen < motif_length) {
                if (motif_length - overlap_length <= 1 &&
                    seed_rlen / motif_length < 3) {
                    c->scr[18] = removes;
                    seed_start = merge_start;
                    seed_end = merge_end;
                    motif_length = last_mlen;
                    goto restart;
                } else if (seed_rlen - motif_length - overlap_length <= last_mlen) {
                    c->scr[18] = removes;
                    return;
                }
            } else {
                if (last_mlen - overlap_length <= 1 && last_rlen / last_mlen < 3) {
                    c->scr[18] = removes;
                    seed_start = merge_start;
                    seed_end = merge_end;
                    motif_length = last_mlen;
                    goto restart;
                } else if (last_rlen - last_mlen - overlap_length <= motif_length) {
                    iv_push(&removes, i);
                }
            }
        }
    }

    for (i64 k = 0; k < removes.n; k++) sl_remove(sp, removes.d[k]);
    c->scr[18] = removes;

    if (seed_end > c->L - motif_length) seed_end = c->L - motif_length;
    Seed s = {seed_start, seed_end, motif_length, RANK_P};
    sl_push(sp, s);
}

/* ------------------------------------------------------------------ */
/* substitution lattice (lattice.py:add_seed_substitution,            */
/* parse_substitute_shiftxor.cpp:18-388)                              */
/* ------------------------------------------------------------------ */

static i64 add_seed_substitution(RibbitCore *c, i64 seed_start, i64 seed_end,
                                 i64 motif_length, const i64 *seedlen_cutoff,
                                 i64 from_index, i64 seed_type) {
restart:;
    SeedList *perfect = &c->perfect, *substut = &c->substut;

    {
        i64 i = from_index;
        while (i < perfect->n) {
            i64 last_start = perfect->d[i].start;
            if (last_start > seed_end) break;
            else if (from_index == perfect->n - 1) break;
            else from_index++;
            i++;
        }
    }

    if (seed_end - seed_start < seedlen_cutoff[motif_length - c->min_motif])
        return from_index;

    IVec last_types = c->scr[0], last_indices = c->scr[1];
    iv_reset(&last_types);
    iv_reset(&last_indices);
    {
        int mvnext_perfect = perfect->n != 0;
        int mvnext_substut = substut->n != 0;
        i64 perfect_index = from_index;
        i64 substut_index = substut->n - 1;
        i64 perfect_end = 0, substut_end = 0;

        while (mvnext_perfect || mvnext_substut) {
            if (!mvnext_substut) {
                while (mvnext_perfect) {
                    perfect_end = perfect->d[perfect_index].end;
                    i64 ptype = perfect->d[perfect_index].rank;
                    if (perfect_end >= seed_start) {
                        if (ptype != RANK_N) {
                            iv_push(&last_types, RANK_P);
                            iv_push(&last_indices, perfect_index);
                        }
                        perfect_index--;
                    }
                    if (perfect_index < 0 || perfect_end < seed_start)
                        mvnext_perfect = 0;
                }
            } else if (!mvnext_perfect) {
                while (mvnext_substut) {
                    substut_end = substut->d[substut_index].end;
                    i64 stype = substut->d[substut_index].rank;
                    if (substut_end >= seed_start) {
                        if (stype != RANK_N) {
                            iv_push(&last_types, RANK_S);
                            iv_push(&last_indices, substut_index);
                        }
                        substut_index--;
                    }
                    if (substut_index < 0 || substut_end < seed_start)
                        mvnext_substut = 0;
                }
            } else {
                perfect_end = perfect->d[perfect_index].end;
                i64 ptype = perfect->d[perfect_index].rank;
                substut_end = substut->d[substut_index].end;
                i64 stype = substut->d[substut_index].rank;

                if (substut_end > perfect_end) {
                    if (stype != RANK_N) {
                        iv_push(&last_types, RANK_S);
                        iv_push(&last_indices, substut_index);
                    }
                    substut_index--;
                } else {
                    if (ptype != RANK_N) {
                        iv_push(&last_types, RANK_P);
                        iv_push(&last_indices, perfect_index);
                    }
                    perfect_index--;
                }
                if (perfect_index < 0 || perfect_end < seed_start)
                    mvnext_perfect = 0;
                if (substut_index < 0 || substut_end < seed_start)
                    mvnext_substut = 0;
            }
        }
    }

    i64 seed_rend = seed_end + motif_length;
    i64 seed_length = seed_end - seed_start;
    i64 seed_rlen = seed_length + motif_length;
    i64 seed_midx = motif_length - c->min_shift;
    (void)seed_rend;

    for (i64 k = 0; k < last_indices.n; k++) {
        i64 i = last_indices.d[k];
        Seed *src = last_types.d[k] == RANK_P ? &perfect->d[i] : &substut->d[i];
        i64 last_start = src->start, last_end = src->end;
        i64 last_mlen = src->mlen, last_type = src->rank;
        i64 last_rend = last_end + last_mlen;
        i64 last_length = last_end - last_start;
        i64 last_rlen = last_rend - last_start;
        i64 last_midx = last_mlen - c->min_shift;

        if (last_end < seed_start) break;
        if (last_type == RANK_N) continue;
        if (seed_end < last_start) continue;

        /* ---- identical ---- */
        if (seed_start == last_start && seed_end == last_end) {
            if (seed_type == RANK_S && (last_type == RANK_P || last_type == RANK_Q))
                goto done_ret;
            else if (seed_type == RANK_Q && last_type == RANK_P)
                goto done_ret;
            else if (seed_type == RANK_Q && last_type == RANK_S)
                substut->d[i].rank = RANK_N;
            else if ((seed_type == RANK_Q && last_type == RANK_Q) ||
                     (seed_type == RANK_S && last_type == RANK_S)) {
                if (motif_length % last_mlen == 0) goto done_ret;
                else if (last_mlen % motif_length == 0) {
                    substut->d[i].rank = RANK_N;
                    c->scr[0] = last_types; c->scr[1] = last_indices;
                    goto restart;
                } else {
                    /* retain_identical */
                    i64 nc = core_bitcount(c, (i32)seed_midx, seed_start, seed_end);
                    i64 pc = core_bitcount(c, (i32)last_midx, seed_start, seed_end);
                    int keep = nc > pc || (nc == pc && seed_midx < last_midx);
                    if (!keep) goto done_ret;
                    substut->d[i].rank = RANK_N;
                    break;
                }
            }
        }
        /* ---- nested ---- */
        else if (last_start <= seed_start && seed_end <= last_end) {
            if (seed_type == RANK_S && (last_type == RANK_P || last_type == RANK_Q))
                goto done_ret;
            else if (seed_type == RANK_Q && last_type == RANK_P)
                goto done_ret;
            else if ((seed_type == RANK_Q && (last_type == RANK_S || last_type == RANK_Q)) ||
                     (seed_type == RANK_S && last_type == RANK_S)) {
                i64 new_type = (seed_type == RANK_S && last_type == RANK_S)
                               ? RANK_S : RANK_Q;
                if (motif_length == last_mlen) {
                    substut->d[i].mlen = motif_length;
                    substut->d[i].rank = new_type;
                    goto done_ret;
                } else if (motif_length % last_mlen == 0) {
                    goto done_ret;
                } else if (last_mlen % motif_length == 0 || last_mlen < motif_length) {
                    if (seed_rlen >= last_mlen - 1 || seed_rlen >= last_length - 1) {
                        substut->d[i].mlen = motif_length;
                        substut->d[i].rank = new_type;
                        goto done_ret;
                    }
                    /* else: add separately */
                } else {
                    /* retain_nested */
                    if (!(core_bitcount(c, (i32)seed_midx, seed_start, seed_end) >=
                          core_bitcount(c, (i32)last_midx, seed_start, seed_end)))
                        goto done_ret;
                }
            }
        }
        /* ---- parent ---- */
        else if (seed_start <= last_start && last_end <= seed_end) {
            if ((seed_type == RANK_S && (last_type == RANK_P || last_type == RANK_Q)) ||
                (seed_type == RANK_Q && last_type == RANK_P)) {
                if (last_mlen % motif_length == 0) {
                    if (last_type == RANK_P) perfect->d[i].rank = RANK_N;
                    else substut->d[i].rank = RANK_N;
                    seed_type = RANK_Q;
                    c->scr[0] = last_types; c->scr[1] = last_indices;
                    goto restart;
                } else if (motif_length % last_mlen == 0 || last_mlen < motif_length) {
                    if (seed_length / motif_length > 3 &&
                        last_rlen >= (3 * motif_length) - 1) {
                        if (last_type != RANK_P) substut->d[i].rank = RANK_N;
                        motif_length = last_mlen;
                        seed_type = RANK_Q;
                        c->scr[0] = last_types; c->scr[1] = last_indices;
                        goto restart;
                    } else if (seed_length / motif_length <= 3 &&
                               (last_rlen >= motif_length - 1 ||
                                last_rlen >= seed_length - 1)) {
                        if (last_type != RANK_P) substut->d[i].rank = RANK_N;
                        motif_length = last_mlen;
                        seed_type = RANK_Q;
                        c->scr[0] = last_types; c->scr[1] = last_indices;
                        goto restart;
                    }
                    /* else: add separately */
                }
                /* else: retain both separately */
            } else if (seed_type == RANK_Q && last_type == RANK_S) {
                substut->d[i].rank = RANK_N;
                break;
            } else if ((seed_type == RANK_Q && last_type == RANK_Q) ||
                       (seed_type == RANK_S && last_type == RANK_S)) {
                if (last_mlen % motif_length == 0) {
                    substut->d[i].rank = RANK_N;
                } else if (motif_length % last_mlen == 0 || motif_length > last_mlen) {
                    if (last_rlen >= motif_length - 1 || last_rlen >= seed_length - 1) {
                        substut->d[i].rank = RANK_N;
                        motif_length = last_mlen;
                        c->scr[0] = last_types; c->scr[1] = last_indices;
                        goto restart;
                    } else {
                        if (core_bitcount(c, (i32)last_midx, last_start, last_end) >=
                            core_bitcount(c, (i32)seed_midx, last_start, last_end))
                            continue;
                        substut->d[i].rank = RANK_N;
                    }
                } else if (last_mlen > motif_length) {
                    if (core_bitcount(c, (i32)last_midx, last_start, last_end) >=
                        core_bitcount(c, (i32)seed_midx, last_start, last_end))
                        continue;
                    substut->d[i].rank = RANK_N;
                    c->scr[0] = last_types; c->scr[1] = last_indices;
                    goto restart;
                }
            }
        }
        /* ---- overlap ---- */
        else {
            i64 overlap_length, merge_start, merge_end;
            if (last_start < seed_start) {
                if (last_mlen <= motif_length)
                    overlap_length = seed_end <= last_rend ? seed_end - seed_start
                                                           : last_rend - seed_start;
                else
                    overlap_length = seed_end <= last_end ? seed_end - seed_start
                                                          : last_end - seed_start;
                merge_start = last_start;
                merge_end = seed_end;
            } else {
                if (motif_length <= last_mlen)
                    overlap_length = last_end <= seed_rend ? last_end - last_start
                                                           : seed_rend - last_start;
                else
                    overlap_length = last_end <= seed_end ? last_end - last_start
                                                          : seed_end - last_start;
                merge_start = seed_start;
                merge_end = last_end;
            }

            if (last_mlen % motif_length == 0 || last_mlen > motif_length) {
                if (last_length / last_mlen > 3 &&
                    overlap_length >= (3 * last_mlen) - 1) {
                    if (last_type == RANK_P) perfect->d[i].rank = RANK_N;
                    else substut->d[i].rank = RANK_N;
                    seed_start = merge_start;
                    seed_end = merge_end;
                    seed_type = RANK_Q;
                    c->scr[0] = last_types; c->scr[1] = last_indices;
                    goto restart;
                } else if (last_length / last_mlen <= 3 &&
                           (overlap_length >= last_mlen - 1 ||
                            overlap_length >= last_length - 1)) {
                    if (last_type == RANK_P) perfect->d[i].rank = RANK_N;
                    else substut->d[i].rank = RANK_N;
                    seed_start = merge_start;
                    seed_end = merge_end;
                    seed_type = RANK_Q;
                    c->scr[0] = last_types; c->scr[1] = last_indices;
                    goto restart;
                }
            } else if (motif_length % last_mlen == 0 || motif_length > last_mlen) {
                if (seed_length / motif_length > 3 &&
                    overlap_length >= (3 * motif_length) - 1) {
                    if (last_type != RANK_P) substut->d[i].rank = RANK_N;
                    seed_start = merge_start;
                    seed_end = merge_end;
                    motif_length = last_mlen;
                    seed_type = RANK_Q;
                    c->scr[0] = last_types; c->scr[1] = last_indices;
                    goto restart;
                } else if (seed_length / motif_length <= 3 &&
                           (overlap_length >= motif_length - 1 ||
                            overlap_length >= seed_length - 1)) {
                    if (last_type != RANK_P) substut->d[i].rank = RANK_N;
                    seed_start = merge_start;
                    seed_end = merge_end;
                    motif_length = last_mlen;
                    seed_type = RANK_Q;
                    c->scr[0] = last_types; c->scr[1] = last_indices;
                    goto restart;
                }
            }
        }
    }

    if (seed_end > c->L - motif_length) seed_end = c->L - motif_length;
    {
        Seed s = {seed_start, seed_end, motif_length, seed_type};
        sl_push(substut, s);
    }
done_ret:
    c->scr[0] = last_types;
    c->scr[1] = last_indices;
    return from_index;
}

/* ------------------------------------------------------------------ */
/* 3-list merge walker (lattice.py:merge_all_lists,                   */
/* merge_types.cpp:11-189)                                            */
/* ------------------------------------------------------------------ */

static inline Seed *list_at(SeedList *l, i64 idx) {
    /* python negative indexing wraps; the guarded states make this
     * unreachable on real inputs, but stay memory-safe */
    if (idx < 0) idx += l->n;
    return &l->d[idx];
}

static void merge_all_lists(RibbitCore *c, i64 from_index_perfect,
                            i64 from_index_substut, IVec *last_types,
                            IVec *last_indices, i64 seed_start) {
    SeedList *perfect = &c->perfect, *substut = &c->substut,
             *anchored = &c->anchored;
    IVec sp_types = c->scr[2], sp_indices = c->scr[3];
    iv_reset(&sp_types);
    iv_reset(&sp_indices);

    int perfect_start_bool = 0, substut_start_bool = 0;
    i64 perfect_index = from_index_perfect;
    i64 substut_index = from_index_substut;
    i64 perfect_end = 0, substut_end = 0;

    if (perfect->n == 0) perfect_start_bool = 1;
    if (substut->n == 0) substut_start_bool = 1;   /* guarded deviation */

    while (!(perfect_start_bool && substut_start_bool)) {
        if (substut_start_bool) {
            while (perfect_index >= 0 || !perfect_start_bool) {
                Seed *s = list_at(perfect, perfect_index);
                perfect_end = s->end;
                i64 ptype = s->rank;
                if (perfect_end >= seed_start) {
                    if (ptype != RANK_N) {
                        iv_push(&sp_types, RANK_P);
                        iv_push(&sp_indices, perfect_index);
                    }
                    perfect_index--;
                }
                if (perfect_index < 0 || perfect_end < seed_start) {
                    perfect_start_bool = 1;
                    break;
                }
            }
        } else if (perfect_start_bool) {
            while (substut_end >= 0 || !substut_start_bool) {
                Seed *s = list_at(substut, substut_index);
                substut_end = s->end;
                i64 stype = s->rank;
                if (substut_end >= seed_start) {
                    if (stype != RANK_N) {
                        iv_push(&sp_types, RANK_S);
                        iv_push(&sp_indices, substut_index);
                    }
                    substut_index--;
                }
                if (substut_index < 0 || substut_end < seed_start) {
                    substut_start_bool = 1;
                    break;
                }
            }
        } else {
            perfect_end = perfect->d[perfect_index].end;
            substut_end = substut->d[substut_index].end;
            i64 ptype = perfect->d[perfect_index].rank;
            i64 stype = substut->d[substut_index].rank;

            if (substut_end > perfect_end) {
                if (stype != RANK_N) {
                    iv_push(&sp_types, RANK_S);
                    iv_push(&sp_indices, substut_index);
                }
                substut_index--;
            } else {
                if (ptype != RANK_N) {
                    iv_push(&sp_types, RANK_P);
                    iv_push(&sp_indices, perfect_index);
                }
                perfect_index--;
            }
            if (perfect_index < 0 || perfect_end < seed_start)
                perfect_start_bool = 1;
            if (substut_index < 0 || substut_end < seed_start)
                substut_start_bool = 1;
        }
    }

    int subperf_start_bool = 0, anchored_start_bool = 0;
    i64 subperf_index = sp_indices.n - 1;
    i64 anchored_index = anchored->n - 1;
    i64 subperf_end = 0, anchored_end = 0;

    if (anchored->n == 0) {
        for (i64 k = 0; k < sp_indices.n; k++) {
            iv_push(last_indices, sp_indices.d[k]);
            iv_push(last_types, sp_types.d[k]);
        }
    } else if (sp_indices.n == 0) {
        while (anchored_end >= 0 || !anchored_start_bool) {
            Seed *s = list_at(anchored, anchored_index);
            anchored_end = s->end;
            i64 atype = s->rank;
            if (anchored_end >= seed_start) {
                if (atype != RANK_N) {
                    iv_push(last_types, RANK_A);
                    iv_push(last_indices, anchored_index);
                }
                anchored_index--;
            }
            if (anchored_index < 0 || anchored_end < seed_start) break;
        }
    } else {
        while (!(subperf_start_bool && anchored_start_bool)) {
            if (anchored_start_bool) {
                while (subperf_index >= 0 || !subperf_start_bool) {
                    i64 sptype = sp_types.d[subperf_index];
                    i64 idx = sp_indices.d[subperf_index];
                    subperf_end = sptype == RANK_P ? perfect->d[idx].end
                                                   : substut->d[idx].end;
                    if (subperf_end >= seed_start) {
                        iv_push(last_types, sptype);
                        iv_push(last_indices, idx);
                        subperf_index--;
                    }
                    if (subperf_index < 0 || subperf_end < seed_start) {
                        subperf_start_bool = 1;
                        break;
                    }
                }
            } else if (subperf_start_bool) {
                while (anchored_end >= 0 || !anchored_start_bool) {
                    Seed *s = list_at(anchored, anchored_index);
                    anchored_end = s->end;
                    i64 atype = s->rank;
                    if (anchored_end >= seed_start) {
                        if (atype != RANK_N) {
                            iv_push(last_types, RANK_A);
                            iv_push(last_indices, anchored_index);
                        }
                        anchored_index--;
                    }
                    if (anchored_index < 0 || anchored_end < seed_start) {
                        anchored_start_bool = 1;
                        break;
                    }
                }
            } else {
                i64 sptype = sp_types.d[subperf_index];
                i64 idx = sp_indices.d[subperf_index];
                subperf_end = sptype == RANK_P ? perfect->d[idx].end
                                               : substut->d[idx].end;
                anchored_end = anchored->d[anchored_index].end;

                if (anchored_end > subperf_end) {
                    iv_push(last_types, RANK_A);
                    iv_push(last_indices, anchored_index);
                    anchored_index--;
                } else {
                    iv_push(last_types, sptype);
                    iv_push(last_indices, idx);
                    subperf_index--;
                }
                if (subperf_index < 0 || subperf_end < seed_start)
                    subperf_start_bool = 1;
                if (anchored_index < 0 || anchored_end < seed_start)
                    anchored_start_bool = 1;
            }
        }
    }
    c->scr[2] = sp_types;
    c->scr[3] = sp_indices;
}

/* ------------------------------------------------------------------ */
/* anchored lattice (lattice.py:add_seed_anchored,                    */
/* parse_anchored_shiftxor.cpp:113-534)                               */
/* ------------------------------------------------------------------ */

typedef struct { i64 fip, fis; } FromIdx;

/* env-gated (RIBBIT_CORE_PROF) consume-path section profile; the anchored
 * consume is single-threaded so plain counters suffice */
static uint64_t g_prof[8];
static i64 g_prof_n[8];
#define PROF_CALLS 0
#define PROF_RESTARTS 1
#define PROF_CAND 2
#define PROF_CURSOR 4
#define PROF_MAL 5
#define PROF_LOOP 6
#define PROF_TAIL 7
#define PROF_FOLD 3
static int g_prof_on = -1;
static inline int prof_on(void) {
    if (g_prof_on < 0) g_prof_on = getenv("RIBBIT_CORE_PROF") != NULL;
    return g_prof_on;
}
#if defined(__x86_64__)
#include <x86intrin.h>
#define PROF_T0(v) uint64_t v = prof_on() ? __rdtsc() : 0
#define PROF_ADD(slot, v) do { if (prof_on())     g_prof[slot] += __rdtsc() - (v); } while (0)
#else
#define PROF_T0(v) uint64_t v = 0; (void)v
#define PROF_ADD(slot, v) (void)(v)
#endif

/* The from-cursor advance (parse_anchored_shiftxor.cpp:121-137 semantics,
 * as in add_seed_anchored's entry block): step while the current entry's
 * start <= seed_end, clamped at n-1.  A stuck-at-barrier forward cursor is
 * monotone in its threshold, so advancing by e1 then e2 equals one advance
 * by max(e1, e2) — run_anchored_scan exploits this to fold the advances of
 * cutoff-rejected emissions into a pending max instead of a call each. */
static inline i64 advance_cursor(const SeedList *l, i64 from, i64 e) {
    while (from < l->n - 1 && l->d[from].start <= e) from++;
    return from;
}

/* Streaming-safe tombstone for the anchored phase.  The watermark argument
 * for streamed finality assumed tombstones only touch entries with
 * end >= the incoming event's seed start — but a merge restart
 * (goto restart with seed_start = merge_start) can lower seed_start
 * below W and then tombstone an entry the incremental merge already
 * consumed (observed once per ~300 Mb: chr14 of the round-3 capstone).
 * The watermark is therefore only a throttling heuristic; correctness
 * comes from poisoning here whenever a tombstone lands behind the merge
 * cursor on an entry the merge consumed as live (already-RANK_N entries
 * were skipped, so re-tombstoning them cannot diverge). */
static inline void anch_tomb(RibbitCore *c, SeedList *l, i64 cursor, i64 i) {
    if (c->stream_cb && i < cursor && l->d[i].rank != RANK_N)
        c->stream_poisoned = 1;
    l->d[i].rank = RANK_N;
}

static FromIdx add_seed_anchored(RibbitCore *c, i64 seed_start, i64 seed_end,
                                 i64 motif_length, const i64 *seedlen_cutoffs,
                                 FromIdx from, i64 seed_type) {
    if (prof_on()) g_prof_n[PROF_CALLS]++;
restart:;
    if (prof_on()) g_prof_n[PROF_RESTARTS]++;
    PROF_T0(tc0);
    SeedList *perfect = &c->perfect, *substut = &c->substut,
             *anchored = &c->anchored;
    i64 from_index_perfect = from.fip, from_index_substut = from.fis;

    {
        i64 i = from_index_perfect;
        while (i < perfect->n) {
            if (perfect->d[i].start > seed_end) break;
            else if (from_index_perfect == perfect->n - 1) break;
            else from_index_perfect++;
            i++;
        }
        i = from_index_substut;
        while (i < substut->n) {
            if (substut->d[i].start > seed_end) break;
            else if (from_index_substut == substut->n - 1) break;
            else from_index_substut++;
            i++;
        }
    }
    from.fip = from_index_perfect;
    from.fis = from_index_substut;
    PROF_ADD(PROF_CURSOR, tc0);

    if (seed_end - seed_start < seedlen_cutoffs[motif_length - c->min_motif])
        return from;

    PROF_T0(tm0);
    IVec last_types = c->scr[4], last_indices = c->scr[5];
    iv_reset(&last_types);
    iv_reset(&last_indices);
    merge_all_lists(c, from_index_perfect, from_index_substut,
                    &last_types, &last_indices, seed_start);
    PROF_ADD(PROF_MAL, tm0);
    if (prof_on()) g_prof_n[PROF_CAND] += last_indices.n;
    PROF_T0(tl0);

    i64 seed_rend = seed_end + motif_length;
    i64 seed_length = seed_end - seed_start;
    i64 seed_rlen = seed_length + motif_length;
    i64 seed_midx = motif_length - c->min_shift;

    IVec po_sp_factor = c->scr[6], po_sp_factorsizes = c->scr[7],
         po_sp_factortypes = c->scr[8];
    IVec po_sp_multiple = c->scr[9], po_sp_multipletypes = c->scr[10];
    IVec po_sp_nonfactor = c->scr[11], po_sp_nonfactorsizes = c->scr[12],
         po_sp_nonfactortypes = c->scr[13];
    IVec po_an_factor = c->scr[14], po_an_nonfactor = c->scr[15],
         nestedin = c->scr[16], identical = c->scr[17];
    iv_reset(&po_sp_factor); iv_reset(&po_sp_factorsizes);
    iv_reset(&po_sp_factortypes);
    iv_reset(&po_sp_multiple); iv_reset(&po_sp_multipletypes);
    iv_reset(&po_sp_nonfactor); iv_reset(&po_sp_nonfactorsizes);
    iv_reset(&po_sp_nonfactortypes);
    iv_reset(&po_an_factor); iv_reset(&po_an_nonfactor);
    iv_reset(&nestedin); iv_reset(&identical);

#define ANCH_FREE_ALL() do { \
    PROF_ADD(PROF_LOOP, tl0); \
    c->scr[4] = last_types; c->scr[5] = last_indices; \
    c->scr[6] = po_sp_factor; c->scr[7] = po_sp_factorsizes; \
    c->scr[8] = po_sp_factortypes; \
    c->scr[9] = po_sp_multiple; c->scr[10] = po_sp_multipletypes; \
    c->scr[11] = po_sp_nonfactor; c->scr[12] = po_sp_nonfactorsizes; \
    c->scr[13] = po_sp_nonfactortypes; \
    c->scr[14] = po_an_factor; c->scr[15] = po_an_nonfactor; \
    c->scr[16] = nestedin; c->scr[17] = identical; \
} while (0)

    /* last_* persist past the loop for the coverage-vote quirks */
    i64 last_start = 0, last_end = 0, last_rend = 0, last_mlen = 0;

    for (i64 k = 0; k < last_indices.n; k++) {
        i64 i = last_indices.d[k];
        Seed *src;
        if (last_types.d[k] == RANK_P) src = &perfect->d[i];
        else if (last_types.d[k] == RANK_S) src = &substut->d[i];
        else src = &anchored->d[i];
        last_start = src->start;
        last_end = src->end;
        last_mlen = src->mlen;
        i64 last_type = src->rank;
        last_rend = last_end + last_mlen;

        if (last_end < seed_start) break;
        if (last_type == RANK_N) continue;
        if (seed_end < last_start) continue;

        i64 last_length = last_end - last_start;
        i64 last_rlen = last_rend - last_start;
        i64 last_midx = last_mlen - c->min_shift;

        /* ---- identical ---- */
        if (seed_start == last_start && seed_end == last_end) {
            if (seed_type == RANK_A && last_type > RANK_A) {
                ANCH_FREE_ALL();
                return from;
            } else if (seed_type == RANK_C && last_type == RANK_A) {
                anch_tomb(c, anchored, c->sm_ai, i);
            } else {
                iv_push(&identical, i);
            }
        }
        /* ---- nested ---- */
        else if (last_start <= seed_start && seed_end <= last_end) {
            if (last_type > seed_type) {
                ANCH_FREE_ALL();
                return from;
            } else if (seed_type == RANK_C && last_type == RANK_A) {
                /* pass */
            } else if ((seed_type == RANK_A && last_type == RANK_A) ||
                       (seed_type == RANK_C && last_type == RANK_C)) {
                /* QUIRK: != 4 carve-outs (parse_anchored_shiftxor.cpp:241,246) */
                if (motif_length % last_mlen == 0 && motif_length != 4) {
                    ANCH_FREE_ALL();
                    return from;
                } else if (last_mlen % motif_length == 0 && last_mlen != 4) {
                    if (seed_rlen >= last_mlen - 1 || seed_rlen >= last_length) {
                        anch_tomb(c, anchored, c->sm_ai, i);
                        seed_start = last_start;
                        seed_end = last_end;
                        ANCH_FREE_ALL();
                        goto restart;
                    }
                    iv_push(&nestedin, i);
                    continue;
                } else {
                    if (!(core_bitcount(c, (i32)seed_midx, seed_start, seed_end) >=
                          core_bitcount(c, (i32)last_midx, seed_start, seed_end))) {
                        ANCH_FREE_ALL();
                        return from;
                    }
                    iv_push(&nestedin, i);
                    continue;
                }
            }
        }
        /* ---- parent ---- */
        else if (seed_start <= last_start && last_end <= seed_end) {
            if (last_type > seed_type) {
                if (motif_length % last_mlen == 0) {
                    if (last_rlen >= motif_length - 2 || last_rlen >= seed_length - 2) {
                        if (last_type == RANK_P) anch_tomb(c, perfect, c->sm_pi, i);
                        else if (last_type == RANK_S || last_type == RANK_Q)
                            anch_tomb(c, substut, c->sm_si, i);
                        motif_length = last_mlen;
                        seed_type = RANK_C;
                        ANCH_FREE_ALL();
                        goto restart;
                    } else {
                        iv_push(&po_sp_factor, i);
                        iv_push(&po_sp_factorsizes, last_mlen);
                        iv_push(&po_sp_factortypes, last_type);
                    }
                } else if (last_mlen % motif_length == 0) {
                    if (last_mlen >= 4 * motif_length ||
                        last_length >= 4 * motif_length) {
                        if (last_type == RANK_P) anch_tomb(c, perfect, c->sm_pi, i);
                        else if (last_type == RANK_S || last_type == RANK_Q)
                            anch_tomb(c, substut, c->sm_si, i);
                        seed_type = RANK_C;
                        ANCH_FREE_ALL();
                        goto restart;
                    } else {
                        iv_push(&po_sp_multiple, i);
                        iv_push(&po_sp_multipletypes, last_type);
                    }
                } else if (last_mlen > motif_length) {
                    if (last_mlen >= 4 * motif_length ||
                        last_length >= 4 * motif_length) {
                        if (last_type == RANK_P) anch_tomb(c, perfect, c->sm_pi, i);
                        else if (last_type == RANK_S || last_type == RANK_Q)
                            anch_tomb(c, substut, c->sm_si, i);
                        seed_type = RANK_C;
                        ANCH_FREE_ALL();
                        goto restart;
                    }
                } else {
                    iv_push(&po_sp_nonfactor, i);
                    iv_push(&po_sp_nonfactorsizes, last_mlen);
                    iv_push(&po_sp_nonfactortypes, last_type);
                }
            } else if (seed_type == RANK_C && last_type == RANK_A) {
                anch_tomb(c, anchored, c->sm_ai, i);
            } else if ((seed_type == RANK_A && last_type == RANK_A) ||
                       (seed_type == RANK_C && last_type == RANK_C)) {
                if (last_mlen == motif_length) {
                    anch_tomb(c, anchored, c->sm_ai, i);
                } else {
                    if (!(core_bitcount(c, (i32)last_midx, last_start, last_end) >=
                          core_bitcount(c, (i32)seed_midx, last_start, last_end))) {
                        anch_tomb(c, anchored, c->sm_ai, i);
                    } else {
                        if (motif_length % last_mlen == 0) {
                            if (last_rlen >= motif_length - 2 ||
                                last_rlen >= seed_length - 2) {
                                anch_tomb(c, anchored, c->sm_ai, i);
                                motif_length = last_mlen;
                                ANCH_FREE_ALL();
                                goto restart;
                            }
                            iv_push(&po_an_factor, i);
                        } else if (last_mlen % motif_length == 0) {
                            continue;
                        } else {
                            iv_push(&po_an_nonfactor, i);
                        }
                    }
                }
            }
        }
        /* ---- overlap ---- */
        else {
            i64 overlap_length, merge_start, merge_end;
            if (last_start < seed_start) {
                if (last_mlen <= motif_length)
                    overlap_length = seed_end <= last_rend ? seed_end - seed_start
                                                           : last_rend - seed_start;
                else
                    overlap_length = seed_end <= last_end ? seed_end - seed_start
                                                          : last_end - seed_start;
                merge_start = last_start;
                merge_end = seed_end;
            } else {
                if (motif_length <= last_mlen)
                    overlap_length = last_end <= seed_rend ? last_end - last_start
                                                           : seed_rend - last_start;
                else
                    overlap_length = last_end <= seed_end ? last_end - last_start
                                                          : seed_end - last_start;
                merge_start = seed_start;
                merge_end = last_end;
            }

            if (seed_type == RANK_A && last_type > RANK_C) {
                if (motif_length == last_mlen) {
                    if (overlap_length >= 4 * motif_length) {
                        if (last_type == RANK_P) anch_tomb(c, perfect, c->sm_pi, i);
                        else if (last_type == RANK_S || last_type == RANK_Q)
                            anch_tomb(c, substut, c->sm_si, i);
                        seed_start = merge_start;
                        seed_end = merge_end;
                        seed_type = RANK_C;
                        ANCH_FREE_ALL();
                        goto restart;
                    }
                }
                if (motif_length % last_mlen == 0 || last_mlen % motif_length == 0) {
                    /* pass */
                } else {
                    if (overlap_length >= motif_length - 1 ||
                        overlap_length >= seed_length - 1) {
                        ANCH_FREE_ALL();
                        return from;
                    }
                }
            } else if ((seed_type == RANK_A || seed_type == RANK_C) &&
                       (last_type == RANK_A || last_type == RANK_C)) {
                if (motif_length == last_mlen) {
                    if (last_length >= seed_length) {
                        if (seed_length >= 3 * motif_length &&
                            (overlap_length >= 3 * motif_length - 1 ||
                             overlap_length >= seed_length - 1)) {
                            anch_tomb(c, anchored, c->sm_ai, i);
                            seed_start = merge_start;
                            seed_end = merge_end;
                            motif_length = last_mlen;
                            ANCH_FREE_ALL();
                            goto restart;
                        } else if (seed_length < 3 * motif_length &&
                                   (overlap_length >= motif_length - 1 ||
                                    overlap_length >= seed_length - 1)) {
                            anch_tomb(c, anchored, c->sm_ai, i);
                            seed_start = merge_start;
                            seed_end = merge_end;
                            motif_length = last_mlen;
                            ANCH_FREE_ALL();
                            goto restart;
                        }
                    } else {
                        if (last_length >= 3 * last_mlen &&
                            (overlap_length >= 3 * last_mlen - 1 ||
                             overlap_length >= last_length - 1)) {
                            anch_tomb(c, anchored, c->sm_ai, i);
                            seed_start = merge_start;
                            seed_end = merge_end;
                            motif_length = last_mlen;
                            ANCH_FREE_ALL();
                            goto restart;
                        } else if (seed_length < 3 * last_mlen &&
                                   (overlap_length >= last_mlen - 1 ||
                                    overlap_length >= last_length - 1)) {
                            anch_tomb(c, anchored, c->sm_ai, i);
                            seed_start = merge_start;
                            seed_end = merge_end;
                            motif_length = last_mlen;
                            ANCH_FREE_ALL();
                            goto restart;
                        }
                    }
                }
            }
        }
    }

    /* ---- non-factor coverage vote (parse_anchored_shiftxor.cpp:441-468)
     * QUIRK: reference indexes the lists with loop counter j, compares
     * against uint32_t prev_start initialized to -1 */
    if (po_sp_nonfactor.n > 0) {
        i64 nonfactor_coverage = 0;
        uint32_t prev_start = 0xFFFFFFFFu;
        c->anch_votes++;
        for (i64 j = 0; j < po_sp_nonfactor.n; j++) {
            i64 ktype = po_sp_nonfactortypes.d[j];
            SeedList *src = ktype == RANK_P ? perfect
                            : (ktype == RANK_S ? substut : NULL);
            if (src != NULL) {
                if (j < src->n) {
                    last_start = src->d[j].start;
                    last_end = src->d[j].end;
                    last_mlen = src->d[j].mlen;
                } else {
                    last_start = last_end = last_mlen = 0;
                }
                last_rend = last_end + last_mlen;
            }
            if ((uint32_t)last_rend >= prev_start)
                nonfactor_coverage += (i64)prev_start - last_start;
            else if (last_rend < seed_end)
                nonfactor_coverage += last_rend - last_start;
            else
                nonfactor_coverage += seed_end - last_start;
            prev_start = (uint32_t)last_start;
        }
        if ((double)nonfactor_coverage > 0.5 * (double)seed_length) {
            ANCH_FREE_ALL();
            return from;
        }
    }

    /* ---- factor coverage vote (parse_anchored_shiftxor.cpp:471-526) ---- */
    if (po_sp_factor.n > 0) {
        /* maps keyed by motif length (bounded by max_motif) */
        i64 nkeys = c->max_motif + 3;
        c->anch_votes++;
        uint32_t *prev_starts = (uint32_t *)malloc((size_t)nkeys * 4);
        i64 *factor_cov = (i64 *)malloc((size_t)nkeys * sizeof(i64));
        uint8_t *present = (uint8_t *)calloc((size_t)nkeys, 1);
        for (i64 j = 0; j < po_sp_factorsizes.n; j++) {
            i64 fs = po_sp_factorsizes.d[j];
            prev_starts[fs] = 0xFFFFFFFFu;
            factor_cov[fs] = 0;
            present[fs] = 1;
        }
        for (i64 j = 0; j < po_sp_factor.n; j++) {
            i64 ktype = po_sp_factortypes.d[j];
            SeedList *src = ktype == RANK_P ? perfect
                            : (ktype == RANK_S ? substut : NULL);
            if (src != NULL) {
                if (j < src->n) {
                    last_start = src->d[j].start;
                    last_end = src->d[j].end;
                    last_mlen = src->d[j].mlen;
                } else {
                    last_start = last_end = last_mlen = 0;
                }
                last_rend = last_end + last_mlen;
            }
            /* operator[] default-inserts 0 for unseen keys */
            if (last_mlen >= 0 && last_mlen < nkeys && !present[last_mlen]) {
                prev_starts[last_mlen] = 0;
                factor_cov[last_mlen] = 0;
                present[last_mlen] = 1;
            }
            uint32_t prev_start = prev_starts[last_mlen];
            if ((uint32_t)last_rend >= prev_start)
                factor_cov[last_mlen] += (i64)prev_start - last_start;
            else if (last_rend < seed_end)
                factor_cov[last_mlen] += last_rend - last_start;
            else
                factor_cov[last_mlen] += seed_end - last_start;
            prev_starts[last_mlen] = (uint32_t)last_start;
        }
        int retagged = 0;
        for (i64 factor = 0; factor < nkeys && !retagged; factor++) {
            if (!present[factor]) continue;
            if ((double)factor_cov[factor] >= 0.8 * (double)seed_length) {
                motif_length = factor;
                seed_type = RANK_C;
                /* QUIRK: retag loop also indexes with j and uses the stale
                 * last_start/last_end (parse_anchored_shiftxor.cpp:511-522) */
                for (i64 j = 0; j < po_sp_factor.n; j++) {
                    i64 ktype = po_sp_factortypes.d[j];
                    if (ktype == RANK_P) {
                        if (j < perfect->n && perfect->d[j].mlen == factor) {
                            /* positional write: if the streaming merge
                             * already consumed this entry, the streamed
                             * seed stream no longer matches the batch
                             * merge — poison it (caller re-merges) */
                            if (c->stream_cb && j < c->sm_pi)
                                c->stream_poisoned = 1;
                            perfect->d[j].start = last_start;
                            perfect->d[j].end = last_end;
                            perfect->d[j].rank = RANK_N;
                        }
                    } else if (ktype == RANK_S) {
                        if (j < substut->n && substut->d[j].mlen == factor) {
                            if (c->stream_cb && j < c->sm_si)
                                c->stream_poisoned = 1;
                            substut->d[j].start = last_start;
                            substut->d[j].end = last_end;
                            substut->d[j].rank = RANK_N;
                        }
                    }
                }
                retagged = 1;
            }
        }
        free(prev_starts);
        free(factor_cov);
        free(present);
    }

    if (seed_end > c->L - motif_length) seed_end = c->L - motif_length;
    {
        Seed s = {seed_start, seed_end, motif_length, seed_type};
        sl_push(anchored, s);
    }
    ANCH_FREE_ALL();
    return from;
#undef ANCH_FREE_ALL
}

/* ------------------------------------------------------------------ */
/* scanner replays (events.py)                                        */
/* ------------------------------------------------------------------ */

/* perfect scanner: turn per-channel runs into the insertion order of
 * processShiftXORsPerfect (events.py:run_perfect_scan) */
static void run_perfect_scan(RibbitCore *c) {
    EVec events;
    ev_init(&events);
    i64 L = c->L;
    for (i32 didx = 0; didx < c->nmotifs; didx++) {
        i64 m = c->min_motif + didx;
        i64 cutoff = m <= 6 ? 12 - m : m;
        /* QUIRK: N-closed runs use cutoff m + midx (parse_perfect_shiftxor.cpp:179) */
        i64 midx = m - c->min_shift;
        i64 cutoff_n = m <= 6 ? 12 - m : m + midx;
        IV32 *ss = &c->perf_s[didx], *ee = &c->perf_e[didx];
        for (i64 r = 0; r < ss->n; r++) {
            i64 s = ss->d[r], e = ee->d[r];
            if (e >= L) {
                /* final flush uses window_position L-1 */
                if ((L - 1) - s >= cutoff) {
                    Emis em = {.pos = (i32)(L), .s = (i32)(s), .e = (i32)(L - 1), .didx = (int16_t)didx, .sub = 0, ._pad = 0};
                    ev_push(&events, em);
                }
            } else if (c->nmask[e]) {
                if (e - s >= cutoff_n) {
                    Emis em = {.pos = (i32)(e), .s = (i32)(s), .e = (i32)(e), .didx = (int16_t)didx, .sub = 0, ._pad = 0};
                    ev_push(&events, em);
                }
            } else {
                if (e - s >= cutoff) {
                    Emis em = {.pos = (i32)(e), .s = (i32)(s), .e = (i32)(e), .didx = (int16_t)didx, .sub = 0, ._pad = 0};
                    ev_push(&events, em);
                }
            }
        }
    }
    emis_sort_stable(events.d, events.n);
    for (i64 k = 0; k < events.n; k++) {
        i64 m = c->min_motif + events.d[k].didx;
        add_seed_perfect(c, events.d[k].s, events.d[k].e, m);
    }
    ev_free(&events);
    for (i32 didx = 0; didx < c->nmotifs; didx++) {
        iv32_free(&c->perf_s[didx]);
        iv32_free(&c->perf_e[didx]);
    }
}



/* fill per-channel emission vectors in parallel (each channel's windowed
 * state machine is independent; only the merged consumption is serial) */
typedef struct {
    RibbitCore *c;
    EVec *per;
    IV32 *qs, *qe;
    int free_runs;          /* free each channel's runs after converting */
    i64 next;
} EmisGenPool;

static void *emis_gen_worker(void *arg) {
    EmisGenPool *p = (EmisGenPool *)arg;
    for (;;) {
        i64 d = __atomic_fetch_add(&p->next, 1, __ATOMIC_RELAXED);
        if (d >= p->c->nmotifs) break;
        i64 m = p->c->min_motif + d;
        /* emissions <= qualified runs + EOF flushes: reserve once */
        EVec *v = &p->per[d];
        v->cap = p->qs[d].n + 4;
        v->d = (Emis *)malloc((size_t)v->cap * sizeof(Emis));
        windowed_emissions(p->c, &p->qs[d], &p->qe[d], m, (i32)d, v);
        if (p->free_runs) {             /* runs are dead once converted */
            iv32_free(&p->qs[d]);
            iv32_free(&p->qe[d]);
        }
    }
    return NULL;
}

static void gen_emissions_parallel(RibbitCore *c, IV32 *qs, IV32 *qe,
                                   EVec *per, int free_runs) {
    i64 nthreads = c->nthreads;
    if (nthreads <= 0) {
        const char *env = getenv("RIBBIT_THREADS");
        if (env) nthreads = atoll(env);
        else nthreads = (i64)sysconf(_SC_NPROCESSORS_ONLN);
    }
    if (nthreads < 1) nthreads = 1;
    if (nthreads > c->nmotifs) nthreads = c->nmotifs;
    EmisGenPool pool = {c, per, qs, qe, free_runs, 0};
    if (nthreads == 1) {
        emis_gen_worker(&pool);
        return;
    }
    pthread_t tids[64];
    if (nthreads > 64) nthreads = 64;
    for (i64 t = 0; t < nthreads; t++)
        pthread_create(&tids[t], NULL, emis_gen_worker, &pool);
    for (i64 t = 0; t < nthreads; t++)
        pthread_join(tids[t], NULL);
}

static void run_substitution_scan(RibbitCore *c) {
    EVec *per = c->q7_emis;          /* streamed during generation */
    c->q7_emis = NULL;
    if (!per) {                      /* injected-events path: runs given */
        per = (EVec *)xcalloc((size_t)c->nmotifs, sizeof(EVec));
        gen_emissions_parallel(c, c->q7_s, c->q7_e, per, 1);
    }
    i64 *cutoffs = (i64 *)malloc((size_t)c->nmotifs * sizeof(i64));
    for (i32 d = 0; d < c->nmotifs; d++) {
        i64 m = c->min_motif + d;
        cutoffs[d] = m > 30 ? m / 3 : 10;
    }
    EvMerge mg;
    evm_init(&mg, per, c->nmotifs);
    Emis ev;
    i64 from_index = 0;
    while (evm_next(&mg, &ev)) {
        i64 m = c->min_motif + ev.didx;
        from_index = add_seed_substitution(c, ev.s, ev.e, m, cutoffs,
                                           from_index, RANK_S);
    }
    evm_free(&mg);
    free(cutoffs);
    for (i32 d = 0; d < c->nmotifs; d++) ev_free(&per[d]);
    free(per);
}

/* build classified sinks from sorted per-channel emission vectors
 * (injected-events path / disorder fallback); consumes and frees `per` */
static Q6Sink *sinks_from_evec(RibbitCore *c, EVec *per) {
    i32 nm = c->nmotifs;
    Q6Sink *sink = (Q6Sink *)xcalloc((size_t)nm, sizeof(Q6Sink));
    for (i32 d = 0; d < nm; d++) {
        i64 m = c->min_motif + d;
        i64 cut = m > 6 ? m : 10;
        if (m >= 10) cut = (i64)(0.9 * (double)m);
        sink[d].cutoff = cut;
        sink[d].L = c->L;
        sink[d].last_pos = -1;
        for (i64 i = 0; i < per[d].n; i++)
            q6sink_push(&sink[d], per[d].d[i]);
        q6sink_flush(&sink[d]);
        ev_free(&per[d]);
    }
    free(per);
    return sink;
}

/* Incremental 3-pointer merge for the streaming scan.  Replays
 * final_merge's walk (same pick + RANK_N skip + 0.9*m filter) but only as
 * far as provably-final entries allow:
 *   - entries with end < W are final: every in-consume mutation
 *     (RANK_N tombstoning in add_seed_anchored's candidate loop) touches
 *     only entries with end >= seed_start, and W lower-bounds every future
 *     event's seed start (min over per-channel surviving heads, s
 *     nondecreasing per channel — encoder-verified);
 *   - entry start/end/mlen never change after append and appends go to the
 *     anchored tail, so head-start comparisons are stable; the one
 *     exception, the positional RANK_C retag quirk, is poison-detected at
 *     its write site against sm_pi/sm_si;
 *   - while the consume runs (done == 0), the anchored head must exist
 *     (sm_ai < A->n), else a future append would have competed in this
 *     pick.
 * Emits in batches through stream_cb and mirrors every emitted seed into
 * final_seeds so ribbit_core_get_seeds stays coherent. */
static void stream_merge_step(RibbitCore *c, i64 W, int done) {
    if (!c->stream_cb || c->stream_poisoned) return;
    SeedList *P = &c->perfect, *S = &c->substut, *A = &c->anchored;
    i64 batch[4 * 128];
    i64 bn = 0;
    for (;;) {
        i64 pi = c->sm_pi, si = c->sm_si, ai = c->sm_ai;
        if (!done && ai >= A->n) break;
        if (pi >= P->n && si >= S->n && ai >= A->n) break;
        i64 smallest = ((i64)1 << 62);
        i64 smallest_type = c->sm_type;
        if (pi < P->n && smallest > P->d[pi].start) {
            smallest = P->d[pi].start;
            smallest_type = RANK_P;
        }
        if (si < S->n && smallest > S->d[si].start) {
            smallest = S->d[si].start;
            smallest_type = RANK_S;
        }
        if (ai < A->n && smallest > A->d[ai].start) {
            smallest = A->d[ai].start;
            smallest_type = RANK_A;
        }
        Seed sd;
        if (smallest_type == RANK_P) sd = P->d[pi];
        else if (smallest_type == RANK_S) sd = S->d[si];
        else sd = A->d[ai];
        if (!done && sd.end >= W) break;      /* rank not final yet */
        c->sm_type = smallest_type;
        if (smallest_type == RANK_P) c->sm_pi++;
        else if (smallest_type == RANK_S) c->sm_si++;
        else c->sm_ai++;

        if (sd.rank == RANK_N) continue;
        if ((double)(sd.end - sd.start) < 0.9 * (double)sd.mlen) continue;
        sl_push(&c->final_seeds, sd);
        batch[bn * 4 + 0] = sd.start;
        batch[bn * 4 + 1] = sd.end;
        batch[bn * 4 + 2] = sd.mlen;
        batch[bn * 4 + 3] = sd.rank;
        if (++bn == 128) {
            c->stream_cb(c->stream_arg, batch, bn);
            bn = 0;
        }
    }
    if (bn) c->stream_cb(c->stream_arg, batch, bn);
}

static void run_anchored_scan(RibbitCore *c) {
    const char *timing = getenv("RIBBIT_CORE_TIMING");
    struct timespec a0, a1;
#define ATICK(label) do { if (timing) { \
    clock_gettime(CLOCK_MONOTONIC, &a1); \
    fprintf(stderr, "[core]   anchored.%-8s %.3fs\n", label, \
            (double)(a1.tv_sec - a0.tv_sec) + 1e-9 * (a1.tv_nsec - a0.tv_nsec)); \
    a0 = a1; } } while (0)
    if (timing) clock_gettime(CLOCK_MONOTONIC, &a0);
    Q6Sink *sink = c->q6_sink;       /* classified during generation */
    c->q6_sink = NULL;
    if (sink) {
        int disorder = 0;
        for (i32 d = 0; d < c->nmotifs; d++)
            if (sink[d].disorder) disorder = 1;
        if (disorder) {
            /* never expected (emission order is monotone by
             * construction): regenerate as plain sorted vectors */
            fprintf(stderr, "ribbit-core: anchored emission disorder; "
                            "regenerating\n");
            for (i32 d = 0; d < c->nmotifs; d++) {
                free(sink[d].sv.d);
                free(sink[d].rj.d);
            }
            free(sink);
            sink = NULL;
            c->q6_evec_mode = 1;
            generate_events(c);
            /* the substitution stream was already consumed: drop the
             * regenerated copy */
            for (i32 d = 0; d < c->nmotifs; d++) ev_free(&c->q7_emis[d]);
            free(c->q7_emis);
            c->q7_emis = NULL;
        }
    }
    if (!sink) {                     /* injected events / fallback */
        EVec *per = c->q6_emis;
        c->q6_emis = NULL;
        if (!per) {
            per = (EVec *)xcalloc((size_t)c->nmotifs, sizeof(EVec));
            gen_emissions_parallel(c, c->q6_s, c->q6_e, per, 1);
        }
        ev_ensure_sorted(per, c->nmotifs);
        sink = sinks_from_evec(c, per);
    }
    ATICK("emisgen");
    i64 *cutoffs = (i64 *)malloc((size_t)c->nmotifs * sizeof(i64));
    for (i32 d = 0; d < c->nmotifs; d++) {
        i64 m = c->min_motif + d;
        i64 cut = m > 6 ? m : 10;
        if (m >= 10) cut = (i64)(0.9 * (double)m);
        cutoffs[d] = cut;
    }
    ATICK("mginit");
    FromIdx from = {0, 0};
    /* Cutoff-rejected emissions (the vast majority on repeat-dense input)
     * only advance the from-cursors: add_seed_anchored returns right after
     * its entry advance when seed_end - seed_start < cutoff, and cursor
     * advances compose through max (see advance_cursor).  The heap
     * therefore carries only each channel's next SURVIVING emission
     * (global merge key (pos << 16) | channel, ties within a channel by
     * generation order, exactly emis_cmp); the rejected majority is folded
     * into `pend` by per-channel fold cursors that drain, at each
     * surviving event, every event ordered strictly before it.  The
     * stream of add_seed_anchored calls and the from-cursor values they
     * observe are bit-identical to the full single-stream merge, with the
     * heap sifts for ~16x-more-frequent rejected events replaced by
     * linear cursor scans. */
    i64 pend = -1;
#define ANCH_APPLY_PEND() do { if (pend >= 0) { \
        from.fip = advance_cursor(&c->perfect, from.fip, pend); \
        from.fis = advance_cursor(&c->substut, from.fis, pend); \
        pend = -1; } } while (0)
    {
        const i64 KMAX = (i64)1 << 62;
        i32 nch = c->nmotifs;
        RDec *rdec = (RDec *)xmalloc((size_t)nch * sizeof(RDec));
        SDec *sdec = (SDec *)xmalloc((size_t)nch * sizeof(SDec));
        i64 *rkey = (i64 *)xmalloc((size_t)nch * sizeof(i64));
        uint64_t *heap = (uint64_t *)xmalloc((size_t)nch * sizeof(uint64_t));
        i32 hn = 0;
        /* lazy min-heap over the channels' next REJECTED keys: the fold
         * touches only channels that actually hold records below the
         * event key instead of scanning all nch per event (the scan was
         * ~60% of consume at 250 Mb: 47M events x 99 channels).  Entries
         * may go stale when the own-channel nrej drain advances a
         * decoder; a popped entry that mismatches rkey[] is dropped and
         * the current key re-pushed. */
        uint64_t *rheap = (uint64_t *)xmalloc((size_t)(nch + 1)
                                              * sizeof(uint64_t));
        i64 rcap = nch + 1;
        i32 rhn = 0;
#define RHEAP_PUSH(k) do { \
        if (rhn == rcap) { rcap += rcap >> 1; \
            rheap = (uint64_t *)xrealloc(rheap, (size_t)rcap * 8); } \
        u64heap_push(rheap, &rhn, (uint64_t)(k)); } while (0)
        int stream_ok = c->stream_cb != NULL;
        i64 stream_tick = 0;
        for (i32 d = 0; d < nch; d++) {
            rdec_init(&rdec[d], &sink[d].rj);
            rkey[d] = rdec[d].valid
                          ? (((i64)rdec[d].pos << 16) | d) : KMAX;
            if (rdec[d].valid) RHEAP_PUSH(rkey[d]);
            sdec_init(&sdec[d], &sink[d].sv);
            if (sdec[d].valid)
                u64heap_push(heap, &hn,
                             ((uint64_t)sdec[d].pos << 16) | (uint64_t)d);
            if (sink[d].sv.s_desc) stream_ok = 0;
        }
        while (hn) {
            i32 d = (i32)(heap[0] & 0xFFFF);
            SDec *ev = &sdec[d];
            i64 skey = ((i64)ev->pos << 16) | d;

            /* fold every rejected event ordered before ev: strictly
             * smaller key in other channels (rejected entries there are
             * all that can precede — the heap pops surviving keys in
             * global order), generation order < ev in ev's own channel
             * (ev.nrej counts them; equal-key cross-channel ties are
             * impossible — the key embeds the channel).  pend composes
             * through max, so drain order across channels is free. */
            PROF_T0(tf0);
            {
                RDec *r = &rdec[d];
                int adv = r->valid && r->idx < ev->nrej;
                if (r->fast) {
                    const uint8_t *save = NULL; i64 spos = 0;
                    while (r->valid && r->idx < ev->nrej) {
                        if (*r->p & 1) { save = r->p; spos = r->pos; }
                        rdec_next(r);
                    }
                    rdec_fold_saved(save, spos, &pend);
                } else {
                    while (r->valid && r->idx < ev->nrej) {
                        rdec_fold_one(r, &pend);
                        rdec_next(r);
                    }
                }
                if (adv) {
                    rkey[d] = r->valid ? (((i64)r->pos << 16) | d) : KMAX;
                    if (r->valid) RHEAP_PUSH(rkey[d]);
                }
            }
            while (rhn && (i64)rheap[0] < skey) {
                i32 dd = (i32)(rheap[0] & 0xFFFF);
                uint64_t top = rheap[0];
                rheap[0] = rheap[--rhn];
                u64heap_sift_down(rheap, rhn);
                if ((i64)top != rkey[dd]) continue;       /* stale */
                RDec *r = &rdec[dd];
                if (r->fast) {
                    const uint8_t *save = NULL; i64 spos = 0;
                    while (r->valid && ((((i64)r->pos << 16) | dd) < skey)) {
                        if (*r->p & 1) { save = r->p; spos = r->pos; }
                        rdec_next(r);
                    }
                    rdec_fold_saved(save, spos, &pend);
                } else {
                    while (r->valid && ((((i64)r->pos << 16) | dd) < skey)) {
                        rdec_fold_one(r, &pend);
                        rdec_next(r);
                    }
                }
                rkey[dd] = r->valid ? (((i64)r->pos << 16) | dd) : KMAX;
                if (r->valid) RHEAP_PUSH(rkey[dd]);
            }
            PROF_ADD(PROF_FOLD, tf0);

            i64 m = c->min_motif + d;
            if (ev->pos < c->L) {
                ANCH_APPLY_PEND();
                from = add_seed_anchored(c, ev->s, ev->e, m, cutoffs, from,
                                         RANK_A);
            } else {
                /* global-next after an EOF emission is its own channel's
                 * next generated entry whenever it is the sub=1 half of a
                 * "save both separately" pair (flag precomputed with the
                 * one-entry lookahead at generation) */
                ANCH_APPLY_PEND();
                FromIdx nf = add_seed_anchored(c, ev->s, ev->e, m, cutoffs,
                                               from, RANK_A);
                if (ev->updates) from = nf;
            }

            sdec_next(ev);
            if (ev->valid)
                heap[0] = ((uint64_t)ev->pos << 16) | (uint64_t)d;
            else
                heap[0] = heap[--hn];
            u64heap_sift_down(heap, hn);

            /* streaming: periodically release provably-final merged seeds
             * to the refinement pool.  W = min surviving head s across
             * channels (all decoders already sit past the event just
             * processed), a lower bound on every future seed start. */
            if (stream_ok && !c->stream_poisoned && ++stream_tick >= 1024) {
                stream_tick = 0;
                i64 W = ((i64)1 << 62);
                for (i32 dd = 0; dd < nch; dd++)
                    if (sdec[dd].valid && sdec[dd].s < W) W = sdec[dd].s;
                if (W > 0) stream_merge_step(c, W, 0);
            }
        }
        free(rdec); free(sdec); free(rkey); free(heap); free(rheap);
#undef RHEAP_PUSH
    }
#undef ANCH_APPLY_PEND
    ATICK("consume");
    if (prof_on()) {
        fprintf(stderr, "[core] prof calls=%lld restarts=%lld cand=%lld "
                "cursor=%.2fGc mal=%.2fGc body=%.2fGc fold=%.2fGc\n",
                (long long)g_prof_n[PROF_CALLS],
                (long long)g_prof_n[PROF_RESTARTS],
                (long long)g_prof_n[PROF_CAND],
                g_prof[PROF_CURSOR] / 1e9, g_prof[PROF_MAL] / 1e9,
                g_prof[PROF_LOOP] / 1e9, g_prof[PROF_FOLD] / 1e9);
    }
#undef ATICK
    free(cutoffs);
    for (i32 d = 0; d < c->nmotifs; d++) {
        free(sink[d].sv.d);
        free(sink[d].rj.d);
    }
    free(sink);
}

/* final 3-pointer merge by seed start (pipeline.py / fasta_utils.cpp:181-242);
 * emits seeds passing the len >= 0.9*m filter, skipping RANK_N */
static void final_merge(RibbitCore *c) {
    i64 pi = 0, si = 0, ai = 0;
    SeedList *P = &c->perfect, *S = &c->substut, *A = &c->anchored;
    i64 smallest_type = -1;
    while (pi < P->n || si < S->n || ai < A->n) {
        i64 smallest = ((i64)1 << 62);
        if (pi < P->n && smallest > P->d[pi].start) {
            smallest = P->d[pi].start;
            smallest_type = RANK_P;
        }
        if (si < S->n && smallest > S->d[si].start) {
            smallest = S->d[si].start;
            smallest_type = RANK_S;
        }
        if (ai < A->n && smallest > A->d[ai].start) {
            smallest = A->d[ai].start;
            smallest_type = RANK_A;
        }
        Seed sd;
        if (smallest_type == RANK_P) sd = P->d[pi++];
        else if (smallest_type == RANK_S) sd = S->d[si++];
        else sd = A->d[ai++];

        if (sd.rank == RANK_N) continue;
        if ((double)(sd.end - sd.start) >= 0.9 * (double)sd.mlen)
            sl_push(&c->final_seeds, sd);
    }
}

/* ------------------------------------------------------------------ */
/* public API (ctypes)                                                */
/* ------------------------------------------------------------------ */

void ribbit_core_set_threads(RibbitCore *c, i32 n);

RibbitCore *ribbit_core_create(const int8_t *code, const uint8_t *nmask,
                               i64 L, i32 min_motif, i32 max_motif) {
    RibbitCore *c = (RibbitCore *)calloc(1, sizeof(RibbitCore));
    c->code = code;
    c->nmask = nmask;
    c->L = L;
    c->min_motif = min_motif;
    c->max_motif = max_motif;
    c->min_shift = min_motif > 2 ? min_motif - 2 : 1;
    c->max_shift = max_motif + 2;
    c->nshifts = c->max_shift - c->min_shift + 1;
    c->nmotifs = max_motif - min_motif + 1;
    sl_init(&c->perfect);
    sl_init(&c->substut);
    sl_init(&c->anchored);
    sl_init(&c->final_seeds);
    c->sm_type = -1;
    return c;
}

/* inject externally produced events (e.g. from the device extractor):
 * flattened per-channel run arrays with offsets[nmotifs+1] */
void ribbit_core_set_events(RibbitCore *c,
                            const i64 *pf_s, const i64 *pf_e, const i64 *pf_off,
                            const i64 *q7_s, const i64 *q7_e, const i64 *q7_off,
                            const i64 *q6_s, const i64 *q6_e, const i64 *q6_off) {
    i32 nm = c->nmotifs;
    c->perf_s = (IV32 *)calloc(nm, sizeof(IV32));
    c->perf_e = (IV32 *)calloc(nm, sizeof(IV32));
    c->q7_s = (IV32 *)calloc(nm, sizeof(IV32));
    c->q7_e = (IV32 *)calloc(nm, sizeof(IV32));
    c->q6_s = (IV32 *)calloc(nm, sizeof(IV32));
    c->q6_e = (IV32 *)calloc(nm, sizeof(IV32));
    for (i32 d = 0; d < nm; d++) {
        for (i64 k = pf_off[d]; k < pf_off[d + 1]; k++) {
            iv32_push(&c->perf_s[d], pf_s[k]);
            iv32_push(&c->perf_e[d], pf_e[k]);
        }
        for (i64 k = q7_off[d]; k < q7_off[d + 1]; k++) {
            iv32_push(&c->q7_s[d], q7_s[k]);
            iv32_push(&c->q7_e[d], q7_e[k]);
        }
        for (i64 k = q6_off[d]; k < q6_off[d + 1]; k++) {
            iv32_push(&c->q6_s[d], q6_s[k]);
            iv32_push(&c->q6_e[d], q6_e[k]);
        }
    }
    /* N-free segments */
    iv_init(&c->seg_a);
    iv_init(&c->seg_b);
    i64 p = 0;
    while (p < c->L) {
        while (p < c->L && c->nmask[p]) p++;
        if (p >= c->L) break;
        i64 s = p;
        while (p < c->L && !c->nmask[p]) p++;
        iv_push(&c->seg_a, s);
        iv_push(&c->seg_b, p);
    }
    build_eval_segments(c);
    c->events_ready = 1;
}

/* Run-capture API: generate events in capture mode (raw qualified runs +
 * perfect runs materialized per channel, scanner state machines bypassed)
 * and export them flattened channel-major.  Used by the exact chunked /
 * distributed paths: per-chunk capture -> clip/merge stitch -> ONE global
 * replay, removing the per-chunk replay's exposure to the reference's
 * positional-index vote quirk (parse_anchored_shiftxor.cpp:441-526). */
void ribbit_core_capture_runs(RibbitCore *c) {
    c->capture_runs = 1;
    generate_events(c);
}

static IV32 *runs_stream(RibbitCore *c, i32 stream, int end) {
    switch (stream) {
    case 0: return end ? c->perf_e : c->perf_s;
    case 1: return end ? c->q7_e : c->q7_s;
    default: return end ? c->q6_e : c->q6_s;
    }
}

i64 ribbit_core_runs_total(RibbitCore *c, i32 stream) {
    IV32 *v = runs_stream(c, stream, 0);
    if (!v) return 0;
    i64 tot = 0;
    for (i32 d = 0; d < c->nmotifs; d++) tot += v[d].n;
    return tot;
}

void ribbit_core_runs_export(RibbitCore *c, i32 stream,
                             i64 *starts, i64 *ends, i64 *offsets) {
    IV32 *vs = runs_stream(c, stream, 0);
    IV32 *ve = runs_stream(c, stream, 1);
    i64 k = 0;
    offsets[0] = 0;
    for (i32 d = 0; d < c->nmotifs; d++) {
        if (vs) {
            for (i64 i = 0; i < vs[d].n; i++) {
                starts[k] = vs[d].d[i];
                ends[k] = ve[d].d[i];
                k++;
            }
        }
        offsets[d + 1] = k;
    }
}

/* failedSeeds (fasta_utils.cpp:44-56): RANK_N entries in a list */
static i64 failed_seeds(const SeedList *l) {
    i64 n = 0;
    for (i64 i = 0; i < l->n; i++)
        if (l->d[i].rank == RANK_N) n++;
    return n;
}

i64 ribbit_core_scan(RibbitCore *c) {
    /* large event vectors and packed caches churn mmap/munmap under the
     * default glibc thresholds (see the matching note in ribbit_refine.c) */
    static int malloc_tuned = 0;
    if (!malloc_tuned) {
        mallopt(M_MMAP_THRESHOLD, 64 << 20);
        mallopt(M_TRIM_THRESHOLD, 64 << 20);
        malloc_tuned = 1;
    }
    const char *timing = getenv("RIBBIT_CORE_TIMING");
    struct timespec t0, t1;
#define TICK(label) do { if (timing) { \
    clock_gettime(CLOCK_MONOTONIC, &t1); \
    fprintf(stderr, "[core] %-12s %.3fs\n", label, \
            (double)(t1.tv_sec - t0.tv_sec) + 1e-9 * (t1.tv_nsec - t0.tv_nsec)); \
    if (getenv("RIBBIT_CORE_MEM")) print_rss(label); \
    t0 = t1; } } while (0)
    if (timing) clock_gettime(CLOCK_MONOTONIC, &t0);
    if (!c->events_ready) generate_events(c);
    TICK("generate");
    if (timing && getenv("RIBBIT_CORE_MEM")) {
        i64 bperf = 0, bq7 = 0, bsv = 0, brj = 0, bov = 0;
        for (i32 d = 0; d < c->nmotifs; d++) {
            if (c->perf_s) bperf += (c->perf_s[d].cap + c->perf_e[d].cap) * 4;
            if (c->q7_emis) bq7 += c->q7_emis[d].cap * (i64)sizeof(Emis);
            if (c->q6_sink) {
                bsv += c->q6_sink[d].sv.cap;
                brj += c->q6_sink[d].rj.cap;
            }
        }
        if (c->ov_pack) bov = (i64)c->nmotifs * c->ov_words * 8;
        fprintf(stderr, "[core] mem perf=%lldM q7=%lldM sv=%lldM rj=%lldM "
                "ov=%lldM seq=%lldM\n", (long long)(bperf >> 20),
                (long long)(bq7 >> 20), (long long)(bsv >> 20),
                (long long)(brj >> 20), (long long)(bov >> 20),
                (long long)(c->L >> 20));
    }
    c->overlay_phase = 0;
    run_perfect_scan(c);
    if (timing)
        fprintf(stderr, "[core] perfect seeds: %lld\n",
                (long long)c->perfect.n);
    TICK("perfect");
    run_substitution_scan(c);
    if (timing)
        fprintf(stderr, "[core] seeds considering substitutions: %lld\n",
                (long long)(c->perfect.n + c->substut.n
                            - failed_seeds(&c->perfect)
                            - failed_seeds(&c->substut)));
    TICK("substitution");
    c->overlay_phase = 1;
    run_anchored_scan(c);
    if (timing)
        fprintf(stderr, "[core] seeds considering indels: %lld\n",
                (long long)(c->perfect.n + c->substut.n + c->anchored.n
                            - failed_seeds(&c->perfect)
                            - failed_seeds(&c->substut)
                            - failed_seeds(&c->anchored)));
    TICK("anchored");
    if (c->stream_cb && !c->stream_poisoned) {
        if (getenv("RIBBIT_STREAM_DEBUG"))
            fprintf(stderr, "[stream] preflush final_seeds=%lld\n",
                    (long long)c->final_seeds.n);
        /* lists are final now: flush the incremental merge to completion */
        stream_merge_step(c, 0, 1);
    } else {
        /* batch, or poisoned stream: rebuild from scratch (the partial
         * incremental walk may have emitted pre-retag values) */
        c->final_seeds.n = 0;
        final_merge(c);
    }
    if (timing)
        fprintf(stderr, "[core] seeds processed for alignment: %lld\n",
                (long long)c->final_seeds.n);
    TICK("merge");
#undef TICK
    /* events, emissions and per-phase lattices are dead now; hand the
     * pages back before refinement starts allocating */
    malloc_trim(0);
    return c->final_seeds.n;
}

void ribbit_core_set_threads(RibbitCore *c, i32 n) { c->nthreads = n; }

i64 ribbit_core_anch_votes(RibbitCore *c) { return c->anch_votes; }

/* Streaming scan: like ribbit_core_scan, but finalized merged seeds are
 * delivered incrementally through cb during the anchored consume so the
 * caller can refine them concurrently with the (serial) lattice walk.
 * Returns the total seed count UNLESS the stream was poisoned by the
 * positional-retag quirk (see stream_merge_step), in which case it returns
 * the NEGATED count minus 1: the caller must discard every streamed batch
 * and re-pull the authoritative seeds via ribbit_core_get_seeds.  In the
 * clean case the streamed batches, concatenated, ARE the final seed list
 * (also mirrored into final_seeds). */
i64 ribbit_core_scan_stream(RibbitCore *c,
                            void (*cb)(void *arg, const i64 *seeds4, i64 n),
                            void *arg) {
    c->stream_cb = cb;
    c->stream_arg = arg;
    c->stream_poisoned = 0;
    /* test hook: force the poisoned path to exercise the exact fallback */
    if (getenv("RIBBIT_STREAM_FORCE_POISON")) c->stream_poisoned = 1;
    i64 n = ribbit_core_scan(c);
    c->stream_cb = NULL;
    c->stream_arg = NULL;
    return c->stream_poisoned ? -n - 1 : n;
}

void ribbit_core_get_seeds(RibbitCore *c, i64 *out) {
    for (i64 i = 0; i < c->final_seeds.n; i++) {
        out[i * 4 + 0] = c->final_seeds.d[i].start;
        out[i * 4 + 1] = c->final_seeds.d[i].end;
        out[i * 4 + 2] = c->final_seeds.d[i].mlen;
        out[i * 4 + 3] = c->final_seeds.d[i].rank;
    }
}

i64 ribbit_core_overlay_bitcount(RibbitCore *c, i32 midx, i64 a, i64 b) {
    return overlay_bitcount(c, midx, a, b);
}

i64 ribbit_core_overlay_longest_run(RibbitCore *c, i32 midx, i64 a, i64 b) {
    return overlay_longest_run(c, midx, a, b);
}

i32 ribbit_core_overlay_run3(RibbitCore *c, i32 midx, i64 a, i64 b) {
    return (i32)overlay_has_run3(c, midx, a, b);
}

/* release the packed overlay cache (12.4 B/bp); refinement's run3 query
 * falls back to chunked early-exit recompute */
void ribbit_core_drop_overlay(RibbitCore *c) {
    if (c->ov_pack) {
        for (i32 d = 0; d < c->nmotifs; d++) free(c->ov_pack[d]);
        free(c->ov_pack);
        c->ov_pack = NULL;
        malloc_trim(0);
    }
}

void ribbit_core_destroy(RibbitCore *c) {
    if (!c) return;
    if (c->perf_s) {
        for (i32 d = 0; d < c->nmotifs; d++) {
            iv32_free(&c->perf_s[d]); iv32_free(&c->perf_e[d]);
        }
        free(c->perf_s); free(c->perf_e);
    }
    if (c->q7_s) {                  /* injected-events path only */
        for (i32 d = 0; d < c->nmotifs; d++) {
            iv32_free(&c->q7_s[d]); iv32_free(&c->q7_e[d]);
            iv32_free(&c->q6_s[d]); iv32_free(&c->q6_e[d]);
        }
        free(c->q7_s); free(c->q7_e);
        free(c->q6_s); free(c->q6_e);
    }
    if (c->q7_emis) {               /* scan never consumed them */
        for (i32 d = 0; d < c->nmotifs; d++) ev_free(&c->q7_emis[d]);
        free(c->q7_emis);
    }
    if (c->q6_emis) {
        for (i32 d = 0; d < c->nmotifs; d++) ev_free(&c->q6_emis[d]);
        free(c->q6_emis);
    }
    if (c->q6_sink) {               /* scan never consumed them */
        for (i32 d = 0; d < c->nmotifs; d++) {
            free(c->q6_sink[d].sv.d);
            free(c->q6_sink[d].rj.d);
        }
        free(c->q6_sink);
    }
    free(c->q7_sm); free(c->q6_sm);
    free(c->eval_lo); free(c->eval_hi); free(c->evseg_b);
    if (c->ov_pack) {
        for (i32 d = 0; d < c->nmotifs; d++) free(c->ov_pack[d]);
        free(c->ov_pack);
    }
    iv_free(&c->seg_a);
    iv_free(&c->seg_b);
    for (int i = 0; i < 19; i++) iv_free(&c->scr[i]);
    sl_free(&c->perfect);
    sl_free(&c->substut);
    sl_free(&c->anchored);
    sl_free(&c->final_seeds);
    free(c);
}
