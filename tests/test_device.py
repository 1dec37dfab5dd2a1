"""Device-path tests on the virtual 8-device CPU mesh.

Covers: the full-bitmap device scan backend vs the host reference, the
compact event-extraction kernel (streams equal to the native host
extractor, BED parity through the native core), the overlap pipeline and
its error behaviour, the driver entry points, and the sharded multi-device
scan step.  Tests marked `gpu` repeat the exactness checks on the card.
"""

import numpy as np
import pytest

from ribbit_tpu.config import RibbitConfig


def test_scan_arrays_device_vs_host(cpu_jax):
    from ribbit_tpu import scan_host, scan_tpu
    from ribbit_tpu.sim import simulate
    from ribbit_tpu.encode import encode

    cfg = RibbitConfig.create()
    sim = simulate(num_loci=3, seed=21, name="dev", n_block_rate=0.4)
    code, n_mask = encode(sim.sequence)

    eq_h = scan_host.match_bitmaps(code, cfg)
    an_h = scan_host.anchor_bitmaps(eq_h, cfg)
    ov_h = scan_host.overlay_bitmaps(eq_h, an_h, cfg)
    q7_h = scan_host.window_qualified(eq_h, n_mask, 7)
    q6_h = scan_host.window_qualified(ov_h, n_mask, 6)

    eq_t, an_t, ov_t, q7_t, q6_t = scan_tpu.scan_arrays(code, n_mask, cfg)
    assert np.array_equal(eq_h, eq_t)
    assert np.array_equal(an_h, an_t)
    assert np.array_equal(ov_h, ov_t)
    assert np.array_equal(q7_h, q7_t)
    assert np.array_equal(q6_h, q6_t)


@pytest.mark.parametrize("golden", ["g1", "g2", "g3"])
def test_event_kernel_bed_parity(cpu_jax, golden_dir, golden):
    """Device event extraction -> native core -> BED must equal the oracle."""
    from ribbit_tpu.fasta import read_fasta
    from ribbit_tpu.pipeline import process_sequence

    cfg = RibbitConfig.create()
    lines = []
    for sid, seq in read_fasta(str(golden_dir / f"{golden}.fa")):
        process_sequence(sid, seq, cfg, out=lines, scan_backend="device")
    expected = (golden_dir / f"{golden}.oracle.bed").read_text().splitlines()
    assert lines == expected


def _fixture(kind: str, cfg: RibbitConfig) -> str:
    """Small seeded sequences: repeat-dense (short spacers) or N-gapped
    (frequent N blocks plus one long N run)."""
    from ribbit_tpu.sim import simulate
    kw = dict(min_motif=cfg.min_motif, max_motif=cfg.max_motif, max_units=30)
    if kind == "dense":
        return simulate(num_loci=10, seed=11, buffer_range=(20, 120),
                        **kw).sequence
    a = simulate(num_loci=4, seed=12, n_block_rate=0.6, **kw).sequence
    b = simulate(num_loci=4, seed=13, n_block_rate=0.6, **kw).sequence
    return a + "N" * 700 + b


def _assert_streams_equal(got, want):
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert np.array_equal(np.asarray(a, dtype=np.int64),
                                  np.asarray(b, dtype=np.int64))


@pytest.mark.parametrize("kind", ["dense", "ngapped"])
@pytest.mark.parametrize("motifs", [(2, 100), (2, 6), (10, 30)])
def test_xla_extractor_matches_host(cpu_jax, motifs, kind):
    """The XLA extractor's three event streams are bit-identical to the
    native host extractor's (capture_runs_host) for every motif setting."""
    from ribbit_tpu.encode import encode
    from ribbit_tpu.eventstitch import capture_runs_host
    from ribbit_tpu.scan_events_tpu import scan_events

    cfg = RibbitConfig.create(min_motif=motifs[0], max_motif=motifs[1])
    code, n_mask = encode(_fixture(kind, cfg))
    dev = scan_events(code, n_mask, cfg)
    assert sum(s.shape[0] for s, _e, _o in dev) > 0
    _assert_streams_equal(dev, capture_runs_host(code, n_mask, cfg))


def test_event_capacity_autotune(cpu_jax):
    """Undersized event caps must self-heal: scan_events retries with grown
    capacities (learned per length bucket) instead of falling back."""
    from ribbit_tpu import scan_events_tpu
    from ribbit_tpu.scan_tpu import _pad_to_bucket
    from ribbit_tpu.sim import simulate
    from ribbit_tpu.encode import encode

    cfg = RibbitConfig.create()
    sim = simulate(num_loci=3, seed=33, name="cap")
    code, n_mask = encode(sim.sequence)
    Lp = _pad_to_bucket(code.shape[0])

    baseline = scan_events_tpu.scan_events(code, n_mask, cfg)

    saved = dict(scan_events_tpu._learned_caps)
    try:
        # poison the bucket with absurdly small caps: every stream overflows
        scan_events_tpu._learned_caps.clear()
        scan_events_tpu._learned_caps[Lp] = (64, 64, 64)
        healed = scan_events_tpu.scan_events(code, n_mask, cfg)
        grown = scan_events_tpu._learned_caps[Lp]
        # every stream whose true event count exceeded 64 must have grown
        counts = [g[0].shape[0] for g in baseline]
        assert any(g > 64 for g in grown)
        for n, g in zip(counts, grown):
            if n > 64:
                assert g >= n
    finally:
        scan_events_tpu._learned_caps.clear()
        scan_events_tpu._learned_caps.update(saved)

    for grp_a, grp_b in zip(baseline, healed):
        for a, b in zip(grp_a, grp_b):
            assert np.array_equal(a, b)


def test_entry_compiles(cpu_jax):
    import __graft_entry__
    fn, args = __graft_entry__.entry()
    out = fn(*args)
    cpu_jax.block_until_ready(out)
    assert out[0].shape[0] == 102


def test_dryrun_multichip(cpu_jax):
    import __graft_entry__
    __graft_entry__.dryrun_multichip(8)


def test_sharded_scan_matches_single_device(cpu_jax):
    """The mesh-sharded chunk scan must equal the unsharded computation."""
    from ribbit_tpu.parallel import make_mesh, sharded_scan_step
    from ribbit_tpu.parallel.sharded_scan import _chunk_scan

    cfg = RibbitConfig.create(min_motif=2, max_motif=12)
    rng = np.random.default_rng(5)
    B, C = 8, 256
    code = rng.integers(0, 4, (B, C)).astype(np.int8)
    n_mask = np.zeros((B, C), dtype=bool)

    mesh = make_mesh(8)
    step = sharded_scan_step(mesh, cfg)
    eq_sh, counts_sh, total_sh = step(code, n_mask)

    import jax.numpy as jnp
    eq_ref, counts_ref = _chunk_scan(jnp.asarray(code), jnp.asarray(n_mask),
                                     min_shift=cfg.min_shift,
                                     nshifts=cfg.nshifts)
    assert np.array_equal(np.asarray(eq_sh), np.asarray(eq_ref))
    assert np.array_equal(np.asarray(counts_sh), np.asarray(counts_ref))
    assert int(total_sh[0]) == int(np.asarray(counts_ref).sum())


def test_multi_contig_tpu_backend_overlap_parity(cpu_jax, tmp_path):
    """Multi-contig --backend device (device-producer / host-consumer
    pipeline) must match the host path byte-for-byte in file order,
    including an empty record."""
    from ribbit_tpu.pipeline import process_fasta
    from ribbit_tpu.sim import simulate

    fa = tmp_path / "multi.fa"
    with open(fa, "w") as fh:
        for ci in range(3):
            sim = simulate(num_loci=3, seed=40 + ci, name=f"c{ci}",
                           n_block_rate=0.2)
            fh.write(f">c{ci}\n{sim.sequence}\n")
            if ci == 1:
                fh.write(">empty\n\n")
    cfg = RibbitConfig.create()
    host = process_fasta(str(fa), cfg, scan_backend="host")
    dev = process_fasta(str(fa), cfg, scan_backend="device")
    assert dev == host


def test_tpu_overlap_prefetch_is_bounded(cpu_jax, tmp_path, monkeypatch):
    """The device-producer pipeline must hold at most PREFETCH+1 contigs'
    extracted events in flight — an eager submit-all would accumulate every
    contig's event streams before the host consumes any."""
    import ribbit_tpu.pipeline as pl
    from ribbit_tpu import eventstitch
    from ribbit_tpu.config import RibbitConfig
    from ribbit_tpu.sim import simulate

    fa = tmp_path / "many.fa"
    with open(fa, "w") as fh:
        for ci in range(8):
            sim = simulate(num_loci=2, seed=60 + ci, name=f"c{ci}")
            fh.write(f">c{ci}\n{sim.sequence}\n")

    state = {"started": 0, "consumed": 0, "max_ahead": 0}
    real = eventstitch.scan_events_segmented

    def spy(*a, **kw):
        state["started"] += 1
        state["max_ahead"] = max(state["max_ahead"],
                                 state["started"] - state["consumed"])
        return real(*a, **kw)

    monkeypatch.setattr(eventstitch, "scan_events_segmented", spy)
    cfg = RibbitConfig.create()
    from ribbit_tpu.fasta import read_fasta
    records = list(read_fasta(str(fa)))
    todo = [(i, sid, seq) for i, (sid, seq) in enumerate(records)]
    for _sid, _n, _lines in pl._fasta_records_device_overlap(records, todo,
                                                             cfg):
        state["consumed"] += 1

    assert state["started"] == 8
    # PREFETCH=2 -> at most PREFETCH+1 extractions ahead of consumption
    assert state["max_ahead"] <= 3, state


def test_tpu_overlap_overcap_contig_falls_back(cpu_jax, tmp_path,
                                               monkeypatch):
    """A contig past the native i32 cap inside a multi-contig device run must
    route through process_sequence's auto-chunk path, not crash."""
    import ribbit_tpu.core as core_mod
    import ribbit_tpu.pipeline as pl
    from ribbit_tpu.config import RibbitConfig
    from ribbit_tpu.sim import simulate

    # c1 carries a big N run so the over-cap auto-chunk fallback can
    # split exactly (raw-offset splits are best-effort by contract)
    s0 = simulate(num_loci=3, seed=70, name="c0").sequence
    s1 = (simulate(num_loci=3, seed=71, name="c1a").sequence + "N" * 800
          + simulate(num_loci=3, seed=72, name="c1b").sequence)
    fa = tmp_path / "oc.fa"
    with open(fa, "w") as fh:
        fh.write(f">c0\n{s0}\n>c1\n{s1}\n")

    cfg = RibbitConfig.create()
    host = pl.process_fasta(str(fa), cfg, scan_backend="host")
    # pretend the larger contig exceeds the cap
    cap = max(len(s0), len(s1))
    monkeypatch.setattr(core_mod, "MAX_CONTIG", cap)
    monkeypatch.setattr(pl, "MAX_CONTIG", cap, raising=False)
    dev = pl.process_fasta(str(fa), cfg, scan_backend="device")
    assert dev == host


@pytest.mark.parametrize("route", ["process_sequence", "overlap"])
def test_device_extraction_error_propagates(cpu_jax, tmp_path, monkeypatch,
                                            route):
    """A device extraction error ends the run: it propagates out of both
    process_sequence and the multi-contig overlap path, with no host
    fallback."""
    import ribbit_tpu.pipeline as pl
    from ribbit_tpu import eventstitch
    from ribbit_tpu.sim import simulate

    sims = [simulate(num_loci=3, seed=80 + i, name=f"c{i}")
            for i in range(3)]
    fa = tmp_path / "af.fa"
    with open(fa, "w") as fh:
        for i, s in enumerate(sims):
            fh.write(f">c{i}\n{s.sequence}\n")

    real = eventstitch.scan_events_segmented
    state = {"n": 0}

    def flaky(*a, **kw):
        state["n"] += 1
        if state["n"] == 2:                # second contig's extraction
            raise OverflowError("synthetic autotune failure")
        return real(*a, **kw)

    monkeypatch.setattr(eventstitch, "scan_events_segmented", flaky)
    cfg = RibbitConfig.create()
    with pytest.raises(OverflowError, match="synthetic"):
        if route == "process_sequence":
            for s in sims:
                pl.process_sequence("c", s.sequence, cfg,
                                    scan_backend="device")
        else:
            pl.process_fasta(str(fa), cfg, scan_backend="device")
    assert state["n"] >= 2          # the overlap path prefetches ahead


@pytest.mark.gpu
def test_xla_extractor_matches_host_on_gpu(gpu):
    """On the card: the XLA extractor at a full extraction window equals
    the native host extractor exactly."""
    from ribbit_tpu.encode import encode
    from ribbit_tpu.eventstitch import HALO, SEG_SIZE, capture_runs_host
    from ribbit_tpu.scan_events_tpu import scan_events
    from ribbit_tpu.sim import simulate

    cfg = RibbitConfig.create()
    L = SEG_SIZE + 2 * HALO
    seq = simulate(num_loci=L // 1500 + 1, seed=5, n_block_rate=0.1,
                   buffer_range=(200, 1500)).sequence[:L]
    code, n_mask = encode(seq)
    _assert_streams_equal(scan_events(code, n_mask, cfg),
                          capture_runs_host(code, n_mask, cfg))


@pytest.mark.parametrize("back", [1, 3, 5, 6])
def test_perfect_run_crossing_generation_tile(cpu_jax, back):
    """A perfect run starting within 6 bp before a host generation tile
    boundary (64 Kbp) keeps its true start in the host extractor, as in
    the XLA extractor."""
    from ribbit_tpu.encode import encode
    from ribbit_tpu.eventstitch import capture_runs_host
    from ribbit_tpu.scan_events_tpu import scan_events

    cfg = RibbitConfig.create()
    rng = np.random.default_rng(back)
    seq = list(rng.choice(list("ACGT"), 1 << 17))
    motif = "ACGTTGCAAGT"                      # m = 11
    s = (1 << 16) - back
    seq[s:s + 4 * len(motif)] = motif * 4
    seq[s - 1] = "A"                           # != motif[-1]: run starts at s
    code, n_mask = encode("".join(seq))
    host = capture_runs_host(code, n_mask, cfg, nthreads=1)
    starts, _ends, off = host[0]
    ch = len(motif) - cfg.min_motif
    assert s in set(np.asarray(starts[off[ch]:off[ch + 1]]).tolist())
    _assert_streams_equal(scan_events(code, n_mask, cfg), host)
