"""Distributed contig processing over the virtual 8-device CPU mesh:
device-sharded event extraction + host-exact seed core must reproduce the
single-process whole-contig output."""

import pytest

from ribbit_tpu.config import RibbitConfig
from ribbit_tpu.sim import simulate


def test_distributed_matches_whole_contig(cpu_jax):
    from ribbit_tpu.pipeline import process_sequence
    from ribbit_tpu.parallel.distributed import distributed_process_contig

    parts = []
    for ci in range(4):
        sim = simulate(num_loci=4, seed=700 + ci, name=f"d{ci}")
        parts.append(sim.sequence)
        parts.append("N" * 800)
    genome = "".join(parts)
    cfg = RibbitConfig.create()

    whole = process_sequence("chr", genome, cfg)
    dist = distributed_process_contig("chr", genome, cfg, chunk_size=25_000,
                                      n_devices=8)
    assert dist == whole


def test_distributed_exact_on_dense_contig(cpu_jax):
    """Raw-offset chunk cuts through repeat arrays (no N-run split points)
    must be byte-exact: clipped-event stitch + one global replay."""
    from ribbit_tpu.pipeline import process_sequence
    from ribbit_tpu.parallel.distributed import distributed_process_contig

    genome = simulate(num_loci=24, seed=89, name="dense").sequence
    cfg = RibbitConfig.create()
    whole = process_sequence("chr", genome, cfg)
    dist = distributed_process_contig("chr", genome, cfg, chunk_size=20_000,
                                      n_devices=8)
    assert dist == whole


def test_distributed_cap_overflow_retries(cpu_jax, monkeypatch):
    """Undersized event capacities must autotune (retry with learned pow2
    caps) instead of raising OverflowError."""
    from ribbit_tpu.pipeline import process_sequence
    import ribbit_tpu.parallel.distributed as dist_mod

    genome = simulate(num_loci=12, seed=31, name="ovf").sequence
    cfg = RibbitConfig.create()
    whole = process_sequence("chr", genome, cfg)
    # pre-seed ruinously small caps for every bucket the call could use
    monkeypatch.setattr(dist_mod, "_learned_caps",
                        {lp: (16, 16, 32) for lp in
                         [(k + 1) << 14 for k in range(64)]})
    dist = dist_mod.distributed_process_contig("chr", genome, cfg,
                                               chunk_size=15_000,
                                               n_devices=8)
    assert dist == whole
    # the used bucket's tiny caps must have been grown by the retry loop
    assert any(c > 32 for caps in dist_mod._learned_caps.values()
               for c in caps)


@pytest.mark.parametrize("ndev", [1, 2, 4])
def test_distributed_device_counts_match_host(cpu_jax, monkeypatch, ndev):
    """The multi-device path equals the host path at 1, 2 and 4 devices,
    and the extraction's shards sit on that many distinct devices."""
    import ribbit_tpu.parallel.distributed as dist_mod
    from ribbit_tpu.pipeline import process_sequence

    seen = []
    real = dist_mod._sharded_extract

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen.append({sh.device for sh in out[0][0].addressable_shards})
        return out

    monkeypatch.setattr(dist_mod, "_sharded_extract", spy)
    genome = simulate(num_loci=10, seed=90, name="nd").sequence
    cfg = RibbitConfig.create()
    whole = process_sequence("chr", genome, cfg)
    dist = dist_mod.distributed_process_contig(
        "chr", genome, cfg, chunk_size=len(genome) // 5, n_devices=ndev)
    assert dist == whole
    assert len(seen) == 1 and len(seen[0]) == ndev
