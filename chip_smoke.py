"""Smoke test of the device path on one NVIDIA GPU.

    python3 chip_smoke.py                # phases 1-4 on one card
    python3 chip_smoke.py --four-cards   # only the multi-device path, 4 cards

Runs in one process and opens the card once.  The CLI is driven in-process
through ribbit_tpu.cli.main(argv).  Phases (any failure exits non-zero
and prints no result line):

  1. device    JAX's first device is a GPU; print its name and power limit.
  2. kernel    compile the XLA event extractor at the full extraction
               window, print compile seconds and memory_analysis(); run it
               on a repeat-dense simulated window and compare its three
               event streams exactly with the native host extractor; print
               the warm time per window and peak device memory.
  3. golden    --backend device on tests/golden/g1-g3.fa must equal the
               committed oracle BEDs byte for byte.
  4. real size a 21.4 Mb chromosome-like contig and a ~50 Mbp multi-contig
               FASTA (one contig longer than the window), each through
               --backend device --timing and --backend host; outputs must
               be identical; prints Mbp/s and the per-layer spans.

--four-cards runs the CLI's multi-device path (--coordinator with one
process over all local devices) on a contig of at least four windows,
checks that the extraction's shards sit on 4 distinct devices, and
compares with --backend host.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import re
import socket
import subprocess
import sys
import tempfile
import time
import traceback

REPO = pathlib.Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "golden"
# the 21.4 Mb chromosome fixture of bench.py: ~2660 bp per simulated locus
# with 10% of spacers carrying an N block
CHROM_BP = 21_400_000
BP_PER_LOCUS = 2660
# ~50 Mbp over 12 contigs: the first is longer than one extraction window
# (segment stitching), the rest exercise the multi-contig overlap pipeline
MULTI_MB = (12, 9, 7, 6, 5, 4, 3, 2, 1, 0.5, 0.25, 0.25)


class SmokeError(RuntimeError):
    pass


def result_line(platform: str, kind: str, count: int) -> str:
    """The contract's last line."""
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def _log(msg: str) -> None:
    print(msg, flush=True)


def _simulate(bp: float, seed: int, name: str, **kw) -> str:
    from ribbit_tpu.sim import simulate
    return simulate(num_loci=max(1, int(bp) // BP_PER_LOCUS), seed=seed,
                    n_block_rate=0.1, name=name, **kw).sequence


def _write_fasta(path: pathlib.Path, records) -> int:
    from ribbit_tpu.fasta import write_fasta
    write_fasta(str(path), records)
    return sum(len(s) for _n, s in records)


class _Fd2Capture:
    """Send file descriptor 2 (Python and the native core's stderr) to a
    file for the duration of a block."""

    def __init__(self, path: pathlib.Path):
        self.path = path

    def __enter__(self):
        sys.stderr.flush()
        self.saved = os.dup(2)
        self.fh = open(self.path, "w")
        os.dup2(self.fh.fileno(), 2)
        return self

    def __exit__(self, *exc):
        sys.stderr.flush()
        os.dup2(self.saved, 2)
        os.close(self.saved)
        self.fh.close()
        return False


_SPAN = re.compile(r"^\[(device|host)\] .*?: (.*)$")
_CORE = re.compile(r"^\[core\] (\w+)\s+([0-9.]+)s$")


def layer_spans(log: str) -> dict:
    """Sum the --timing spans of one run by layer: [device] encode/extract,
    [host] replay/refine (pipeline) and [core] phases (native core)."""
    tot: dict = {}
    for line in log.splitlines():
        m = _SPAN.match(line)
        if m:
            for label, secs in re.findall(r"(\w+) ([0-9.]+)s", m.group(2)):
                key = f"{m.group(1)}.{label}"
                tot[key] = tot.get(key, 0.0) + float(secs)
            continue
        m = _CORE.match(line)
        if m:
            key = f"core.{m.group(1)}"
            tot[key] = tot.get(key, 0.0) + float(m.group(2))
    return tot


def _cli(argv, log_path: pathlib.Path = None) -> float:
    """ribbit_tpu.cli.main(argv) in this process; returns wall seconds."""
    from ribbit_tpu.cli import main
    saved = os.environ.get("RIBBIT_CORE_TIMING")    # --timing sets it
    t0 = time.perf_counter()
    try:
        if log_path is None:
            rc = main(argv)
        else:
            with _Fd2Capture(log_path):
                rc = main(argv)
    finally:
        wall = time.perf_counter() - t0
        if saved is None:
            os.environ.pop("RIBBIT_CORE_TIMING", None)
        else:
            os.environ["RIBBIT_CORE_TIMING"] = saved
    if rc != 0:
        raise SmokeError(f"ribbit-tpu {' '.join(argv)} exited {rc}")
    return wall


def phase_device():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SmokeError(f"needs a GPU; JAX platform is {dev.platform} "
                         f"({dev.device_kind})")
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise SmokeError(f"nvidia-smi failed: {r.stderr.strip()}")
    _log(f"card: {r.stdout.strip()}")
    _log(f"jax: {jax.__version__} {dev.platform} {dev.device_kind} "
         f"x{len(jax.devices())}")
    return dev


def phase_kernel(window_bp: int = None, bench: bool = True) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from ribbit_tpu.config import RibbitConfig
    from ribbit_tpu.encode import encode
    from ribbit_tpu.eventstitch import HALO, SEG_SIZE, capture_runs_host
    from ribbit_tpu.scan_events_tpu import (_event_kernel, default_caps,
                                            scan_events)
    from ribbit_tpu.scan_tpu import _pad_to_bucket

    cfg = RibbitConfig.create()
    L = window_bp or SEG_SIZE + 2 * HALO
    Lp = _pad_to_bucket(L)
    cap_p, cap_q7, cap_q6 = default_caps(Lp)
    t0 = time.perf_counter()
    compiled = _event_kernel.lower(
        jax.ShapeDtypeStruct((Lp,), jnp.int8),
        jax.ShapeDtypeStruct((Lp,), jnp.bool_), jnp.int32(L),
        min_shift=cfg.min_shift, nshifts=cfg.nshifts,
        min_motif=cfg.min_motif, max_motif=cfg.max_motif,
        cap_p=cap_p, cap_q7=cap_q7, cap_q6=cap_q6).compile()
    _log(f"kernel: window {L} bp (padded {Lp}), compile "
         f"{time.perf_counter() - t0:.3f}s")
    ma = compiled.memory_analysis()
    if ma is not None:
        _log("kernel: memory_analysis " + json.dumps(
            {k: getattr(ma, k) for k in ("argument_size_in_bytes",
                                         "output_size_in_bytes",
                                         "temp_size_in_bytes",
                                         "generated_code_size_in_bytes")}))

    # repeat-dense window: short spacers between simulated repeat loci
    seq = _simulate(L * BP_PER_LOCUS // 1500 + BP_PER_LOCUS, seed=5,
                    name="w", buffer_range=(200, 1500))[:L]
    code, n_mask = encode(seq)
    t0 = time.perf_counter()
    dev = scan_events(code, n_mask, cfg)
    first = time.perf_counter() - t0
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        dev = scan_events(code, n_mask, cfg)
        warm.append(time.perf_counter() - t0)
    capture_runs_host(code, n_mask, cfg)      # first use builds the C library
    t0 = time.perf_counter()
    host = capture_runs_host(code, n_mask, cfg)
    host_s = time.perf_counter() - t0
    for name, g, h in zip(("perfect", "q7", "q6"), dev, host):
        for a, b in zip(g, h):
            if not np.array_equal(np.asarray(a, np.int64),
                                  np.asarray(b, np.int64)):
                raise SmokeError(f"kernel: {name} stream differs from "
                                 "capture_runs_host")
    _log(f"kernel: streams == capture_runs_host (events "
         f"{[g[0].shape[0] for g in dev]})")
    _log(f"kernel: scan_events per window (transfer + host conversion "
         f"included) first {first:.3f}s warm {sorted(warm)[1]:.3f}s; "
         f"host capture_runs_host {host_s:.3f}s")
    stats = jax.devices()[0].memory_stats() or {}
    _log(f"kernel: scan_events peak_bytes_in_use "
         f"{stats.get('peak_bytes_in_use')} of bytes_limit "
         f"{stats.get('bytes_limit')}")
    if bench:
        from ribbit_tpu.bench_device import bench_events
        b = bench_events(cfg, L=L)
        _log(f"kernel: device-resident extractor {b['extract_s_per_window']:.4f}"
             f"s per window ({b['extract_mbps']:.1f} Mbp/s), sweep compile "
             f"{b['extract_sweep_compile_s']:.1f}s")


def phase_golden(tmp: pathlib.Path) -> None:
    for g in ("g1", "g2", "g3"):
        out = tmp / f"{g}.bed"
        _cli(["-i", str(GOLDEN / f"{g}.fa"), "-o", str(out),
              "--backend", "device"])
        if out.read_bytes() != (GOLDEN / f"{g}.oracle.bed").read_bytes():
            raise SmokeError(f"golden: {g} differs from {g}.oracle.bed")
        _log(f"golden: {g} == oracle")


def _device_vs_host(tag: str, fa: pathlib.Path, bp: int,
                    tmp: pathlib.Path) -> None:
    """Device run (cold, then warm with --timing) and host run on one
    FASTA; outputs must be identical."""
    cold = _cli(["-i", str(fa), "-o", str(tmp / f"{tag}.cold.bed"),
                 "--backend", "device"], tmp / f"{tag}.cold.log")
    log = tmp / f"{tag}.device.log"
    warm = _cli(["-i", str(fa), "-o", str(tmp / f"{tag}.device.bed"),
                 "--backend", "device", "--timing"], log)
    host = _cli(["-i", str(fa), "-o", str(tmp / f"{tag}.host.bed"),
                 "--backend", "host"], tmp / f"{tag}.host.log")
    ref = (tmp / f"{tag}.host.bed").read_bytes()
    for run in ("cold", "device"):
        if (tmp / f"{tag}.{run}.bed").read_bytes() != ref:
            raise SmokeError(f"{tag}: --backend device ({run}) output "
                             "differs from --backend host")
    nlines = ref.count(b"\n")
    _log(f"{tag}: {bp} bp, {nlines} BED lines, device == host")
    _log(f"{tag}: device cold {cold:.3f}s ({bp / 1e6 / cold:.3f} Mbp/s, "
         f"compiles included), warm {warm:.3f}s "
         f"({bp / 1e6 / warm:.3f} Mbp/s); host {host:.3f}s "
         f"({bp / 1e6 / host:.3f} Mbp/s)")
    spans = layer_spans(log.read_text())
    _log(f"{tag}: warm device spans (s) " + json.dumps(
        {k: round(v, 3) for k, v in sorted(spans.items())}))
    if "device.extract" in spans:
        _log(f"{tag}: extract share of warm device wall "
             f"{spans['device.extract'] / warm:.3f}")


def phase_real_size(tmp: pathlib.Path, chrom_bp: int = CHROM_BP,
                    multi_mb=MULTI_MB) -> None:
    t0 = time.perf_counter()
    chrom = tmp / "chrom.fa"
    cbp = _write_fasta(chrom, [("chr1", _simulate(chrom_bp, 38, "chr1"))])
    multi = tmp / "multi.fa"
    mbp = _write_fasta(multi, [
        (f"ctg{i}", _simulate(mb * 1e6, 500 + i, f"ctg{i}"))
        for i, mb in enumerate(multi_mb)])
    _log(f"real size: fixtures {cbp} + {mbp} bp simulated in "
         f"{time.perf_counter() - t0:.1f}s")
    _device_vs_host("chrom", chrom, cbp, tmp)
    _device_vs_host("multi", multi, mbp, tmp)


def phase_four_cards(tmp: pathlib.Path, contig_bp: int = None,
                     chunk: int = None, ndev: int = 4) -> None:
    """The CLI's multi-device path over all local devices vs the host."""
    import ribbit_tpu.parallel.distributed as dist
    from ribbit_tpu.eventstitch import SEG_SIZE

    chunk = chunk or SEG_SIZE
    contig_bp = contig_bp or int(3.6 * chunk)       # 4 windows
    fa = tmp / "four.fa"
    bp = _write_fasta(fa, [("chr4", _simulate(contig_bp, 44, "chr4"))])
    shard_devices = []
    real = dist._sharded_extract

    def spy(*a, **kw):
        out = real(*a, **kw)
        shard_devices.append(
            sorted({str(sh.device) for sh in out[0][0].addressable_shards}))
        return out

    dist._sharded_extract = spy
    try:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        # jax.distributed.initialize runs inside the CLI, before any
        # other JAX call of this process
        wall = _cli(["-i", str(fa), "-o", str(tmp / "four.bed"),
                     "--coordinator", f"localhost:{port}",
                     "--num-processes", "1", "--process-id", "0",
                     "--chunk-size", str(chunk), "--timing"])
    finally:
        dist._sharded_extract = real
    import jax
    if jax.device_count() != ndev:
        raise SmokeError(f"four cards: {jax.device_count()} devices")
    if len(shard_devices) != 1 or len(shard_devices[0]) != ndev:
        raise SmokeError(f"four cards: extraction shards on "
                         f"{shard_devices}")
    _log(f"four cards: extraction shards on {shard_devices[0]}")
    host = _cli(["-i", str(fa), "-o", str(tmp / "four.host.bed"),
                 "--backend", "host"])
    if (tmp / "four.bed").read_bytes() != \
            (tmp / "four.host.bed").read_bytes():
        raise SmokeError("four cards: output differs from --backend host")
    _log(f"four cards: {bp} bp == host; multi-device {wall:.3f}s "
         f"({bp / 1e6 / wall:.3f} Mbp/s, compile included), host "
         f"{host:.3f}s ({bp / 1e6 / host:.3f} Mbp/s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device path on 4 cards")
    args = ap.parse_args(argv)
    if not (REPO / "ribbit_tpu" / "cli.py").exists():
        print(f"chip_smoke: no ribbit_tpu package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    phase = "setup"
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
            tmp = pathlib.Path(td)
            if args.four_cards:
                phase = "four cards"
                phase_four_cards(tmp)
                import jax
                dev = phase_device()
                count = jax.device_count()
            else:
                from ribbit_tpu.backend import start_device
                phase = "device"
                start_device()
                dev = phase_device()
                import jax
                count = len(jax.devices())
                phase = "kernel"
                phase_kernel()
                phase = "golden"
                phase_golden(tmp)
                phase = "real size"
                phase_real_size(tmp)
    except Exception as exc:                       # report, exit non-zero
        traceback.print_exc()
        print(f"chip_smoke: {phase} failed: {exc}", file=sys.stderr)
        return 1
    print(result_line(dev.platform, dev.device_kind, count), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
