"""Command-line interface, flag-compatible with the reference ribbit binary.

    ribbit-tpu -i genome.fa -o out.bed [-m 2] [-M 100]
               [-l <int|tsv>] [--min-units <int|tsv>] [--perfect-units <int|tsv>]

Compat notes (ribbit.cpp:82-204):
  * -p/--purity is accepted and ignored — the reference declares it but never
    applies it; the threshold is hard-wired 0.85
  * with no -o the reference writes results to stderr; we default to stdout
    and provide --stderr-output for bit-compat piping
"""

from __future__ import annotations

import argparse
import sys
import time

from .config import RibbitConfig
from .fasta import read_fasta
from .pipeline import process_sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ribbit-tpu",
        description="Accelerated tandem repeat detection "
                    "(ribbit-compatible output)")
    from . import __version__
    p.add_argument("--version", action="version",
                   version=f"ribbit-tpu {__version__}")
    p.add_argument("-i", "--input-file", required=True,
                   help="input FASTA file")
    p.add_argument("-o", "--output-file", default=None,
                   help="output BED file (default stdout)")
    p.add_argument("-m", "--min-motif-length", type=int, default=2)
    p.add_argument("-M", "--max-motif-length", type=int, default=100)
    p.add_argument("-p", "--purity", type=float, default=None,
                   help="accepted for compatibility; ignored like the "
                        "reference (hard-wired 0.85)")
    p.add_argument("-l", "--min-length", default=None,
                   help="minimum repeat length: integer or TSV "
                        "(motif_size<TAB>cutoff)")
    p.add_argument("--min-units", default=None,
                   help="minimum repeat units: integer or TSV")
    p.add_argument("--perfect-units", default=None,
                   help="minimum perfect units: integer or TSV")
    p.add_argument("--backend", choices=["auto", "host", "device"],
                   default="auto",
                   help="compute backend (default auto: 'device' when JAX's "
                        "default platform is a GPU, else 'host'; see "
                        "ribbit_tpu.backend). 'device' extracts scan events "
                        "on the accelerator through XLA, then replays and "
                        "refines on the host; output stays byte-identical")
    p.add_argument("--stderr-output", action="store_true",
                   help="mirror the reference quirk of writing results to "
                        "stderr when no -o is given")
    p.add_argument("--workers", type=int, default=None,
                   help="parallel contigs (default: min(ncpu, ncontigs); "
                        "output stays byte-identical)")
    p.add_argument("--timing", action="store_true",
                   help="per-phase stage timing to stderr (scan generation, "
                        "scanner phases, merge, refinement; implies "
                        "--workers 1 for readable interleaving)")
    p.add_argument("--resume", action="store_true",
                   help="with -o: keep a per-contig completion manifest "
                        "(<out>.manifest.json) and skip already-finished "
                        "contigs on restart")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-host mode: jax.distributed coordinator "
                        "address; run one ribbit-tpu per host with the same "
                        "flags plus a distinct --process-id. Only process 0 "
                        "writes output")
    p.add_argument("--num-processes", type=int, default=1,
                   help="multi-host mode: total process count")
    p.add_argument("--process-id", type=int, default=0,
                   help="multi-host mode: this process's id (0-based)")
    p.add_argument("--chunk-size", type=int, default=None, metavar="BP",
                   help="process contigs longer than 1.5x this many bp in "
                        "bounded-memory chunks (per-chunk event extraction "
                        "stitched into one exact global replay); output is "
                        "byte-identical to whole-contig processing for "
                        "contigs under 2^31-64 bp (past the cap, splits "
                        "prefer exact N-run midpoints and warn if output "
                        "near raw cuts is best-effort)")
    return p


def _maybe_int(v):
    if v is None:
        return None
    try:
        return int(v)
    except ValueError:
        return v  # treat as TSV path


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import os.path as _os_check
    if not _os_check.exists(args.input_file):
        print(f"ribbit-tpu: error: input file not found: {args.input_file}",
              file=sys.stderr)
        return 2

    cfg = RibbitConfig.create(
        min_motif=args.min_motif_length,
        max_motif=args.max_motif_length,
        min_length=_maybe_int(args.min_length),
        min_units=_maybe_int(args.min_units),
        perfect_units=_maybe_int(args.perfect_units),
    )

    if args.coordinator is not None:
        if args.resume:
            print("ribbit-tpu: --resume is not supported with --coordinator",
                  file=sys.stderr)
            return 2
        # NOTE: no backend probe before this point — jax.distributed
        # .initialize must precede any XLA-initializing call
        return _main_multihost(args, cfg)

    from .backend import resolve_backend, start_device
    args.backend = resolve_backend(args.backend)
    if args.backend == "device":
        try:
            platform = start_device()
        except RuntimeError as exc:
            print(f"ribbit-tpu: --backend device: the JAX platform did not "
                  f"initialise ({exc})", file=sys.stderr)
            return 1
        print(f"ribbit-tpu: device path on JAX platform {platform}",
              file=sys.stderr)

    # resume manifest must be consulted BEFORE the output file is opened
    # (mode "w" would truncate the partial results being resumed)
    import json
    import os as _os
    manifest = None
    done: dict = {}
    if args.resume and args.output_file:
        manifest = args.output_file + ".manifest.json"
        if _os.path.exists(manifest) and _os.path.exists(args.output_file):
            with open(manifest) as fh:
                done = json.load(fh).get("contigs", {})

    if args.output_file:
        if done:
            # a crash can land between the output flush and the manifest
            # update; truncate back to the recorded state so the resumed
            # run never duplicates a partially-recorded contig
            recorded = sum(v["lines"] for v in done.values())
            with open(args.output_file) as fh:
                kept = fh.readlines()[:recorded]
            if len(kept) < recorded:
                print("ribbit-tpu: output shorter than manifest; "
                      "restarting from scratch", file=sys.stderr)
                done = {}
                kept = []
            with open(args.output_file, "w") as fh:
                fh.writelines(kept)
        out = open(args.output_file, "a" if done else "w")
        if done:
            print(f"Resuming: {len(done)} contig(s) already done",
                  file=sys.stderr)
    elif args.stderr_output:
        out = sys.stderr
    else:
        out = sys.stdout

    print(f"Minimum motif:\t{cfg.min_motif}", file=sys.stderr)
    print(f"Maximum motif:\t{cfg.max_motif}", file=sys.stderr)
    print("Purity threshold: 0.85", file=sys.stderr)

    if args.timing:
        import os as _os_t
        _os_t.environ["RIBBIT_CORE_TIMING"] = "1"
        if args.workers is None:
            args.workers = 1

    t0 = time.time()
    from .pipeline import process_fasta_records

    # per-contig completion manifest (the contig is the reference's implicit
    # unit of restartability, ribbit.cpp:269-280; SURVEY.md §5)
    total = 0
    for name, nbp, lines in process_fasta_records(
            args.input_file, cfg, scan_backend=args.backend,
            workers=args.workers, chunk_size=args.chunk_size,
            skip=set(done)):
        total += nbp
        if lines is None:
            continue
        print(f"Processing sequence {name}", file=sys.stderr)
        for line in lines:
            out.write(line + "\n")
        out.flush()
        if manifest:
            done[name] = {"bp": nbp, "lines": len(lines)}
            tmp = manifest + ".tmp"
            with open(tmp, "w") as fh:
                json.dump({"contigs": done}, fh)
            _os.replace(tmp, manifest)
    elapsed = time.time() - t0
    print(f"Done: {total} bp in {elapsed:.2f}s "
          f"({total / max(elapsed, 1e-9) / 1e6:.3f} Mbp/s)", file=sys.stderr)

    if args.output_file:
        out.close()
    return 0


def _main_multihost(args, cfg) -> int:
    """Multi-host driver: all processes read the same FASTA, cooperate per
    contig over the global device mesh, process 0 writes the output.
    See parallel/multihost.py for the design."""
    import jax

    from .backend import start_device
    from .eventstitch import SEG_SIZE
    from .parallel.multihost import ensure_initialized, multihost_process_contig

    ensure_initialized(args.coordinator, args.num_processes, args.process_id)
    start_device()
    is_main = jax.process_index() == 0

    if is_main:
        if args.output_file:
            out = open(args.output_file, "w")
        elif args.stderr_output:
            out = sys.stderr
        else:
            out = sys.stdout
        print(f"Minimum motif:\t{cfg.min_motif}", file=sys.stderr)
        print(f"Maximum motif:\t{cfg.max_motif}", file=sys.stderr)
        print("Purity threshold: 0.85", file=sys.stderr)
    else:
        out = None

    chunk_size = args.chunk_size or SEG_SIZE
    t0 = time.time()
    total = 0
    for name, seq in read_fasta(args.input_file):
        if is_main:
            print(f"Processing sequence {name}", file=sys.stderr)
        total += len(seq)
        lines = multihost_process_contig(name, seq, cfg,
                                         chunk_size=chunk_size,
                                         workers=args.workers,
                                         timing=args.timing)
        if is_main:
            for line in lines:
                out.write(line + "\n")
            out.flush()
    elapsed = time.time() - t0
    if is_main:
        print(f"Done: {total} bp in {elapsed:.2f}s "
              f"({total / max(elapsed, 1e-9) / 1e6:.3f} Mbp/s) "
              f"[{jax.process_count()} processes, "
              f"{jax.device_count()} devices]", file=sys.stderr)
        if args.output_file:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
