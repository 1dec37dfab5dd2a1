"""Multi-host scaling-efficiency harness.

Runs the same workload through the multi-host pipeline with 1 process and
with N processes (each process an OS process with its own jax.distributed
client), times both, and reports scaling efficiency t1 / (N * tN).

On this CPU simulation the processes share cores, so the printed number
measures orchestration overhead, not hardware scaling.  With
RIBBIT_MH_BENCH_REAL=1 the processes keep JAX's own platform and each is
bound to its own GPU (CUDA_VISIBLE_DEVICES=<process id>): a JAX process
reserves most of every card it can see, so unbound processes on one host
would fail for want of memory.  That mode needs one card per process.

    python tools/multihost_bench.py [--processes 2] [--loci 60]
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(devices: int, pid: int) -> dict:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    if os.environ.get("RIBBIT_MH_BENCH_REAL") == "1":
        env["CUDA_VISIBLE_DEVICES"] = str(pid)        # one card per process
    else:                                             # CPU simulation
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = REPO
    return env


def _run(nproc: int, fa: str, out: str, chunk: int, devices: int) -> float:
    port = _free_port()
    t0 = time.perf_counter()
    procs = []
    for pid in range(nproc):
        cmd = [sys.executable, "-m", "ribbit_tpu.cli", "-i", fa,
               "--coordinator", f"localhost:{port}",
               "--num-processes", str(nproc), "--process-id", str(pid),
               "--chunk-size", str(chunk), "--timing"]
        if pid == 0:
            cmd += ["-o", out]
        procs.append(subprocess.Popen(cmd, env=_env(devices, pid),
                                      stdout=subprocess.DEVNULL,
                                      stderr=subprocess.PIPE))
    for p in procs:
        _, err = p.communicate(timeout=3600)
        if p.returncode != 0:
            raise RuntimeError(err.decode())
        for ln in err.decode().splitlines():
            if ln.startswith("[p"):
                print(ln, file=sys.stderr)
    return time.perf_counter() - t0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--loci", type=int, default=60)
    ap.add_argument("--devices", type=int, default=2,
                    help="virtual devices per process (CPU simulation)")
    args = ap.parse_args()

    from ribbit_tpu.sim import simulate

    parts = []
    for ci in range(4 * args.processes):
        parts.append(simulate(num_loci=args.loci // (4 * args.processes) + 1,
                              seed=900 + ci, name=f"b{ci}").sequence)
        parts.append("N" * 800)
    genome = "".join(parts)
    tmp = tempfile.gettempdir()
    fa = os.path.join(tmp, "ribbit_mh_bench.fa")
    with open(fa, "w") as fh:
        fh.write(">chr\n")
        for i in range(0, len(genome), 80):
            fh.write(genome[i:i + 80] + "\n")
    chunk = len(genome) // (4 * args.processes)

    b1_path = os.path.join(tmp, "ribbit_mh_b1.bed")
    bn_path = os.path.join(tmp, "ribbit_mh_bn.bed")
    t1 = _run(1, fa, b1_path, chunk, args.devices)
    tn = _run(args.processes, fa, bn_path, chunk, args.devices)

    with open(b1_path, "rb") as fh:
        b1 = fh.read()
    with open(bn_path, "rb") as fh:
        bn = fh.read()
    if b1 != bn:
        raise SystemExit("PARITY FAIL: multi-process output differs")

    eff = t1 / (args.processes * tn)
    print(json.dumps({"mbp": len(genome) / 1e6, "t1_s": round(t1, 2),
                      f"t{args.processes}_s": round(tn, 2),
                      "scaling_efficiency": round(eff, 3),
                      "parity": "identical"}))


if __name__ == "__main__":
    main()
