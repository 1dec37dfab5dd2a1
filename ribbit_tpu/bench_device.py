"""Device-resident benchmark of the XLA event extractor.

Times scan_events_tpu._event_kernel (what --backend device runs for every
extraction window) with the window generated and kept on the device: no
host<->device transfer is in the timed region.

Method (marginal two-point timing):
  * a sweep jits K chained extractor calls, each on a DISTINCT input (the
    code XOR k and the true length L - k), so XLA cannot merge repeated
    pure calls into one;
  * every output of every call is reduced into the returned scalar, so no
    call is dead code; the scalar's host fetch waits for the device;
  * the per-call time is (t(K2) - t(K1)) / (K2 - K1), taken back to back
    in each pass and medianed over passes, which cancels the dispatch and
    fetch overhead common to both sweeps.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp

K1, K2 = 1, 3


def _marginal(make_sweep, args, reps: int = 1, passes: int = 3):
    """(seconds per marginal call, compile_s)."""
    t0 = time.perf_counter()
    sweeps = {k: make_sweep(k) for k in (K1, K2)}
    for k in (K1, K2):
        int(sweeps[k](*args))                 # compile + warmup
    compile_s = time.perf_counter() - t0
    per = []
    for _ in range(passes):
        best = {}
        for k in (K1, K2):
            b = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                int(sweeps[k](*args))         # scalar fetch forces completion
                b = min(b, time.perf_counter() - t0)
            best[k] = b
        per.append(max(best[K2] - best[K1], 1e-9) / (K2 - K1))
    per.sort()
    return per[len(per) // 2], compile_s


def bench_events(cfg=None, L: int = None) -> dict:
    """Extractor time per window of L bp (default: one full extraction
    window, SEG_SIZE plus a halo on each side), on random sequence."""
    from .eventstitch import HALO, SEG_SIZE
    from .scan_events_tpu import _event_kernel, default_caps
    from .scan_tpu import _pad_to_bucket
    if cfg is None:
        from .config import RibbitConfig
        cfg = RibbitConfig.create()
    if L is None:
        L = SEG_SIZE + 2 * HALO
    Lp = _pad_to_bucket(L)
    cap_p, cap_q7, cap_q6 = default_caps(Lp)
    code = jax.random.randint(jax.random.PRNGKey(0), (Lp,), 0, 4,
                              dtype=jnp.int8)
    n_mask = jnp.arange(Lp) >= L
    jax.block_until_ready((code, n_mask))

    def make_sweep(K):
        # n_mask is an argument, not a closure constant: XLA would
        # otherwise constant-fold the window sums over it at compile time
        @jax.jit
        def sweep(code, n_mask):
            acc = jnp.int32(0)
            for k in range(K):
                groups = _event_kernel(
                    code ^ jnp.int8(k), n_mask, jnp.int32(L - k),
                    min_shift=cfg.min_shift, nshifts=cfg.nshifts,
                    min_motif=cfg.min_motif, max_motif=cfg.max_motif,
                    cap_p=cap_p, cap_q7=cap_q7, cap_q6=cap_q6)
                for grp in groups:
                    for x in grp:
                        acc = acc + x.sum(dtype=jnp.int32)
            return acc
        return sweep

    per_call, compile_s = _marginal(make_sweep, (code, n_mask))
    dev = jax.devices()[0]
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "extract_window_bp": L,
            "extract_s_per_window": per_call,
            "extract_mbps": L / 1e6 / per_call,
            "extract_sweep_compile_s": compile_s}


if __name__ == "__main__":
    import json
    print(json.dumps(bench_events()))
