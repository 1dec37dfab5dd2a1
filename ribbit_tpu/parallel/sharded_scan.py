"""Sharded shift-XOR scan over a 1-D device mesh ("data"/sequence axis).

This is the multi-chip analogue of the reference's single pass over a contig
(fasta_utils.cpp:120-170): the genome is chunked with halo overlap >= the
largest detectable repeat span, chunks are sharded over the mesh, every chip
scans its chunks for all shift channels, and per-chunk summaries (candidate
window counts) are psum-reduced across the mesh.
Host-side seed extraction consumes the per-chunk compact outputs.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import RibbitConfig, WINDOW_LENGTH


def make_mesh(n_devices: int | None = None, axis: str = "chunks") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def _chunk_scan(code: jax.Array, n_mask: jax.Array, *,
                min_shift: int, nshifts: int) -> tuple[jax.Array, jax.Array]:
    """Per-chunk scan body: [B, C] int8 codes -> (eq [B, S, C] match bitmaps,
    qualified-window counts per (chunk, shift))."""
    B, C = code.shape
    pos = jnp.arange(C, dtype=jnp.int32)
    shifts = jnp.arange(min_shift, min_shift + nshifts, dtype=jnp.int32)
    max_shift = min_shift + nshifts - 1
    padded = jnp.concatenate(
        [code, jnp.zeros((B, max_shift), dtype=code.dtype)], axis=1)
    gathered = padded[:, pos[None, :] + shifts[:, None]]        # [B, S, C]
    eq = code[:, None, :] == gathered

    W = WINDOW_LENGTH
    cs = jnp.cumsum(eq.astype(jnp.int32), axis=2)
    win = cs[:, :, W - 1:] - jnp.pad(cs[:, :, :C - W], ((0, 0), (0, 0), (1, 0)))
    ncs = jnp.cumsum(n_mask.astype(jnp.int32), axis=1)
    nwin = ncs[:, W - 1:] - jnp.pad(ncs[:, :C - W], ((0, 0), (1, 0)))
    qualified = (win >= 7) & (nwin == 0)[:, None, :]
    return eq, qualified.sum(axis=2)


def sharded_scan_step(mesh: Mesh, cfg: RibbitConfig):
    """Builds the jitted multi-chip step: chunks sharded over the mesh axis,
    per-chunk scan on each device, global candidate-count psum."""
    axis = mesh.axis_names[0]

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None)),
        out_specs=(P(axis, None, None), P(axis, None), P()))
    def step(code, n_mask):
        eq, counts = _chunk_scan(code, n_mask,
                                 min_shift=cfg.min_shift, nshifts=cfg.nshifts)
        total = jax.lax.psum(counts.sum(), axis)
        return eq, counts, total[None]

    return jax.jit(step)
