"""Distributed layer: chunked sequence parallelism over a device mesh.

The reference is single-threaded (SURVEY.md §2 parallelism inventory); this
package is the from-scratch multi-device design: contigs are split into
fixed-size chunks with halo overlap, the shift-XOR scan runs data-parallel
over a 1-D mesh via shard_map, and boundary-straddling candidates are merged
deterministically on the host so output is byte-stable for any topology.
"""

from .sharded_scan import sharded_scan_step, make_mesh  # noqa: F401
