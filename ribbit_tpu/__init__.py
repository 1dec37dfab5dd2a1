"""ribbit_tpu — an accelerated tandem-repeat detection engine.

Reimplements the capabilities of SowpatiLab/ribbit (shift-XOR periodicity
scan, rank-lattice seed merging, pseudo-perfect-repeat alignment with banded
affine-gap DP, BED emission) with a native C host core and a JAX/XLA device
path: bulk fixed-shape array passes on the device, compact event arrays
replayed and refined on the host, and mesh-sharded chunk parallelism for
whole-genome scale.
"""

from .config import RibbitConfig
from .pipeline import (process_sequence, process_fasta, process_fasta_records,
                       process_sequence_chunked)

__version__ = "0.1.0"

__all__ = ["RibbitConfig", "process_sequence", "process_fasta",
           "process_fasta_records", "process_sequence_chunked", "__version__"]
