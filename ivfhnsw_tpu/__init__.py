"""ivfhnsw_tpu — billion-scale IVF-ADC nearest-neighbor search in JAX, run on
an NVIDIA GPU.

A ground-up JAX/XLA/Pallas re-architecture of the IVF-HNSW engine
(Baranchuk, Babenko, Malkov, ECCV'18; reference C++ at github.com/dbaranchuk/ivf-hnsw):

- The HNSW graph coarse quantizer over ~2^20 centroids becomes a batched
  matmul top-k (exact; the graph only exists to make pointer-chasing CPUs fast).
- PQ/OPQ codebook training (k-means per subspace, procrustes rotation) is batched XLA.
- The ADC posting-list scan is a Pallas kernel (Triton route) reading each
  scanned code once from the flat code store, with the per-query LUTs
  looked up by pointer gather (ops.adc_kernel); the XLA scan (ops.adc) is
  the portable path and the oracle.
- Grouping+Pruning (subcentroids on segments toward neighboring centroids) is
  masked batched compute instead of nested loops.
- Scale-out shards posting lists over a `jax.sharding.Mesh` with query fan-out
  and all-gather top-k merge.

Reference parity map lives in SURVEY.md §2; each public class documents the
reference entry points (file:line) it replaces.
"""

__version__ = "0.1.0"

from ivfhnsw_tpu.utils.config import IndexConfig, SearchParams  # noqa: F401
from ivfhnsw_tpu.models.ivfadc import IVFADCIndex  # noqa: F401
from ivfhnsw_tpu.models.grouping import IVFADCGroupingIndex  # noqa: F401
