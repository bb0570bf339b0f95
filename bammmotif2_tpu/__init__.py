"""bammmotif2_tpu — a JAX Bayesian Markov Model motif-discovery framework.

A from-scratch JAX/XLA re-design of the capabilities of
soedinglab/BaMMmotif2 (Siebert & Soeding, NAR 2016; Ge et al., NARGAB 2021):
de-novo transcription-factor binding-motif discovery with inhomogeneous
Markov models of order 0-5, interpolated pseudo-counts, ZOOPS EM and
collapsed Gibbs refinement, occurrence scanning with empirical p-values,
and cross-validated FDR evaluation.

Architecture (not a port):
  - sequences are tensorized once on the host into int8 code arrays,
  - every per-order conditional-probability table lives in ONE combined
    lookup table of shape [R, W] (rows grouped by Markov order), indexed by
    a precomputed per-position combined k-mer index tensor,
  - the EM E-step is W shifted gathers against that LUT and the M-step is
    the transposed scatter (one segment-sum per motif position) on the same
    index — one plain XLA data path (``ops.escore``) on every backend,
  - multi-chip scaling shards the sequence axis over a jax.sharding.Mesh
    and merges per-shard expected-count tensors with one psum per EM
    iteration (the model itself is tiny and replicated).

Reference parity citations in docstrings use the upstream layout
(e.g. ``src/refinement/EM.cpp::EM::EStep``) as mapped by SURVEY.md; the
reference mount was empty during development, so line numbers are omitted
and behavior follows the published math (SURVEY.md section 2.9).
"""

__version__ = "0.1.0"

from bammmotif2_tpu.utils.alphabet import Alphabet
from bammmotif2_tpu.utils.config import Params

__all__ = ["Alphabet", "Params", "__version__"]
