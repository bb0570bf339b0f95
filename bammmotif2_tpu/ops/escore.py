"""Window scoring, ZOOPS responsibilities, and M-step count collection.

These are the hot ops shared by EM refinement (``src/refinement/EM.cpp::
EM::EStep/MStep``), occurrence scanning (``src/seq_scoring/ScoreSeqSet.cpp``)
and FDR evaluation.  The reference walks every sequence position in nested
C++ loops; here each op is a batched XLA program over the precomputed
combined k-mer index tensor (see ``bammmotif2_tpu.ops.encode``):

  - ``window_scores``: score[s, n, i] = sum_j  s_flat[cidx[s, n, i+j], j]
    — W shifted gathers against the [R+1, W] combined log-odds LUT.  The
    sentinel row R is 0 so padded positions contribute nothing (they are
    additionally masked at the window level).
  - ``zoops_posterior``: log-space ZOOPS E-step — responsibilities over
    {no occurrence} + all windows of both strands, and the per-sequence
    marginal log-likelihood (relative to the background-only model).
  - ``mstep_counts``: the transposed op — scatter window responsibilities
    into combined count rows, one segment-sum per motif offset j.

These ops are the one data path of EM, CGS, FDR and scanning on every
backend.  ``ops.reference`` re-derives the same quantities in float64
numpy, independently of this module, for the parity tests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

NEG_INF = -1e30  # large-negative instead of -inf: keeps XLA reductions NaN-free


def window_mask(lens: jnp.ndarray, n_windows: int, W: int) -> jnp.ndarray:
    """[N, n_windows] bool: window start i is valid iff i + W <= len."""
    i = jnp.arange(n_windows)[None, :]
    return i + W <= lens[:, None]


@functools.partial(jax.jit, static_argnames=("W",))
def window_scores(s_flat: jnp.ndarray, cidx: jnp.ndarray, lens: jnp.ndarray, W: int):
    """Per-window motif-vs-background log-odds.

    Args:
      s_flat: f32 [R+1, W] combined log-odds LUT (row R = sentinel, zeros).
      cidx: int32 [S, N, L] combined k-mer indices (S strands).
      lens: int32 [N].
      W: motif width (static).

    Returns:
      scores: f32 [S, N, L-W+1] (NEG_INF on invalid windows)
      mask:   bool [N, L-W+1]
    """
    S, N, L = cidx.shape
    n_win = L - W + 1
    if n_win <= 0:
        raise ValueError(f"motif width {W} exceeds padded length {L}")
    scores = jnp.zeros((S, N, n_win), jnp.float32)
    for j in range(W):
        col = s_flat[:, j]
        scores = scores + col[cidx[:, :, j : j + n_win]]
    mask = window_mask(lens, n_win, W)
    return jnp.where(mask[None], scores, NEG_INF), mask


@jax.jit
def zoops_posterior(scores: jnp.ndarray, mask: jnp.ndarray, q) -> tuple:
    """ZOOPS E-step in log space.

    Each sequence has no occurrence (prior 1-q) or exactly one occurrence
    uniform over its valid windows across all strands (prior q / n_win).
    Parity: ``EM::EStep`` responsibility computation (SURVEY.md 2.9).

    Args:
      scores: f32 [S, N, n_win] log-odds (NEG_INF where invalid).
      mask: bool [N, n_win] valid windows (per strand counts are equal).
      q: scalar occurrence prior.

    Returns:
      r: f32 [S, N, n_win] window responsibilities (0 on invalid windows)
      r0: f32 [N] no-occurrence responsibility
      ll: f32 [] total ZOOPS log-likelihood relative to background-only
    """
    S = scores.shape[0]
    n_win_per_seq = S * mask.sum(axis=1)  # [N]
    has_win = n_win_per_seq > 0
    log_prior = jnp.where(
        has_win, jnp.log(q) - jnp.log(jnp.maximum(n_win_per_seq, 1)), NEG_INF
    )  # [N]
    log_w = scores + log_prior[None, :, None]  # [S, N, n_win]
    log_r0 = jnp.log1p(-q)
    m = jnp.maximum(jnp.max(log_w, axis=(0, 2)), log_r0)  # [N]
    denom = jnp.exp(log_r0 - m) + jnp.sum(jnp.exp(log_w - m[None, :, None]), axis=(0, 2))
    log_z = m + jnp.log(denom)  # [N] per-seq marginal
    r = jnp.exp(log_w - log_z[None, :, None])
    r = jnp.where(mask[None], r, 0.0)
    r0 = jnp.exp(log_r0 - log_z)
    return r, r0, jnp.sum(log_z)


@functools.partial(jax.jit, static_argnames=("R", "W"))
def mstep_counts(r: jnp.ndarray, cidx: jnp.ndarray, R: int, W: int) -> jnp.ndarray:
    """Scatter window responsibilities into combined count rows.

    C[row, j] = sum over (s, n, i) of r[s, n, i] * 1[cidx[s, n, i+j] == row]

    Parity: ``EM::MStep`` fractional k-mer counts; the per-order count
    tensors are later derived by marginalization (models.motif).

    Returns C: f32 [R+1, W] (row R collects sentinel/invalid mass; callers
    slice it off).
    """
    S, N, L = cidx.shape
    n_win = L - W + 1
    rf = r.reshape(-1)
    cols = []
    for j in range(W):
        idx = cidx[:, :, j : j + n_win].reshape(-1)
        cols.append(jax.ops.segment_sum(rf, idx, num_segments=R + 1))
    return jnp.stack(cols, axis=1)  # [R+1, W]
