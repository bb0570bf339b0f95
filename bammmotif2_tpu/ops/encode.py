"""k-mer index tensors: the device-side sequence representation.

Core idea (no analogue in the reference, which recomputes k-mer indices
per position in C++ loops — ``Sequence::extractKmer`` inside
``EM::EStep`` / ``ScoreSeqSet::score``):

Every conditional-probability table of every order k <= K is stored in ONE
combined LUT with rows grouped by order; order k's block starts at

    off[k] = sum_{m<k} A^(m+1)

and within a block a (k+1)-mer ending at position t is its lexicographic
code (oldest base most significant).  A single precomputed index tensor

    cidx[n, t] = off[m(t)] + kmer_code_{m(t)}(n, t)     (int32)

where m(t) = min(t, K, #consecutive unambiguous bases ending just before t)
turns window scoring into a pure gather against the combined LUT, and the EM M-step into the transposed scatter on the same
index.  Sequence-start and ambiguous-base context truncation fall out
naturally: truncated positions simply index a lower-order block.  Invalid
positions (ambiguous current base, padding) index the trailing sentinel row
``R`` whose LUT value is 0 and whose counts are discarded.

cidx depends only on the sequences, never on the model, so it is computed
once per run and reused by every EM iteration / scan.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from bammmotif2_tpu.utils.fasta import SequenceSet


def order_offsets(A: int, K: int) -> np.ndarray:
    """off[k] for k = 0..K+1; off[K+1] == R == total #rows excl. sentinel."""
    sizes = [A ** (k + 1) for k in range(K + 1)]
    return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)


def num_rows(A: int, K: int) -> int:
    """R: number of combined-LUT rows excluding the sentinel row."""
    return int(order_offsets(A, K)[-1])


def _combined_kmer_index_impl(codes, A: int, K: int, xp):
    """combined_kmer_index generic over the array namespace ``xp``
    (jax.numpy on device, numpy for pure-host counting paths)."""
    codes = codes.astype(xp.int32)
    valid = codes >= 0
    base = xp.where(valid, codes, 0)
    N, L = codes.shape
    off = order_offsets(A, K)  # static numpy offsets
    R = int(off[-1])

    # shifted[d][:, t] = base[:, t-d]  (zero-filled before sequence start)
    def shift(x, d, fill):
        if d == 0:
            return x
        return xp.concatenate(
            [xp.full((N, d), fill, x.dtype), x[:, : L - d]], axis=1
        )

    shifted = [shift(base, d, 0) for d in range(K + 1)]
    valid_sh = [shift(valid, d, False) for d in range(K + 1)]

    # m(t): longest context of unambiguous bases ending at t-1, capped at K
    # and at t (no context before the sequence start).
    m = xp.zeros((N, L), xp.int32)
    ctx_ok = xp.ones((N, L), bool)
    for d in range(1, K + 1):
        ctx_ok = ctx_ok & valid_sh[d]
        in_range = xp.arange(L)[None, :] >= d
        m = xp.where(ctx_ok & in_range, d, m)

    # y_k(t): lexicographic (k+1)-mer code for each candidate order
    cidx = off[0] + base  # order-0 index
    acc = base
    for k in range(1, K + 1):
        acc = acc + shifted[k] * (A ** k)
        cidx = xp.where(m >= k, off[k] + acc, cidx)
    return xp.where(valid, cidx, R).astype(xp.int32)


@functools.partial(jax.jit, static_argnames=("A", "K"))
def combined_kmer_index(codes: jnp.ndarray, A: int, K: int) -> jnp.ndarray:
    """Compute cidx[n, t] for an int8 code array [N, L].

    codes: int8 [N, L]; >=0 concrete letter, -1 ambiguous, -2 pad.
    Returns int32 [N, L]; invalid positions = R (the sentinel row).
    """
    return _combined_kmer_index_impl(codes, A, K, jnp)


def combined_kmer_index_np(codes: np.ndarray, A: int, K: int) -> np.ndarray:
    """Host-numpy combined_kmer_index (bit-identical; tested).

    For counting paths (background model fits) that would otherwise
    upload the codes, encode on device, and fetch the whole [S, N, L]
    int32 tensor back just to bincount it — ~1 s+ per call on a slow
    transport for ~50 ms of numpy."""
    return _combined_kmer_index_impl(np.asarray(codes), A, K, np)


def comp_table(alphabet) -> np.ndarray:
    """int8 complement lookup table for an Alphabet (letter i -> index of
    its complement letter) — the one shared construction for every
    reverse-complement site (host, device, sampling, scanning)."""
    return np.array(
        [alphabet.letters.index(c) for c in alphabet.complements],
        dtype=np.int8,
    )


def revcomp_codes(codes: np.ndarray, lens: np.ndarray, comp_table: np.ndarray) -> np.ndarray:
    """Host-side reverse complement of a padded code batch.

    rc[n, t] = complement(codes[n, lens[n]-1-t]) for t < lens[n], PAD after.
    Parity: ``Sequence::appendRevComp`` (we keep it as a separate array).
    """
    codes = np.asarray(codes)
    lens = np.asarray(lens)
    N, L = codes.shape
    t = np.arange(L)[None, :]
    src = lens[:, None] - 1 - t
    in_range = src >= 0
    gathered = np.take_along_axis(codes, np.clip(src, 0, L - 1), axis=1)
    comp = np.where(
        gathered >= 0,
        comp_table[np.clip(gathered, 0, len(comp_table) - 1)],
        gathered,  # AMBIG (-1) complements to AMBIG; PAD shouldn't occur in-range
    )
    return np.where(in_range, comp, -2).astype(np.int8)


@jax.jit
def revcomp_codes_device(codes: jnp.ndarray, lens: jnp.ndarray, comp_table: jnp.ndarray):
    """Device-side batch reverse complement (same contract as revcomp_codes).

    Genome-scale scanning is bottlenecked by host work if the revcomp runs
    in numpy (~3 s for 100k x 200 bp); on device it is one gather.
    """
    N, L = codes.shape
    t = jnp.arange(L)[None, :]
    src = lens[:, None] - 1 - t
    in_range = src >= 0
    gathered = jnp.take_along_axis(
        codes, jnp.clip(src, 0, L - 1).astype(jnp.int32), axis=1
    )
    comp = jnp.where(
        gathered >= 0,
        comp_table[jnp.clip(gathered, 0, comp_table.shape[0] - 1)],
        gathered,  # AMBIG (-1) complements to AMBIG
    )
    return jnp.where(in_range, comp, jnp.int8(-2)).astype(jnp.int8)


def _strand_codes(sset: SequenceSet, ss: bool) -> list:
    """Forward (+ reverse-complement unless ss) code arrays (device)."""
    codes = jnp.asarray(sset.codes)
    out = [codes]
    if not ss:
        out.append(
            revcomp_codes_device(
                codes, jnp.asarray(sset.lens),
                jnp.asarray(comp_table(sset.alphabet)),
            )
        )
    return out


@functools.partial(jax.jit, static_argnames=("A", "K"))
def _stack_combined(strands: tuple, A: int, K: int):
    """Encode + stack all strands in ONE program (combined_kmer_index is
    ~20 elementwise ops per strand — eager, that is ~40 dispatches on a
    high-latency transport for work that takes microseconds)."""
    return jnp.stack([combined_kmer_index(c, A, K) for c in strands])


def strand_indices(sset: SequenceSet, K: int, ss: bool):
    """Build the per-strand combined k-mer index tensors for a SequenceSet.

    Returns (cidx [S, N, L] int32 jnp, lens [N] int32 jnp) with S = 1 for
    single-strand (--ss) or 2 (forward, reverse-complement) otherwise.
    """
    A = sset.alphabet.size
    strands = _strand_codes(sset, ss)
    cidx = _stack_combined(tuple(strands), A, K)
    return cidx, jnp.asarray(sset.lens)
