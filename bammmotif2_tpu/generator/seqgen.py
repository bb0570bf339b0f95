"""Artificial sequence generation with on-device PRNG.

JAX equivalent of ``src/seq_generator/SeqGenerator.{h,cpp}``:
negatives for FDR / p-value calibration are sampled from a homogeneous
Markov model of order ``--sOrder`` (default 2) fit to the positive set, at
``--mFold`` times the positive count; motif-embedded sets support
benchmarking.  The reference uses C++ host RNG sequence-by-sequence; here
all sequences sample in parallel with ``jax.random`` counter-based keys
(``fold_in`` per sequence), so results are reproducible and shardable but
deliberately NOT bit-compatible with the C++ RNG (SURVEY.md 2.1: sampled
paths are compared distributionally; deterministic paths carry the
bit-compat tests).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from bammmotif2_tpu.models.background import BackgroundModel
from bammmotif2_tpu.models.motif import Motif
from bammmotif2_tpu.utils.fasta import PAD, SequenceSet


@functools.partial(jax.jit, static_argnames=("L", "s_order", "A"))
def _sample_markov_batch(key, trans: tuple, lens: jnp.ndarray, *, L: int, s_order: int, A: int):
    """Sample [N, L] code arrays from a homogeneous Markov chain.

    trans[m]: [A^(m+1)] conditional probs (flat, lexicographic) for order m.
    The first s_order positions use the lower-order conditionals; the rest
    scan with the order-s transition table.
    """
    N = lens.shape[0]
    keys = jax.random.split(key, L)

    logits = tuple(jnp.log(t.reshape(-1, A)) for t in trans)  # [A^m, A] rows

    # first s_order positions: unrolled, growing context
    cols = []
    ctx = jnp.zeros((N,), jnp.int32)  # context code at current order
    for t in range(min(s_order, L)):
        lg = logits[t][ctx]  # [N, A]
        c = jax.random.categorical(keys[t], lg, axis=-1).astype(jnp.int32)
        cols.append(c)
        ctx = ctx * A + c  # grow context (order t+1 code)

    if L > s_order:

        def step(ctx, key_t):
            lg = logits[s_order][ctx]
            c = jax.random.categorical(key_t, lg, axis=-1).astype(jnp.int32)
            if s_order > 0:
                ctx = (ctx % (A ** (s_order - 1))) * A + c  # drop oldest base
            return ctx, c

        _, rest = jax.lax.scan(step, ctx, keys[s_order:])  # rest: [L-s, N]
        first = (
            jnp.stack(cols, axis=1) if cols else jnp.zeros((N, 0), jnp.int32)
        )
        codes = jnp.concatenate([first, rest.T], axis=1)
    else:
        codes = jnp.stack(cols, axis=1)

    t_idx = jnp.arange(L)[None, :]
    return jnp.where(t_idx < lens[:, None], codes.astype(jnp.int8), jnp.int8(PAD))


def generate_neg_set(
    bg_fit: BackgroundModel,
    lens: np.ndarray,
    m_fold: int = 1,
    seed: int = 42,
    name_prefix: str = "neg",
    n_pad: int | None = None,
    pad_len: int | None = None,
) -> SequenceSet:
    """Sample a negative set: lengths = positive lengths repeated m_fold
    times, bases from the order-sOrder model fit to the positives.

    ``n_pad`` / ``pad_len``: pad the sequence count (with zero-length rows)
    and the length axis to fixed sizes so callers that sample per CV fold
    (evaluation.fdr) keep STATIC tensor shapes across folds — one compiled
    sampler/scorer program instead of one per fold.

    Parity: ``SeqGenerator::generateNegSeqSet`` (mFold x |pos| sequences).
    """
    A = bg_fit.alphabet.size
    s_order = bg_fit.order
    lens_rep = np.tile(np.asarray(lens, np.int32), m_fold)
    if n_pad is not None:
        if n_pad < lens_rep.size:
            raise ValueError(f"n_pad {n_pad} < {lens_rep.size} sampled rows")
        lens_rep = np.concatenate(
            [lens_rep, np.zeros(n_pad - lens_rep.size, np.int32)]
        )
    L = int(lens_rep.max()) if lens_rep.size else 0
    if pad_len is not None:
        if pad_len < L:
            raise ValueError(f"pad_len {pad_len} < max sampled length {L}")
        L = pad_len
    key = jax.random.PRNGKey(seed)
    trans = tuple(jnp.asarray(v, jnp.float32) for v in bg_fit.v)
    codes = np.asarray(
        _sample_markov_batch(key, trans, jnp.asarray(lens_rep), L=L, s_order=s_order, A=A)
    )
    headers = [f"{name_prefix}_{i + 1}" for i in range(len(lens_rep))]
    return SequenceSet(codes=codes, lens=lens_rep, headers=headers, alphabet=bg_fit.alphabet)


@functools.partial(
    jax.jit, static_argnames=("L", "s_order", "A", "K", "ss")
)
def _sample_encode(key, trans, lens, comp_table, *, L, s_order, A, K, ss):
    """Markov sampling + reverse complement + k-mer encoding in ONE jitted
    program (no host round trip between the stages)."""
    from bammmotif2_tpu.ops import encode as encode_mod

    codes = _sample_markov_batch(key, trans, lens, L=L, s_order=s_order, A=A)
    strands = [codes]
    if not ss:
        strands.append(
            encode_mod.revcomp_codes_device(codes, lens, comp_table)
        )
    return jnp.stack(
        [encode_mod.combined_kmer_index(c, A, K) for c in strands]
    )


def generate_neg_data(
    bg_fit: BackgroundModel,
    lens: np.ndarray,
    m_fold: int,
    seed: int,
    K: int,
    ss: bool,
    n_pad: int | None = None,
    pad_len: int | None = None,
):
    """Sampled-negative index tensors entirely on device.

    Same sampling contract as generate_neg_set (identical PRNG keys →
    identical sequences), but the codes never visit the host: sampling,
    reverse complement, and combined k-mer encoding run as one jitted
    program, returning (cidx [S, N, L] device, lens [N] host int32).
    Used by the FDR fold loop, whose per-fold negative sets otherwise
    paid a fetch + re-upload + ~10 eager dispatches each.
    """
    A = bg_fit.alphabet.size
    lens_rep = np.tile(np.asarray(lens, np.int32), m_fold)
    if n_pad is not None:
        if n_pad < lens_rep.size:
            raise ValueError(f"n_pad {n_pad} < {lens_rep.size} sampled rows")
        lens_rep = np.concatenate(
            [lens_rep, np.zeros(n_pad - lens_rep.size, np.int32)]
        )
    L = int(lens_rep.max()) if lens_rep.size else 0
    if pad_len is not None:
        if pad_len < L:
            raise ValueError(f"pad_len {pad_len} < max sampled length {L}")
        L = pad_len
    from bammmotif2_tpu.ops import encode as encode_mod

    table = encode_mod.comp_table(bg_fit.alphabet)
    cidx = _sample_encode(
        jax.random.PRNGKey(seed),
        tuple(jnp.asarray(v, jnp.float32) for v in bg_fit.v),
        jnp.asarray(lens_rep),
        jnp.asarray(table),
        L=L, s_order=bg_fit.order, A=A, K=K, ss=ss,
    )
    return cidx, lens_rep


def sample_motif_sites(motif: Motif, n: int, seed: int = 0) -> np.ndarray:
    """Sample n site code arrays [n, W] from the motif's highest-order chain
    (for embedded-benchmark sets — ``SeqGenerator::sample_seqset_with_motif``)."""
    A, K, W = motif.A, motif.K, motif.W
    key = jax.random.PRNGKey(seed)
    out = np.zeros((n, W), np.int8)
    ctx = np.zeros(n, np.int64)  # k-mer context code
    rng_keys = jax.random.split(key, W)
    for j in range(W):
        k_eff = min(j, K)
        vk = motif.v[k_eff][:, j].reshape(-1, A)  # [A^k_eff, A]
        probs = vk[ctx % (A ** k_eff)] if k_eff else np.broadcast_to(vk[0], (n, A))
        c = np.asarray(
            jax.random.categorical(rng_keys[j], jnp.log(jnp.asarray(probs)), axis=-1)
        )
        out[:, j] = c
        ctx = ctx * A + c
    return out


def mask_motif(
    sset: SequenceSet,
    motif: Motif,
    bg: BackgroundModel,
    pval_cutoff: float = 1e-3,
    m_fold: int = 10,
    seed: int = 7,
    ss: bool = False,
) -> SequenceSet:
    """Motif-masked positives: resample every significant motif window from
    the background model (``SeqGenerator`` masked variant — used to hunt
    secondary motifs after the primary is found).

    Windows whose log-odds beats the empirical p-value cutoff (ranked
    against the per-window score distribution of ``m_fold`` sampled
    negatives) are replaced by bases drawn from the background's
    mono-nucleotide conditionals.
    """
    from bammmotif2_tpu.scoring import scan as scan_mod

    res = scan_mod.score_set(motif, bg, sset, ss=ss)
    neg = generate_neg_set(bg, sset.lens, m_fold=m_fold, seed=seed)
    neg_res = scan_mod.score_set(motif, bg, neg, ss=ss)
    # per-window p-values against the negatives' per-window distribution
    # (same convention as the CLI scan path — ScoreSeqSet::calcPvalues);
    # the pool stays on device (ScanResult input)
    occs = scan_mod.find_occurrences(res, sset, neg_res, pval_cutoff)

    rng = np.random.default_rng(seed)
    f0 = np.asarray(bg.v[0], np.float64)
    f0 = f0 / f0.sum()
    codes = sset.codes.copy()
    for occ in occs:
        i = occ.seq_idx
        start = occ.start  # 0-based inclusive
        end = min(occ.end, int(sset.lens[i]))
        codes[i, start:end] = rng.choice(len(f0), size=end - start, p=f0)
    return SequenceSet(
        codes=codes, lens=sset.lens.copy(), headers=list(sset.headers),
        alphabet=sset.alphabet,
    )


def embed_motif(
    sset: SequenceSet, motif: Motif, q: float = 1.0, seed: int = 1
) -> SequenceSet:
    """Implant one sampled motif site at a uniform position in a fraction q
    of the sequences (benchmark-set construction)."""
    rng = np.random.default_rng(seed)
    codes = sset.codes.copy()
    sites = sample_motif_sites(motif, sset.n, seed=seed)
    W = motif.W
    for i in range(sset.n):
        if sset.lens[i] >= W and rng.random() < q:
            pos = rng.integers(0, sset.lens[i] - W + 1)
            codes[i, pos : pos + W] = sites[i]
    return SequenceSet(codes=codes, lens=sset.lens.copy(), headers=list(sset.headers), alphabet=sset.alphabet)
