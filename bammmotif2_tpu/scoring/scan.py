"""Occurrence scanning: log-odds scores, empirical p-values, .occurrence.

JAX equivalent of ``src/seq_scoring/ScoreSeqSet.{h,cpp}``
(``calcLogOdds``, ``calcPvalues``, ``write``): reuses the EM window-score
op against the combined LUT, computes empirical p-values by rank against a
sorted negative-score distribution (vectorized searchsorted instead of the
reference's per-score scan), and writes occurrence rows above the p-value
cutoff.

Streaming (SURVEY.md 5 long-context row): sequences scan in batches and
every reduction (ZOOPS maxima, hit extraction, MOPS pooling) happens
per-chunk ON DEVICE — the full [S, N, n_win] score tensor (~40x the input
bytes) is retained on device only when it fits a fixed budget
(``keep_bytes``); genome-scale sets re-score chunks on demand instead, so
HBM usage stays bounded by one chunk regardless of N.

p-value convention (SURVEY.md 2.9): for a score s against M sorted negative
scores, p(s) = (M - frac(s) + 1) / (M + 1) with frac = #neg < s, except
inside a tie block where frac is the block's midpoint rank (so tied
negatives don't quantize small p-values); e-value = p * (#windows scanned
in the dataset).  Pinned deviation: the survey's "linear interpolation
between adjacent negative scores" is tagged [MED] and unverifiable against
the empty reference mount — rank-midpoint is the shipped convention (one
implementation: ``_pvalues_from_ranks``) and sits on the golden-harness
compare list (tools/golden_harness.py).
"""

from __future__ import annotations

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from bammmotif2_tpu.models.background import BackgroundModel
from bammmotif2_tpu.models.motif import Motif, log_odds_lut
from bammmotif2_tpu.ops import encode, escore
from bammmotif2_tpu.utils.fasta import PAD, SequenceSet

# retain chunk score tensors on device only below this total (bytes);
# larger sets stream (re-score on demand) so HBM stays chunk-bounded
KEEP_BYTES = 256 << 20


@dataclasses.dataclass
class ScanResult:
    """Per-sequence reductions + chunked access to window scores.

    Device->host traffic is the scanner's real cost at genome scale (the
    score tensor is ~40x the input), so ZOOPS maxima, p-values, and
    occurrence extraction all reduce ON DEVICE per chunk; only reductions
    and hit rows cross to the host.  ``iter_chunks`` yields
    ``(row0, scores_dev [S, n, n_win], mask_dev [n, n_win])`` — from the
    retained tensors for small sets, by re-scoring for large ones.

    Results from one ``score_set_multi`` group SHARE the retained stacked
    [M, S, n, n_win] chunk tensors (``_mi`` selects this result's seed
    plane lazily) — one device copy per group instead of M.
    """

    max_scores: np.ndarray  # [N] best window per sequence (ZOOPS statistic)
    n_windows: int          # total valid windows scanned
    W: int
    _chunks: list | None = None     # retained (row0, scores, mask) triples
    _rescan: object = None          # () -> iterator of (row0, scores, mask)
    _mi: int | None = None          # seed index into shared stacked chunks

    def iter_chunks(self):
        if self._chunks is not None:
            for row0, sc, mk in self._chunks:
                yield row0, (sc if self._mi is None else sc[self._mi]), mk
        else:
            yield from self._rescan()

    @property
    def scores(self) -> np.ndarray:
        """Full [S, N, n_win_max] host score tensor (NEG_INF on invalid).

        Materializes every chunk — fine for small sets; large sets should
        prefer iter_chunks / the on-device reductions.
        """
        chunks = list(self.iter_chunks())
        if not chunks:
            S = 1 if self.max_scores.size == 0 else 2
            return np.zeros((S, self.max_scores.size, 0), np.float32)
        n_win_max = max(c[1].shape[2] for c in chunks)

        def padw(x, fill):
            p = n_win_max - x.shape[-1]
            if p == 0:
                return x
            cfg = [(0, 0)] * (x.ndim - 1) + [(0, p)]
            return np.pad(np.asarray(x), cfg, constant_values=fill)

        return np.concatenate(
            [padw(c[1], escore.NEG_INF) for c in chunks], axis=1
        )

    @property
    def mask(self) -> np.ndarray:
        chunks = list(self.iter_chunks())
        if not chunks:
            return np.zeros((self.max_scores.size, 0), bool)
        n_win_max = max(c[2].shape[1] for c in chunks)

        def padw(x):
            p = n_win_max - x.shape[-1]
            return np.pad(np.asarray(x), [(0, 0), (0, p)]) if p else np.asarray(x)

        return np.concatenate([padw(c[2]) for c in chunks], axis=0)

    def all_window_scores(self) -> np.ndarray:
        """Valid per-window scores pooled over strands (MOPS statistic)."""
        out = []
        for _row0, sc, m in self.iter_chunks():
            sc_h = np.asarray(sc)
            m_h = np.broadcast_to(np.asarray(m)[None], sc_h.shape)
            out.append(sc_h[m_h])
        return np.concatenate(out) if out else np.zeros(0, np.float32)

    def window_pool_device(self):
        """Per-window score pool as a DEVICE array, never fetched.

        Returns (ascending-sorted f32 device array whose first
        ``size - n_windows`` entries are NEG_INF padding, n_windows).
        find_occurrences consumes this directly for p-value ranking, so a
        genome-scale negative pool (hundreds of MB at 100k seqs × mFold)
        stays on the chip instead of round-tripping through the host the
        way ``all_window_scores()`` does.

        Peak device memory is bounded by the POOL size (irreducible — the
        sorted pool is the product) plus one chunk and the sort
        workspace, not by all chunks at once: chunks fold into the
        accumulator one at a time so their buffers free as the iteration
        advances.
        """
        pool = None
        for _row0, sc, m in self.iter_chunks():
            part = jnp.where(
                jnp.broadcast_to(m[None], jnp.shape(sc)), sc, escore.NEG_INF
            ).ravel()
            pool = part if pool is None else jnp.concatenate([pool, part])
        pool = jnp.sort(pool if pool is not None else jnp.zeros(0, jnp.float32))
        return pool, self.n_windows


def _stacked_luts(motifs: list, bg: BackgroundModel) -> jnp.ndarray:
    """[M, R+1, W] combined log-odds LUTs for a (W, K, A) group."""
    K, W, A = motifs[0].K, motifs[0].W, motifs[0].A
    assert all((m.K, m.W, m.A) == (K, W, A) for m in motifs)
    bg_flat = jnp.asarray(bg.conditional_flat(K), jnp.float32)
    return jnp.stack([
        log_odds_lut(tuple(jnp.asarray(v, jnp.float32) for v in m.v), bg_flat)
        for m in motifs
    ])


@functools.partial(
    jax.jit, static_argnames=("A", "K", "W", "B", "ss")
)
def _score_chunk_device(
    s_flat, codes, lens, comp_table, start,
    *, A: int, K: int, W: int, B: int, ss: bool,
):
    """Score one B-row chunk of a DEVICE-RESIDENT code tensor, one program.

    Row slice, reverse complement, combined k-mer encoding
    (encode.combined_kmer_index), the seed-stacked window scores, and the
    per-chunk reductions (ZOOPS maxima + valid-window count) all fuse into
    this single jitted program, so no chunk needs host-side slicing,
    encoding or a re-upload.  ``start`` is dynamic: every chunk reuses one
    compiled program.

    Returns (scores [M, S, B, n_win], mask [B, n_win], maxima [M, B],
    valid-window count).
    """
    L = codes.shape[1]
    codes_c = jax.lax.dynamic_slice(codes, (start, 0), (B, L))
    lens_c = jax.lax.dynamic_slice(lens, (start,), (B,))
    strands = [codes_c]
    if not ss:
        strands.append(
            encode.revcomp_codes_device(codes_c, lens_c, comp_table)
        )
    cidx = jnp.stack(
        [encode.combined_kmer_index(c, A, K) for c in strands]
    )
    sc, mks = jax.vmap(
        lambda sf: escore.window_scores(sf, cidx, lens_c, W)
    )(s_flat)
    mk = mks[0]
    return sc, mk, jnp.max(sc, axis=(1, 3)), jnp.sum(mk)


def _device_codes(sset: SequenceSet, B: int):
    """Upload the set's codes ONCE, padded to a whole number of B-chunks.

    Returns (codes_dev [N_pad, L], lens_dev [N_pad], comp_table_dev,
    n_chunks).  Pad rows are PAD codes with length 0: they score NEG_INF,
    mask False, and count nothing.

    Memoized on the SequenceSet instance: re-scanning the same set (the
    CLI scans it once per (W, K) group; benchmarks scan repeatedly) would
    otherwise re-upload the code tensor every call (20 MB per pass at
    100k x 200 bp).
    """
    cache = sset.__dict__.setdefault("_device_codes_cache", {})
    hit = cache.get(B)
    if hit is not None:
        return hit
    while len(cache) >= 2:  # bound pinned HBM: keep the 2 newest batchings
        cache.pop(next(iter(cache)))
    N = sset.n
    L = sset.codes.shape[1] if N else 0
    n_chunks = -(-N // B) if N else 0
    pad = n_chunks * B - N
    codes = np.pad(sset.codes, ((0, pad), (0, 0)), constant_values=PAD)
    lens = np.pad(sset.lens.astype(np.int32), (0, pad))
    out = (
        jnp.asarray(codes), jnp.asarray(lens),
        jnp.asarray(encode.comp_table(sset.alphabet)), n_chunks
    )
    cache[B] = out
    return out


def score_set_multi(
    motifs: list,
    bg: BackgroundModel,
    sset: SequenceSet,
    ss: bool = False,
    batch: int = 16384,
    keep_bytes: int = KEEP_BYTES,
) -> list:
    """score_set for several motifs of equal (W, K) in ONE stacked pass.

    The M motifs' window scores come from one vmapped program per chunk —
    the seed-stacked form of the reference driver's per-motif
    ``ScoreSeqSet::calcLogOdds`` loop.  Returns a list of ScanResult
    aligned with ``motifs``.

    Codes upload ONCE and stay device-resident: slicing, reverse
    complement, k-mer encoding, scoring, and the per-chunk reductions all
    run inside one compiled program per chunk (_score_chunk_device), and
    every chunk program dispatches asynchronously before the single
    maxima fetch — the scanner's host work is O(n_chunks) dispatches
    regardless of N.  When the retained-chunk budget is exceeded, each
    result's ``iter_chunks`` re-scores its own seed plane with an M=1
    pass (never all M per chunk).
    """
    M = len(motifs)
    K, W, A = motifs[0].K, motifs[0].W, motifs[0].A
    S = 1 if ss else 2
    N = sset.n
    L_pad = sset.codes.shape[1] if N else 0
    if N == 0 or L_pad < W:
        # no sequence can host a window (or the set is empty): empty
        # results instead of a trace-time shape error inside the chunk
        # program (n_win would be <= 0)
        return [
            ScanResult(
                max_scores=np.full(N, escore.NEG_INF, np.float32),
                n_windows=0, W=W, _chunks=[], _mi=i,
            )
            for i in range(M)
        ]
    s_flat = _stacked_luts(motifs, bg)
    # the retained tensors' window axis is set by the PADDED length (every
    # chunk is [M, S, n, L_pad - W + 1]), not by lens.max(): a subset of
    # short rows from a wide-padded set would otherwise under-estimate by
    # orders of magnitude and blow HBM at exactly the scale the budget
    # exists to prevent
    n_win_pad = L_pad - W + 1
    retain = 4 * M * S * N * n_win_pad <= keep_bytes

    B = max(1, min(batch, N)) if N else 1
    codes_dev, lens_dev, comp_dev, n_chunks = _device_codes(sset, B)
    statics = dict(A=A, K=K, W=W, B=B, ss=ss)

    chunks: list | None = [] if retain else None
    mxs, cnts = [], []
    for ci in range(n_chunks):
        sc, mk, mx, cnt = _score_chunk_device(
            s_flat, codes_dev, lens_dev, comp_dev, ci * B, **statics
        )
        n = min(B, N - ci * B)
        if retain:
            if n < B:
                sc, mk = sc[:, :, :n], mk[:n]
            chunks.append((ci * B, sc, mk))
        mxs.append(mx[:, :n] if n < B else mx)
        cnts.append(cnt)
    if n_chunks:
        max_scores = np.asarray(jnp.concatenate(mxs, axis=1))
        n_valid = int(np.asarray(jnp.stack(cnts)).sum()) * S
    else:
        max_scores = np.zeros((M, 0), np.float32)
        n_valid = 0

    def make_rescan(i):
        # streamed (non-retained) sets re-score ONLY seed i per chunk:
        # all-M rescans would make the CLI's per-motif occurrence loop
        # O(M^2) scoring passes at exactly the genome scale streaming
        # targets (advisor r4 finding)
        def rescan():
            sf = s_flat[i : i + 1]
            for ci in range(n_chunks):
                sc, mk, _mx, _cnt = _score_chunk_device(
                    sf, codes_dev, lens_dev, comp_dev, ci * B, **statics
                )
                n = min(B, N - ci * B)
                if n < B:
                    sc, mk = sc[:, :, :n], mk[:n]
                yield ci * B, sc[0], mk

        return rescan

    return [
        ScanResult(
            max_scores=max_scores[i],
            n_windows=n_valid,
            W=W,
            _chunks=chunks if retain else None,
            _rescan=make_rescan(i) if not retain else None,
            _mi=i if retain else None,
        )
        for i in range(M)
    ]


def score_set(
    motif: Motif,
    bg: BackgroundModel,
    sset: SequenceSet,
    ss: bool = False,
    batch: int = 16384,
    keep_bytes: int = KEEP_BYTES,
) -> ScanResult:
    """Log-odds-score every window of every sequence (ScoreSeqSet::calcLogOdds).

    Sequences are processed in batches of ``batch``; per-chunk reductions
    (max score, valid-window count) happen on device.  Chunk score tensors
    are retained only while their total stays under ``keep_bytes`` —
    genome-scale sets (BASELINE config 5: 100k+ sequences) stream through
    HBM and downstream consumers re-score chunks via ``iter_chunks``.
    """
    return score_set_multi(
        [motif], bg, sset, ss=ss, batch=batch, keep_bytes=keep_bytes
    )[0]


def _pvalues_from_ranks(lo: np.ndarray, hi: np.ndarray, M: int) -> np.ndarray:
    """p-values from integer negative-pool ranks, float64 host math.

    ``lo`` = #neg strictly below s, ``hi`` = #neg <= s: frac is lo except
    inside a tie block, where the block's midpoint rank is used so tied
    negatives don't quantize small p-values (the shipped convention —
    module docstring; the ONE implementation behind empirical_pvalues and
    find_occurrences).
    """
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    frac = np.where(hi > lo, 0.5 * (lo + hi), lo)
    p = (M - frac + 1.0) / (M + 1.0)
    return np.clip(p, 1.0 / (M + 1.0), 1.0)


def empirical_pvalues(scores: np.ndarray, neg_scores: np.ndarray) -> np.ndarray:
    """Empirical p-values by rank against a negative score sample.

    Parity: ``ScoreSeqSet::calcPvalues``.  With Sn = sorted negative scores
    (ascending, size M): p(s) = (M - frac(s) + 1) / (M + 1) with frac the
    rank convention of ``_pvalues_from_ranks``.
    """
    neg = np.sort(np.asarray(neg_scores, np.float64))
    M = neg.size
    if M == 0:
        return np.full(np.shape(scores), 1.0)
    s = np.asarray(scores, np.float64)
    lo = np.searchsorted(neg, s, side="left")    # #neg strictly below s
    hi = np.searchsorted(neg, s, side="right")   # #neg <= s
    return _pvalues_from_ranks(lo, hi, M)


@dataclasses.dataclass
class Occurrence:
    seq_idx: int
    header: str
    length: int
    strand: str       # '+' or '-'
    start: int        # 0-based inclusive, forward-strand coordinates
    end: int          # 0-based exclusive
    site: str
    score: float
    pvalue: float
    evalue: float


def find_occurrences(
    scan: ScanResult,
    sset: SequenceSet,
    neg_scores: np.ndarray,
    pval_cutoff: float = 1e-4,
) -> list:
    """Windows with p-value below the cutoff, as occurrence records.

    ``neg_scores`` must be the negatives' PER-WINDOW score pool: either a
    host array (``ScanResult.all_window_scores()``) or, preferably, the
    negatives' ScanResult itself — then the pool sorts and ranks entirely
    ON DEVICE (``window_pool_device``; at genome scale the pool is
    hundreds of MB that never need to exist on the host).  The reference
    ranks scan scores against the sorted per-window negative distribution
    from ``calcLogOdds`` (``ScoreSeqSet::calcPvalues``, SURVEY.md 3.3) —
    per-sequence ZOOPS maxima are a different distribution family and
    would mis-scale the p/e-values (pinned by tests/test_scan_fdr.py).

    Streams chunk by chunk: p-values + thresholding reduce on device and
    only hit rows cross to the host, so memory stays bounded for
    genome-scale scans.  Reverse-strand windows are reported in forward
    coordinates (start = len - W - i for rc-window start i), matching the
    reference's convention of scanning the appended reverse complement.
    """
    W = scan.W
    if isinstance(neg_scores, ScanResult):
        neg, M = neg_scores.window_pool_device()  # pads sort first (asc)
        pad = int(neg.size) - M
    else:
        neg = jnp.sort(jnp.asarray(neg_scores, jnp.float32))
        M = int(neg.size)
        pad = 0
    if int(neg.size) >= 2**31:
        # device searchsorted ranks are int32 (cf. prcurve.thinned_rank_rows)
        raise ValueError("negative window pool exceeds int32 rank range")

    if M > 0 and pval_cutoff < 1.0 / (M + 1.0):
        return []  # pv is clipped to >= 1/(M+1): nothing can pass

    # conservative score cutoff from the p-value cutoff: pv is monotone
    # non-increasing in score, and pv(s) >= (M - hi(s) + 1) / (M + 1)
    # with hi(s) = #neg <= s, so pv <= cutoff requires
    # hi(s) >= k = M + 1 - cutoff * (M + 1).  Only windows scoring at or
    # above the k-th smallest negative can pass — searchsorted then runs
    # on the few candidates instead of every window (one binary search
    # per query).
    if M > 0 and pval_cutoff < 1.0:
        k = int(np.clip(np.ceil((M + 1) * (1.0 - pval_cutoff)), 1, M))
        s_cut = neg[pad + k - 1]
    else:
        # cutoff >= 1 admits pv == 1 (scores below every negative), and an
        # empty pool gives pv == 1 everywhere: no prefilter possible
        s_cut = -np.inf

    occs: list = []
    for row0, sc, mask in scan.iter_chunks():
        S, n, n_win = sc.shape
        valid = jnp.broadcast_to(mask[None], sc.shape)
        cand = (valid & (sc >= s_cut)).ravel()
        n_cand = int(cand.sum())
        if n_cand == 0:
            continue
        cidx_flat = jnp.nonzero(cand, size=n_cand)[0]
        sc_c = sc.ravel()[cidx_flat]
        lo = jnp.clip(jnp.searchsorted(neg, sc_c, side="left") - pad, 0, M)
        hi = jnp.clip(jnp.searchsorted(neg, sc_c, side="right") - pad, 0, M)
        # exact f64 host math from the int32 ranks — on-device f32 frac
        # quantizes past 2^24 pooled negatives (fine for the cutoff
        # prefilter, not for the written deep-tail values)
        pv_c = _pvalues_from_ranks(np.asarray(lo), np.asarray(hi), M)
        keep = pv_c <= pval_cutoff
        if not keep.any():
            continue
        flat = np.asarray(cidx_flat)[keep]
        hit_scores = np.asarray(sc_c)[keep]
        hit_pv = pv_c[keep]
        s_i, n_i, i_i = np.unravel_index(flat, (S, n, n_win))

        for s, nn, i, score, p in zip(s_i, n_i, i_i, hit_scores, hit_pv):
            gi = row0 + int(nn)
            L = int(sset.lens[gi])
            if s == 0:
                start, strand = int(i), "+"
                site = sset.alphabet.decode(sset.codes[gi, start : start + W])
            else:
                start, strand = L - W - int(i), "-"
                site = sset.alphabet.decode(
                    sset.alphabet.revcomp(sset.codes[gi, start : start + W])
                )
            occs.append(
                Occurrence(
                    seq_idx=gi,
                    header=sset.headers[gi],
                    length=L,
                    strand=strand,
                    start=start,
                    end=start + W,
                    site=site,
                    score=float(score),
                    pvalue=float(p),
                    evalue=float(p * scan.n_windows),
                )
            )
    occs.sort(key=lambda o: (o.seq_idx, o.start, o.strand))
    return occs


def write_logodds(
    path: str | os.PathLike, scan: ScanResult, sset: SequenceSet
) -> int:
    """Per-window log-odds dump (``--saveLogOdds`` → <basename>.logOdds).

    One TSV row per VALID window: sequence header, strand, 1-based
    forward-coordinate start, log-odds score.  Streams chunk by chunk
    (device arrays fetched one chunk at a time, rows formatted in bulk),
    so genome-scale dumps stay memory-bounded.  Pinned deviation
    (SURVEY.md 2 Global row, ``ScoreSeqSet::write`` reconstruction): the
    reference's exact .logOdds layout is unverified — per-window rows
    carry strictly more information than per-sequence maxima and are on
    the golden-harness compare list (tools/golden_harness.py).

    Returns the number of window rows written.
    """
    W = scan.W
    n_rows = 0
    with open(path, "w") as fh:
        fh.write("header\tstrand\tstart\tscore\n")
        for row0, sc, mask in scan.iter_chunks():
            sc_h = np.asarray(sc)          # [S, n, n_win]
            mk_h = np.asarray(mask)        # [n, n_win]
            S, n, n_win = sc_h.shape
            # strand-independent extraction, hoisted (the header
            # list-to-array conversion alone is O(N) per call)
            ni, wi = np.nonzero(mk_h)
            if ni.size == 0:
                continue
            lens_r = sset.lens[row0 + ni]
            heads = np.asarray(sset.headers, object)[row0 + ni]
            for s in range(S):
                scores = sc_h[s, ni, wi]
                starts = wi if s == 0 else lens_r - W - wi
                strand = "+" if s == 0 else "-"
                lines = [
                    f"{h}\t{strand}\t{int(st) + 1}\t{sc:.6g}\n"
                    for h, st, sc in zip(heads, starts, scores)
                ]
                fh.writelines(lines)
                n_rows += len(lines)
    return n_rows


def write_occurrences(path: str | os.PathLike, occs: list) -> None:
    """TSV occurrence rows (ScoreSeqSet::write → <basename>.occurrence).

    Columns: seq header, seq length, strand, start..end (1-based inclusive,
    as in the reference output), site string, log-odds score, p-value,
    e-value.
    """
    with open(path, "w") as fh:
        fh.write("header\tlength\tstrand\tstart..end\tsite\tscore\tp-value\te-value\n")
        for o in occs:
            fh.write(
                f"{o.header}\t{o.length}\t{o.strand}\t{o.start + 1}..{o.end}\t"
                f"{o.site}\t{o.score:.6g}\t{o.pvalue:.4e}\t{o.evalue:.4e}\n"
            )
