"""Precision/recall threshold sweep and ranking metrics.

Parity: ``FDR::calculatePR`` (SURVEY.md 2.9): pool positive and negative
scores, sweep thresholds over the sorted pool; at threshold t,
TP = #pos >= t, FP = (#neg >= t) / mFold (negatives are an mFold-times
oversample), precision = TP / (TP + FP), recall = TP / #pos.  Also provides
the average-recall (AvRec) summary used by the companion papers as the
single-number motif quality metric.
"""

from __future__ import annotations

import numpy as np

from bammmotif2_tpu.scoring.scan import empirical_pvalues


def thin_rows(n: int, max_rows: int) -> np.ndarray:
    """Uniform rank thinning shared by every sweep writer/fetcher."""
    if n > max_rows:
        return np.unique(
            np.round(np.linspace(0, n - 1, max_rows)).astype(np.int64)
        )
    return np.arange(max(n, 0), dtype=np.int64)


def thinned_rank_rows(pp, nn, rows_d, n_neg: int):
    """(score, tp, fp, lo, hi) int32 rank rows at thinned descending ranks.

    The single implementation of the tie-block rank reconstruction used
    by BOTH threshold_sweep_device and the fused FDR program
    (evaluation.fdr): rows above a tie block are all > s, and within the
    s tie block every positive precedes every negative (the pos pool
    concatenates first under the stable-argsort formulation this
    replaces), so
        tp(r) = #pos > s_r + clip(r + 1 - #pool > s_r, 0, #pos == s_r)
        fp(r) = (r + 1) - tp(r)
    Needs only VALUE sorts plus searchsorted on the thinned rows — the
    argsort form pays two full-pool gathers, and searchsorted with
    full-pool queries runs one binary search per pooled window.  Ranks stay int32 ON
    DEVICE (exact; caller guards pool < 2^31); the f64 sweep math runs
    on the host from the fetched integer ranks — f32 ranks would
    quantize past 2^24 pooled windows.  Pads (-inf) sit below any real
    score, so thinned rows < n never reach them.

    ``pp``/``nn``: positive/negative pooled scores (may carry -inf
    pads); ``rows_d``: int32 descending-rank rows; ``n_neg``: true
    (unpadded) negative count.
    """
    import jax.numpy as jnp

    n_tot = int(pp.shape[0] + nn.shape[0])
    if n_tot >= 2**31:
        raise ValueError("pooled window count exceeds int32 rank range")
    pool_sorted = jnp.sort(jnp.concatenate([pp, nn]))  # ascending
    pos_sorted = jnp.sort(pp)
    neg_sorted = jnp.sort(nn)  # -inf pads sort FIRST ascending
    sc_t = pool_sorted[n_tot - 1 - rows_d]  # r-th largest at each row
    n_pool_gt = (
        n_tot - jnp.searchsorted(pool_sorted, sc_t, side="right")
    ).astype(jnp.int32)
    pos_le = jnp.searchsorted(pos_sorted, sc_t, side="right")
    pos_lt = jnp.searchsorted(pos_sorted, sc_t, side="left")
    n_pos_gt = (int(pp.shape[0]) - pos_le).astype(jnp.int32)
    ties_pos = (pos_le - pos_lt).astype(jnp.int32)
    r1 = rows_d.astype(jnp.int32) + 1
    tp = n_pos_gt + jnp.clip(r1 - n_pool_gt, 0, ties_pos)
    fpc = r1 - tp
    pad_neg = int(nn.shape[0]) - n_neg
    lo = jnp.clip(
        jnp.searchsorted(neg_sorted, sc_t, side="left") - pad_neg, 0, n_neg
    ).astype(jnp.int32)
    hi = jnp.clip(
        jnp.searchsorted(neg_sorted, sc_t, side="right") - pad_neg, 0, n_neg
    ).astype(jnp.int32)
    return sc_t, tp, fpc, lo, hi


def threshold_sweep_device(
    pos_dev, neg_dev, m_fold: float,
    n_pos: int, n_neg: int, max_rows: int = 100_000,
) -> dict:
    """threshold_sweep computed ON DEVICE, fetching only a thinned table.

    For MOPS (per-window) statistics the pooled score count reaches
    tens of millions (23M at 10k x 200 bp x mFold 10); hosting the pool
    costs gigabytes of device->host traffic per motif while the sweep
    itself is one sort + two cumsums — textbook device work.  The full-
    resolution sweep runs in jnp; at most ``max_rows`` uniformly-ranked
    rows (endpoints kept) cross to the host.

    ``pos_dev``/``neg_dev`` may carry -inf padding on invalid windows;
    ``n_pos``/``n_neg`` are the true counts (host-computable from the
    length vectors), and pads sort past the true tail where a static
    slice drops them.

    Tie handling matches the numpy sweep up to within-tie row order
    (cumulative values at tie-block boundaries are identical).
    """
    import jax.numpy as jnp

    pp = jnp.asarray(pos_dev, jnp.float32).ravel()
    nn = jnp.asarray(neg_dev, jnp.float32).ravel()
    n = n_pos + n_neg
    rows_d = jnp.asarray(thin_rows(n, max_rows), jnp.int32)
    pool_s, tp_dev, fp_dev, lo_dev, hi_dev = thinned_rank_rows(
        pp, nn, rows_d, n_neg
    )
    return sweep_from_ranks(
        pool_s, tp_dev, fp_dev, lo_dev, hi_dev, m_fold, n_pos, n_neg
    )


def sweep_from_ranks(score, tp, fpc, lo, hi,
                     m_fold: float, n_pos: int, n_neg: int) -> dict:
    """float64 host sweep table from fetched integer ranks — the ONE
    implementation behind threshold_sweep_device and the fused FDR MOPS
    path (evaluation.fdr).  Tie p-values use the rank-midpoint convention
    (scoring.scan._pvalues_from_ranks documents it)."""
    m = m_fold if m_fold > 0 else 1
    tp_h = np.asarray(tp, np.float64)
    fp_h = np.asarray(fpc, np.float64) / m
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    frac = np.where(hi > lo, 0.5 * (lo + hi), lo)
    if n_neg > 0:
        pv = np.clip(
            (n_neg - frac + 1.0) / (n_neg + 1.0), 1.0 / (n_neg + 1.0), 1.0
        )
    else:
        pv = np.ones_like(frac)
    return {
        "score": np.asarray(score, np.float64),
        "tp": tp_h,
        "fp": fp_h,
        "precision": tp_h / np.maximum(tp_h + fp_h, 1e-30),
        "recall": tp_h / max(n_pos, 1),
        "pvalue": pv,
    }


def threshold_sweep(pos: np.ndarray, neg: np.ndarray, m_fold: float) -> dict:
    """Sweep thresholds over pooled descending scores.

    ``m_fold``: the negative oversampling factor FP counts are divided by
    so precision/recall refer to the positive-set scale — the --mFold
    integer for sampled negatives, or #neg/#pos (possibly < 1) for
    user-provided negative sets.

    Returns dict of arrays (one entry per pooled score, descending):
    score, tp, fp (mFold-normalized), precision, recall, pvalue.
    """
    pos = np.asarray(pos, np.float64)
    neg = np.asarray(neg, np.float64)
    pool = np.concatenate([pos, neg])
    is_pos = np.concatenate([np.ones(pos.size, bool), np.zeros(neg.size, bool)])
    order = np.argsort(-pool, kind="stable")
    pool, is_pos = pool[order], is_pos[order]
    tp = np.cumsum(is_pos).astype(np.float64)
    fp = np.cumsum(~is_pos).astype(np.float64) / (m_fold if m_fold > 0 else 1)
    precision = tp / np.maximum(tp + fp, 1e-30)
    recall = tp / max(pos.size, 1)
    pvalue = empirical_pvalues(pool, neg)
    return {
        "score": pool,
        "tp": tp,
        "fp": fp,
        "precision": precision,
        "recall": recall,
        "pvalue": pvalue,
    }


def average_recall(sweep: dict, fdr_range: tuple = (0.0, 0.5)) -> float:
    """AvRec: mean recall over a false-discovery-rate range (default 0..0.5),
    the quality headline of Ge et al. 2021.  Computed by integrating recall
    as a function of FDR = 1 - precision over the sweep.

    O(n log n): sort by FDR once and take the running-max recall, then
    read the 101 grid points by searchsorted.  (The previous 101 x n
    broadcast allocated ~2 GB per call on MOPS sweeps of genome-scale
    sets — 23M pooled window scores at 10k x 200 bp x mFold 10.)"""
    fdr = 1.0 - sweep["precision"]
    recall = sweep["recall"]
    lo, hi = fdr_range
    order = np.argsort(fdr, kind="stable")
    f_sorted = fdr[order]
    r_best = np.maximum.accumulate(recall[order])  # best recall at FDR <= f
    grid = np.linspace(lo, hi, 101)
    idx = np.searchsorted(f_sorted, grid, side="right") - 1
    best = np.where(idx >= 0, r_best[np.clip(idx, 0, None)], 0.0)
    return float(best.mean())
