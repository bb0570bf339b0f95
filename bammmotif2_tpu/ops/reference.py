"""Float64 numpy reference of the EM data path, independent of ``ops.escore``.

Brute force on purpose, so that it shares no code with what it checks:

  - ``kmer_rows`` walks each sequence position by position and derives its
    order-truncated combined-LUT row from the raw codes (the rule
    ``ops.encode`` implements with shifted arrays);
  - window scores, the ZOOPS posterior, the M-step counts, the per-order
    marginalization and the interpolated pseudo-count update follow the
    published math (SURVEY.md 2.9) in float64.

The CPU parity tests and ``chip_smoke.py`` compare the device path with it.
"""

from __future__ import annotations

import numpy as np


def _offsets(A: int, K: int) -> np.ndarray:
    return np.concatenate([[0], np.cumsum([A ** (k + 1) for k in range(K + 1)])])


def revcomp(codes: np.ndarray, lens: np.ndarray, comp: np.ndarray) -> np.ndarray:
    """Reverse complement of each sequence's first ``lens[n]`` codes;
    ambiguous (-1) stays ambiguous, the tail is padding (-2)."""
    out = np.full_like(codes, -2)
    for n, ln in enumerate(lens):
        seq = codes[n, :ln][::-1]
        out[n, :ln] = np.where(seq >= 0, comp[np.maximum(seq, 0)], seq)
    return out


def kmer_rows(codes: np.ndarray, lens: np.ndarray, A: int, K: int) -> np.ndarray:
    """[N, L] combined-LUT row of every position.

    The context of position t is the run of unambiguous bases ending at
    t-1, capped at K; the (m+1)-mer of context length m indexes block m
    of the combined LUT, oldest base most significant.  Ambiguous bases
    and padding map to the sentinel row R.
    """
    codes = np.asarray(codes, np.int64)
    N, L = codes.shape
    off = _offsets(A, K)
    out = np.full((N, L), off[-1], np.int64)
    for n in range(N):
        run = 0
        for t in range(min(int(lens[n]), L)):
            if codes[n, t] < 0:
                run = 0
                continue
            m = min(run, K)
            y = 0
            for d in range(m, -1, -1):
                y = y * A + codes[n, t - d]
            out[n, t] = off[m] + y
            run += 1
    return out


def strand_rows(codes, lens, comp, A: int, K: int, ss: bool) -> np.ndarray:
    """[S, N, L] rows of the forward (and, unless ``ss``, the reverse-
    complement) strand."""
    strands = [np.asarray(codes)]
    if not ss:
        strands.append(revcomp(np.asarray(codes), np.asarray(lens), comp))
    return np.stack([kmer_rows(c, lens, A, K) for c in strands])


def log_odds_lut(v: list, bg_flat: np.ndarray) -> np.ndarray:
    """[R+1, W] log(v / bg) per combined row, sentinel row zero."""
    vf = np.concatenate([np.asarray(vk, np.float64) for vk in v])
    s = np.log(vf) - np.log(np.asarray(bg_flat, np.float64))[:, None]
    return np.concatenate([s, np.zeros((1, s.shape[1]))])


def window_scores(lut: np.ndarray, rows: np.ndarray, lens, W: int):
    """scores [S, N, n_win] (-inf where the window does not fit) and the
    window mask [N, n_win]."""
    S, N, L = rows.shape
    n_win = L - W + 1
    mask = np.arange(n_win)[None, :] + W <= np.asarray(lens)[:, None]
    scores = np.zeros((S, N, n_win))
    for j in range(W):
        scores += lut[rows[:, :, j : j + n_win], j]
    return np.where(mask[None], scores, -np.inf), mask


def zoops_posterior(scores: np.ndarray, mask: np.ndarray, q: float):
    """ZOOPS responsibilities r [S, N, n_win], r0 [N] and the total
    log-likelihood relative to the background-only model."""
    S = scores.shape[0]
    n_win = S * mask.sum(axis=1)
    log_prior = np.where(n_win > 0, np.log(q) - np.log(np.maximum(n_win, 1)), -np.inf)
    log_w = scores + log_prior[None, :, None]
    top = np.maximum(np.max(log_w, axis=(0, 2), initial=-np.inf), np.log1p(-q))
    log_z = top + np.log(
        np.exp(np.log1p(-q) - top)
        + np.exp(log_w - top[None, :, None]).sum(axis=(0, 2))
    )
    r = np.where(mask[None], np.exp(log_w - log_z[None, :, None]), 0.0)
    return r, np.exp(np.log1p(-q) - log_z), float(log_z.sum())


def mstep_counts(r: np.ndarray, rows: np.ndarray, R: int, W: int) -> np.ndarray:
    """C [R+1, W]: C[row, j] sums r over the windows whose position j
    falls on ``row``."""
    n_win = r.shape[2]
    C = np.zeros((R + 1, W))
    for j in range(W):
        C[:, j] = np.bincount(
            rows[:, :, j : j + n_win].ravel(), weights=r.ravel(), minlength=R + 1
        )
    return C


def counts_by_order(C: np.ndarray, A: int, K: int) -> list:
    """Per-order counts: the direct counts of order k plus the order-(k+1)
    counts summed over their oldest base."""
    off = _offsets(A, K)
    out = [C[off[k] : off[k + 1]].copy() for k in range(K + 1)]
    for k in range(K - 1, -1, -1):
        np.add.at(out[k], np.arange(A ** (k + 2)) % A ** (k + 1), out[k + 1])
    return out


def update_v(counts: list, alphas: np.ndarray, f_bg: np.ndarray) -> list:
    """Interpolated pseudo-count estimator (Siebert & Soeding 2016)."""
    A = len(f_bg)
    n0 = counts[0]
    v = [(n0 + alphas[0] * np.asarray(f_bg)[:, None]) / (n0.sum(axis=0) + alphas[0])]
    for k in range(1, len(counts)):
        nk = counts[k]
        y = np.arange(nk.shape[0])
        ctx = np.zeros((A ** k, nk.shape[1]))
        np.add.at(ctx, y // A, nk)
        v.append((nk + alphas[k] * v[k - 1][y % A ** k]) / (ctx[y // A] + alphas[k]))
    return v


def em_step(v, q, rows, lens, bg_flat, alphas, f_bg, *, A, K, W, optimize_q):
    """One EM iteration: (v_new, q_new, ll)."""
    R = int(_offsets(A, K)[-1])
    scores, mask = window_scores(log_odds_lut(v, bg_flat), rows, lens, W)
    r, _r0, ll = zoops_posterior(scores, mask, q)
    v_new = update_v(
        counts_by_order(mstep_counts(r, rows, R, W)[:R], A, K),
        np.asarray(alphas, np.float64), f_bg,
    )
    q_new = float(np.clip(r.sum() / len(lens), 1e-4, 1 - 1e-4)) if optimize_q else q
    return v_new, q_new, ll
