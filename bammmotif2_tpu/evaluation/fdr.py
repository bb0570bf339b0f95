"""Cross-validated FDR evaluation of motif quality.

JAX equivalent of ``src/evaluation/FDR.{h,cpp}``
(``FDR::evaluateMotif``, ``calculatePR``, ``calculatePvalues``, ``write``):

  for each of --cvFold folds: refine a copy of the seed motif on the other
  folds (reusing the EM engine), obtain negatives (user-provided via
  --negSeqFile, folded like the positives; otherwise sampled at
  --mFold x |heldout| from an order---sOrder background fit to the training
  positives), score held-out positives and negatives, pool ZOOPS
  (max-per-sequence) and MOPS (per-window) scores across folds, then sweep
  thresholds for precision/recall and per-score empirical p-values.

Fold mechanics (SURVEY.md 3.5 "folds are just masks"): the
sequence set is tensorized ONCE; a fold's train/test split is expressed by
zeroing the held-out/held-in rows of the length vector (a zero-length row
has no valid windows and contributes nothing to counts).  Every fold
therefore reuses the SAME compiled programs — one EM convergence loop, one
positive scorer, one negative sampler + scorer — instead of recompiling
per fold for each subset's shape.

Outputs ``.zoops.stats`` / ``.mops.stats`` TSVs.  Downstream AvRec/AUSFC
plotting lives in companion repos (SURVEY.md 2: FDR row) and is out of
scope; the stats files carry all needed columns.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from bammmotif2_tpu.evaluation import prcurve
from bammmotif2_tpu.generator import seqgen
from bammmotif2_tpu.models import motif as motif_mod
from bammmotif2_tpu.models.background import BackgroundModel
from bammmotif2_tpu.models.motif import Motif
from bammmotif2_tpu.ops import encode, escore
from bammmotif2_tpu.refinement.em import prepare_data, run_em
from bammmotif2_tpu.scoring.scan import empirical_pvalues
from bammmotif2_tpu.utils.config import Params
from bammmotif2_tpu.utils.fasta import SequenceSet


@dataclasses.dataclass
class FDRResult:
    zoops: dict  # threshold sweep arrays for max-per-sequence scores
    mops: dict   # threshold sweep arrays for per-window scores
    pos_pvalues: np.ndarray  # per held-out-positive ZOOPS-score p-values
    m_fold: int

    def write(self, outdir: str, basename: str) -> list:
        os.makedirs(outdir, exist_ok=True)
        paths = []
        for tag, sweep in (("zoops", self.zoops), ("mops", self.mops)):
            path = os.path.join(outdir, f"{basename}.{tag}.stats")
            _write_stats(path, sweep)
            paths.append(path)
        return paths


MAX_STATS_ROWS = 20_000  # written rows per .stats file (sweep stays full)


def _write_stats(path: str, sweep: dict, max_rows: int = MAX_STATS_ROWS) -> None:
    """One TSV row per sweep point, uniformly thinned past ``max_rows``.

    ZOOPS sweeps stay full-resolution in memory; MOPS sweeps arrive from
    the device already rank-thinned to this same row budget, so no row
    the writer would discard crosses to the host.
    Documented deviation: the reference writes one row per pooled score,
    which at MOPS/window scale (23M rows for 10k x 200 bp x mFold 10)
    produces gigabyte files and dominated end-to-end wall-clock;
    endpoints are always kept so the written curve spans the full range,
    and AvRec from the thinned curve matches the full sweep to ~1e-3.
    """
    n = len(sweep["score"])
    idx = prcurve.thin_rows(n, max_rows)
    with open(path, "w") as fh:
        fh.write("score\tTP\tFP\tprecision\trecall\tp-value\n")
        for i in idx:
            fh.write(
                f"{sweep['score'][i]:.6g}\t{sweep['tp'][i]:.3f}\t{sweep['fp'][i]:.3f}\t"
                f"{sweep['precision'][i]:.6f}\t{sweep['recall'][i]:.6f}\t"
                f"{sweep['pvalue'][i]:.4e}\n"
            )


@functools.partial(jax.jit, static_argnames=("W",))
def _fold_scores(v: tuple, data: dict, lens, *, W: int):
    """Score every window of the rows selected by ``lens`` (0 = masked out).

    One compiled program serves every fold: only the (static-shape) length
    vector changes.  Returns (max_per_seq [N], scores [S, N, n_win], mask
    [N, n_win]); masked rows score NEG_INF / False.
    """
    s_flat = motif_mod.log_odds_lut(v, data["bg_flat"])
    scores, mask = escore.window_scores(s_flat, data["cidx"], lens, W)
    return jnp.max(scores, axis=(0, 2)), scores, mask


@functools.partial(jax.jit, static_argnames=("n_rows",))
def _select_rows(scores, mask, rows, n_rows: int):
    """Device-side row gather before the host fetch.

    ``rows``: [n_rows] int32 selected sequence indices, -1 padding.  The
    scorer's static shapes cover ALL N rows with the unselected ones
    length-masked; fetching the full [S, N, n_win] tensor moves ~cvFold x
    the needed bytes per fold (151 MB/fold at 100k seqs), so the held-out
    rows are gathered on device first.
    """
    valid_row = rows >= 0
    safe = jnp.maximum(rows, 0)
    return scores[:, safe, :], mask[safe] & valid_row[:, None]


def _collect_scores(v: tuple, data: dict, lens_np: np.ndarray, row_sel: np.ndarray,
                    *, W: int):
    """ZOOPS maxima (host) + the fold's MOPS scores as a DEVICE array.

    Returns (max_per_seq [n_sel] host, mops_flat device f32 with -inf on
    invalid/pad windows, n_true valid-window count).  The MOPS pool stays
    ON DEVICE — it feeds prcurve.threshold_sweep_device, so the
    tens-of-millions-of-windows pool never crosses to the host (fetching
    it cost gigabytes per motif at 10k-seq mFold-10 scale).  Sparse
    selections (held-out CV folds) additionally gather their rows on
    device so the retained array is fold-sized, not set-sized.
    """
    lens_dev = jnp.asarray(np.where(row_sel, lens_np, 0).astype(lens_np.dtype))
    max_s, scores, mask = _fold_scores(v, data, lens_dev, W=W)
    max_h = np.asarray(max_s)[row_sel]
    n_sel = int(row_sel.sum())
    if n_sel * 2 <= row_sel.size:
        # fold sizes differ by <= 1, so at most two compiled shapes per run
        rows = np.nonzero(row_sel)[0].astype(np.int64)
        sc, mk = _select_rows(scores, mask, jnp.asarray(rows), n_sel)
    else:
        sc, mk = scores, mask  # unselected rows are length-masked already
    flat = jnp.where(mk[None], sc, escore.NEG_INF).ravel()
    S = scores.shape[0]
    n_true = int(
        S * np.sum(np.maximum(lens_np[row_sel].astype(np.int64) - W + 1, 0))
    )
    return max_h, flat, n_true


_thin_rows = prcurve.thin_rows  # single implementation (prcurve)


@functools.lru_cache(maxsize=32)
def _group_fdr_program(
    A: int, K: int, W: int, F: int, M: int, n_per: int,
    refine: str, optimize_q: bool, max_iters: int,
    cgs_statics: tuple, ss: bool, sampled: bool,
    neg_pad_len: int, s_order: int, n_neg_gather: int,
    n_pos_true: int, n_neg_true: int, max_rows: int,
):
    """The whole k-fold FDR evaluation of a seed group as ONE device program.

    Batched form of ``FDR::evaluateMotif`` (SURVEY.md 3.5) for M seeds
    of equal (W, K) at once: a ``lax.scan`` over the cvFold folds — each
    iteration refines ALL M seeds in one seed-stacked batched EM/CGS
    convergence loop on the train-masked length vector, scores the
    held-out positives and the fold's negatives (sampled in-program from
    the fold's background tables, or row-masked user negatives) for all
    seeds at once — followed by the per-seed MOPS
    threshold sweep (sort + int32 rank cumsums) still on device.  Only
    fold-level ZOOPS maxima and rank-thinned sweep tables return to the
    host.  One dispatch per (W, K) group replaces a per-seed, per-fold
    host loop of ~cvFold x seeds x 4 eager stages.

    Rank arithmetic stays int32 on device (exact; pools < 2^31) and the
    p-value/precision math runs on the host in float64 from the thinned
    integer ranks — f32 rank quantization past 2^24 pooled windows would
    corrupt deep-tail MOPS p-values (advisor r4 finding).
    """
    import jax.numpy as jnp  # noqa: F811 (local for the traced closures)

    from bammmotif2_tpu.ops import escore as escore_mod
    from bammmotif2_tpu.refinement import multi as multi_mod

    NEG = escore_mod.NEG_INF
    S = 1 if ss else 2
    rows_thin = _thin_rows(n_pos_true + n_neg_true, max_rows)

    def score_multi(s_flat, cidx, lens):
        sc, mk = jax.vmap(
            lambda sf: escore_mod.window_scores(sf, cidx, lens, W)
        )(s_flat)
        return sc, mk[0]

    if refine == "EM":
        batched = multi_mod.make_batched_step(A, K, W, optimize_q)

        def refine_fn(v0, q0, alphas, f_bg, tdata, n_train, epsilon, keys0):
            # the ONE batched convergence loop (multi.batched_while_loop)
            # — any change to the stop rule stays in sync with run_em_multi
            v, _q, _lls, _vds, _its, _h = multi_mod.batched_while_loop(
                batched, v0, q0, tdata, alphas, f_bg, n_train, epsilon,
                max_iters,
            )
            return v

    elif refine == "CGS":
        from bammmotif2_tpu.models import motif as motif_mod2
        from bammmotif2_tpu.refinement.gibbs import gibbs_step_multi

        sample_z, sample_q, learn_alpha, n_iters, burn_in = cgs_statics

        def refine_fn(v0, q0, alphas, f_bg, tdata, n_train, epsilon, keys0):
            la0 = jnp.log(alphas)
            acc0 = tuple(
                jnp.zeros((M, A ** (k + 1), W), jnp.float32)
                for k in range(K + 1)
            )

            def body(carry, i):
                v, q, la, keys, acc = carry
                v2, q2, la2, keys2, _lls, _noccs, counts = gibbs_step_multi(
                    v, q, la, keys, tdata, f_bg, alphas, n_train,
                    A=A, K=K, W=W, sample_z=sample_z, sample_q=sample_q,
                    learn_alpha=learn_alpha,
                )
                take = (i >= burn_in).astype(jnp.float32)
                acc = tuple(a + take * c for a, c in zip(acc, counts))
                return (v2, q2, la2, keys2, acc), None

            (v, _q, la, _keys, acc), _ = jax.lax.scan(
                body, (v0, q0, la0, keys0, acc0), jnp.arange(n_iters)
            )
            if burn_in > 0:
                acc = tuple(a / max(n_iters - burn_in, 1) for a in acc)
                v = jax.vmap(motif_mod2.update_v, in_axes=(0, 0, None))(
                    acc, jnp.exp(la), f_bg
                )
            return v

    else:  # score the seeds as-is

        def refine_fn(v0, q0, alphas, f_bg, tdata, n_train, epsilon, keys0):
            return v0

    def gather_rows(sc, mk, rows):
        """[M, S, N, nw] scores -> the selected rows, -inf on row pads."""
        valid = rows >= 0
        safe = jnp.maximum(rows, 0)
        scr = jnp.where(valid[None, None, :, None], sc[:, :, safe, :], NEG)
        mkr = mk[safe] & valid[:, None]
        return scr, mkr

    @jax.jit
    def program(inp):
        cidx, bg_flat = inp["cidx"], inp["bg_flat"]
        v0, q0 = inp["v0"], inp["q0"]
        alphas, f_bg = inp["alphas"], inp["f_bg"]
        epsilon, keys0 = inp["epsilon"], inp["keys0"]

        def fold_body(_, x):
            tdata = {"cidx": cidx, "lens": x["train_lens"],
                     "bg_flat": bg_flat}
            v = refine_fn(
                v0, q0, alphas, f_bg, tdata, x["n_train"], epsilon, keys0
            )
            s_flat = jax.vmap(
                lambda vk: motif_mod.log_odds_lut(vk, bg_flat)
            )(v)

            sc, mk = score_multi(s_flat, cidx, x["test_lens"])
            scr, mkr = gather_rows(sc, mk, x["rows"])
            pos_z = jnp.max(scr, axis=(1, 3))
            pos_m = jnp.where(mkr[None, None], scr, NEG).reshape(M, -1)

            if sampled:
                ncidx = seqgen._sample_encode(
                    x["key"], x["trans"], x["neg_lens"], inp["comp_table"],
                    L=neg_pad_len, s_order=s_order, A=A, K=K, ss=ss,
                )
                nsc, nmk = score_multi(s_flat, ncidx, x["neg_lens"])
                neg_z = jnp.max(nsc, axis=(1, 3))
                neg_m = jnp.where(nmk[None, None], nsc, NEG).reshape(M, -1)
            else:
                nsc, nmk = score_multi(
                    s_flat, inp["neg_cidx"], x["neg_test_lens"]
                )
                nscr, nmkr = gather_rows(nsc, nmk, x["neg_rows"])
                neg_z = jnp.max(nscr, axis=(1, 3))
                neg_m = jnp.where(nmkr[None, None], nscr, NEG).reshape(M, -1)
            return 0, (pos_z, pos_m, neg_z, neg_m)

        _, (pos_z, pos_m, neg_z, neg_m) = jax.lax.scan(
            fold_body, 0, inp["xs"]
        )

        # fold-pooled per-seed MOPS pools: [F, M, X] -> [M, F * X]
        pos_pool = jnp.swapaxes(pos_m, 0, 1).reshape(M, -1)
        neg_pool = jnp.swapaxes(neg_m, 0, 1).reshape(M, -1)
        rows_d = jnp.asarray(rows_thin, jnp.int32)

        def sweep_one(pools):
            # tie-block rank reconstruction — single implementation
            # shared with threshold_sweep_device (see
            # prcurve.thinned_rank_rows for the math and why argsort/
            # full-pool searchsorted are unusable at this scale)
            pp, nn = pools
            return prcurve.thinned_rank_rows(pp, nn, rows_d, n_neg_true)

        # lax.map (sequential over seeds) bounds the sort workspace to one
        # seed's pool instead of vmapping M sorts of tens of millions each
        sw = jax.lax.map(sweep_one, (pos_pool, neg_pool))
        return dict(pos_z=pos_z, neg_z=neg_z, sw=sw)

    return program


def _mops_from_ranks(sw, m: int, m_fold_eff: float,
                     n_pos_true: int, n_neg_true: int) -> dict:
    """Host float64 sweep table from the fetched int32 device ranks
    (one implementation: prcurve.sweep_from_ranks)."""
    return prcurve.sweep_from_ranks(
        sw[0][m], sw[1][m], sw[2][m], sw[3][m], sw[4][m],
        m_fold_eff, n_pos_true, n_neg_true,
    )


def evaluate_motifs(
    seed_motifs: list,
    bg: BackgroundModel,
    sset: SequenceSet,
    params: Params | None = None,
    refine: str | None = None,
    neg_set: SequenceSet | None = None,
) -> list:
    """k-fold CV FDR analysis for a whole MotifSet — the batched driver.

    Semantically ``[evaluate_motif(m, ...) for m in seed_motifs]`` (same
    folds, same per-fold PRNG keys, same statistics), but seeds of equal
    (W, K) evaluate through ONE fused device program per group
    (``_group_fdr_program``): the fold loop, seed-stacked refinement,
    scoring, in-program negative sampling, and the MOPS threshold sweeps
    all run device-side, so a full --FDR pass costs one dispatch + one
    small fetch per group instead of ~cvFold x seeds x 4 eager stages.

    Falls back to the per-seed path when cvFold < 2 (the fused program's
    fold scan needs at least one real train/test split).

    ``refine``: 'EM', 'CGS', or 'none' (score the seeds as-is, no
    per-fold refinement); None (the default) derives the engine from
    ``params`` (CGS when params.CGS else EM).
    """
    params = params or Params(FDR=True)
    if refine is None:
        refine = "CGS" if params.CGS else "EM"
    n_folds = max(1, params.cvFold)
    if n_folds < 2 or sset.n < n_folds:
        return [
            evaluate_motif(m, bg, sset, params, refine=refine,
                           neg_set=neg_set)
            for m in seed_motifs
        ]

    results: list = [None] * len(seed_motifs)
    groups: dict = {}
    for i, m in enumerate(seed_motifs):
        # f_bg joins the key: the fused program shares one f_bg across
        # the stack, so seeds lifted against different base frequencies
        # must land in separate groups to match the per-seed path
        groups.setdefault(
            (m.W, m.K, m.A, np.asarray(m.f_bg, np.float64).tobytes()), []
        ).append(i)
    for idxs in groups.values():
        group = [seed_motifs[i] for i in idxs]
        for i, res in zip(idxs, _evaluate_group(
            group, bg, sset, params, refine, neg_set
        )):
            results[i] = res
    return results


def _evaluate_group(
    group: list,
    bg: BackgroundModel,
    sset: SequenceSet,
    params: Params,
    refine: str,
    neg_set: SequenceSet | None,
) -> list:
    """Fused FDR evaluation of one (W, K) seed group (see evaluate_motifs)."""
    A, K, W = group[0].A, group[0].K, group[0].W
    M = len(group)
    F = max(1, params.cvFold)
    S = 1 if params.ss else 2
    N = sset.n
    lens_np = np.asarray(sset.lens, np.int32)
    fold_of = np.arange(N) % F
    n_per = -(-N // F)

    data = prepare_data(sset, bg, K, params.ss)

    rows_np = np.full((F, n_per), -1, np.int32)
    train_lens = np.zeros((F, N), np.int32)
    test_lens = np.zeros((F, N), np.int32)
    n_train = np.zeros((F,), np.float32)
    fold_sizes = np.zeros((F,), np.int64)
    for f in range(F):
        t_idx = np.nonzero(fold_of == f)[0]
        rows_np[f, : t_idx.size] = t_idx
        fold_sizes[f] = t_idx.size
        test_lens[f, t_idx] = lens_np[t_idx]
        train_lens[f] = np.where(fold_of != f, lens_np, 0)
        n_train[f] = float((fold_of != f).sum())

    xs: dict = {
        "train_lens": jnp.asarray(train_lens),
        "test_lens": jnp.asarray(test_lens),
        "rows": jnp.asarray(rows_np),
        "n_train": jnp.asarray(n_train),
    }
    inp: dict = {
        "cidx": data["cidx"],
        "bg_flat": data["bg_flat"],
        "v0": tuple(
            jnp.stack([jnp.asarray(m.v[k], jnp.float32) for m in group])
            for k in range(K + 1)
        ),
        "q0": jnp.full((M,), params.q, jnp.float32),
        "alphas": jnp.stack(
            [jnp.asarray(m.alphas, jnp.float32) for m in group]
        ),
        "f_bg": jnp.asarray(group[0].f_bg, jnp.float32),
        "epsilon": jnp.float32(params.epsilon),
        # CGS parity with the per-seed path: every seed samples with the
        # run key PRNGKey(params.seed) (run_gibbs's default), every fold
        "keys0": jnp.stack(
            [jax.random.PRNGKey(params.seed)] * M
        ),
        "xs": xs,
    }

    n_pos_true = int(S * np.maximum(lens_np.astype(np.int64) - W + 1, 0).sum())
    sampled = neg_set is None
    if sampled:
        m_fold = params.mFold
        n_neg_pad = int(fold_sizes.max()) * max(m_fold, 1)
        neg_pad_len = int(lens_np.max()) if lens_np.size else W
        neg_lens_f = np.zeros((F, n_neg_pad), np.int32)
        trans_f = [
            np.zeros((F, A ** (o + 1)), np.float32)
            for o in range(params.sOrder + 1)
        ]
        for f in range(F):
            train_idx = np.nonzero(fold_of != f)[0]
            if train_idx.size == 0:
                train_idx = np.nonzero(fold_of == f)[0]
            bg_fit = BackgroundModel.from_sequence_set(
                sset.subset(train_idx), order=params.sOrder,
                alpha=params.bgModelAlpha, ss=params.ss,
            )
            for o in range(params.sOrder + 1):
                trans_f[o][f] = np.asarray(bg_fit.v[o], np.float32).ravel()
            rep = np.tile(lens_np[fold_of == f], m_fold)
            neg_lens_f[f, : rep.size] = rep
        xs["key"] = jnp.stack([
            jax.random.PRNGKey(params.seed + f) for f in range(F)
        ])
        xs["trans"] = tuple(jnp.asarray(t) for t in trans_f)
        xs["neg_lens"] = jnp.asarray(neg_lens_f)
        inp["comp_table"] = jnp.asarray(encode.comp_table(sset.alphabet))
        n_neg_true = int(
            S * np.maximum(neg_lens_f.astype(np.int64) - W + 1, 0).sum()
        )
        n_neg_gather = 0
        # rows with real sampled negatives, BY INDEX: a zero-length
        # positive row tiles into interior zero-length negative rows, so
        # a prefix slice would keep NEG_INF rows and drop real tail rows
        # (the per-seed path selects by neg_lens > 0 the same way)
        neg_keep = [np.nonzero(neg_lens_f[f] > 0)[0] for f in range(F)]
    else:
        neg_data = prepare_data(neg_set, bg, K, params.ss)
        neg_lens_np = np.asarray(neg_set.lens, np.int32)
        Nn = neg_set.n
        neg_fold_of = np.arange(Nn) % F
        n_neg_gather = -(-Nn // F)
        neg_rows_np = np.full((F, n_neg_gather), -1, np.int32)
        neg_test_lens = np.zeros((F, Nn), np.int32)
        for f in range(F):
            t_idx = np.nonzero(neg_fold_of == f)[0]
            neg_rows_np[f, : t_idx.size] = t_idx
            neg_test_lens[f, t_idx] = neg_lens_np[t_idx]
        xs["neg_rows"] = jnp.asarray(neg_rows_np)
        xs["neg_test_lens"] = jnp.asarray(neg_test_lens)
        inp["neg_cidx"] = neg_data["cidx"]
        neg_pad_len = 0
        n_neg_true = int(
            S * np.maximum(neg_lens_np.astype(np.int64) - W + 1, 0).sum()
        )
        neg_keep = [
            np.arange(int((neg_fold_of == f).sum())) for f in range(F)
        ]

    cgs_statics = (
        not params.noZSampling, not params.noQSampling,
        not params.noAlphaOptimization, params.maxCGSIterations,
        min(getattr(params, "cgsBurnIn", 0),
            max(params.maxCGSIterations - 1, 0)),
    )
    # MOPS sweeps fetch at the written .stats resolution (MAX_STATS_ROWS):
    # rows the writer would thin away never leave the device (AvRec from
    # a 20k-row curve matches the full sweep to ~1e-3, cf.
    # test_device_sweep_matches_numpy's thinned check)
    program = _group_fdr_program(
        A, K, W, F, M, n_per, refine, params.optimizeQ,
        params.maxEMIterations, cgs_statics, params.ss, sampled,
        neg_pad_len, params.sOrder, n_neg_gather,
        n_pos_true, n_neg_true, MAX_STATS_ROWS,
    )
    out = program(inp)

    pos_z = np.asarray(out["pos_z"])  # [F, M, n_per]
    neg_z = np.asarray(out["neg_z"])
    sw = tuple(np.asarray(s) for s in out["sw"])

    m_fold_eff = (
        max(params.mFold, 1) if sampled else neg_set.n / max(sset.n, 1)
    )
    results = []
    for m in range(M):
        pz = np.concatenate(
            [pos_z[f, m, : int(fold_sizes[f])] for f in range(F)]
        )
        nz = np.concatenate(
            [neg_z[f, m, neg_keep[f]] for f in range(F)]
        )
        results.append(FDRResult(
            zoops=prcurve.threshold_sweep(pz, nz, m_fold_eff),
            mops=_mops_from_ranks(sw, m, m_fold_eff, n_pos_true, n_neg_true),
            pos_pvalues=empirical_pvalues(pz, nz),
            m_fold=params.mFold,
        ))
    return results


def evaluate_motif(
    seed_motif: Motif,
    bg: BackgroundModel,
    sset: SequenceSet,
    params: Params | None = None,
    refine: str | None = None,
    neg_set: SequenceSet | None = None,
) -> FDRResult:
    """k-fold CV FDR analysis (``FDR::evaluateMotif``).

    ``refine``: 'EM', 'CGS', or 'none' (score the seed as-is); None (the
    default) derives the engine from ``params``.  Folds are assigned
    round-robin by sequence index (deterministic); pooled outputs
    (``pos_pvalues``, the sweep score pools) are therefore in fold-major
    order — sequences [0, F, 2F, ...] then [1, F+1, ...] — not input
    order.

    ``neg_set``: user-provided negatives (``--negSeqFile``).  When given,
    they are folded round-robin like the positives and the held-out
    negative fold is scored against the fold-trained motif — fully
    deterministic FDR statistics (the reference scores provided negatives
    the same way).  When absent, negatives are sampled per fold from an
    order---sOrder background fit to the TRAINING positives.
    """
    params = params or Params(FDR=True)
    if refine is None:
        refine = "CGS" if params.CGS else "EM"
    if sset.n == 0:
        empty = np.zeros(0)
        sweep = prcurve.threshold_sweep(empty, empty, max(params.mFold, 1))
        return FDRResult(zoops=sweep, mops=dict(sweep),
                         pos_pvalues=empty, m_fold=params.mFold)
    n_folds = max(1, params.cvFold)
    fold_of = np.arange(sset.n) % n_folds

    A, K, W = seed_motif.A, seed_motif.K, seed_motif.W
    data = prepare_data(sset, bg, K, params.ss)
    lens_np = np.asarray(sset.lens, np.int32)

    if neg_set is not None:
        neg_fold_of = np.arange(neg_set.n) % n_folds
        neg_data = prepare_data(neg_set, bg, K, params.ss)
        neg_lens_np = np.asarray(neg_set.lens, np.int32)
    else:
        # static sampled-negative geometry shared by every fold: row count
        # padded to mFold x (largest fold), lengths padded to the global max
        fold_sizes = np.bincount(fold_of, minlength=n_folds)
        n_neg_pad = int(fold_sizes.max()) * max(params.mFold, 1)
        neg_pad_len = int(lens_np.max()) if lens_np.size else 0

    pos_zoops, neg_zoops = [], []
    pos_mops, neg_mops = [], []  # DEVICE flat arrays (-inf padded)
    n_pos_mops = n_neg_mops = 0
    for f in range(n_folds):
        test_sel = fold_of == f
        train_sel = ~test_sel
        if not test_sel.any():
            continue

        m = seed_motif.copy()
        if train_sel.any():
            # train on the SAME tensors with held-out rows length-masked;
            # identical shapes every fold -> one compiled EM/CGS program
            tdata = {
                **data,
                "lens": jnp.asarray(np.where(train_sel, lens_np, 0)),
            }
            n_train = int(train_sel.sum())
            if refine == "EM":
                run_em(m, bg, sset, params, data=tdata, n_real=n_train)
            elif refine == "CGS":
                from bammmotif2_tpu.refinement.gibbs import run_gibbs

                run_gibbs(m, bg, sset, params, data=tdata, n_real=n_train)

        v = tuple(jnp.asarray(vk, jnp.float32) for vk in m.v)
        pz, pm, pm_n = _collect_scores(
            v, data, lens_np, test_sel, W=W
        )
        pos_zoops.append(pz)
        pos_mops.append(pm)
        n_pos_mops += pm_n

        if neg_set is not None:
            neg_sel = neg_fold_of == f
            if neg_sel.any():
                nz, nm, nm_n = _collect_scores(
                    v, neg_data, neg_lens_np, neg_sel, W=W
                )
                neg_zoops.append(nz)
                neg_mops.append(nm)
                n_neg_mops += nm_n
        else:
            # negatives: order-sOrder model fit to TRAINING positives
            train_set = (
                sset.subset(np.nonzero(train_sel)[0])
                if train_sel.any()
                else sset.subset(np.nonzero(test_sel)[0])
            )
            bg_fit = BackgroundModel.from_sequence_set(
                train_set, order=params.sOrder, alpha=params.bgModelAlpha,
                ss=params.ss,
            )
            # sampling + revcomp + encoding fused in one device program;
            # same PRNG keys as generate_neg_set -> identical sequences
            neg_cidx, neg_lens = seqgen.generate_neg_data(
                bg_fit, lens_np[test_sel], m_fold=params.mFold,
                seed=params.seed + f, K=K, ss=params.ss,
                n_pad=n_neg_pad, pad_len=neg_pad_len,
            )
            sdata = {
                "cidx": neg_cidx,
                "lens": jnp.asarray(neg_lens),
                "bg_flat": data["bg_flat"],
            }
            nz, nm, nm_n = _collect_scores(
                v, sdata, np.asarray(neg_lens, np.int32),
                neg_lens > 0, W=W,
            )
            neg_zoops.append(nz)
            neg_mops.append(nm)
            n_neg_mops += nm_n

    pz = np.concatenate(pos_zoops)
    nz = np.concatenate(neg_zoops) if neg_zoops else np.zeros(0)
    pm = jnp.concatenate(pos_mops)
    nm = jnp.concatenate(neg_mops) if neg_mops else jnp.zeros(0, jnp.float32)

    # FP normalization: sampled negatives are an mFold-times oversample of
    # the positives; user-provided negatives count at their true ratio
    m_fold_eff = (
        max(params.mFold, 1) if neg_set is None else neg_set.n / max(sset.n, 1)
    )
    return FDRResult(
        zoops=prcurve.threshold_sweep(pz, nz, m_fold_eff),
        # negatives share the positives' length distribution (sampled case),
        # so the MOPS window count is also mFold x the positive window
        # count; the window-scale pool sorts/sweeps ON DEVICE and only a
        # thinned table crosses to the host
        mops=prcurve.threshold_sweep_device(
            pm, nm, m_fold_eff, n_pos_mops, n_neg_mops,
            max_rows=MAX_STATS_ROWS,
        ),
        pos_pvalues=empirical_pvalues(pz, nz),
        m_fold=params.mFold,
    )
