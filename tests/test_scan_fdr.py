"""Tests for scanning, p-values, sequence generation, and FDR evaluation."""

import numpy as np
import pytest

from bammmotif2_tpu.evaluation import prcurve
from bammmotif2_tpu.evaluation.fdr import evaluate_motif
from bammmotif2_tpu.generator import seqgen
from bammmotif2_tpu.models import seeds as seeds_mod
from bammmotif2_tpu.models.background import BackgroundModel
from bammmotif2_tpu.scoring import scan
from bammmotif2_tpu.utils.config import Params
from bammmotif2_tpu.utils.fasta import SequenceSet

from tests.test_em import planted_set

MOTIF = "TGACTCAG"


@pytest.fixture(scope="module")
def trained():
    sset = planted_set(n=200, l=80, motif=MOTIF, q=0.9, noise=0.05)
    bg = BackgroundModel.from_sequence_set(sset, order=2)
    m = seeds_mod.motif_from_pwm(
        seeds_mod.iupac_to_pwm(MOTIF, soft=0.6), K=2, f_bg=sset.base_frequencies()
    )
    from bammmotif2_tpu.refinement.em import run_em

    run_em(m, bg, sset, Params(EM=True, q=0.5))
    return sset, bg, m


class TestEmpiricalPvalues:
    def test_ranks(self):
        neg = np.arange(100, dtype=float)  # 0..99
        p = scan.empirical_pvalues(np.array([99.5, 49.5, -1.0]), neg)
        assert p[0] == pytest.approx(1 / 101, rel=1e-6)
        assert p[1] == pytest.approx(51 / 101, rel=0.02)
        assert p[2] == pytest.approx(1.0)
        # monotone: higher score -> smaller p
        s = np.linspace(-5, 105, 50)
        ps = scan.empirical_pvalues(s, neg)
        assert np.all(np.diff(ps) <= 1e-12)

    def test_empty_negatives(self):
        p = scan.empirical_pvalues(np.array([1.0]), np.array([]))
        assert p[0] == 1.0


class TestScan:
    def test_planted_sites_found(self, trained):
        sset, bg, m = trained
        res = scan.score_set(m, bg, sset)
        assert res.scores.shape[0] == 2  # both strands
        # negatives for p-value calibration
        bg_fit = BackgroundModel.from_sequence_set(sset, order=2)
        neg = seqgen.generate_neg_set(bg_fit, sset.lens, m_fold=2, seed=7)
        neg_res = scan.score_set(m, bg, neg)
        occs = scan.find_occurrences(res, sset, neg_res.max_scores, pval_cutoff=0.01)
        # most sequences contain the motif; expect at least half hit
        hit_seqs = {o.seq_idx for o in occs}
        assert len(hit_seqs) > sset.n * 0.5
        # occurrence sites should mostly spell the planted motif
        sites = [o.site for o in occs]
        frac = np.mean([s == MOTIF for s in sites])
        assert frac > 0.5

    def test_revcomp_occurrence_coordinates(self, trained):
        _, bg, m = trained
        import bammmotif2_tpu.utils.fasta as fasta

        # place the motif's reverse complement on the forward strand
        rc = m.alphabet.decode(m.alphabet.revcomp(m.alphabet.encode(MOTIF)))
        s = "ACGTACGTACGT" + rc + "ACGTACGTACGT"
        sset1 = fasta.SequenceSet.from_sequences([s])
        res = scan.score_set(m, bg, sset1)
        occs = scan.find_occurrences(res, sset1, np.random.normal(-20, 1, 500), 0.01)
        assert any(o.strand == "-" and o.start == 12 and o.site == MOTIF for o in occs)

    def test_write_occurrences(self, trained, tmp_path):
        sset, bg, m = trained
        res = scan.score_set(m, bg, sset)
        occs = scan.find_occurrences(res, sset, np.random.normal(-20, 1, 500), 1e-3)
        path = tmp_path / "out.occurrence"
        scan.write_occurrences(path, occs)
        lines = path.read_text().splitlines()
        assert lines[0].startswith("header\t")
        assert len(lines) == len(occs) + 1

    def test_batched_scan_matches_unbatched(self, trained):
        sset, bg, m = trained
        full = scan.score_set(m, bg, sset, batch=4096)
        small = scan.score_set(m, bg, sset, batch=17)
        np.testing.assert_allclose(full.max_scores, small.max_scores, rtol=1e-5)

    def test_streaming_matches_retained(self, trained):
        # keep_bytes=0 forces the streaming path (chunks re-scored on
        # demand, HBM bounded by one chunk); results must be identical
        sset, bg, m = trained
        kept = scan.score_set(m, bg, sset, batch=64)
        streamed = scan.score_set(m, bg, sset, batch=64, keep_bytes=0)
        assert kept._chunks is not None and streamed._chunks is None
        np.testing.assert_array_equal(kept.max_scores, streamed.max_scores)
        assert kept.n_windows == streamed.n_windows
        np.testing.assert_array_equal(
            kept.all_window_scores(), streamed.all_window_scores()
        )
        neg = np.random.default_rng(0).normal(-10, 3, 1000)
        o1 = scan.find_occurrences(kept, sset, neg, 0.01)
        o2 = scan.find_occurrences(streamed, sset, neg, 0.01)
        assert [(o.seq_idx, o.start, o.strand, o.site) for o in o1] == [
            (o.seq_idx, o.start, o.strand, o.site) for o in o2
        ]
        assert len(o1) > 0


    def test_occurrence_pvalues_use_per_window_negative_distribution(
        self, trained
    ):
        """Shipped .occurrence p-values rank against the negatives'
        PER-WINDOW score pool (ScoreSeqSet::calcPvalues ranks calcLogOdds
        window scores) — not the per-sequence ZOOPS maxima, a different
        distribution whose use would deflate significance and mis-scale
        e-values.  This test names and pins the shipped convention."""
        sset, bg, m = trained
        res = scan.score_set(m, bg, sset)
        bg_fit = BackgroundModel.from_sequence_set(sset, order=2)
        neg = seqgen.generate_neg_set(bg_fit, sset.lens, m_fold=2, seed=7)
        neg_res = scan.score_set(m, bg, neg)
        win_pool = neg_res.all_window_scores()
        max_pool = neg_res.max_scores
        # the two pools are genuinely different distributions
        assert np.median(max_pool) > np.median(win_pool)

        occs = scan.find_occurrences(res, sset, win_pool, pval_cutoff=0.01)
        assert occs
        for o in occs[:20]:
            p_win = scan.empirical_pvalues(np.array([o.score]), win_pool)[0]
            assert o.pvalue == pytest.approx(p_win, rel=1e-3)
            # e-value = p * (#positive windows scanned)
            assert o.evalue == pytest.approx(o.pvalue * res.n_windows, rel=1e-5)
        # ranking the same score against the ZOOPS-max pool gives a LARGER
        # (conservative) p — the convention shipped is the per-window one
        p_max = scan.empirical_pvalues(np.array([occs[0].score]), max_pool)[0]
        assert p_max >= occs[0].pvalue

class TestSeqGen:
    def test_lengths_and_alphabet(self):
        sset = planted_set(n=50, l=60)
        bg_fit = BackgroundModel.from_sequence_set(sset, order=2)
        neg = seqgen.generate_neg_set(bg_fit, sset.lens, m_fold=3, seed=1)
        assert neg.n == 150
        np.testing.assert_array_equal(neg.lens, np.tile(sset.lens, 3))
        valid = neg.codes[neg.codes != -2]
        assert valid.min() >= 0 and valid.max() <= 3

    def test_matches_background_distribution(self):
        # skewed background should be reproduced in the sample
        rng = np.random.default_rng(0)
        seqs = ["".join(rng.choice(list("ACGT"), p=[0.4, 0.1, 0.1, 0.4], size=200)) for _ in range(50)]
        sset = SequenceSet.from_sequences(seqs)
        bg_fit = BackgroundModel.from_sequence_set(sset, order=0, ss=True)
        neg = seqgen.generate_neg_set(bg_fit, sset.lens, m_fold=1, seed=2)
        np.testing.assert_allclose(
            neg.base_frequencies(), sset.base_frequencies(), atol=0.02
        )

    def test_order2_dinucleotide_structure(self):
        # build a strongly correlated source: alternating-ish AC repeats
        seqs = ["ACACACACAC" * 10 for _ in range(20)]
        sset = SequenceSet.from_sequences(seqs)
        bg_fit = BackgroundModel.from_sequence_set(sset, order=1, ss=True)
        neg = seqgen.generate_neg_set(bg_fit, sset.lens, m_fold=1, seed=3)
        # after an A, a C should follow nearly always
        codes = neg.codes
        a_pos = codes[:, :-1] == 0
        c_next = codes[:, 1:] == 1
        frac = (a_pos & c_next).sum() / max(a_pos.sum(), 1)
        assert frac > 0.9

    def test_embed_motif(self, trained):
        sset, bg, m = trained
        bg_fit = BackgroundModel.from_sequence_set(sset, order=2)
        neg = seqgen.generate_neg_set(bg_fit, sset.lens, m_fold=1, seed=4)
        emb = seqgen.embed_motif(neg, m, q=1.0, seed=5)
        res = scan.score_set(m, bg, emb)
        res_neg = scan.score_set(m, bg, neg)
        assert res.max_scores.mean() > res_neg.max_scores.mean() + 2.0


class TestPRCurve:
    def test_perfect_separation(self):
        sweep = prcurve.threshold_sweep(
            pos=np.full(10, 5.0), neg=np.zeros(100), m_fold=10
        )
        # at the threshold catching all positives, FP=0 -> precision 1
        k = np.searchsorted(-sweep["score"], -5.0, side="right") - 1
        assert sweep["precision"][k] == pytest.approx(1.0)
        assert sweep["recall"][k] == pytest.approx(1.0)
        assert prcurve.average_recall(sweep) == pytest.approx(1.0)

    def test_random_scores_low_avrec(self):
        rng = np.random.default_rng(0)
        sweep = prcurve.threshold_sweep(rng.normal(size=100), rng.normal(size=1000), 10)
        assert prcurve.average_recall(sweep) < 0.6


class TestFDR:
    def test_end_to_end(self, trained, tmp_path):
        sset, bg, m = trained
        seed = seeds_mod.motif_from_pwm(
            seeds_mod.iupac_to_pwm(MOTIF, soft=0.6), K=2, f_bg=sset.base_frequencies()
        )
        params = Params(
            FDR=True, cvFold=3, mFold=2, q=0.5, maxEMIterations=20
        )
        res = evaluate_motif(seed, bg, sset, params)
        # a strongly planted motif must separate well
        assert prcurve.average_recall(res.zoops) > 0.6
        # p-values of true positives skew small
        assert np.median(res.pos_pvalues) < 0.2
        paths = res.write(str(tmp_path), "motif_1")
        for p in paths:
            assert len(open(p).readlines()) > 1


class TestFDRFoldMasks:
    def test_fold_mask_equals_subset_training(self):
        # SURVEY 3.5 "folds are just masks": EM on the full tensorization
        # with held-out rows length-masked == EM on the compacted subset
        import jax.numpy as jnp

        from bammmotif2_tpu.refinement.em import prepare_data, run_em

        sset = planted_set(n=60, l=50, motif=MOTIF, q=0.8, noise=0.05)
        bg = BackgroundModel.from_sequence_set(sset, order=2)
        params = Params(EM=True, q=0.5, maxEMIterations=15)
        train_sel = np.arange(sset.n) % 3 != 0

        def seed():
            return seeds_mod.motif_from_pwm(
                seeds_mod.iupac_to_pwm(MOTIF, soft=0.6), K=2,
                f_bg=sset.base_frequencies(),
            )

        m_sub = seed()
        r_sub = run_em(m_sub, bg, sset.subset(np.nonzero(train_sel)[0]), params)

        m_mask = seed()
        data = prepare_data(sset, bg, 2, False)
        tdata = {
            **data,
            "lens": jnp.asarray(np.where(train_sel, sset.lens, 0).astype(np.int32)),
        }
        r_mask = run_em(
            m_mask, bg, sset, params, data=tdata, n_real=int(train_sel.sum())
        )

        assert r_sub.iterations == r_mask.iterations
        assert r_sub.ll == pytest.approx(r_mask.ll, rel=1e-5)
        for a, b in zip(m_sub.v, m_mask.v):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)

    def test_folds_share_compiled_programs(self, trained):
        from bammmotif2_tpu.evaluation import fdr as fdr_mod
        from bammmotif2_tpu.refinement import em as em_mod

        sset, bg, _ = trained
        seed = seeds_mod.motif_from_pwm(
            seeds_mod.iupac_to_pwm(MOTIF, soft=0.6), K=2,
            f_bg=sset.base_frequencies(),
        )
        params = Params(
            FDR=True, cvFold=4, mFold=2, q=0.5, maxEMIterations=10,
        )
        em_before = len(em_mod._AOT_CACHE)
        sc_before = fdr_mod._fold_scores._cache_size()
        evaluate_motif(seed, bg, sset, params)
        # 4 folds share ONE EM program and <=2 scorer programs (pos + neg)
        assert len(em_mod._AOT_CACHE) - em_before <= 1
        assert fdr_mod._fold_scores._cache_size() - sc_before <= 2


class TestFDRUserNegatives:
    def test_deterministic_and_distinct_from_sampled(self, trained):
        sset, bg, _ = trained
        neg = planted_set(n=150, l=80, motif="ACGTACGT", q=0.0, noise=1.0)
        seed = seeds_mod.motif_from_pwm(
            seeds_mod.iupac_to_pwm(MOTIF, soft=0.6), K=2,
            f_bg=sset.base_frequencies(),
        )
        params = Params(
            FDR=True, cvFold=3, mFold=2, q=0.5, maxEMIterations=10,
        )
        r1 = evaluate_motif(seed.copy(), bg, sset, params, neg_set=neg)
        r2 = evaluate_motif(seed.copy(), bg, sset, params, neg_set=neg)
        np.testing.assert_array_equal(r1.zoops["score"], r2.zoops["score"])
        np.testing.assert_array_equal(r1.mops["pvalue"], r2.mops["pvalue"])
        np.testing.assert_array_equal(r1.pos_pvalues, r2.pos_pvalues)
        # and they really came from the provided negatives, not sampling
        r3 = evaluate_motif(seed.copy(), bg, sset, params)
        assert r3.zoops["score"].shape != r1.zoops["score"].shape or not np.allclose(
            r3.zoops["score"], r1.zoops["score"]
        )
        # strongly planted motif still separates against real negatives
        assert prcurve.average_recall(r1.zoops) > 0.6


class TestMaskMotif:
    def test_masking_removes_planted_sites(self):
        from bammmotif2_tpu.generator.seqgen import mask_motif
        from bammmotif2_tpu.models import seeds as seeds_mod
        from bammmotif2_tpu.models.background import BackgroundModel
        from bammmotif2_tpu.scoring import scan as scan_mod
        from bammmotif2_tpu.generator import seqgen

        from tests.test_em import planted_set

        sset = planted_set(n=150, l=80, motif="TGACTCAG", q=0.9, noise=0.02)
        bg = BackgroundModel.from_sequence_set(sset, order=2)
        motif = seeds_mod.motif_from_pwm(
            seeds_mod.iupac_to_pwm("TGACTCAG", soft=0.8),
            K=0, f_bg=sset.base_frequencies(),
        )

        def hits(s):
            res = scan_mod.score_set(motif, bg, s, ss=False)
            neg = seqgen.generate_neg_set(bg, s.lens, m_fold=5, seed=3)
            neg_res = scan_mod.score_set(motif, bg, neg, ss=False)
            return len(scan_mod.find_occurrences(res, s, neg_res.max_scores, 0.01))

        before = hits(sset)
        masked = mask_motif(sset, motif, bg, pval_cutoff=0.01, m_fold=5)
        after = hits(masked)
        assert before > 100
        assert after < before * 0.1


class TestScoreSetMulti:
    def test_matches_per_motif_score_set(self, trained):
        """score_set_multi == per-motif score_set (stacked scanner parity),
        in both retained and streaming modes."""
        sset, bg, m1 = trained
        m2 = seeds_mod.motif_from_pwm(
            seeds_mod.iupac_to_pwm(MOTIF, soft=0.8), K=2,
            f_bg=sset.base_frequencies(),
        )
        for kb in (scan.KEEP_BYTES, 0):
            multi = scan.score_set_multi([m1, m2], bg, sset, keep_bytes=kb)
            for m, res_m in zip((m1, m2), multi):
                solo = scan.score_set(m, bg, sset)
                np.testing.assert_allclose(
                    res_m.max_scores, solo.max_scores, rtol=1e-5
                )
                assert res_m.n_windows == solo.n_windows
                np.testing.assert_allclose(
                    np.sort(res_m.all_window_scores()),
                    np.sort(solo.all_window_scores()),
                    rtol=1e-5,
                )


class TestDeviceSweep:
    def test_device_sweep_matches_numpy(self):
        """threshold_sweep_device (on-device sort/cumsum, -inf padding,
        thinned fetch) == the numpy threshold_sweep."""
        import jax.numpy as jnp

        from bammmotif2_tpu.ops.escore import NEG_INF

        rng = np.random.default_rng(0)
        pos = rng.normal(2, 1, 5000).astype(np.float32)
        neg = rng.normal(0, 1, 20000).astype(np.float32)
        pos_dev = jnp.concatenate(
            [jnp.asarray(pos), jnp.full(137, NEG_INF, jnp.float32)]
        )
        neg_dev = jnp.concatenate(
            [jnp.asarray(neg), jnp.full(59, NEG_INF, jnp.float32)]
        )
        a = prcurve.threshold_sweep(pos, neg, 5)
        b = prcurve.threshold_sweep_device(
            pos_dev, neg_dev, 5, pos.size, neg.size, max_rows=10**9
        )
        for k in ("score", "tp", "fp", "precision", "recall", "pvalue"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-6, atol=1e-9, err_msg=k)
        # a thinned device sweep must reproduce AvRec
        b2 = prcurve.threshold_sweep_device(
            pos_dev, neg_dev, 5, pos.size, neg.size, max_rows=4000
        )
        assert prcurve.average_recall(b2) == pytest.approx(
            prcurve.average_recall(a), abs=2e-3
        )

    def test_scanresult_negative_pool_matches_host_array(self, trained):
        """find_occurrences with the negatives' ScanResult (device pool,
        -inf padding frontier) == with the fetched host array."""
        sset, bg, m = trained
        res = scan.score_set(m, bg, sset)
        bg_fit = BackgroundModel.from_sequence_set(sset, order=2)
        neg = seqgen.generate_neg_set(bg_fit, sset.lens, m_fold=2, seed=7)
        neg_res = scan.score_set(m, bg, neg)
        o_host = scan.find_occurrences(
            res, sset, neg_res.all_window_scores(), 0.01
        )
        o_dev = scan.find_occurrences(res, sset, neg_res, 0.01)
        assert [(o.seq_idx, o.start, o.strand) for o in o_host] == [
            (o.seq_idx, o.start, o.strand) for o in o_dev
        ]
        for a, b in zip(o_host, o_dev):
            assert a.pvalue == pytest.approx(b.pvalue, rel=1e-6)
            assert a.evalue == pytest.approx(b.evalue, rel=1e-6)
        assert len(o_host) > 0


class TestFusedFDR:
    """evaluate_motifs: the whole k-fold FDR of a seed group as ONE device
    program (fold scan + seed-stacked refinement + in-program negative
    sampling + device MOPS sweep) must reproduce the per-seed
    evaluate_motif path exactly."""

    @staticmethod
    def _seeds(sset, specs):
        return [
            seeds_mod.motif_from_pwm(
                seeds_mod.iupac_to_pwm(s, soft=0.6), K=2,
                f_bg=sset.base_frequencies(),
            )
            for s in specs
        ]

    def _assert_parity(self, ref, new):
        for i, (r, n) in enumerate(zip(ref, new)):
            assert r.m_fold == n.m_fold
            np.testing.assert_allclose(
                r.pos_pvalues, n.pos_pvalues, rtol=1e-5, atol=1e-8,
                err_msg=f"pos_pvalues motif {i}",
            )
            for k in ("score", "tp", "fp", "precision", "recall", "pvalue"):
                np.testing.assert_allclose(
                    r.zoops[k], n.zoops[k], rtol=1e-4, atol=1e-6,
                    err_msg=f"zoops {k} motif {i}",
                )
                np.testing.assert_allclose(
                    r.mops[k], n.mops[k], rtol=1e-5, atol=1e-7,
                    err_msg=f"mops {k} motif {i}",
                )

    def test_matches_per_seed_em_sampled(self, trained):
        from bammmotif2_tpu.evaluation.fdr import evaluate_motifs

        sset, bg, _ = trained
        params = Params(
            FDR=True, cvFold=3, mFold=2, q=0.5, maxEMIterations=15,
        )
        specs = [MOTIF, "TGACTCAG", "ACGTACGT"]
        ref = [
            evaluate_motif(m, bg, sset, params)
            for m in self._seeds(sset, specs)
        ]
        new = evaluate_motifs(self._seeds(sset, specs), bg, sset, params)
        self._assert_parity(ref, new)

    def test_matches_per_seed_user_negatives(self, trained):
        from bammmotif2_tpu.evaluation.fdr import evaluate_motifs

        sset, bg, _ = trained
        neg = planted_set(n=100, l=80, motif="ACGTACGT", q=0.0, noise=1.0)
        params = Params(
            FDR=True, cvFold=3, mFold=2, q=0.5, maxEMIterations=10,
        )
        specs = [MOTIF, "ACGTACGT"]
        ref = [
            evaluate_motif(m, bg, sset, params, neg_set=neg)
            for m in self._seeds(sset, specs)
        ]
        new = evaluate_motifs(
            self._seeds(sset, specs), bg, sset, params, neg_set=neg
        )
        self._assert_parity(ref, new)

    def test_matches_per_seed_cgs(self, trained):
        from bammmotif2_tpu.evaluation.fdr import evaluate_motifs

        sset, bg, _ = trained
        params = Params(
            FDR=True, CGS=True, cvFold=2, mFold=2, q=0.5,
            maxCGSIterations=6, cgsBurnIn=2,
        )
        specs = [MOTIF, "ACGTACGT"]
        ref = [
            evaluate_motif(m, bg, sset, params)
            for m in self._seeds(sset, specs)
        ]
        new = evaluate_motifs(self._seeds(sset, specs), bg, sset, params)
        self._assert_parity(ref, new)

    def test_one_program_per_group_not_per_seed(self, trained, monkeypatch):
        """The fused path never touches the per-seed EM/scoring machinery:
        all cvFold x seeds refinements run inside ONE compiled program per
        (W, K) group (round-4 verdict item #1's 'done' criterion)."""
        from bammmotif2_tpu.evaluation import fdr as fdr_mod

        sset, bg, _ = trained
        params = Params(
            FDR=True, cvFold=3, mFold=2, q=0.5, maxEMIterations=10,
        )

        def boom(*a, **k):
            raise AssertionError("per-seed machinery used in fused path")

        monkeypatch.setattr(fdr_mod, "run_em", boom)
        monkeypatch.setattr(fdr_mod, "_fold_scores", boom)
        fdr_mod._group_fdr_program.cache_clear()
        specs = [MOTIF, "TGACTCAG", "ACGTACGT"]
        res = fdr_mod.evaluate_motifs(
            self._seeds(sset, specs), bg, sset, params
        )
        assert len(res) == 3 and all(r is not None for r in res)
        # one fused program serves the whole (W=8, K=2) group
        assert fdr_mod._group_fdr_program.cache_info().currsize == 1

    def test_cvfold1_falls_back(self, trained):
        from bammmotif2_tpu.evaluation.fdr import evaluate_motifs

        sset, bg, _ = trained
        params = Params(
            FDR=True, cvFold=1, mFold=2, q=0.5, maxEMIterations=5,
        )
        res = evaluate_motifs(self._seeds(sset, [MOTIF]), bg, sset, params)
        assert len(res) == 1 and res[0].zoops["score"].size > 0


class TestWriteLogOdds:
    def test_per_window_rows(self, trained, tmp_path):
        sset, bg, m = trained
        res = scan.score_set(m, bg, sset)
        path = tmp_path / "out.logOdds"
        n_rows = scan.write_logodds(path, res, sset)
        lines = path.read_text().splitlines()
        assert lines[0] == "header\tstrand\tstart\tscore"
        assert len(lines) == n_rows + 1
        # every VALID window of every sequence, both strands
        assert n_rows == res.n_windows
        # spot-check a row: the score must equal the scored window plane
        h, strand, start, score = lines[1].split("\t")
        gi = sset.headers.index(h)
        sc = res.scores  # [S, N, n_win]
        s = 0 if strand == "+" else 1
        i = (int(start) - 1 if s == 0
             else int(sset.lens[gi]) - res.W - (int(start) - 1))
        assert float(score) == pytest.approx(float(sc[s, gi, i]), rel=1e-5)


class TestMOPSDiscrimination:
    def test_mops_scales_with_site_density(self):
        """MOPS AvRec must DISCRIMINATE site density: its recall
        denominator is ALL positive windows (FDR::calculatePR pools
        per-window scores), so a single-site set is structurally diluted
        to AvRec ~ sites/windows — the near-zero config-4 MOPS numbers —
        while a 3-sites-per-sequence set must score ~3x higher.  If this
        scaling disappears, the pool/normalization convention broke."""
        from bammmotif2_tpu.evaluation.fdr import evaluate_motifs

        rng = np.random.default_rng(3)
        L, n, W = 60, 120, len(MOTIF)

        def planted_k_sites(k_sites):
            seqs = []
            starts = [5, 25, 45]
            for i in range(n):
                s = rng.choice(4, size=L)
                for j in range(k_sites):
                    pos = starts[j] + rng.integers(0, 8)
                    s[pos : pos + W] = [
                        "ACGT".index(c) for c in MOTIF
                    ]
                seqs.append("".join("ACGT"[c] for c in s))
            return SequenceSet.from_sequences(seqs)

        params = Params(
            FDR=True, cvFold=2, mFold=4, q=0.9, maxEMIterations=20,
        )
        avrec = {}
        for k_sites in (1, 3):
            sset = planted_k_sites(k_sites)
            bg = BackgroundModel.from_sequence_set(sset, order=2)
            seed = seeds_mod.motif_from_pwm(
                seeds_mod.iupac_to_pwm(MOTIF, soft=0.6), K=2,
                f_bg=sset.base_frequencies(),
            )
            res = evaluate_motifs([seed], bg, sset, params)[0]
            avrec[k_sites] = prcurve.average_recall(res.mops)
            # ZOOPS saturates near 1 either way (every sequence has >= 1
            # site); MOPS is diluted by the all-windows denominator
            assert prcurve.average_recall(res.zoops) > 0.5
        # ~1.8x measured (sub-linear: the extra sites also shift the
        # precision curve); anything under 1.5x means no discrimination
        assert avrec[3] > 1.5 * avrec[1]
        # per-window dilution: a W-site in an L-length both-strand set
        # contributes ~W overlapping above-threshold windows out of
        # 2*(L-W+1); AvRec stays well under the ZOOPS scale
        assert avrec[1] < 0.25


class TestFusedFDRSingleStrand:
    def test_matches_per_seed_ss(self, trained):
        """--ss (S=1) geometry through the fused group program."""
        from bammmotif2_tpu.evaluation.fdr import evaluate_motifs

        sset, bg, _ = trained
        params = Params(
            FDR=True, ss=True, cvFold=2, mFold=2, q=0.5,
            maxEMIterations=10,
        )

        def mk():
            return seeds_mod.motif_from_pwm(
                seeds_mod.iupac_to_pwm(MOTIF, soft=0.6), K=2,
                f_bg=sset.base_frequencies(),
            )

        ref = [evaluate_motif(mk(), bg, sset, params)]
        new = evaluate_motifs([mk()], bg, sset, params)
        for k in ("score", "tp", "fp", "precision", "recall", "pvalue"):
            np.testing.assert_allclose(
                ref[0].zoops[k], new[0].zoops[k], rtol=1e-4, atol=1e-6,
                err_msg=f"zoops {k}",
            )
            np.testing.assert_allclose(
                ref[0].mops[k], new[0].mops[k], rtol=1e-5, atol=1e-7,
                err_msg=f"mops {k}",
            )


class TestFusedFDRMoreGeometries:
    def test_k0_parity(self, trained):
        from bammmotif2_tpu.evaluation.fdr import evaluate_motifs

        sset, bg0, _ = trained
        bg = BackgroundModel.from_sequence_set(sset, order=0)
        params = Params(
            FDR=True, cvFold=2, mFold=2, q=0.5, maxEMIterations=8,
            modelOrder=0,
        )

        def mk():
            return seeds_mod.motif_from_pwm(
                seeds_mod.iupac_to_pwm(MOTIF, soft=0.6), K=0,
                f_bg=sset.base_frequencies(),
            )

        ref = evaluate_motif(mk(), bg, sset, params)
        new = evaluate_motifs([mk()], bg, sset, params)[0]
        for k in ("score", "tp", "fp", "pvalue"):
            np.testing.assert_allclose(ref.mops[k], new.mops[k],
                                       rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(ref.zoops[k], new.zoops[k],
                                       rtol=1e-4, atol=1e-6)

    def test_methylc_alphabet_smoke(self):
        """A=5 (METHYLC) through the fused program: complements/sampling/
        scoring all honor the 5-letter alphabet (gather path on CPU)."""
        from bammmotif2_tpu.evaluation.fdr import evaluate_motifs
        from bammmotif2_tpu.utils.alphabet import Alphabet

        alphabet = Alphabet.from_type("METHYLC")
        rng = np.random.default_rng(4)
        codes = rng.integers(0, 5, (60, 50)).astype(np.int8)
        sset = SequenceSet(
            codes=codes, lens=np.full(60, 50, np.int32),
            headers=[f"s{i}" for i in range(60)], alphabet=alphabet,
        )
        bg = BackgroundModel.from_sequence_set(sset, order=1)
        pwm = np.full((6, 5), 0.1)
        pwm[:, 0] = 0.6
        m = seeds_mod.motif_from_pwm(
            pwm / pwm.sum(1, keepdims=True), K=1,
            f_bg=sset.base_frequencies(), alphabet=alphabet,
        )
        params = Params(FDR=True, cvFold=2, mFold=2, q=0.5,
                        maxEMIterations=5, sOrder=1)
        res = evaluate_motifs([m], bg, sset, params)[0]
        assert np.isfinite(res.zoops["score"]).all()
        assert res.mops["score"].size > 0


class TestFusedFDRVariableLengths:
    def test_parity_with_short_rows(self):
        """Variable-length sets, including rows SHORTER than W (zero valid
        windows): fold masks, window frontiers, and negative-length
        tiling must all agree with the per-seed path."""
        from bammmotif2_tpu.evaluation.fdr import evaluate_motifs
        from bammmotif2_tpu.utils.alphabet import Alphabet

        rng = np.random.default_rng(9)
        N, Lmax, W = 57, 70, 8
        codes = np.full((N, Lmax), -2, np.int8)
        lens = rng.integers(5, Lmax + 1, N).astype(np.int32)
        lens[3] = 5
        lens[10] = 7
        for i in range(N):
            codes[i, : lens[i]] = rng.integers(0, 4, lens[i])
            if lens[i] >= W and rng.random() < 0.7:
                p = rng.integers(0, lens[i] - W + 1)
                codes[i, p : p + W] = [
                    "ACGT".index(c) for c in MOTIF
                ]
        sset = SequenceSet(
            codes=codes, lens=lens,
            headers=[f"s{i}" for i in range(N)],
            alphabet=Alphabet.standard(),
        )
        bg = BackgroundModel.from_sequence_set(sset, order=2)

        def mk():
            return seeds_mod.motif_from_pwm(
                seeds_mod.iupac_to_pwm(MOTIF, soft=0.6), K=2,
                f_bg=sset.base_frequencies(),
            )

        params = Params(FDR=True, cvFold=4, mFold=3, q=0.5,
                        maxEMIterations=12)
        ref = evaluate_motif(mk(), bg, sset, params)
        new = evaluate_motifs([mk()], bg, sset, params)[0]
        for k in ("score", "tp", "fp", "precision", "recall", "pvalue"):
            np.testing.assert_allclose(
                ref.mops[k], new.mops[k], rtol=1e-5, atol=1e-7,
                err_msg=f"mops {k}",
            )
            np.testing.assert_allclose(
                ref.zoops[k], new.zoops[k], rtol=1e-4, atol=1e-6,
                err_msg=f"zoops {k}",
            )
        np.testing.assert_allclose(
            ref.pos_pvalues, new.pos_pvalues, rtol=1e-5, atol=1e-8
        )


class TestScanEdgeCases:
    def test_motif_wider_than_set(self, trained):
        """W > every sequence's (padded) length: empty results, not a
        trace-time shape error inside the chunk program."""
        _, bg, _ = trained
        short = SequenceSet.from_sequences(["ACGTACGTACGT"])  # len 12
        m = seeds_mod.motif_from_pwm(
            seeds_mod.iupac_to_pwm("TGACTCAGTGACTCAGTGAC", soft=0.6), K=2,
            f_bg=short.base_frequencies(),
        )  # W=20 > 12
        res = scan.score_set(m, bg, short)
        assert res.n_windows == 0
        assert res.max_scores.shape == (1,)
        assert scan.find_occurrences(res, short, np.zeros(10), 0.01) == []

    def test_empty_set(self, trained):
        _, bg, m = trained
        empty = SequenceSet.from_sequences([])
        res = scan.score_set(m, bg, empty)
        assert res.n_windows == 0 and res.max_scores.size == 0
        assert res.scores.shape[1] == 0
        assert res.mask.shape[0] == 0
        assert res.all_window_scores().size == 0

    def test_budget_uses_padded_width(self, trained):
        """The retain budget must count the PADDED window axis: a subset
        of short rows from a wide-padded set streams when the padded
        tensors exceed the budget even though lens.max() is small."""
        sset, bg, m = trained
        wide = np.full((300, 4000), -2, np.int8)
        wide[:, :30] = np.random.default_rng(0).integers(0, 4, (300, 30))
        short_wide = SequenceSet(
            codes=wide, lens=np.full(300, 30, np.int32),
            headers=[f"s{i}" for i in range(300)],
            alphabet=sset.alphabet,
        )
        # padded chunks: 2 * 300 * (4000-8+1) * 4B = 9.6 MB > budget 1 MB,
        # while the lens-based estimate (30-8+1 windows) would say retain
        res = scan.score_set(m, bg, short_wide, keep_bytes=1 << 20)
        assert res._chunks is None and res._rescan is not None
        assert res.n_windows == 300 * (30 - m.W + 1) * 2


class TestFDRRobustness:
    def test_zero_length_positive_rows_parity(self):
        """A zero-length positive row tiles into INTERIOR zero-length
        sampled-negative rows; the fused path must select real negative
        rows by index, not by prefix (regression: a prefix slice kept
        NEG_INF rows and dropped real tail scores)."""
        from bammmotif2_tpu.evaluation.fdr import (
            evaluate_motif, evaluate_motifs,
        )
        from bammmotif2_tpu.utils.alphabet import Alphabet

        rng = np.random.default_rng(5)
        N, L = 40, 50
        codes = np.full((N, L), -2, np.int8)
        lens = np.full(N, L, np.int32)
        lens[2] = 0   # empty record in fold 2 % F
        lens[7] = 0
        for i in range(N):
            codes[i, : lens[i]] = rng.integers(0, 4, lens[i])
        sset = SequenceSet(codes=codes, lens=lens,
                           headers=[f"s{i}" for i in range(N)],
                           alphabet=Alphabet.standard())
        bg = BackgroundModel.from_sequence_set(sset, order=1)

        def mk():
            return seeds_mod.motif_from_pwm(
                seeds_mod.iupac_to_pwm(MOTIF, soft=0.6), K=1,
                f_bg=sset.base_frequencies(),
            )

        params = Params(FDR=True, cvFold=3, mFold=2, q=0.5, sOrder=1,
                        maxEMIterations=6)
        ref = evaluate_motif(mk(), bg, sset, params)
        new = evaluate_motifs([mk()], bg, sset, params)[0]
        for k in ("score", "tp", "fp", "pvalue"):
            np.testing.assert_allclose(
                ref.zoops[k], new.zoops[k], rtol=1e-4, atol=1e-6,
                err_msg=f"zoops {k}",
            )
            np.testing.assert_allclose(
                ref.mops[k], new.mops[k], rtol=1e-5, atol=1e-7,
                err_msg=f"mops {k}",
            )

    def test_refine_none_scores_seed_as_is(self, trained):
        from bammmotif2_tpu.evaluation.fdr import (
            evaluate_motif, evaluate_motifs,
        )

        sset, bg, _ = trained
        params = Params(FDR=True, cvFold=2, mFold=2, q=0.5)

        def mk():
            return seeds_mod.motif_from_pwm(
                seeds_mod.iupac_to_pwm(MOTIF, soft=0.6), K=2,
                f_bg=sset.base_frequencies(),
            )

        ref = evaluate_motif(mk(), bg, sset, params, refine="none")
        new = evaluate_motifs([mk()], bg, sset, params, refine="none")[0]
        np.testing.assert_allclose(ref.zoops["score"], new.zoops["score"],
                                   rtol=1e-5)
        # the unrefined seed must differ from the EM-refined evaluation
        refined = evaluate_motif(mk(), bg, sset, params, refine="EM")
        assert not np.allclose(ref.zoops["score"], refined.zoops["score"])

    def test_empty_set(self, trained):
        from bammmotif2_tpu.evaluation.fdr import evaluate_motif

        _, bg, m = trained
        empty = SequenceSet.from_sequences([])
        res = evaluate_motif(m, bg, empty, Params(FDR=True, cvFold=3))
        assert res.pos_pvalues.size == 0
        assert res.zoops["score"].size == 0
