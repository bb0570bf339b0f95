"""The five canonical configs from BASELINE.json, at CI scale.

Each test mirrors one entry of BASELINE.json's ``configs`` list (the
reference's benchmark matrix); ``chip_smoke.py`` runs configs 3-5 at
their published sizes on the GPU.  Sizes here are reduced so the suite
stays fast on the 8-virtual-device CPU backend.
"""

import numpy as np
import pytest

from bammmotif2_tpu.cli import main
from bammmotif2_tpu.evaluation.fdr import evaluate_motif
from bammmotif2_tpu.models import seeds as seeds_mod
from bammmotif2_tpu.models.background import BackgroundModel
from bammmotif2_tpu.models.motif import Motif
from bammmotif2_tpu.refinement.em import run_em
from bammmotif2_tpu.refinement.multi import run_em_multi
from bammmotif2_tpu.utils.config import Params
from bammmotif2_tpu.utils.fasta import write_fasta

from tests.test_em import planted_set

MOTIF = "TGACTCAG"


@pytest.fixture(scope="module")
def chipseq_like():
    sset = planted_set(n=250, l=120, motif=MOTIF, q=0.85, noise=0.05)
    return sset


def _seed(sset, K, soft=0.6):
    return seeds_mod.motif_from_pwm(
        seeds_mod.iupac_to_pwm(MOTIF, soft=soft), K=K,
        f_bg=sset.base_frequencies(),
    )


def _consensus(m: Motif) -> str:
    return "".join("ACGT"[i] for i in m.v[0].argmax(axis=0))


class TestBaselineConfigs:
    def test_config1_order0_pwm_em(self, chipseq_like):
        """Order-0 (PWM) single-motif EM, PWM seed."""
        sset = chipseq_like
        bg = BackgroundModel.from_sequence_set(sset, order=2)
        m = _seed(sset, K=0)
        r = run_em(m, bg, sset, Params(EM=True, q=0.5))
        assert r.converged and _consensus(m) == MOTIF
        # order-0: rows of v[0] normalize per position
        np.testing.assert_allclose(m.v[0].sum(axis=0), 1.0, atol=1e-5)

    def test_config2_order2_interpolated(self, chipseq_like):
        """Order-2 BaMM EM with interpolated pseudo-counts."""
        sset = chipseq_like
        bg = BackgroundModel.from_sequence_set(sset, order=2)
        m = _seed(sset, K=2)
        r = run_em(m, bg, sset, Params(EM=True, q=0.5))
        assert r.converged and _consensus(m) == MOTIF
        # all orders present and context-normalized
        assert len(m.v) == 3
        for k, vk in enumerate(m.v):
            grp = vk.reshape(-1, 4, vk.shape[1]).sum(axis=1)
            np.testing.assert_allclose(grp, 1.0, atol=1e-4)

    def test_config3_order4_motif_order2_bg(self, chipseq_like):
        """Order-4 BaMM with order-2 background."""
        sset = chipseq_like
        bg = BackgroundModel.from_sequence_set(sset, order=2)
        m = _seed(sset, K=4)
        r = run_em(m, bg, sset, Params(EM=True, q=0.5, modelOrder=4))
        assert np.isfinite(r.ll) and _consensus(m) == MOTIF
        assert len(m.v) == 5 and m.v[4].shape[0] == 4**5

    def test_config4_multiseed_fdr(self, chipseq_like):
        """Multi-seed batched refinement + FDR with sampled negatives."""
        sset = chipseq_like
        bg = BackgroundModel.from_sequence_set(sset, order=2)
        seeds = [_seed(sset, K=2, soft=s) for s in (0.5, 0.6, 0.7, 0.8)]
        params = Params(EM=True, FDR=True, q=0.5, cvFold=2, mFold=3)
        results = run_em_multi(seeds, bg, sset, params)
        assert all(np.isfinite(r.ll) for r in results)
        fdr = evaluate_motif(seeds[0], bg, sset, params)
        # the planted motif separates positives from sampled negatives
        from bammmotif2_tpu.evaluation.prcurve import average_recall

        assert average_recall(fdr.zoops) > 0.5
        assert (fdr.pos_pvalues < 0.5).mean() > 0.6

    def test_config5_genome_scale_scan(self, tmp_path):
        """Occurrence scanning of a learned BaMM over a large set with
        p-value output (CI-scale: 2k sequences; chip_smoke.py: 100k)."""
        sset = planted_set(n=2000, l=100, motif=MOTIF, q=0.5, noise=0.05)
        fasta = tmp_path / "scan.fasta"
        write_fasta(fasta, sset)
        meme = tmp_path / "seed.meme"
        meme.write_text(
            "MEME version 4\n\nMOTIF m1\n"
            "letter-probability matrix: alength= 4 w= 8 nsites= 50\n"
            + "".join(
                " ".join(f"{p:.3f}" for p in row) + "\n"
                for row in seeds_mod.iupac_to_pwm(MOTIF, soft=0.7)
            )
        )
        out = tmp_path / "out"
        rc = main(
            [str(out), str(fasta), "--PWMFile", str(meme), "--EM",
             "--scoreSeqset", "--pvalCutoff", "0.01", "-q", "0.5",
             "--basename", "t"]
        )
        assert rc == 0
        lines = (out / "t_motif_1.occurrence").read_text().splitlines()
        assert lines[0].startswith("header\t")
        # ~half the 2000 sequences carry a planted site
        assert len(lines) > 500
