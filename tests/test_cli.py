"""End-to-end CLI pipeline tests (the reference README walkthrough shape)."""

import os

import numpy as np
import pytest

from bammmotif2_tpu.cli import main, params_from_args
from bammmotif2_tpu.utils.fasta import write_fasta

from tests.test_em import planted_set

MOTIF = "TGACTCAG"


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    sset = planted_set(n=120, l=80, motif=MOTIF, q=0.85, noise=0.05)
    fasta = d / "pos.fasta"
    write_fasta(fasta, sset)
    meme = d / "seeds.meme"
    meme.write_text(
        "MEME version 4\n\nMOTIF seed1\n"
        "letter-probability matrix: alength= 4 w= 8 nsites= 50\n"
        + "".join(
            " ".join(f"{p:.3f}" for p in row) + "\n"
            for row in __import__(
                "bammmotif2_tpu.models.seeds", fromlist=["iupac_to_pwm"]
            ).iupac_to_pwm(MOTIF, soft=0.6)
        )
    )
    return d, str(fasta), str(meme)


class TestArgParsing:
    def test_defaults_match_reference(self):
        p = params_from_args(["out", "pos.fa", "--PWMFile", "s.meme"])
        assert p.modelOrder == 2
        assert p.bgModelOrder == 2
        assert p.q == 0.9
        assert p.modelBeta == 7.0
        assert p.modelGamma == 3.0
        assert p.bgModelAlpha == 10.0
        assert p.cvFold == 5
        assert p.mFold == 10
        assert p.sOrder == 2
        assert not p.EM and not p.CGS and not p.FDR

    def test_reference_style_flags(self):
        p = params_from_args(
            ["out", "pos.fa", "--PWMFile", "s.meme", "--EM", "--FDR",
             "-k", "4", "-K", "3", "-q", "0.5", "--mFold", "5", "--ss",
             "--extend", "2", "3"]
        )
        assert p.EM and p.FDR and p.ss
        assert p.modelOrder == 4 and p.bgModelOrder == 3
        assert p.q == 0.5 and p.mFold == 5
        assert p.extend == (2, 3)


class TestPipeline:
    def test_pattern_seed_pipeline(self, workdir):
        # --pattern: IUPAC seed straight from the command line (no PWM file)
        d, fasta, _ = workdir
        out = d / "run_pattern"
        rc = main(
            [str(out), fasta, "--pattern", MOTIF, "--EM", "-k", "2",
             "-q", "0.5", "--basename", "t"]
        )
        assert rc == 0
        from bammmotif2_tpu.models.motif import Motif

        m = Motif.read(str(out / "t_motif_1.ihbcp"))
        consensus = "".join("ACGT"[i] for i in m.v[0].argmax(axis=0))
        assert consensus == MOTIF
        # header metadata present and ignored by the reader
        head = (out / "t_motif_1.ihbcp").read_text().splitlines()[:3]
        assert head[0].startswith("# W = ")
        assert head[1] == "# K = 2"
        assert m.W == len(MOTIF) and m.K == 2

    def test_pattern_multiple_seeds(self, workdir):
        from bammmotif2_tpu.models.motifset import load_motifs
        from bammmotif2_tpu.utils.config import Params

        ms = load_motifs(
            Params(pattern="TGACTCAG;NNRYSWKN", modelOrder=1),
            np.full(4, 0.25),
        )
        assert [m.name for m in ms] == ["motif_1", "motif_2"]
        assert all(m.W == 8 and m.K == 1 for m in ms)

    def test_em_pipeline_writes_models(self, workdir):
        d, fasta, meme = workdir
        out = d / "run_em"
        rc = main(
            [str(out), fasta, "--PWMFile", meme, "--EM", "-k", "2",
             "-q", "0.5", "--basename", "t"]
        )
        assert rc == 0
        files = os.listdir(out)
        assert "t.hbcp" in files and "t.hbp" in files
        assert "t_motif_1.ihbcp" in files and "t_motif_1.ihbp" in files
        # refined model should encode the planted consensus
        from bammmotif2_tpu.models.motif import Motif

        m = Motif.read(str(out / "t_motif_1.ihbcp"))
        consensus = "".join("ACGT"[i] for i in m.v[0].argmax(axis=0))
        assert consensus == MOTIF

    def test_scan_pipeline(self, workdir):
        d, fasta, meme = workdir
        out = d / "run_scan"
        rc = main(
            [str(out), fasta, "--PWMFile", meme, "--EM", "--scoreSeqset",
             "--pvalCutoff", "0.01", "-q", "0.5",
             "--basename", "t", "--saveLogOdds"]
        )
        assert rc == 0
        occ = (out / "t_motif_1.occurrence").read_text().splitlines()
        assert len(occ) > 50  # most of the 120 planted sites found
        assert (out / "t_motif_1.logOdds").exists()

    def test_fdr_pipeline(self, workdir):
        d, fasta, meme = workdir
        out = d / "run_fdr"
        rc = main(
            [str(out), fasta, "--PWMFile", meme, "--EM", "--FDR",
             "--cvFold", "3", "--mFold", "2", "-q", "0.5",
             "--basename", "t", "--savePvalues"]
        )
        assert rc == 0
        stats = (out / "t_motif_1.zoops.stats").read_text().splitlines()
        assert stats[0].startswith("score\t")
        assert len(stats) > 100
        assert (out / "t_motif_1.mops.stats").exists()
        assert (out / "t_motif_1.pvalues").exists()

    def test_cgs_pipeline(self, workdir):
        d, fasta, meme = workdir
        out = d / "run_cgs"
        rc = main(
            [str(out), fasta, "--PWMFile", meme, "--CGS",
             "--maxCGSIterations", "10", "-q", "0.5", "--basename", "t"]
        )
        assert rc == 0
        assert (out / "t_motif_1.ihbcp").exists()

    def test_jsonl_metrics_and_checkpointing(self, workdir):
        import json

        d, fasta, meme = workdir
        out = d / "run_jsonl"
        rc = main(
            [str(out), fasta, "--PWMFile", meme, "--EM", "-q", "0.5",
             "--basename", "t", "--jsonl",
             "--checkpointEvery", "3"]
        )
        assert rc == 0
        events = [
            json.loads(line)
            for line in (out / "t.metrics.jsonl").read_text().splitlines()
        ]
        kinds = [e["event"] for e in events]
        assert kinds[0] == "run_start" and kinds[-1] == "run_done"
        assert "sequences_loaded" in kinds and "em_done" in kinds
        ckpts = [e for e in events if e["event"] == "em_checkpoint"]
        assert len(ckpts) >= 2  # converges after several 3-iteration chunks
        assert ckpts[0]["iteration"] == 3
        em = next(e for e in events if e["event"] == "em_done")
        # checkpointed chunked run reaches the same convergence as one-shot
        assert em["converged"]
        # the checkpoint file is the final model file (valid resume point)
        assert (out / "t_motif_1.ihbcp").exists()

    def test_checkpointed_run_matches_oneshot(self, workdir):
        d, fasta, meme = workdir
        out_a = d / "run_ck"
        out_b = d / "run_os"
        main([str(out_a), fasta, "--PWMFile", meme, "--EM", "-q", "0.5",
              "--basename", "t", "--checkpointEvery", "2"])
        main([str(out_b), fasta, "--PWMFile", meme, "--EM", "-q", "0.5",
              "--basename", "t"])
        a = (out_a / "t_motif_1.ihbcp").read_text()
        b = (out_b / "t_motif_1.ihbcp").read_text()
        assert a == b

    def test_bamm_file_resume(self, workdir):
        """A written .ihbcp re-loads via --BaMMFile (checkpoint/resume)."""
        import numpy as np

        from bammmotif2_tpu.models.motif import Motif

        d, fasta, meme = workdir
        out1 = d / "run_resume1"
        rc = main(
            [str(out1), fasta, "--PWMFile", meme, "--EM", "-q", "0.5",
             "--basename", "t"]
        )
        assert rc == 0
        saved = out1 / "t_motif_1.ihbcp"

        # resume: init from the saved BaMM; already converged, so EM should
        # stop almost immediately and write an equivalent model
        out2 = d / "run_resume2"
        rc = main(
            [str(out2), fasta, "--BaMMFile", str(saved),
             "--bgModelFile", str(out1 / "t.hbcp"), "--EM", "-q", "0.5",
             "--basename", "t"]
        )
        assert rc == 0
        m1 = Motif.read(str(saved))
        m2 = Motif.read(str(out2 / "t_motif_1.ihbcp"))
        for a, b in zip(m1.v, m2.v):
            np.testing.assert_allclose(a, b, atol=5e-3)

    def test_bgmodel_file_roundtrip(self, workdir):
        d, fasta, meme = workdir
        out1 = d / "run_bg1"
        main([str(out1), fasta, "--PWMFile", meme, "--basename", "t"])
        # reuse the saved background via --bgModelFile
        out2 = d / "run_bg2"
        rc = main(
            [str(out2), fasta, "--PWMFile", meme, "--basename", "t",
             "--bgModelFile", str(out1 / "t.hbcp")]
        )
        assert rc == 0
        a = (out1 / "t.hbcp").read_text()
        b = (out2 / "t.hbcp").read_text()
        assert a == b  # byte-identical round-trip through read->write

    def test_output_optout_flags(self, workdir):
        """--no-saveBaMMs / --no-savePRs suppress the respective outputs
        (the reference's Global booleans gate these writes)."""
        d, fasta, meme = workdir
        out = d / "run_optout"
        rc = main(
            [str(out), fasta, "--PWMFile", meme, "--EM", "--FDR",
             "--cvFold", "2", "--mFold", "2", "-q", "0.5",
             "--basename", "t", "--no-saveBaMMs", "--no-savePRs"]
        )
        assert rc == 0
        files = os.listdir(out)
        assert "t_motif_1.ihbcp" not in files and "t_motif_1.ihbp" not in files
        assert "t_motif_1.zoops.stats" not in files
        assert "t_motif_1.mops.stats" not in files
        assert "t.hbcp" in files  # background files are not gated

    def test_base_bg_model_file_seeds_f_bg(self, workdir):
        """--baseBgModelFile: the paired background's mono-nucleotide
        marginals become the --BaMMFile init's order-0 interpolation base
        (Motif::initFromBaMM's bgFile argument)."""
        from bammmotif2_tpu.models.background import BackgroundModel
        from bammmotif2_tpu.models.motifset import load_motifs
        from bammmotif2_tpu.utils.config import Params

        d, fasta, meme = workdir
        out = d / "run_basebg"
        rc = main(
            [str(out), fasta, "--PWMFile", meme, "--EM", "-q", "0.5",
             "--basename", "t"]
        )
        assert rc == 0
        bg = BackgroundModel.read(str(out / "t.hbcp"))
        f0 = np.asarray(bg.v[0], float)
        f0 = f0 / f0.sum()
        ms = load_motifs(
            Params(
                BaMMFile=str(out / "t_motif_1.ihbcp"),
                baseBgModelFile=str(out / "t.hbcp"),
            ),
            np.full(4, 0.25),
        )
        np.testing.assert_allclose(ms[0].f_bg, f0, rtol=1e-6)
        # without the flag, the caller-supplied frequencies stay in effect
        ms2 = load_motifs(
            Params(BaMMFile=str(out / "t_motif_1.ihbcp")), np.full(4, 0.25)
        )
        np.testing.assert_allclose(ms2[0].f_bg, np.full(4, 0.25))


class TestEMThenCGS:
    def test_em_and_cgs_both_run(self, workdir, tmp_path):
        """--EM --CGS runs BOTH engines (independent ifs, SURVEY 3.1):
        CGS refines the EM-refined models instead of being silently
        dropped (review regression)."""
        from bammmotif2_tpu.cli import run_pipeline

        _d, fasta, meme = workdir
        out = run_pipeline(params_from_args([
            str(tmp_path / "o"), fasta, "--PWMFile", meme,
            "--EM", "--CGS", "--maxEMIterations", "10",
            "--maxCGSIterations", "5", "-q", "0.5",
        ]))
        assert "em_results" in out and "cgs_results" in out
        assert len(out["cgs_results"]) == len(out["em_results"]) == 1

    def test_estimate_n_seeds(self, workdir):
        from bammmotif2_tpu.cli import _estimate_n_seeds

        _d, _fasta, meme = workdir
        p = params_from_args(["o", "p.fa", "--PWMFile", meme])
        assert _estimate_n_seeds(p) == 1  # one MOTIF record
        p2 = params_from_args(["o", "p.fa", "--pattern", "TGASTCA;ACGT"])
        assert _estimate_n_seeds(p2) == 2
        p3 = params_from_args(
            ["o", "p.fa", "--pattern", "A;C;G;T", "--maxPWM", "2"]
        )
        assert _estimate_n_seeds(p3) == 2
