"""EM refinement tests: invariants, planted-motif recovery, ops checks."""

import numpy as np
import pytest

import jax.numpy as jnp

from bammmotif2_tpu.models import seeds as seeds_mod
from bammmotif2_tpu.models.background import BackgroundModel
from bammmotif2_tpu.models.motif import log_odds_lut
from bammmotif2_tpu.ops import encode, escore
from bammmotif2_tpu.refinement.em import run_em
from bammmotif2_tpu.utils.config import Params
from bammmotif2_tpu.utils.fasta import SequenceSet

BASES = np.array(list("ACGT"))


def planted_set(n=300, l=100, motif="TGACTCAG", q=0.8, seed=0, noise=0.1):
    """Background-uniform sequences, a noisy motif planted in fraction q."""
    rng = np.random.default_rng(seed)
    seqs = []
    for i in range(n):
        s = rng.choice(4, size=l)
        if rng.random() < q:
            pos = rng.integers(0, l - len(motif) + 1)
            for j, ch in enumerate(motif):
                if rng.random() > noise:
                    s[pos + j] = "ACGT".index(ch)
        seqs.append("".join(BASES[s]))
    return SequenceSet.from_sequences(seqs)


@pytest.fixture(scope="module")
def planted():
    sset = planted_set()
    bg = BackgroundModel.from_sequence_set(sset, order=2)
    return sset, bg


class TestEScoreOps:
    def test_window_scores_against_naive(self, planted):
        sset, bg = planted
        motif = seeds_mod.motif_from_pwm(
            seeds_mod.iupac_to_pwm("TGACTCAG"), K=2, f_bg=sset.base_frequencies()
        )
        cidx, lens = encode.strand_indices(sset, motif.K, ss=True)
        s_flat = log_odds_lut(
            tuple(jnp.asarray(v, jnp.float32) for v in motif.v),
            jnp.asarray(bg.conditional_flat(motif.K), jnp.float32),
        )
        scores, mask = escore.window_scores(s_flat, cidx, lens, motif.W)
        # naive check on a few windows
        sf = np.asarray(s_flat)
        ci = np.asarray(cidx)
        for n in (0, 5):
            for i in (0, 3, 50):
                want = sum(sf[ci[0, n, i + j], j] for j in range(motif.W))
                np.testing.assert_allclose(np.asarray(scores)[0, n, i], want, rtol=1e-5)
        assert bool(np.asarray(mask)[0, 0])

    def test_zoops_responsibilities_normalize(self, planted):
        sset, bg = planted
        motif = seeds_mod.motif_from_pwm(
            seeds_mod.iupac_to_pwm("TGACTCAG"), K=2, f_bg=sset.base_frequencies()
        )
        cidx, lens, bg_flat = _prep(sset, bg, motif)
        s_flat = log_odds_lut(
            tuple(jnp.asarray(v, jnp.float32) for v in motif.v), bg_flat
        )
        scores, mask = escore.window_scores(s_flat, cidx, lens, motif.W)
        r, r0, ll = escore.zoops_posterior(scores, mask, 0.9)
        total = np.asarray(r).sum(axis=(0, 2)) + np.asarray(r0)
        np.testing.assert_allclose(total, 1.0, atol=1e-5)
        assert np.isfinite(float(ll))

    def test_mstep_counts_mass(self, planted):
        sset, bg = planted
        motif = seeds_mod.motif_from_pwm(
            seeds_mod.iupac_to_pwm("TGACTCAG"), K=2, f_bg=sset.base_frequencies()
        )
        cidx, lens, bg_flat = _prep(sset, bg, motif)
        s_flat = log_odds_lut(
            tuple(jnp.asarray(v, jnp.float32) for v in motif.v), bg_flat
        )
        scores, mask = escore.window_scores(s_flat, cidx, lens, motif.W)
        r, r0, _ = escore.zoops_posterior(scores, mask, 0.9)
        R = encode.num_rows(4, motif.K)
        C = escore.mstep_counts(r, cidx, R, motif.W)
        # every motif column j collects the full responsibility mass
        col_mass = np.asarray(C).sum(axis=0)
        np.testing.assert_allclose(col_mass, float(np.asarray(r).sum()), rtol=1e-4)


def _prep(sset, bg, motif):
    cidx, lens = encode.strand_indices(sset, motif.K, ss=False)
    return cidx, lens, jnp.asarray(bg.conditional_flat(motif.K), jnp.float32)


class TestEM:
    @pytest.mark.parametrize("K", [0, 2])
    def test_recovers_planted_motif(self, planted, K):
        sset, bg = planted
        # seed: the true consensus but weakened
        motif = seeds_mod.motif_from_pwm(
            seeds_mod.iupac_to_pwm("TGACTCAG", soft=0.55),
            K=K,
            f_bg=sset.base_frequencies(),
        )
        params = Params(EM=True, q=0.5)
        res = run_em(motif, bg, sset, params)
        assert res.iterations >= 1
        consensus = "".join("ACGT"[i] for i in motif.v[0].argmax(axis=0))
        assert consensus == "TGACTCAG"
        # refined order-0 probs should sharpen beyond the seed (0.55)
        assert motif.v[0].max(axis=0).mean() > 0.7

    def test_ll_nondecreasing(self, planted):
        sset, bg = planted
        motif = seeds_mod.motif_from_pwm(
            seeds_mod.iupac_to_pwm("TGACTCAG", soft=0.6),
            K=2,
            f_bg=sset.base_frequencies(),
        )
        params = Params(EM=True, q=0.5, maxEMIterations=15)
        res = run_em(motif, bg, sset, params)
        ll = np.array(res.ll_history)
        # EM monotonicity (small float32 slack)
        assert np.all(np.diff(ll) > -np.abs(ll[:-1]) * 1e-5)

    def test_v_rows_stay_normalized(self, planted):
        sset, bg = planted
        motif = seeds_mod.motif_from_pwm(
            seeds_mod.iupac_to_pwm("TGACTCAG"), K=2, f_bg=sset.base_frequencies()
        )
        run_em(motif, bg, sset, Params(EM=True, maxEMIterations=5))
        for k, vk in enumerate(motif.v):
            sums = vk.reshape(-1, 4, motif.W).sum(axis=1)
            np.testing.assert_allclose(sums, 1.0, atol=1e-4, err_msg=f"order {k}")

    def test_optimize_q_converges_toward_plant_rate(self, planted):
        sset, bg = planted
        motif = seeds_mod.motif_from_pwm(
            seeds_mod.iupac_to_pwm("TGACTCAG", soft=0.6),
            K=2,
            f_bg=sset.base_frequencies(),
        )
        params = Params(EM=True, q=0.3, optimizeQ=True, maxEMIterations=40)
        res = run_em(motif, bg, sset, params)
        # planted occurrence rate is 0.8
        assert 0.5 < res.q <= 1.0

    def test_single_strand_mode(self, planted):
        sset, bg = planted
        motif = seeds_mod.motif_from_pwm(
            seeds_mod.iupac_to_pwm("TGACTCAG", soft=0.6),
            K=1,
            f_bg=sset.base_frequencies(),
        )
        params = Params(EM=True, ss=True, maxEMIterations=10)
        res = run_em(motif, bg, sset, params)
        assert np.isfinite(res.ll)


class TestExtendedAlphabetEM:
    def test_methylc_em_recovers_motif(self):
        """EM with the 5-letter METHYLC alphabet (A=5 end to end)."""
        from bammmotif2_tpu.models import seeds as seeds_mod
        from bammmotif2_tpu.models.background import BackgroundModel
        from bammmotif2_tpu.refinement.em import run_em
        from bammmotif2_tpu.utils.alphabet import Alphabet
        from bammmotif2_tpu.utils.config import Params
        from bammmotif2_tpu.utils.fasta import SequenceSet

        alpha = Alphabet.from_type("METHYLC")
        rng = np.random.default_rng(0)
        motif = "TGAMTCAG"  # contains methyl-C
        seqs = []
        for _ in range(120):
            s = "".join(
                rng.choice(list("ACGTM"), size=60,
                           p=[0.24, 0.24, 0.24, 0.24, 0.04])
            )
            p = rng.integers(0, 52)
            seqs.append(s[:p] + motif + s[p + 8:])
        sset = SequenceSet.from_sequences(seqs, alphabet=alpha)
        bg = BackgroundModel.from_sequence_set(sset, order=1, ss=True)
        pwm = np.full((8, 5), 0.05)
        for j, c in enumerate(motif):
            pwm[j, alpha.letters.index(c)] = 0.8
        m = seeds_mod.motif_from_pwm(
            pwm, K=1, f_bg=sset.base_frequencies(), alphabet=alpha
        )
        r = run_em(
            m, bg, sset, Params(EM=True, q=0.7, ss=True)
        )
        cons = "".join(alpha.letters[i] for i in m.v[0].argmax(axis=0))
        assert cons == motif
        assert r.converged

    def test_pwm_alphabet_mismatch_raises(self):
        from bammmotif2_tpu.models import seeds as seeds_mod

        with np.testing.assert_raises(ValueError):
            seeds_mod.motif_from_pwm(
                np.full((8, 5), 0.2), K=1, f_bg=np.full(4, 0.25)
            )
