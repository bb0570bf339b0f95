"""Collapsed Gibbs sampling tests."""

import jax
import numpy as np
import pytest

from bammmotif2_tpu.models import seeds as seeds_mod
from bammmotif2_tpu.models.background import BackgroundModel
from bammmotif2_tpu.refinement.gibbs import run_gibbs, run_gibbs_multi
from bammmotif2_tpu.utils.config import Params

from tests.test_em import planted_set

MOTIF = "TGACTCAG"


@pytest.fixture(scope="module")
def planted():
    sset = planted_set(n=300, l=100, motif=MOTIF, q=0.8, noise=0.1)
    bg = BackgroundModel.from_sequence_set(sset, order=2)
    return sset, bg


def seed_motif(sset, K=2, soft=0.6):
    return seeds_mod.motif_from_pwm(
        seeds_mod.iupac_to_pwm(MOTIF, soft=soft), K=K, f_bg=sset.base_frequencies()
    )


class TestGibbs:
    def test_recovers_planted_motif(self, planted):
        sset, bg = planted
        m = seed_motif(sset)
        params = Params(CGS=True, q=0.5, maxCGSIterations=30, seed=0)
        res = run_gibbs(m, bg, sset, params)
        consensus = "".join("ACGT"[i] for i in m.v[0].argmax(axis=0))
        assert consensus == MOTIF
        assert np.isfinite(res.ll)
        # late iterations should beat the early ones on average
        ll = np.array(res.ll_history)
        assert ll[-5:].mean() > ll[:5].mean()

    def test_alphas_learned_and_positive(self, planted):
        sset, bg = planted
        m = seed_motif(sset)
        a0 = m.alphas.copy()
        run_gibbs(m, bg, sset, Params(CGS=True, q=0.5, maxCGSIterations=15, seed=1))
        assert m.alphas.shape == a0.shape
        assert np.all(m.alphas > 0)
        assert not np.allclose(m.alphas, a0)  # something was learned

    def test_no_alpha_optimization_flag(self, planted):
        sset, bg = planted
        m = seed_motif(sset)
        a0 = m.alphas.copy()
        run_gibbs(
            m, bg, sset,
            Params(CGS=True, maxCGSIterations=5, noAlphaOptimization=True, seed=2),
        )
        np.testing.assert_allclose(m.alphas, a0)

    def test_q_sampled_near_plant_rate(self, planted):
        sset, bg = planted
        m = seed_motif(sset)
        res = run_gibbs(m, bg, sset, Params(CGS=True, q=0.3, maxCGSIterations=30, seed=3))
        assert 0.5 < res.q <= 1.0

    def test_deterministic_given_seed(self, planted):
        sset, bg = planted
        m1, m2 = seed_motif(sset), seed_motif(sset)
        p = Params(CGS=True, maxCGSIterations=5, seed=7)
        run_gibbs(m1, bg, sset, p)
        run_gibbs(m2, bg, sset, p)
        for a, b in zip(m1.v, m2.v):
            np.testing.assert_allclose(a, b)

    def test_rows_normalized(self, planted):
        sset, bg = planted
        m = seed_motif(sset)
        run_gibbs(m, bg, sset, Params(CGS=True, maxCGSIterations=8, seed=4))
        for k, vk in enumerate(m.v):
            sums = vk.reshape(-1, 4, m.W).sum(axis=1)
            np.testing.assert_allclose(sums, 1.0, atol=1e-4, err_msg=f"order {k}")

    def test_burn_in_posterior_mean(self, planted):
        # --cgsBurnIn: Rao-Blackwellized average over post-burn-in sweeps
        sset, bg = planted
        m_avg, m_last = seed_motif(sset), seed_motif(sset)
        run_gibbs(
            m_avg, bg, sset,
            Params(CGS=True, q=0.5, maxCGSIterations=25, cgsBurnIn=10, seed=6),
        )
        run_gibbs(
            m_last, bg, sset,
            Params(CGS=True, q=0.5, maxCGSIterations=25, seed=6),
        )
        consensus = "".join("ACGT"[i] for i in m_avg.v[0].argmax(axis=0))
        assert consensus == MOTIF
        # averaging must change the estimate but keep rows normalized
        assert not np.allclose(m_avg.v[0], m_last.v[0])
        for k, vk in enumerate(m_avg.v):
            sums = vk.reshape(-1, 4, m_avg.W).sum(axis=1)
            np.testing.assert_allclose(sums, 1.0, atol=1e-4, err_msg=f"order {k}")


class TestGibbsScaleOut:
    def test_sharded_matches_single_device(self, planted):
        # data-sharded CGS over 8 virtual devices must reproduce the
        # single-device run given the same key (per-row counter-derived
        # sampling keys are layout- and padding-invariant)
        from bammmotif2_tpu.parallel import mesh as mesh_mod

        sset, bg = planted
        m1, m2 = seed_motif(sset), seed_motif(sset)
        p = Params(CGS=True, q=0.5, maxCGSIterations=6, seed=5)
        r1 = run_gibbs(m1, bg, sset, p)
        mesh = mesh_mod.make_mesh(n_data=8, n_seed=1)
        r2 = run_gibbs(m2, bg, sset, p, mesh=mesh)
        np.testing.assert_allclose(
            r1.ll_history, r2.ll_history, rtol=1e-4, atol=1e-3
        )
        assert r1.q == pytest.approx(r2.q, rel=1e-4)
        for a, b in zip(m1.v, m2.v):
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-6)

    def test_multi_seed_matches_individual(self, planted):
        sset, bg = planted
        p = Params(CGS=True, q=0.5, maxCGSIterations=5, seed=9)
        seeds = [seed_motif(sset, soft=0.6), seed_motif(sset, soft=0.8)]
        singles = [seed_motif(sset, soft=0.6), seed_motif(sset, soft=0.8)]
        results = run_gibbs_multi(seeds, bg, sset, p)
        assert len(results) == 2
        base = jax.random.PRNGKey(p.seed)
        for m, (single, batched) in enumerate(zip(singles, seeds)):
            run_gibbs(single, bg, sset, p, key=jax.random.fold_in(base, m))
            for a, b in zip(single.v, batched.v):
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(
                single.alphas, batched.alphas, rtol=1e-4
            )

    def test_sharded_step_matches_unsharded(self):
        # one CGS sweep on data sharded over 4 devices (GSPMD count
        # all-reduce) vs the same sweep unsharded, same key
        import jax.numpy as jnp

        from bammmotif2_tpu.ops import encode
        from bammmotif2_tpu.parallel import mesh as mesh_mod
        from bammmotif2_tpu.refinement.em import prepare_data
        from bammmotif2_tpu.refinement.gibbs import gibbs_step

        sset = planted_set(n=32, l=40, motif=MOTIF, q=0.8, noise=0.05, seed=2)
        bg = BackgroundModel.from_sequence_set(sset, order=2)
        m = seed_motif(sset)
        data = prepare_data(sset, bg, 2, False)
        mesh = mesh_mod.make_mesh(n_data=4, n_seed=1, devices=jax.devices()[:4])
        sdata = mesh_mod.shard_em_data(mesh, data, encode.num_rows(4, 2))

        def step(d):
            return gibbs_step(
                tuple(jnp.asarray(vk, jnp.float32) for vk in m.v),
                jnp.float32(0.5),
                jnp.log(jnp.asarray(m.alphas, jnp.float32)),
                jax.random.PRNGKey(3),
                d,
                jnp.asarray(m.f_bg, jnp.float32),
                jnp.asarray(m.alphas, jnp.float32),
                jnp.float32(sset.n),
                A=4, K=2, W=m.W, sample_z=True, sample_q=True,
                learn_alpha=True,
            )

        g = step(data)
        p = step(sdata)
        for a, b in zip(g[0], p[0]):  # v
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
        assert float(g[4]) == pytest.approx(float(p[4]), rel=1e-5)  # ll
        assert int(g[5]) == int(p[5])  # n_occ

    def test_multi_sharded_step_matches_single_unsharded(self):
        # seed-stacked sweep on data sharded over 4 devices vs the
        # single-seed unsharded gibbs_step, member by member
        import jax.numpy as jnp

        from bammmotif2_tpu.ops import encode
        from bammmotif2_tpu.parallel import mesh as mesh_mod
        from bammmotif2_tpu.refinement.em import prepare_data
        from bammmotif2_tpu.refinement.gibbs import gibbs_step, gibbs_step_multi

        sset = planted_set(n=32, l=40, motif=MOTIF, q=0.8, noise=0.05, seed=2)
        bg = BackgroundModel.from_sequence_set(sset, order=2)
        seeds = [seed_motif(sset, soft=0.55), seed_motif(sset, soft=0.75)]
        data = prepare_data(sset, bg, 2, False)
        mesh = mesh_mod.make_mesh(n_data=4, n_seed=1, devices=jax.devices()[:4])
        sdata = mesh_mod.shard_em_data(mesh, data, encode.num_rows(4, 2))
        keys = jnp.stack([jax.random.PRNGKey(3), jax.random.PRNGKey(4)])
        kw = dict(A=4, K=2, W=seeds[0].W, sample_z=True, sample_q=True,
                  learn_alpha=True)

        vb = tuple(
            jnp.stack([jnp.asarray(m.v[k], jnp.float32) for m in seeds])
            for k in range(3)
        )
        mult = gibbs_step_multi(
            vb, jnp.full((2,), 0.5, jnp.float32),
            jnp.log(jnp.stack([jnp.asarray(m.alphas, jnp.float32) for m in seeds])),
            keys, sdata,
            jnp.asarray(seeds[0].f_bg, jnp.float32),
            jnp.stack([jnp.asarray(m.alphas, jnp.float32) for m in seeds]),
            jnp.float32(sset.n), **kw,
        )
        for i, m in enumerate(seeds):
            g = gibbs_step(
                tuple(jnp.asarray(vk, jnp.float32) for vk in m.v),
                jnp.float32(0.5),
                jnp.log(jnp.asarray(m.alphas, jnp.float32)),
                keys[i], data,
                jnp.asarray(m.f_bg, jnp.float32),
                jnp.asarray(m.alphas, jnp.float32),
                jnp.float32(sset.n), **kw,
            )
            for a, b in zip(g[0], (vk[i] for vk in mult[0])):
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
            assert float(g[4]) == pytest.approx(float(mult[4][i]), rel=1e-5)
            assert int(g[5]) == int(mult[5][i])

    def test_multi_seed_grouped_widths(self, planted):
        # seeds of different widths fall into separate (W, K) groups
        sset, bg = planted
        p = Params(CGS=True, q=0.5, maxCGSIterations=4, seed=11)
        wide = seeds_mod.motif_from_pwm(
            seeds_mod.iupac_to_pwm(MOTIF + "NN", soft=0.6), K=2,
            f_bg=sset.base_frequencies(),
        )
        seeds = [seed_motif(sset), wide, seed_motif(sset, soft=0.7)]
        results = run_gibbs_multi(seeds, bg, sset, p)
        assert all(r is not None and np.isfinite(r.ll) for r in results)
        assert seeds[1].W == len(MOTIF) + 2


class TestCGSValidation:
    """CGS quality vs EM (SURVEY.md 2 Gibbs row: 'the distinctive Bayesian
    part') — held-out likelihood parity and the papers' qualitative alpha
    behavior (large pseudo-counts at uninformative positions)."""

    @staticmethod
    def _heldout_ll(motif, bg, sset, q=0.5):
        import jax.numpy as jnp

        from bammmotif2_tpu.models.motif import log_odds_lut
        from bammmotif2_tpu.ops import escore
        from bammmotif2_tpu.refinement.em import prepare_data

        data = prepare_data(sset, bg, motif.K, ss=False)
        lut = log_odds_lut(
            tuple(jnp.asarray(vk, jnp.float32) for vk in motif.v),
            data["bg_flat"],
        )
        sc, mask = escore.window_scores(lut, data["cidx"], data["lens"], motif.W)
        _r, _r0, ll = escore.zoops_posterior(sc, mask, jnp.float32(q))
        return float(ll)

    def test_cgs_matches_em_on_heldout_likelihood(self):
        """CGS-refined and EM-refined models score held-out data about
        equally, and both clearly beat the unrefined seed."""
        from bammmotif2_tpu.refinement.em import run_em

        train = planted_set(n=300, l=80, motif=MOTIF, q=0.8, noise=0.1, seed=11)
        held = planted_set(n=150, l=80, motif=MOTIF, q=0.8, noise=0.1, seed=12)
        bg = BackgroundModel.from_sequence_set(train, order=2)

        m_seed = seed_motif(train, soft=0.55)
        ll_seed = self._heldout_ll(m_seed, bg, held)

        m_em = seed_motif(train, soft=0.55)
        run_em(m_em, bg, train, Params(EM=True, q=0.5))
        ll_em = self._heldout_ll(m_em, bg, held)

        m_cgs = seed_motif(train, soft=0.55)
        run_gibbs(
            m_cgs, bg, train,
            Params(CGS=True, q=0.5, maxCGSIterations=60, cgsBurnIn=30, seed=4),
        )
        ll_cgs = self._heldout_ll(m_cgs, bg, held)

        assert ll_em > ll_seed and ll_cgs > ll_seed
        # CGS is a sampler, not an optimizer: allow a modest held-out gap
        # to the EM optimum, but it must capture most of the improvement
        assert ll_cgs - ll_seed > 0.7 * (ll_em - ll_seed), (
            ll_seed, ll_em, ll_cgs,
        )

    def test_alpha_larger_at_uninformative_flanks(self):
        """Learned pseudo-count strengths alpha_k(j) grow where the data
        is background-like (flank columns of a wide seed) and shrink at
        informative core columns — the qualitative behavior that motivates
        per-position alpha learning in the BaMM papers."""
        import numpy as np

        sset = planted_set(n=400, l=80, motif=MOTIF, q=0.85, noise=0.05, seed=13)
        bg = BackgroundModel.from_sequence_set(sset, order=2)
        # W=12 seed: 2 uninformative N columns flanking the 8-col core
        wide = "NN" + MOTIF + "NN"
        m = seeds_mod.motif_from_pwm(
            seeds_mod.iupac_to_pwm(wide, soft=0.6), K=2,
            f_bg=sset.base_frequencies(),
        )
        run_gibbs(
            m, bg, sset,
            Params(CGS=True, q=0.5, maxCGSIterations=80, seed=5),
        )
        flanks = [0, 1, len(wide) - 2, len(wide) - 1]
        core = list(range(2, len(wide) - 2))
        for k in (1, 2):
            a_flank = float(np.mean(m.alphas[k][flanks]))
            a_core = float(np.mean(m.alphas[k][core]))
            assert a_flank > a_core, (k, a_flank, a_core, m.alphas[k])


class TestCrossGroupKeys:
    def test_global_index_keys_across_groups(self, planted):
        """Motif i samples with fold_in(base, i) GLOBALLY: group-local
        indices would give the first member of every (W, K) group an
        identical PRNG stream, perfectly correlating supposedly
        independent chains (review regression)."""
        import jax

        from bammmotif2_tpu.refinement.gibbs import run_gibbs, run_gibbs_multi

        sset, bg = planted
        params = Params(CGS=True, q=0.5, maxCGSIterations=5, seed=11)

        def mk(s):
            return seeds_mod.motif_from_pwm(
                seeds_mod.iupac_to_pwm(s, soft=0.6), K=2,
                f_bg=sset.base_frequencies(),
            )

        m8, m6 = mk("TGACTCAG"), mk("TGACTC")   # two (W, K) groups
        run_gibbs_multi([m8, m6], bg, sset, params)

        base = jax.random.PRNGKey(params.seed)
        solo6 = mk("TGACTC")
        run_gibbs(solo6, bg, sset, params, key=jax.random.fold_in(base, 1))
        for a, b in zip(m6.v, solo6.v):
            np.testing.assert_allclose(a, b, atol=1e-6)
        # and a group-local key (index 0) must NOT reproduce it
        solo6b = mk("TGACTC")
        run_gibbs(solo6b, bg, sset, params, key=jax.random.fold_in(base, 0))
        assert not all(
            np.allclose(a, b, atol=1e-6) for a, b in zip(m6.v, solo6b.v)
        )
