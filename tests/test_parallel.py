"""Sharding tests: shard invariance, multi-seed vmap, dryrun entry points."""

import numpy as np
import pytest

import jax

from bammmotif2_tpu.models import seeds as seeds_mod
from bammmotif2_tpu.models.background import BackgroundModel
from bammmotif2_tpu.parallel import mesh as mesh_mod
from bammmotif2_tpu.refinement.em import run_em
from bammmotif2_tpu.refinement.multi import run_em_multi
from bammmotif2_tpu.utils.config import Params

from tests.test_em import planted_set

MOTIF = "TGACTCAG"


@pytest.fixture(scope="module")
def planted():
    # 300 is not divisible by 8: exercises the pad path
    sset = planted_set(n=300, l=80, motif=MOTIF, q=0.8, noise=0.1)
    bg = BackgroundModel.from_sequence_set(sset, order=2)
    return sset, bg


def seed_motif(sset, K=2, soft=0.6):
    return seeds_mod.motif_from_pwm(
        seeds_mod.iupac_to_pwm(MOTIF, soft=soft), K=K, f_bg=sset.base_frequencies()
    )


class TestShardInvariance:
    def test_sharded_em_matches_single_device(self, planted):
        sset, bg = planted
        params = Params(EM=True, q=0.5, maxEMIterations=10, optimizeQ=True)

        m_single = seed_motif(sset)
        r_single = run_em(m_single, bg, sset, params)

        mesh = mesh_mod.make_mesh(n_data=8, n_seed=1)
        m_shard = seed_motif(sset)
        r_shard = run_em(m_shard, bg, sset, params, mesh=mesh)

        assert r_single.iterations == r_shard.iterations
        np.testing.assert_allclose(r_single.ll, r_shard.ll, rtol=1e-4)
        np.testing.assert_allclose(r_single.q, r_shard.q, rtol=1e-4)
        for a, b in zip(m_single.v, m_shard.v):
            np.testing.assert_allclose(a, b, atol=2e-4)

    def test_mesh_2d(self, planted):
        sset, bg = planted
        mesh = mesh_mod.make_mesh(n_data=4, n_seed=2)
        assert dict(mesh.shape) == {"data": 4, "seed": 2}
        m = seed_motif(sset)
        params = Params(EM=True, maxEMIterations=3)
        r = run_em(m, bg, sset, params, mesh=mesh)
        assert np.isfinite(r.ll)


class TestMultiSeed:
    def test_vmap_matches_sequential(self, planted):
        sset, bg = planted
        params = Params(EM=True, q=0.5, maxEMIterations=8)

        seeds = [seed_motif(sset, soft=s) for s in (0.55, 0.65, 0.75)]
        singles = [m.copy() for m in seeds]
        for m in singles:
            run_em(m, bg, sset, params)

        results = run_em_multi(seeds, bg, sset, params)
        assert len(results) == 3
        for m_batch, m_single in zip(seeds, singles):
            for a, b in zip(m_batch.v, m_single.v):
                np.testing.assert_allclose(a, b, atol=2e-4)

    def test_mixed_widths_grouped(self, planted):
        sset, bg = planted
        m1 = seed_motif(sset)  # W=8
        m2 = seeds_mod.motif_from_pwm(
            seeds_mod.iupac_to_pwm("TGACTC"), K=2, f_bg=sset.base_frequencies()
        )  # W=6
        res = run_em_multi([m1, m2], bg, sset, Params(EM=True, maxEMIterations=3))
        assert all(r is not None and np.isfinite(r.ll) for r in res)

    def test_multi_seed_on_mesh(self, planted):
        sset, bg = planted
        mesh = mesh_mod.make_mesh(n_data=4, n_seed=2)
        seeds = [seed_motif(sset, soft=s) for s in (0.6, 0.7)]
        res = run_em_multi(seeds, bg, sset, Params(EM=True, maxEMIterations=3), mesh=mesh)
        assert all(np.isfinite(r.ll) for r in res)


class TestGraftEntry:
    def test_entry_compiles(self):
        import __graft_entry__ as ge

        fn, args = ge.entry()
        out = jax.jit(fn)(*args)
        jax.block_until_ready(out)
        v_new, q_new, ll, v_diff = out
        assert np.isfinite(float(ll))

    def test_dryrun_multichip(self, capsys):
        import __graft_entry__ as ge

        ge.dryrun_multichip(8)
        assert "dryrun_multichip OK" in capsys.readouterr().out


class TestMultiSeedSharded:
    def test_sharded_batched_step_matches_per_seed(self, planted):
        """One batched step on the ('data', 'seed') mesh == per-seed
        unsharded em_step."""
        import jax.numpy as jnp

        from bammmotif2_tpu.ops import encode
        from bammmotif2_tpu.refinement.em import em_step, prepare_data
        from bammmotif2_tpu.refinement.multi import make_batched_step

        sset, bg = planted
        seeds = [seed_motif(sset, soft=s) for s in (0.6, 0.7)]
        K, W = seeds[0].K, seeds[0].W
        data = prepare_data(sset, bg, K, ss=False)
        nr = jnp.asarray(float(sset.n), jnp.float32)
        kw = dict(A=4, K=K, W=W, optimize_q=True)

        refs = []
        for m in seeds:
            v = tuple(jnp.asarray(vk, jnp.float32) for vk in m.v)
            refs.append(
                em_step(
                    v, jnp.float32(0.9), data,
                    jnp.asarray(m.alphas, jnp.float32),
                    jnp.asarray(m.f_bg, jnp.float32), nr, **kw,
                )
            )

        mesh = mesh_mod.make_mesh(n_data=4, n_seed=2)
        sdata = mesh_mod.shard_em_data(mesh, data, encode.num_rows(4, K))
        seed_sh = jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec("seed")
        )
        vb = jax.device_put(tuple(
            jnp.stack([jnp.asarray(m.v[k], jnp.float32) for m in seeds])
            for k in range(K + 1)
        ), seed_sh)
        qb = jax.device_put(jnp.full((2,), 0.9, jnp.float32), seed_sh)
        ab = jax.device_put(
            jnp.stack([jnp.asarray(m.alphas, jnp.float32) for m in seeds]),
            seed_sh,
        )
        f_bg = mesh_mod.replicate(mesh, jnp.asarray(seeds[0].f_bg, jnp.float32))
        step = make_batched_step(4, K, W, True)
        v_new, q_new, lls, vds = jax.jit(step)(vb, qb, sdata, ab, f_bg, nr)

        for gi, (vr, qr, llr, vdr) in enumerate(refs):
            np.testing.assert_allclose(float(lls[gi]), float(llr), rtol=1e-5)
            np.testing.assert_allclose(float(q_new[gi]), float(qr), rtol=1e-5)
            for a, b in zip(vr, [vk[gi] for vk in v_new]):
                np.testing.assert_allclose(
                    np.asarray(a), np.asarray(b), atol=1e-5
                )


class TestShardedStep:
    def test_sharded_step_matches_unsharded(self, planted):
        """em_step on data sharded over 8 devices == unsharded em_step."""
        import jax.numpy as jnp

        from bammmotif2_tpu.ops import encode
        from bammmotif2_tpu.refinement.em import em_step, prepare_data

        sset, bg = planted
        motif = seed_motif(sset)
        K, W = motif.K, motif.W
        data = prepare_data(sset, bg, K, ss=False)
        v = tuple(jnp.asarray(vk, jnp.float32) for vk in motif.v)
        alphas = jnp.asarray(motif.alphas, jnp.float32)
        f_bg = jnp.asarray(motif.f_bg, jnp.float32)
        q = jnp.asarray(0.9, jnp.float32)
        nr = jnp.asarray(float(sset.n), jnp.float32)
        kw = dict(A=4, K=K, W=W, optimize_q=True)

        vg, qg, llg, vdg = em_step(v, q, data, alphas, f_bg, nr, **kw)

        mesh = mesh_mod.make_mesh(n_data=8, n_seed=1)
        sdata = mesh_mod.shard_em_data(mesh, data, encode.num_rows(4, K))
        assert len(sdata["cidx"].sharding.device_set) == 8
        v_r, q_r, a_r, f_r = mesh_mod.replicate(mesh, (v, q, alphas, f_bg))
        vp, qp, llp, vdp = em_step(v_r, q_r, sdata, a_r, f_r, nr, **kw)
        np.testing.assert_allclose(float(llg), float(llp), rtol=1e-5)
        np.testing.assert_allclose(float(qg), float(qp), rtol=1e-5)
        for a, b in zip(vg, vp):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


class TestBatchedLLHistory:
    def test_history_matches_solo_trace(self, planted):
        """The batched loop's device-side ll trace buffer must reproduce
        the solo per-iteration trace (stride 1 while maxEMIterations <=
        HIST_CAP) — --jsonl convergence traces survive the production
        (batched) path."""
        sset, bg = planted
        params = Params(EM=True, q=0.5, maxEMIterations=12)
        seeds = [seed_motif(sset, soft=s) for s in (0.55, 0.75)]
        solo_hist = []
        for m in seeds:
            mm = m.copy()
            r = run_em(mm, bg, sset, Params(
                EM=True, q=0.5, maxEMIterations=12,
                verbose=True,
            ))
            solo_hist.append(r.ll_history)

        results = run_em_multi(seeds, bg, sset, params)
        for r, hist in zip(results, solo_hist):
            assert len(r.ll_history) == r.iterations == len(hist)
            np.testing.assert_allclose(
                r.ll_history, hist, rtol=1e-5, atol=1e-3
            )
            assert r.ll_history[-1] == pytest.approx(r.ll, rel=1e-6)
