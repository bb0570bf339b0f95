"""The plain data path against the float64 numpy reference (ops.reference).

Geometries follow what the path has to serve: every order 0-5, both
strand modes, ragged lengths with ambiguous bases, sequences shorter
than the motif, zero-length pad rows, the 5-letter METHYLC alphabet, and
seed groups of 1, 3 and 7.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from bammmotif2_tpu.models import motif as motif_mod
from bammmotif2_tpu.models import seeds as seeds_mod
from bammmotif2_tpu.models.background import BackgroundModel
from bammmotif2_tpu.ops import encode, escore, reference
from bammmotif2_tpu.refinement.em import em_step, prepare_data
from bammmotif2_tpu.refinement.multi import make_batched_step
from bammmotif2_tpu.utils.alphabet import Alphabet
from bammmotif2_tpu.utils.fasta import SequenceSet

import chip_smoke

ORDERS = [0, 1, 2, 3, 4, 5]


def _problem(K, ss=False, W=6, n=24, lmax=40, alphabet="STANDARD", seed=0,
             extra=()):
    """Ragged random sequences with ambiguous bases, a seed motif, the
    device data and the reference rows."""
    alpha = Alphabet.from_type(alphabet)
    rng = np.random.default_rng(seed + 10 * K)
    seqs = []
    for i in range(n):
        s = rng.choice(list(alpha.letters), size=int(rng.integers(W + 2, lmax + 1)))
        if i % 3 == 0:
            s[int(rng.integers(0, len(s)))] = "N"
        seqs.append("".join(s))
    sset = SequenceSet.from_sequences(seqs + list(extra), alphabet=alpha)
    bg = BackgroundModel.from_sequence_set(sset, order=min(2, K), ss=ss)
    pwm = rng.dirichlet(np.full(alpha.size, 2.0), size=W)
    motif = chip_smoke.with_context(seeds_mod.motif_from_pwm(
        pwm, K=K, f_bg=sset.base_frequencies(), alphabet=alpha
    ), seed=seed + K)
    data = prepare_data(sset, bg, K, ss)
    rows = reference.strand_rows(
        sset.codes, sset.lens, encode.comp_table(alpha), alpha.size, K, ss
    )
    return sset, bg, motif, data, rows


def _lut(motif, data):
    v = tuple(jnp.asarray(vk, jnp.float32) for vk in motif.v)
    return motif_mod.log_odds_lut(v, data["bg_flat"])


def _assert_scores(sc_dev, mask_dev, sc_ref, mask_ref):
    np.testing.assert_array_equal(np.asarray(mask_dev), mask_ref)
    m = np.broadcast_to(mask_ref[None], sc_ref.shape)
    np.testing.assert_allclose(
        np.asarray(sc_dev)[m], sc_ref[m], rtol=1e-5, atol=1e-5
    )


def _step_both(motif, bg, sset, data, rows, q=0.7, optimize_q=True):
    A, K, W = motif.A, motif.K, motif.W
    v = tuple(jnp.asarray(vk, jnp.float32) for vk in motif.v)
    out = em_step(
        v, jnp.float32(q), data, jnp.asarray(motif.alphas, jnp.float32),
        jnp.asarray(motif.f_bg, jnp.float32),
        A=A, K=K, W=W, optimize_q=optimize_q,
    )
    ref = reference.em_step(
        motif.v, q, rows, sset.lens, bg.conditional_flat(K), motif.alphas,
        motif.f_bg, A=A, K=K, W=W, optimize_q=optimize_q,
    )
    return out, ref


def _assert_step(out, ref):
    v_new, q_new, ll, _vd = out
    v_ref, q_ref, ll_ref = ref
    np.testing.assert_allclose(float(ll), ll_ref, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(float(q_new), q_ref, rtol=1e-5)
    for a, b in zip(v_new, v_ref):
        np.testing.assert_allclose(np.asarray(a), b, atol=1e-5)


@pytest.mark.parametrize("K", ORDERS)
def test_kmer_rows_match_encode(K):
    sset, _bg, _m, data, rows = _problem(K)
    np.testing.assert_array_equal(np.asarray(data["cidx"]), rows)


@pytest.mark.parametrize("ss", [False, True])
@pytest.mark.parametrize("K", ORDERS)
def test_window_scores(K, ss):
    sset, bg, motif, data, rows = _problem(K, ss=ss)
    sc, mask = escore.window_scores(_lut(motif, data), data["cidx"], data["lens"], motif.W)
    sc_ref, mask_ref = reference.window_scores(
        reference.log_odds_lut(motif.v, bg.conditional_flat(K)),
        rows, sset.lens, motif.W,
    )
    _assert_scores(sc, mask, sc_ref, mask_ref)


@pytest.mark.parametrize("ss", [False, True])
@pytest.mark.parametrize("K", ORDERS)
def test_mstep_counts(K, ss):
    sset, bg, motif, data, rows = _problem(K, ss=ss)
    sc_ref, mask_ref = reference.window_scores(
        reference.log_odds_lut(motif.v, bg.conditional_flat(K)),
        rows, sset.lens, motif.W,
    )
    r, _r0, _ll = reference.zoops_posterior(sc_ref, mask_ref, 0.6)
    R = encode.num_rows(motif.A, K)
    C = escore.mstep_counts(jnp.asarray(r, jnp.float32), data["cidx"], R, motif.W)
    np.testing.assert_allclose(
        np.asarray(C), reference.mstep_counts(r, rows, R, motif.W),
        rtol=1e-5, atol=1e-5,
    )


@pytest.mark.parametrize("ss", [False, True])
def test_zoops_posterior(ss):
    sset, bg, motif, data, rows = _problem(2, ss=ss)
    sc, mask = escore.window_scores(_lut(motif, data), data["cidx"], data["lens"], motif.W)
    r, r0, ll = escore.zoops_posterior(sc, mask, 0.6)
    sc_ref, mask_ref = reference.window_scores(
        reference.log_odds_lut(motif.v, bg.conditional_flat(2)),
        rows, sset.lens, motif.W,
    )
    r_ref, r0_ref, ll_ref = reference.zoops_posterior(sc_ref, mask_ref, 0.6)
    np.testing.assert_allclose(np.asarray(r), r_ref, atol=1e-6)
    np.testing.assert_allclose(np.asarray(r0), r0_ref, atol=1e-6)
    np.testing.assert_allclose(float(ll), ll_ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("K", ORDERS)
def test_em_step(K):
    sset, bg, motif, data, rows = _problem(K)
    _assert_step(*_step_both(motif, bg, sset, data, rows))


@pytest.mark.parametrize("M", [1, 3, 7])
def test_batched_step_matches_per_seed(M):
    K, W = 2, 8
    sset, bg, motif, data, rows = _problem(K, W=W)
    rng = np.random.default_rng(M)
    seeds = [motif] + [
        seeds_mod.motif_from_pwm(
            rng.dirichlet(np.full(4, 2.0), size=W), K=K, f_bg=motif.f_bg
        )
        for _ in range(M - 1)
    ]
    qs = rng.uniform(0.3, 0.9, M).astype(np.float32)
    step = make_batched_step(4, K, W, True)
    v_b, q_b, ll_b, _vd = step(
        tuple(jnp.stack([jnp.asarray(m.v[k], jnp.float32) for m in seeds])
              for k in range(K + 1)),
        jnp.asarray(qs), data,
        jnp.stack([jnp.asarray(m.alphas, jnp.float32) for m in seeds]),
        jnp.asarray(motif.f_bg, jnp.float32), jnp.float32(sset.n),
    )
    for i, m in enumerate(seeds):
        ref = reference.em_step(
            m.v, float(qs[i]), rows, sset.lens, bg.conditional_flat(K),
            m.alphas, m.f_bg, A=4, K=K, W=W, optimize_q=True,
        )
        _assert_step(
            (tuple(vk[i] for vk in v_b), q_b[i], ll_b[i], None), ref
        )


@pytest.mark.parametrize("K", [1, 2])
def test_methylc_em_step(K):
    sset, bg, motif, data, rows = _problem(K, ss=True, alphabet="METHYLC")
    assert motif.A == 5
    _assert_step(*_step_both(motif, bg, sset, data, rows))


def test_short_sequences_carry_no_windows():
    # rows shorter than W put all their mass on r0 and add log(1 - q)
    extra = ["ACG", "", "ACGTA"]
    sset, bg, motif, data, rows = _problem(2, W=8, n=10, extra=extra)
    out, ref = _step_both(motif, bg, sset, data, rows, optimize_q=False)
    _assert_step(out, ref)
    sc, mask = escore.window_scores(_lut(motif, data), data["cidx"], data["lens"], 8)
    _r, r0, _ll = escore.zoops_posterior(sc, mask, 0.7)
    np.testing.assert_allclose(np.asarray(r0)[-3:], 1.0, rtol=1e-6)


def test_padded_rows_match_unpadded():
    # zero-length pad rows (shard padding, CV fold masking) change nothing
    # once n_real discounts them
    sset, bg, motif, data, rows = _problem(3)
    pad = 5
    padded = {
        "cidx": jnp.pad(data["cidx"], ((0, 0), (0, pad), (0, 0)),
                        constant_values=encode.num_rows(4, 3)),
        "lens": jnp.pad(data["lens"], (0, pad)),
        "bg_flat": data["bg_flat"],
    }
    v = tuple(jnp.asarray(vk, jnp.float32) for vk in motif.v)
    v_p, q_p, ll_p, _ = em_step(
        v, jnp.float32(0.7), padded, jnp.asarray(motif.alphas, jnp.float32),
        jnp.asarray(motif.f_bg, jnp.float32), jnp.float32(sset.n),
        A=4, K=3, W=motif.W, optimize_q=True,
    )
    _assert_step((v_p, q_p, ll_p, None), _step_both(motif, bg, sset, data, rows)[1])
