"""Collapsed Gibbs sampling refinement with pseudo-count (alpha) learning.

JAX equivalent of ``src/refinement/GibbsSampling.{h,cpp}``
(``GibbsSampling::optimize``, ``CollapsedGibbsSampling``, ``updateAlphas``).

Deviation (documented, SURVEY.md 3.4): the reference resamples z_n
sequence-by-sequence with leave-one-out counts (inherently sequential); we
use the batch-synchronous variant — sample ALL z_n from the current model,
then rebuild counts once.  Equivalent in expectation for the N >= 1000
sequence sets this tool targets, and it maps the whole sweep onto one XLA
program.  Bit-compat tests therefore gate on the deterministic EM path.

Per iteration:
  1. z-sampling: z_n ~ Categorical({absent} + all windows), posterior
     proportional to the same ZOOPS weights as the EM E-step.  Each
     sequence samples with its own counter-derived key
     (``fold_in(key, n)``), which makes the draw independent of padding
     and sharding: a mesh-sharded run reproduces the single-device run
     given the same key.
  2. count rebuild: one-hot scatter of sampled positions (reuses
     ops.escore.mstep_counts with a 0/1 responsibility tensor).
  3. q-sampling: q ~ Beta(#occupied + 1, #real - #occupied + 1)
     (--noQSampling off; zero-length mask/pad rows are excluded).
  4. alpha update: one gradient-ascent step on the collapsed log posterior
     w.r.t. log alpha_k(j).  The marginal likelihood of the counts given
     alpha is Dirichlet-multinomial with prior mean = the lower-order
     conditionals (total concentration per context = alpha, since lower
     orders normalize); jax.grad supplies the digamma gradients the
     reference hand-codes.  Prior: alpha ~ InvGamma(1, scale = the
     motif's ENTRY alphas) — for fresh seeds those are the paper
     defaults (alpha_0=1, alpha_k=beta*gamma^(k-1)); re-running CGS on
     an already-refined motif re-centers the prior on its learned
     alphas, a deliberate resume semantic.  (The exact reference prior
     could not be verified against the empty mount.)

Burn-in (extension, --cgsBurnIn N): with N > 0 the first N
sweeps are discarded and the final model is the Rao-Blackwellized
posterior mean — v estimated from counts AVERAGED over the post-burn-in
sweeps — instead of the last sweep's state.  Default 0 keeps the
reference's final-sweep behavior.

Multi-chip: pass a mesh — sequences shard over the 'data' axis and the
sweep partitions through GSPMD (mirroring refinement.em).
run_gibbs_multi batches all seeds of a (W, K) group into ONE device
program (the reference's OpenMP-over-motifs, cf. refinement.multi).
"""

from __future__ import annotations

import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from bammmotif2_tpu.models import motif as motif_mod
from bammmotif2_tpu.models.background import BackgroundModel
from bammmotif2_tpu.models.motif import Motif
from bammmotif2_tpu.ops import encode, escore
from bammmotif2_tpu.refinement.em import _aot_compile, prepare_data
from bammmotif2_tpu.utils.config import Params
from bammmotif2_tpu.utils.fasta import SequenceSet


@dataclasses.dataclass
class GibbsResult:
    iterations: int
    ll: float
    q: float
    seconds: float       # warm execution time (compile/trace time excluded);
                         # in batched group runs: this seed's equal share of
                         # the group wall clock (see run_gibbs_multi)
    ll_history: list
    alphas: np.ndarray
    compile_seconds: float = 0.0  # trace+compile time (0 when cache-hot)
    group_seconds: float = 0.0    # raw wall-clock of the batched group
                                  # program this seed ran in (0 = solo run)


def _log_alpha_posterior(log_alphas, counts, f_bg, default_alphas):
    """Collapsed log posterior of log(alpha) given hard counts.

    counts: tuple of per-order count tensors [A^(k+1), W].
    Returns a scalar; differentiable w.r.t. log_alphas [K+1, W].
    """
    K = len(counts) - 1
    A = f_bg.shape[0]
    total = 0.0
    # lower-order prior means (recomputed from counts with current alphas
    # would be circular; use the fixed-point v estimated from these counts)
    v = motif_mod.update_v(counts, jnp.exp(log_alphas), f_bg)
    for k in range(K + 1):
        alpha = jnp.exp(log_alphas[k])[None, :]  # [1, W]
        nk = counts[k]
        W = nk.shape[1]
        if k == 0:
            lower = jnp.tile(f_bg[:, None], (1, W))
        else:
            lower = v[k - 1][jnp.arange(nk.shape[0]) % (A ** k)]
        am = alpha * lower  # prior pseudo-counts per (y, j)
        # sum over kmers y: log Gamma(n + a v') - log Gamma(a v')
        total = total + jnp.sum(jax.lax.lgamma(nk + am) - jax.lax.lgamma(am))
        # sum over contexts x: log Gamma(alpha) - log Gamma(n_x + alpha)
        ctx = nk.reshape(-1, A, W).sum(axis=1)  # [A^k, W]
        total = total + jnp.sum(
            jax.lax.lgamma(alpha) - jax.lax.lgamma(ctx + jnp.broadcast_to(alpha, ctx.shape))
        )
        # InvGamma(1, scale) prior on alpha, plus log-alpha Jacobian:
        # log p(alpha) = log(scale) - 2 log alpha - scale / alpha ; + log alpha
        scale = default_alphas[k][None, :]
        a = jnp.exp(log_alphas[k])[None, :]
        total = total + jnp.sum(-2.0 * jnp.log(a) - scale / a + jnp.log(a))
    return total


@functools.partial(
    jax.jit,
    static_argnames=("A", "K", "W", "sample_z", "sample_q", "learn_alpha"),
)
def gibbs_step(
    v: tuple,
    q,
    log_alphas,
    key,
    data: dict,
    f_bg,
    default_alphas,
    n_real,
    *,
    A: int,
    K: int,
    W: int,
    sample_z: bool,
    sample_q: bool,
    learn_alpha: bool,
    alpha_lr: float = 0.05,
):
    """One batch-synchronous CGS sweep.

    Returns (v, q, log_alphas, key, ll, n_occ, counts); ``counts`` is the
    per-order tuple of this sweep's hard counts (consumed by the burn-in
    averaging in gibbs_optimize).
    """
    cidx, lens, bg_flat = data["cidx"], data["lens"], data["bg_flat"]
    R = encode.num_rows(A, K)
    s_flat = motif_mod.log_odds_lut(v, bg_flat)
    scores, mask = escore.window_scores(s_flat, cidx, lens, W)
    S, N, n_win = scores.shape

    n_win_per_seq = S * mask.sum(axis=1)
    has_win = n_win_per_seq > 0
    log_prior = jnp.where(
        has_win, jnp.log(q) - jnp.log(jnp.maximum(n_win_per_seq, 1)), escore.NEG_INF
    )
    log_w = scores + log_prior[None, :, None]  # [S, N, n_win]
    flat = jnp.concatenate(
        [jnp.full((N, 1), jnp.log1p(-q)), jnp.moveaxis(log_w, 1, 0).reshape(N, -1)],
        axis=1,
    )  # [N, 1 + S*n_win]

    key, sub = jax.random.split(key)
    if sample_z:
        # per-sequence counter-derived keys: the draw for sequence n
        # depends only on (sub, n), never on N — identical across shard
        # layouts and row padding
        row_keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
            sub, jnp.arange(N)
        )
        z = jax.vmap(jax.random.categorical)(row_keys, flat)  # [N]
    else:
        z = jnp.argmax(flat, axis=-1)
    occupied = z > 0
    zi = z - 1  # flattened (s, i)
    # hard responsibilities: a one-hot of the sampled window per sequence
    cols = jnp.arange(S * n_win, dtype=zi.dtype)[None, :]
    r = ((cols == zi[:, None]) & occupied[:, None]).astype(jnp.float32)
    r = jnp.moveaxis(r.reshape(N, S, n_win), 1, 0)  # [S, N, n_win]
    C = escore.mstep_counts(r, cidx, R, W)
    counts = motif_mod.counts_from_combined(C[:R], A, K)

    n_occ = occupied.sum()
    key, sub_q = jax.random.split(key)
    if sample_q:
        # q ~ Beta(#occupied + 1, #real - #occupied + 1); n_real excludes
        # zero-length mask/pad rows (CV fold masking, shard padding), which
        # can never be occupied and must not bias the Beta posterior
        q_new = jax.random.beta(sub_q, n_occ + 1.0, n_real - n_occ + 1.0)
        q_new = jnp.clip(q_new, 1e-4, 1 - 1e-4)
    else:
        q_new = q

    if learn_alpha:
        grad = jax.grad(_log_alpha_posterior)(log_alphas, counts, f_bg, default_alphas)
        log_alphas = log_alphas + alpha_lr * jnp.clip(grad, -10.0, 10.0)
        log_alphas = jnp.clip(log_alphas, jnp.log(1e-2), jnp.log(1e4))

    v_new = motif_mod.update_v(counts, jnp.exp(log_alphas), f_bg)

    # ZOOPS marginal ll for monitoring (same statistic as EM); zero-length
    # mask/pad rows each contribute exactly log(1-q) — removed here so
    # sharded/masked runs report the same ll as compact ones
    _, _, ll = escore.zoops_posterior(scores, mask, q)
    ll = ll - (N - n_real) * jnp.log1p(-q)
    return v_new, q_new, log_alphas, key, ll, n_occ, counts


@functools.partial(
    jax.jit,
    static_argnames=("A", "K", "W", "sample_z", "sample_q", "learn_alpha"),
)
def gibbs_step_multi(
    v: tuple,
    q,
    log_alphas,
    keys,
    data: dict,
    f_bg,
    default_alphas,
    n_real,
    *,
    A: int,
    K: int,
    W: int,
    sample_z: bool,
    sample_q: bool,
    learn_alpha: bool,
    alpha_lr: float = 0.05,
):
    """One batch-synchronous CGS sweep for M seeds at once.

    Seed-stacked analogue of gibbs_step: scoring, sampling, counting and
    the model math vmap over the seed axis.  Key handling per seed is
    IDENTICAL to gibbs_step's (split → fold_in(n) → categorical →
    split → beta), so member m of a batched run reproduces
    run_gibbs(..., key=keys[m]) exactly.

    Args mirror gibbs_step with a leading seed axis on v/q/log_alphas/
    keys/default_alphas.  Returns (v, q, log_alphas, keys, ll [M],
    n_occ [M], counts tuple of [M, A^(k+1), W]).
    """
    cidx, lens, bg_flat = data["cidx"], data["lens"], data["bg_flat"]
    R = encode.num_rows(A, K)
    s_flat = jax.vmap(lambda vm: motif_mod.log_odds_lut(vm, bg_flat))(v)

    # ---- stage 1: window scores, all seeds ------------------------------
    scores, mask = jax.vmap(
        lambda sf: escore.window_scores(sf, cidx, lens, W)
    )(s_flat)
    mask = mask[0]
    _Mm, S, N, n_win = scores.shape

    # ---- stage 2: per-seed z/q sampling (vmapped pure XLA) -------------
    n_win_per_seq = S * mask.sum(axis=1)
    has_win = n_win_per_seq > 0

    def sample_one(scores_m, q_m, key_m):
        log_prior = jnp.where(
            has_win,
            jnp.log(q_m) - jnp.log(jnp.maximum(n_win_per_seq, 1)),
            escore.NEG_INF,
        )
        log_w = scores_m + log_prior[None, :, None]
        flat = jnp.concatenate(
            [jnp.full((N, 1), jnp.log1p(-q_m)),
             jnp.moveaxis(log_w, 1, 0).reshape(N, -1)],
            axis=1,
        )
        key_m, sub = jax.random.split(key_m)
        if sample_z:
            row_keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
                sub, jnp.arange(N)
            )
            z = jax.vmap(jax.random.categorical)(row_keys, flat)
        else:
            z = jnp.argmax(flat, axis=-1)
        occupied = z > 0
        zi = z - 1
        cols = jnp.arange(S * n_win, dtype=zi.dtype)[None, :]
        r = ((cols == zi[:, None]) & occupied[:, None]).astype(jnp.float32)
        r = jnp.moveaxis(r.reshape(N, S, n_win), 1, 0)
        n_occ = occupied.sum()
        key_m, sub_q = jax.random.split(key_m)
        if sample_q:
            q_new = jax.random.beta(sub_q, n_occ + 1.0, n_real - n_occ + 1.0)
            q_new = jnp.clip(q_new, 1e-4, 1 - 1e-4)
        else:
            q_new = q_m
        _, _, ll = escore.zoops_posterior(scores_m, mask, q_m)
        ll = ll - (N - n_real) * jnp.log1p(-q_m)
        return r, n_occ, q_new, key_m, ll

    r, n_occ, q_new, keys, ll = jax.vmap(sample_one)(scores, q, keys)

    # ---- stage 3: counts, all seeds -------------------------------------
    C = jax.vmap(lambda rm: escore.mstep_counts(rm, cidx, R, W))(r)
    counts = jax.vmap(
        lambda Cm: motif_mod.counts_from_combined(Cm[:R], A, K)
    )(C)

    # ---- stage 4: per-seed alpha/v updates (vmapped) -------------------
    def update_one(counts_m, la_m, da_m):
        if learn_alpha:
            grad = jax.grad(_log_alpha_posterior)(la_m, counts_m, f_bg, da_m)
            la_m = la_m + alpha_lr * jnp.clip(grad, -10.0, 10.0)
            la_m = jnp.clip(la_m, jnp.log(1e-2), jnp.log(1e4))
        v_m = motif_mod.update_v(counts_m, jnp.exp(la_m), f_bg)
        return la_m, v_m

    log_alphas, v_new = jax.vmap(update_one)(counts, log_alphas, default_alphas)
    return v_new, q_new, log_alphas, keys, ll, n_occ, counts


@functools.partial(
    jax.jit,
    static_argnames=(
        "A", "K", "W", "sample_z", "sample_q", "learn_alpha", "n_iters",
        "burn_in",
    ),
)
def gibbs_optimize(
    v: tuple,
    q,
    log_alphas,
    key,
    data: dict,
    f_bg,
    default_alphas,
    n_real,
    *,
    A: int,
    K: int,
    W: int,
    sample_z: bool,
    sample_q: bool,
    learn_alpha: bool,
    n_iters: int,
    burn_in: int = 0,
):
    """Whole CGS run as one device program (lax.scan over sweeps).

    Returns (v, q, log_alphas, ll_history [n_iters], n_occ_history,
    avg_counts) where avg_counts averages the post-burn-in sweeps' hard
    counts (meaningful when burn_in > 0; see module docstring).
    """

    def body(carry, i):
        v, q, la, key, acc = carry
        v, q, la, key, ll, n_occ, counts = gibbs_step(
            v, q, la, key, data, f_bg, default_alphas, n_real,
            A=A, K=K, W=W, sample_z=sample_z, sample_q=sample_q,
            learn_alpha=learn_alpha,
        )
        take = (i >= burn_in).astype(jnp.float32)
        acc = tuple(a + take * c for a, c in zip(acc, counts))
        return (v, q, la, key, acc), (ll, n_occ)

    acc0 = tuple(
        jnp.zeros((A ** (k + 1), W), jnp.float32) for k in range(K + 1)
    )
    (v, q, log_alphas, key, acc), (lls, n_occs) = jax.lax.scan(
        body, (v, q, log_alphas, key, acc0), jnp.arange(n_iters)
    )
    n_avg = max(n_iters - burn_in, 1)
    acc = tuple(a / n_avg for a in acc)
    return v, q, log_alphas, lls, n_occs, acc


def run_gibbs(
    motif: Motif,
    bg: BackgroundModel,
    sset: SequenceSet,
    params: Params | None = None,
    data=None,
    n_real: int | None = None,
    mesh=None,
    key=None,
) -> GibbsResult:
    """Refine ``motif`` in place by CGS (``GibbsSampling::optimize``).

    ``n_real``: number of REAL sequences when ``data`` rows are masked out
    with length 0 (CV fold masking, cf. run_em).

    ``mesh``: shard sequences over the 'data' axis (multi-chip/multi-host);
    the per-sequence counter-derived sampling keys make the sharded run
    reproduce the single-device run given the same ``key``.

    ``key``: explicit PRNG key (defaults to PRNGKey(params.seed)).
    """
    params = params or Params(CGS=True)
    A, K, W = motif.A, motif.K, motif.W
    if data is None:
        data = prepare_data(sset, bg, K, params.ss)
    if n_real is None:
        n_real = int(data["lens"].shape[0])

    if mesh is not None:
        from bammmotif2_tpu.parallel import mesh as mesh_mod

        data = mesh_mod.shard_em_data(mesh, data, encode.num_rows(A, K))

    v = tuple(jnp.asarray(vk, jnp.float32) for vk in motif.v)
    q = jnp.asarray(params.q, jnp.float32)
    log_alphas = jnp.log(jnp.asarray(motif.alphas, jnp.float32))
    default_alphas = jnp.asarray(motif.alphas, jnp.float32)
    f_bg = jnp.asarray(motif.f_bg, jnp.float32)
    if key is None:
        key = jax.random.PRNGKey(params.seed)
    if mesh is not None:
        from bammmotif2_tpu.parallel import mesh as mesh_mod

        v, q, log_alphas, default_alphas, f_bg, key = mesh_mod.replicate(
            mesh, (v, q, log_alphas, default_alphas, f_bg, key)
        )

    n_iters = params.maxCGSIterations
    burn_in = min(getattr(params, "cgsBurnIn", 0), max(n_iters - 1, 0))
    args = (
        v, q, log_alphas, key, data, f_bg, default_alphas,
        jnp.asarray(n_real, jnp.float32),
    )
    statics = dict(
        A=A, K=K, W=W,
        sample_z=not params.noZSampling,
        sample_q=not params.noQSampling,
        learn_alpha=not params.noAlphaOptimization,
        n_iters=n_iters, burn_in=burn_in,
    )
    compiled, compile_seconds = _aot_compile(gibbs_optimize, args, statics)
    t0 = time.perf_counter()
    v, q, log_alphas, lls, _n_occs, acc = compiled(*args)
    jax.block_until_ready((v, q, log_alphas, lls))
    seconds = time.perf_counter() - t0
    ll_hist = [float(x) for x in np.asarray(lls)]

    if burn_in > 0:
        # Rao-Blackwellized posterior mean over the kept sweeps
        v = motif_mod.update_v(acc, jnp.exp(log_alphas), f_bg)
    motif.v = [np.asarray(vk, np.float64) for vk in v]
    motif.alphas = np.asarray(jnp.exp(log_alphas), np.float64)
    return GibbsResult(
        iterations=len(ll_hist),
        ll=ll_hist[-1] if ll_hist else float("nan"),
        q=float(q),
        seconds=seconds,
        ll_history=ll_hist,
        alphas=np.asarray(jnp.exp(log_alphas)),
        compile_seconds=compile_seconds,
    )


@functools.lru_cache(maxsize=64)
def _batched_gibbs_loop(
    A: int, K: int, W: int, M: int, sample_z: bool, sample_q: bool,
    learn_alpha: bool, n_iters: int, burn_in: int,
):
    """Batched CGS over the seed axis: all M seeds of a (W, K) group sweep
    inside ONE lax.scan program via gibbs_step_multi, which vmaps every
    stage over seeds.  Compiles once per (W, K, M) group.

    lru_cached by static configuration so repeat calls reuse the compiled
    closure.  Sequences may shard over a mesh 'data' axis; the seed axis
    stays replicated (CGS state is tiny, z-sampling is the data-parallel
    cost).
    """

    @jax.jit
    def loop(v, q, la, keys, data, f_bg, da, n_real):
        acc0 = tuple(
            jnp.zeros((M, A ** (k + 1), W), jnp.float32) for k in range(K + 1)
        )

        def body(carry, i):
            v, q, la, keys, acc = carry
            v2, q2, la2, keys2, lls, noccs, counts = gibbs_step_multi(
                v, q, la, keys, data, f_bg, da, n_real,
                A=A, K=K, W=W, sample_z=sample_z, sample_q=sample_q,
                learn_alpha=learn_alpha,
            )
            take = (i >= burn_in).astype(jnp.float32)
            acc = tuple(a + take * c for a, c in zip(acc, counts))
            return (v2, q2, la2, keys2, acc), (lls, noccs)

        (v, q, la, keys, acc), (lls, noccs) = jax.lax.scan(
            body, (v, q, la, keys, acc0), jnp.arange(n_iters)
        )
        n_avg = max(n_iters - burn_in, 1)
        acc = tuple(a / n_avg for a in acc)
        return v, q, la, lls, noccs, acc

    return loop


def run_gibbs_multi(
    motifs: list,
    bg: BackgroundModel,
    sset: SequenceSet,
    params: Params | None = None,
    mesh=None,
) -> list:
    """Batched CGS over a MotifSet; refines every motif in place.

    The batched analogue of the reference driver's OpenMP-over-motifs for
    --CGS: seeds of equal (W, K) sweep in one program sharing the
    sequence tensors.  The motif at INPUT position i samples with key
    fold_in(PRNGKey(params.seed), i) — global, not group-local, indices,
    so chains stay independent across (W, K) groups — and
    ``run_gibbs(motifs[i], ..., key=fold_in(base, i))`` reproduces it
    exactly.  Returns a list of GibbsResult aligned with ``motifs``.
    """
    params = params or Params(CGS=True)
    results: list = [None] * len(motifs)

    groups: dict = {}
    for i, m in enumerate(motifs):
        # f_bg joins the key: the stacked program shares one f_bg across
        # the group (cf. run_em_multi/evaluate_motifs)
        groups.setdefault(
            (m.W, m.K, np.asarray(m.f_bg, np.float64).tobytes()), []
        ).append(i)

    base_key = jax.random.PRNGKey(params.seed)
    for (W, K, _fbg), idxs in groups.items():
        group = [motifs[i] for i in idxs]
        A = group[0].A
        M = len(group)
        if M == 1:
            # single-member group: the plain path needs none of the
            # seed-stacked vmaps, and with the same global-index key it
            # reproduces the stacked member exactly
            results[idxs[0]] = run_gibbs(
                group[0], bg, sset, params, mesh=mesh,
                key=jax.random.fold_in(base_key, idxs[0]),
            )
            continue
        data = prepare_data(sset, bg, K, params.ss)
        n_real = int(data["lens"].shape[0])
        if mesh is not None:
            from bammmotif2_tpu.parallel import mesh as mesh_mod

            data = mesh_mod.shard_em_data(mesh, data, encode.num_rows(A, K))

        v = tuple(
            jnp.stack([jnp.asarray(m.v[k], jnp.float32) for m in group])
            for k in range(K + 1)
        )
        q = jnp.full((M,), params.q, jnp.float32)
        la = jnp.log(jnp.stack([jnp.asarray(m.alphas, jnp.float32) for m in group]))
        da = jnp.stack([jnp.asarray(m.alphas, jnp.float32) for m in group])
        f_bg = jnp.asarray(group[0].f_bg, jnp.float32)
        # keys fold in the GLOBAL motif index: group-local indices would
        # give the m-th member of every (W, K) group an identical PRNG
        # stream, perfectly correlating supposedly independent chains
        keys = jnp.stack([jax.random.fold_in(base_key, i) for i in idxs])
        if mesh is not None:
            from bammmotif2_tpu.parallel import mesh as mesh_mod

            v, q, la, da, f_bg, keys = mesh_mod.replicate(
                mesh, (v, q, la, da, f_bg, keys)
            )

        n_iters = params.maxCGSIterations
        burn_in = min(getattr(params, "cgsBurnIn", 0), max(n_iters - 1, 0))
        loop = _batched_gibbs_loop(
            A, K, W, M,
            not params.noZSampling, not params.noQSampling,
            not params.noAlphaOptimization, n_iters, burn_in,
        )
        args = (v, q, la, keys, data, f_bg, da,
                jnp.asarray(n_real, jnp.float32))
        # AOT split so GibbsResult.seconds honors its warm-time contract
        # (the first call of the lru-cached jitted loop otherwise folds
        # several seconds of trace+compile into the timing)
        compiled, compile_seconds = _aot_compile(loop, args, {})
        t0 = time.perf_counter()
        v, q, la, lls, _noccs, acc = compiled(*args)
        jax.block_until_ready((v, q, la, lls))
        seconds = time.perf_counter() - t0

        lls_h = np.asarray(lls)  # [n_iters, M]
        for gi, i in enumerate(idxs):
            if burn_in > 0:
                v_gi = motif_mod.update_v(
                    tuple(a[gi] for a in acc), jnp.exp(la[gi]), f_bg
                )
            else:
                v_gi = tuple(v[k][gi] for k in range(K + 1))
            motifs[i].v = [np.asarray(vk, np.float64) for vk in v_gi]
            motifs[i].alphas = np.asarray(jnp.exp(la[gi]), np.float64)
            results[i] = GibbsResult(
                iterations=n_iters,
                ll=float(lls_h[-1, gi]) if n_iters else float("nan"),
                q=float(q[gi]),
                # every member sweeps the same fixed n_iters, so each is
                # charged an equal share of the ONE group program's wall
                # clock (summing members then reproduces the group cost,
                # cf. EMResult.seconds); group_seconds carries the raw
                # group wall-clock for aggregate math
                seconds=seconds / M,
                ll_history=[float(x) for x in lls_h[:, gi]],
                alphas=np.asarray(jnp.exp(la[gi])),
                compile_seconds=compile_seconds,
                group_seconds=seconds,
            )
    return results
