"""ZOOPS EM refinement — the hot loop.

JAX equivalent of ``src/refinement/EM.{h,cpp}`` (``EM::optimize``,
``EStep``, ``MStep``, ``optimizeQ``).  One EM iteration is ONE jitted XLA
program over device-resident tensors, built from the gather/segment-sum
ops of ``ops.escore`` (any order, any alphabet):

    E: rebuild the [R+1, W] log-odds LUT (cheap), window scores, log-space
       ZOOPS posterior
    M: fractional combined count rows, marginalize to per-order counts,
       apply the interpolated pseudo-count estimator
       (models.motif.update_v), optionally update q

Only two scalars (log-likelihood, |delta v|) return to the host per
iteration; convergence is |delta v| < epsilon with a --maxEMIterations cap,
as in the reference.  Multi-chip: pass a mesh — sequences shard over the
'data' axis and GSPMD inserts the one count all-reduce per iteration.
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
from bammmotif2_tpu.utils.config import Params
from bammmotif2_tpu.utils.fasta import SequenceSet


@dataclasses.dataclass
class EMResult:
    iterations: int
    ll: float
    q: float
    v_diff: float
    converged: bool
    ll_history: list
    seconds: float       # warm execution time (compile/trace time excluded);
                         # in batched group runs: this seed's iteration share
                         # of the group wall-clock (see run_em_multi)
    windows_scored: int  # total windows scored across all iterations
    compile_seconds: float = 0.0  # trace+compile time (0 when cache-hot)
    group_seconds: float = 0.0    # raw wall-clock of the batched group
                                  # program this seed ran in (0 = solo run)

    @property
    def windows_per_sec(self) -> float:
        """Warm throughput — same methodology as bench.py (compile excluded)."""
        return self.windows_scored / self.seconds if self.seconds > 0 else 0.0


_AOT_CACHE: dict = {}


def _aot_compile(fn, args: tuple, statics: dict):
    """Ahead-of-time compile a jitted ``fn`` for ``args``, memoized.

    Separates trace+compile time from execution time so EMResult.seconds /
    windows_per_sec report WARM throughput (same methodology as bench.py —
    the reference's timers never include a compiler either).  Returns
    ``(compiled, seconds)`` with seconds == 0.0 on a memo hit; call the
    compiled object with the dynamic ``args`` only.
    """
    leaves, treedef = jax.tree_util.tree_flatten(args)
    key = (
        id(fn),
        treedef,
        tuple(
            (l.shape, l.dtype.name, str(getattr(l, "sharding", None)))
            for l in leaves
        ),
        tuple(statics[k] for k in sorted(statics)),
    )
    hit = _AOT_CACHE.get(key)
    if hit is not None:
        return hit, 0.0
    t0 = time.perf_counter()
    compiled = fn.lower(*args, **statics).compile()
    _AOT_CACHE[key] = compiled
    return compiled, time.perf_counter() - t0


def prepare_data(sset: SequenceSet, bg: BackgroundModel, K: int, ss: bool) -> dict:
    """One-time device tensorization for EM/scanning.

    Returns a dict pytree:
      cidx [S, N, L] combined-LUT rows
      lens [N], bg_flat [R]

    The (cidx, lens) tensors memoize per SequenceSet instance and (K, ss):
    the CLI tensorizes the same set once per (W, K) seed group for EM and
    again for FDR, and each re-encode paid an upload plus dozens of eager
    dispatches on slow transports.  Callers never mutate the returned
    arrays (fold masking builds NEW dicts with a masked lens).
    """
    cache = sset.__dict__.setdefault("_em_data_cache", {})
    hit = cache.get((K, ss))
    if hit is None:
        while len(cache) >= 2:  # bound pinned HBM: keep the 2 newest K's
            cache.pop(next(iter(cache)))
        cidx, lens = encode.strand_indices(sset, K, ss)
        hit = cache[(K, ss)] = (cidx, lens)
    return {
        "cidx": hit[0],
        "lens": hit[1],
        "bg_flat": jnp.asarray(bg.conditional_flat(K), jnp.float32),
    }


@functools.partial(
    jax.jit, static_argnames=("A", "K", "W", "optimize_q")
)
def em_step(
    v: tuple,
    q: jnp.ndarray,
    data: dict,
    alphas: jnp.ndarray,
    f_bg: jnp.ndarray,
    n_real: jnp.ndarray | None = None,
    *,
    A: int,
    K: int,
    W: int,
    optimize_q: bool,
):
    """One fused EM iteration. Returns (v_new, q_new, ll, v_diff).

    ``n_real``: true (unpadded) sequence count; when the data was padded to
    a shardable multiple (parallel.mesh.shard_data), the zero-length pad
    sequences each contribute exactly log(1-q) to the ZOOPS likelihood and
    1 to the q denominator — both are corrected here so sharded and
    unsharded runs agree.

    Sharded data (parallel.mesh.shard_em_data) partitions through GSPMD,
    which inserts the one count all-reduce.
    """
    R = encode.num_rows(A, K)
    lens = data["lens"]
    s_flat = motif_mod.log_odds_lut(v, data["bg_flat"])
    scores, mask = escore.window_scores(s_flat, data["cidx"], lens, W)
    r, _r0, ll = escore.zoops_posterior(scores, mask, q)
    C = escore.mstep_counts(r, data["cidx"], R, W)
    counts = motif_mod.counts_from_combined(C[:R], A, K)
    v_new = motif_mod.update_v(counts, alphas, f_bg)
    if optimize_q:
        # q = (sum_n sum_i r_{n,i}) / N  (EM::optimizeQ).  Every window
        # deposits exactly one count at motif position 0 (possibly in the
        # sentinel row if that base is ambiguous), so column 0 of the full
        # combined count tensor is the total occurrence responsibility.
        total_r = C.sum(axis=0)[0]
        denom = lens.shape[0] if n_real is None else n_real
        q_new = jnp.clip(total_r / denom, 1e-4, 1.0 - 1e-4)
    else:
        q_new = q
    if n_real is not None:
        ll = ll - (lens.shape[0] - n_real) * jnp.log1p(-q)
    # parameter-change convergence statistic: L1 change over all orders
    v_diff = sum(jnp.abs(vn - vo).sum() for vn, vo in zip(v_new, v))
    return v_new, q_new, ll, v_diff


@functools.partial(
    jax.jit,
    static_argnames=("A", "K", "W", "optimize_q", "max_iters"),
)
def em_optimize(
    v: tuple,
    q: jnp.ndarray,
    data: dict,
    alphas: jnp.ndarray,
    f_bg: jnp.ndarray,
    n_real: jnp.ndarray,
    epsilon: jnp.ndarray,
    ll0: jnp.ndarray,
    *,
    A: int,
    K: int,
    W: int,
    optimize_q: bool,
    max_iters: int,
):
    """Whole EM convergence loop as ONE device program (lax.while_loop).

    Zero per-iteration host syncs: the convergence test — parameter change
    `v_diff < eps` OR likelihood change `|dll| < eps` (the reference's
    EM::optimize stop rule; the OR keeps f32 runs from hitting the
    iteration cap, since a sum-of-|dv| over ~10^3 float32 entries floors
    around 1e-2 while dll keeps shrinking) — runs on device.

    ``ll0``: log-likelihood the first iteration's dll compares against
    (-inf for a fresh run).  The chunked --checkpointEvery driver passes
    the previous chunk's final ll so the dll criterion spans chunk
    boundaries exactly as in a one-shot run.

    Returns (v, q, ll, v_diff, iterations).
    """

    def cond(state):
        v, q, ll_prev, vd, it = state
        return (it < max_iters) & (vd >= epsilon)

    def body(state):
        v, q, ll_prev, vd, it = state
        v2, q2, ll, vd2 = em_step(
            v, q, data, alphas, f_bg, n_real,
            A=A, K=K, W=W, optimize_q=optimize_q,
        )
        # fold the dll criterion into the carried v_diff: once either
        # signal is under epsilon we report a value < epsilon and stop
        dll = jnp.abs(ll - ll_prev)
        vd_eff = jnp.minimum(vd2, dll)
        return (v2, q2, ll, vd_eff, it + 1)

    state = (v, q, jnp.asarray(ll0, jnp.float32), jnp.float32(jnp.inf), jnp.int32(0))
    v, q, ll, vd, it = jax.lax.while_loop(cond, body, state)
    return v, q, ll, vd, it


def run_em(
    motif: Motif,
    bg: BackgroundModel,
    sset: SequenceSet,
    params: Params | None = None,
    data: dict | None = None,
    verbose: bool | None = None,
    mesh=None,
    checkpoint_fn=None,
    n_real: int | None = None,
) -> EMResult:
    """Refine ``motif`` in place with ZOOPS EM (``EM::optimize``).

    ``n_real``: number of REAL sequences in ``data`` when some rows are
    masked out with length 0 (CV folds mask the held-out fold this way —
    SURVEY.md 3.5 "folds are just masks"; also used for shard padding).
    Defaults to the row count of ``data``.

    With ``mesh`` (jax.sharding.Mesh with a 'data' axis): sequences shard
    over the data axis, the model replicates, and GSPMD inserts the one
    count all-reduce per iteration — the multi-chip/multi-host path.

    ``checkpoint_fn(motif=, iteration=)``: when set together with
    ``params.checkpointEvery > 0``, the convergence loop runs in device
    chunks of that many iterations and the callback fires after each chunk
    with the refreshed motif — the restartable-multi-host-run hook (the
    written model file is a valid ``--BaMMFile`` resume point).
    """
    params = params or Params(EM=True)
    verbose = params.verbose if verbose is None else verbose
    A, K, W = motif.A, motif.K, motif.W
    if data is None:
        data = prepare_data(sset, bg, K, params.ss)

    n_real = int(data["lens"].shape[0]) if n_real is None else int(n_real)
    n_win = int(data["cidx"].shape[0]) * int(
        np.maximum(np.asarray(data["lens"]) - W + 1, 0).sum()
    )
    if mesh is not None:
        from bammmotif2_tpu.parallel import mesh as mesh_mod

        data = mesh_mod.shard_em_data(mesh, data, encode.num_rows(A, K))

    v = tuple(jnp.asarray(vk, jnp.float32) for vk in motif.v)
    q = jnp.asarray(params.q, jnp.float32)
    alphas = jnp.asarray(motif.alphas, jnp.float32)
    f_bg = jnp.asarray(motif.f_bg, jnp.float32)
    if mesh is not None:
        from bammmotif2_tpu.parallel import mesh as mesh_mod

        v, q, alphas, f_bg = mesh_mod.replicate(mesh, (v, q, alphas, f_bg))

    ll_hist: list = []
    nr = jnp.asarray(n_real, jnp.float32)
    eps = jnp.float32(params.epsilon)
    statics = dict(A=A, K=K, W=W, optimize_q=params.optimizeQ)
    compile_seconds = 0.0
    seconds = 0.0

    def _sync_motif():
        motif.v = [np.asarray(vk, np.float64) for vk in v]

    ckpt_every = getattr(params, "checkpointEvery", 0) if checkpoint_fn else 0
    if not verbose and ckpt_every > 0:
        # restartable path: the device loop runs in chunks of
        # checkpointEvery iterations; the model is materialized and handed
        # to checkpoint_fn after each chunk.  The previous chunk's final ll
        # carries into the next chunk (ll0) so the |dll| stop criterion
        # spans chunk boundaries exactly as in a one-shot run.
        it, ll, v_diff = 0, float("-inf"), float("inf")
        converged = False
        ll_carry = jnp.float32(-jnp.inf)
        while it < params.maxEMIterations and not converged:
            chunk = min(ckpt_every, params.maxEMIterations - it)
            args = (v, q, data, alphas, f_bg, nr, eps, ll_carry)
            compiled, csecs = _aot_compile(
                em_optimize, args, {**statics, "max_iters": chunk}
            )
            compile_seconds += csecs
            t0 = time.perf_counter()
            v, q, ll_dev, vd_dev, it_dev = compiled(*args)
            jax.block_until_ready((v, q, ll_dev, vd_dev, it_dev))
            seconds += time.perf_counter() - t0
            it += int(it_dev)
            ll, v_diff = float(ll_dev), float(vd_dev)
            ll_carry = jnp.asarray(ll_dev, jnp.float32)
            ll_hist.append(ll)
            converged = v_diff < params.epsilon or int(it_dev) < chunk
            _sync_motif()
            checkpoint_fn(motif=motif, iteration=it)
    elif not verbose:
        # whole convergence loop in one device program: no per-iteration
        # host round-trips (the production path)
        args = (v, q, data, alphas, f_bg, nr, eps, jnp.float32(-jnp.inf))
        compiled, compile_seconds = _aot_compile(
            em_optimize, args, {**statics, "max_iters": params.maxEMIterations}
        )
        t0 = time.perf_counter()
        v, q, ll_dev, vd_dev, it_dev = compiled(*args)
        jax.block_until_ready((v, q, ll_dev, vd_dev, it_dev))
        seconds = time.perf_counter() - t0
        it = int(it_dev)
        ll, v_diff = float(ll_dev), float(vd_dev)
        ll_hist.append(ll)
        converged = v_diff < params.epsilon
    else:
        it, ll, v_diff = 0, float("-inf"), float("inf")
        converged = False
        args = (v, q, data, alphas, f_bg, nr)
        compiled, compile_seconds = _aot_compile(em_step, args, statics)
        for it in range(1, params.maxEMIterations + 1):
            ll_prev = ll
            t0 = time.perf_counter()
            v, q, ll_dev, vd_dev = compiled(v, q, data, alphas, f_bg, nr)
            jax.block_until_ready((v, q, ll_dev, vd_dev))
            seconds += time.perf_counter() - t0
            ll, v_diff = float(ll_dev), float(vd_dev)
            ll_hist.append(ll)
            print(f"  EM iter {it:4d}  ll={ll:.4f}  dv={v_diff:.3e}  q={float(q):.4f}")
            if ckpt_every > 0 and it % ckpt_every == 0:
                _sync_motif()
                checkpoint_fn(motif=motif, iteration=it)
            if v_diff < params.epsilon or abs(ll - ll_prev) < params.epsilon:
                converged = True
                break

    _sync_motif()
    return EMResult(
        iterations=it,
        ll=ll,
        q=float(q),
        v_diff=v_diff,
        converged=converged,
        ll_history=ll_hist,
        seconds=seconds,
        windows_scored=n_win * it,
        compile_seconds=compile_seconds,
    )
