"""Multi-seed refinement: one batched device program over the seed axis.

JAX equivalent of the reference driver's ``#pragma omp parallel for``
over the MotifSet (SURVEY.md 3.1): instead of threads, all seeds of equal
(W, K) refine in ONE batched XLA program inside a single jitted
while_loop, and the sequence tensors are shared.  The batched step
statically unrolls the per-seed ``em_step``, so XLA fuses the per-seed
programs freely.  On a ('data', 'seed') mesh the seed axis shards over
its own mesh axis while sequences shard over 'data' (2-D parallelism).

Seeds with differing widths are grouped by (W, K) and each group runs
batched; the host loop iterates until every member converges (finished
members keep iterating on converged state — idempotent — which keeps the
program shape static).
"""

from __future__ import annotations

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from bammmotif2_tpu.models.background import BackgroundModel
from bammmotif2_tpu.refinement.em import EMResult, em_step, prepare_data
from bammmotif2_tpu.ops import encode
from bammmotif2_tpu.utils.config import Params
from bammmotif2_tpu.utils.fasta import SequenceSet

# ll-trace slots carried in the batched convergence loop (a [HIST_CAP, M]
# f32 buffer costs ~2 KB at M=2 — negligible against the count tensors)
HIST_CAP = 256


def run_em_multi(
    motifs: list,
    bg: BackgroundModel,
    sset: SequenceSet,
    params: Params | None = None,
    mesh=None,
) -> list:
    """Batched EM over a MotifSet; refines every motif in place.

    Returns a list of EMResult aligned with ``motifs``.
    """
    params = params or Params(EM=True)
    results: list = [None] * len(motifs)

    groups: dict = {}
    for i, m in enumerate(motifs):
        # f_bg joins the key: the batched program shares one f_bg across
        # the stack (cf. evaluate_motifs)
        groups.setdefault(
            (m.W, m.K, np.asarray(m.f_bg, np.float64).tobytes()), []
        ).append(i)

    for (W, K, _fbg), idxs in groups.items():
        group = [motifs[i] for i in idxs]
        A = group[0].A
        data = prepare_data(sset, bg, K, params.ss)
        n_real = int(data["lens"].shape[0])
        n_win_1 = int(data["cidx"].shape[0]) * int(
            np.maximum(np.asarray(data["lens"]) - W + 1, 0).sum()
        )
        if mesh is not None:
            from bammmotif2_tpu.parallel import mesh as mesh_mod

            data = mesh_mod.shard_em_data(mesh, data, encode.num_rows(A, K))

        M = len(group)
        v = tuple(
            jnp.stack([jnp.asarray(m.v[k], jnp.float32) for m in group])
            for k in range(K + 1)
        )  # each [M, A^(k+1), W]
        q = jnp.full((M,), params.q, jnp.float32)
        alphas = jnp.stack([jnp.asarray(m.alphas, jnp.float32) for m in group])
        f_bg = jnp.asarray(group[0].f_bg, jnp.float32)

        m_pad = 0
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            # the seed axis shards over 'seed': pad the group to a multiple
            # by replicating the last member (idempotent; sliced off below)
            n_seed_axis = mesh.shape.get("seed", 1)
            m_pad = (-M) % n_seed_axis
            if m_pad:
                v = tuple(
                    jnp.concatenate([vk, jnp.repeat(vk[-1:], m_pad, 0)])
                    for vk in v
                )
                q = jnp.concatenate([q, jnp.repeat(q[-1:], m_pad)])
                alphas = jnp.concatenate(
                    [alphas, jnp.repeat(alphas[-1:], m_pad, 0)]
                )
            seed_sh = NamedSharding(mesh, P("seed"))
            v = jax.tree_util.tree_map(
                lambda x: mesh_mod._put(x, seed_sh), v
            )
            q = mesh_mod._put(q, seed_sh)
            alphas = mesh_mod._put(alphas, seed_sh)

        loop, hist_stride = _batched_optimize(
            A, K, W, params.optimizeQ, params.maxEMIterations
        )
        n_win = n_win_1
        t0 = time.perf_counter()
        nr = jnp.asarray(n_real, jnp.float32)
        v, q, lls, vds, its, hist = loop(
            v, q, data, alphas, f_bg, nr, jnp.float32(params.epsilon)
        )
        jax.block_until_ready(lls)
        seconds = time.perf_counter() - t0
        hist_np = np.asarray(hist)  # [n_slots, M], nan past each seed's end

        # Per-seed timing attribution: the group is ONE device program, so
        # only the group wall-clock is observable.  Each member is charged
        # its iteration share of it (seconds * its_i / sum(its)); its
        # windows_per_sec then equals the group's aggregate useful
        # throughput n_win * sum(its) / seconds — the honest per-program
        # number (do NOT sum windows_per_sec over members).  group_seconds
        # carries the raw wall-clock for aggregate math.  ll_history is
        # the device-side trace buffer: one entry per ``hist_stride``
        # iterations (stride 1 while maxEMIterations <= HIST_CAP), ending
        # with the seed's final ll.
        total_its = max(int(jnp.sum(its[: len(idxs)])), 1)
        for gi, i in enumerate(idxs):
            motifs[i].v = [np.asarray(v[k][gi], np.float64) for k in range(K + 1)]
            n_rec = -(-int(its[gi]) // hist_stride)
            results[i] = EMResult(
                iterations=int(its[gi]),
                ll=float(lls[gi]),
                q=float(q[gi]),
                v_diff=float(vds[gi]),
                converged=float(vds[gi]) < params.epsilon,
                ll_history=[float(x) for x in hist_np[:n_rec, gi]],
                seconds=seconds * int(its[gi]) / total_its,
                windows_scored=n_win * int(its[gi]),
                group_seconds=seconds,
            )
    return results


def make_batched_step(A: int, K: int, W: int, optimize_q: bool):
    """The one-batched-EM-iteration callable for a seed-stacked group.

    Shared by run_em_multi's convergence loop and the fused FDR group
    program (evaluation.fdr.evaluate_motifs): (v, q, data, alphas, f_bg,
    n_real) -> (v_new, q_new, ll, v_diff), everything carrying a leading
    seed axis M.
    """

    def batched(v, q, data, alphas, f_bg, n_real):
        # static unrolled loop over seeds: each member is the plain
        # em_step, which XLA fuses per seed
        M = q.shape[0]
        outs = [
            em_step(
                tuple(vk[m] for vk in v), q[m], data, alphas[m], f_bg,
                n_real, A=A, K=K, W=W, optimize_q=optimize_q,
            )
            for m in range(M)
        ]
        v2 = tuple(
            jnp.stack([o[0][k] for o in outs]) for k in range(len(v))
        )
        q2 = jnp.stack([o[1] for o in outs])
        ll = jnp.stack([o[2] for o in outs])
        vd = jnp.stack([o[3] for o in outs])
        return v2, q2, ll, vd

    return batched


def batched_while_loop(batched, v0, q0, data, alphas, f_bg, n_real,
                       epsilon, max_iters: int,
                       n_hist_slots: int = 0, hist_stride: int = 1):
    """The batched EM convergence loop — ONE implementation.

    Shared by _batched_optimize (run_em_multi) and the fused FDR group
    program (evaluation.fdr), so the stop rule (per-seed freeze on
    v_diff OR |dll| under epsilon, group exit when all froze or the cap
    hits) cannot drift between the two paths the parity tests pin
    against each other.  ``n_hist_slots > 0`` additionally carries the
    ll-trace buffer (one slot per ``hist_stride`` iterations, last write
    wins).  Returns (v, q, lls, vds, its, hist [n_hist_slots, M]).
    """
    M = q0.shape[0]

    def cond(state):
        _v, _q, _lls, vds, its, _h = state
        return (jnp.max(its) < max_iters) & (jnp.max(vds) >= epsilon)

    def body(state):
        v, q, lls, vds, its, hist = state
        active = vds >= epsilon
        v2, q2, ll2, vd2 = batched(v, q, data, alphas, f_bg, n_real)
        vd_eff = jnp.minimum(vd2, jnp.abs(ll2 - lls))

        def keep(new, old):
            ax = (slice(None),) + (None,) * (new.ndim - 1)
            return jnp.where(active[ax], new, old)

        v = tuple(keep(a, b) for a, b in zip(v2, v))
        if n_hist_slots > 0:
            slot = jnp.minimum(its // hist_stride, n_hist_slots - 1)
            hist = hist.at[slot, jnp.arange(M)].set(
                jnp.where(active, ll2, hist[slot, jnp.arange(M)])
            )
        return (
            v,
            jnp.where(active, q2, q),
            jnp.where(active, ll2, lls),
            jnp.where(active, vd_eff, vds),
            its + active.astype(jnp.int32),
            hist,
        )

    state = (
        v0, q0,
        jnp.full((M,), -jnp.inf, jnp.float32),
        jnp.full((M,), jnp.inf, jnp.float32),
        jnp.zeros((M,), jnp.int32),
        jnp.full((max(n_hist_slots, 1), M), jnp.nan, jnp.float32),
    )
    return jax.lax.while_loop(cond, body, state)


@functools.lru_cache(maxsize=64)
def _batched_optimize(A: int, K: int, W: int, optimize_q: bool,
                      max_iters: int):
    """Batched on-device EM convergence loop over the seed axis.

    lru_cached by its (hashable) static configuration: the jitted loop
    closure must be REUSED across calls or every run_em_multi invocation
    traces and compiles the whole while_loop program again.

    One jitted while_loop for the whole group: every live seed steps in the
    same batched program; a seed whose v_diff OR
    |dll| drops under epsilon freezes (jnp.where mask) so its final state
    and iteration count are its own.  The loop exits when all seeds froze
    or the cap is hit — only then does anything return to host.
    """

    batched = make_batched_step(A, K, W, optimize_q)

    # convergence-trace buffer: lls at every ``stride``-th iteration land
    # in a fixed [HIST_CAP, M] carry slot (slot = it // stride, last write
    # wins), so --jsonl keeps a real per-seed ll history in the batched
    # production path without any per-iteration host syncs
    stride = max(1, -(-max_iters // HIST_CAP))
    n_slots = -(-max_iters // stride)

    @jax.jit
    def loop(v, q, data, alphas, f_bg, n_real, epsilon):
        return batched_while_loop(
            batched, v, q, data, alphas, f_bg, n_real, epsilon,
            max_iters, n_hist_slots=n_slots, hist_stride=stride,
        )

    return loop, stride
