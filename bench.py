"""Throughput of the plain data path on one GPU: EM, scan, 3-seed EM, CGS.

Times fused EM iterations (order 2, W = 12, both strands) on a synthetic
10k x 200 bp planted-motif set — the BASELINE.json metric, windows scored
per second and EM iterations per second — plus window scoring alone, one
batched 3-seed EM step and collapsed-Gibbs sweeps (1 and 3 seeds).  Every
timed loop runs N_TIMED_ITERS steps inside one jitted ``fori_loop`` that
ends in ``block_until_ready``; compilation happens before the window.  The
loop is timed REPEATS times and the median is reported beside the spread.

Fails unless JAX's platform is ``gpu``.  Prints the device lines, then ONE
JSON line with the results and the device they were measured on.
"""

from __future__ import annotations

import functools
import json
import time

import numpy as np

import jax
import jax.numpy as jnp

from bammmotif2_tpu.models import seeds as seeds_mod
from bammmotif2_tpu.models.background import BackgroundModel
from bammmotif2_tpu.models.motif import log_odds_lut
from bammmotif2_tpu.ops import escore
from bammmotif2_tpu.refinement.em import em_step, prepare_data
from bammmotif2_tpu.refinement.gibbs import gibbs_step, gibbs_step_multi
from bammmotif2_tpu.refinement.multi import make_batched_step
from bammmotif2_tpu.utils.alphabet import Alphabet
from bammmotif2_tpu.utils.fasta import SequenceSet

N_SEQS = 10_000
SEQ_LEN = 200
W = 12
K = 2
N_TIMED_ITERS = 30
REPEATS = 5


def build_problem():
    rng = np.random.default_rng(0)
    alphabet = Alphabet.from_type("STANDARD")
    codes = rng.integers(0, 4, (N_SEQS, SEQ_LEN)).astype(np.int8)
    motif_codes = rng.integers(0, 4, W)
    pos = rng.integers(0, SEQ_LEN - W, N_SEQS)
    has = rng.random(N_SEQS) < 0.8
    for n in range(N_SEQS):
        if has[n]:
            codes[n, pos[n] : pos[n] + W] = motif_codes
    lens = np.full(N_SEQS, SEQ_LEN, np.int32)
    sset = SequenceSet(
        codes=codes, lens=lens, headers=[f"s{i}" for i in range(N_SEQS)],
        alphabet=alphabet,
    )
    bg = BackgroundModel.from_sequence_set(sset, order=2, alpha=10.0, ss=False)
    pwm = np.full((W, 4), 0.1, np.float64)
    pwm[np.arange(W), motif_codes] = 0.7
    motif = seeds_mod.motif_from_pwm(pwm, K=K, f_bg=sset.base_frequencies())
    data = prepare_data(sset, bg, K, ss=False)
    v = tuple(jnp.asarray(vk, jnp.float32) for vk in motif.v)
    alphas = jnp.asarray(motif.alphas, jnp.float32)
    f_bg = jnp.asarray(motif.f_bg, jnp.float32)
    q = jnp.asarray(0.9, jnp.float32)
    n_windows_per_iter = 2 * int(np.maximum(lens - W + 1, 0).sum())
    return v, q, data, alphas, f_bg, n_windows_per_iter


def _seconds(loop, *args) -> dict:
    """Compile + warm once, then REPEATS timed runs of the whole loop."""
    jax.block_until_ready(loop(*args))
    runs = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        jax.block_until_ready(loop(*args))
        runs.append(time.perf_counter() - t0)
    return {"median": float(np.median(runs)), "min": min(runs), "max": max(runs)}


def _rate(units: float, secs: dict) -> dict:
    """units per second at the median, with the spread of the runs."""
    return {"median": units / secs["median"], "min": units / secs["max"],
            "max": units / secs["min"]}


def _stack(tree, M):
    return jax.tree_util.tree_map(lambda x: jnp.stack([x] * M), tree)


def time_em(problem) -> dict:
    v, q, data, alphas, f_bg, _n = problem
    nr = jnp.float32(N_SEQS)

    @jax.jit
    def loop(v, q):
        def body(_, carry):
            v1, q1, _ll, _vd = em_step(
                *carry, data, alphas, f_bg, nr, A=4, K=K, W=W, optimize_q=True
            )
            return v1, q1

        return jax.lax.fori_loop(0, N_TIMED_ITERS, body, (v, q))

    return _seconds(loop, v, q)


def time_em_multi(problem, M: int = 3) -> dict:
    v1, _q, data, alphas1, f_bg, _n = problem
    nr = jnp.float32(N_SEQS)
    step = make_batched_step(4, K, W, True)
    alphas = _stack(alphas1, M)

    @jax.jit
    def loop(v, q):
        def body(_, carry):
            vv, qq, _ll, _vd = step(*carry, data, alphas, f_bg, nr)
            return vv, qq

        return jax.lax.fori_loop(0, N_TIMED_ITERS, body, (v, q))

    return _seconds(loop, _stack(v1, M), jnp.full((M,), 0.9, jnp.float32))


def time_scan(problem) -> dict:
    v, _q, data, _a, _f, _n = problem
    s_flat = log_odds_lut(v, data["bg_flat"])

    @jax.jit
    def loop(s):
        def body(_, s):
            sc, _m = escore.window_scores(s, data["cidx"], data["lens"], W)
            # a dependence on every score, so no window is left uncomputed
            return s + 0.0 * jnp.max(sc)

        return jax.lax.fori_loop(0, N_TIMED_ITERS, body, s)

    return _seconds(loop, s_flat)


def time_cgs(problem, M: int = 1) -> dict:
    v1, _q, data, alphas1, f_bg, _n = problem
    nr = jnp.float32(N_SEQS)
    statics = dict(A=4, K=K, W=W, sample_z=True, sample_q=True, learn_alpha=True)
    if M == 1:
        step = functools.partial(gibbs_step, **statics)
        state = (v1, jnp.float32(0.9), jnp.log(alphas1), jax.random.PRNGKey(0))
        da = alphas1
    else:
        step = functools.partial(gibbs_step_multi, **statics)
        keys = jnp.stack(
            [jax.random.fold_in(jax.random.PRNGKey(0), m) for m in range(M)]
        )
        state = (_stack(v1, M), jnp.full((M,), 0.9, jnp.float32),
                 jnp.log(_stack(alphas1, M)), keys)
        da = _stack(alphas1, M)

    @jax.jit
    def loop(state):
        def body(_, carry):
            v, q, la, key = carry
            return step(v, q, la, key, data, f_bg, da, nr)[:4]

        return jax.lax.fori_loop(0, N_TIMED_ITERS, body, state)

    return _seconds(loop, state)


def main():
    from chip_smoke import phase_device

    device = phase_device()
    problem = build_problem()
    n_win = problem[-1] * N_TIMED_ITERS
    em = time_em(problem)
    out = {
        "metric": "EM sequence-windows scored/sec (order-2, 10k x 200bp, "
                  "W=12, both strands)",
        "unit": "windows/sec",
        "em_windows_per_sec": _rate(n_win, em),
        "em_iters_per_sec": _rate(N_TIMED_ITERS, em),
        "scan_windows_per_sec": _rate(n_win, time_scan(problem)),
        "multi3_agg_windows_per_sec": _rate(3 * n_win, time_em_multi(problem, 3)),
        "cgs_windows_per_sec": _rate(n_win, time_cgs(problem, 1)),
        "cgs3_agg_windows_per_sec": _rate(3 * n_win, time_cgs(problem, 3)),
        "timed_iters": N_TIMED_ITERS,
        "repeats": REPEATS,
        "device": device,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
