"""Smoke run of the BaMM pipeline on an NVIDIA GPU, in one process.

    python chip_smoke.py               # phases device, parity, pipeline
    python chip_smoke.py --four-cards  # phases device, four_cards

Phases:

  device      JAX's devices, the card's name and power limit from
              nvidia-smi, the compile-cache directory; fails unless JAX's
              platform is ``gpu``.
  parity      At 10k x 200 bp, both strands, W = 12, orders 0/2/4/5: the
              card against JAX's CPU backend in this process (k-mer
              encoding, window scores, ZOOPS posterior, M-step counts, one
              EM step, one 3-seed batched EM step, one CGS sweep with a
              fixed key), and against the float64 numpy reference
              (``ops.reference``) on the first 256 sequences.
  pipeline    ``bammmotif2_tpu.cli.main`` on BASELINE configs 3, 4 and 5
              (order-4 EM on 10k sequences; ten seeds with EM and 5-fold
              FDR; a 100k-sequence scan with p-values), cold and warm, with
              every output file parsed and the planted motifs recovered.
  four_cards  ``cli.main`` on the 4-device mesh against ``--single-device``
              for a one-seed order-2 run and the ten-seed EM run.

Sequences are planted synthetic sets made from fixed seeds.  Any failed
check raises, so the exit code is non-zero; the last line of standard
output is then never the result.  On success the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

import jax
import jax.numpy as jnp

from bammmotif2_tpu import cli
from bammmotif2_tpu.models import motif as motif_mod
from bammmotif2_tpu.models import seeds as seeds_mod
from bammmotif2_tpu.models.background import BackgroundModel
from bammmotif2_tpu.models.motif import Motif
from bammmotif2_tpu.ops import encode, escore, reference
from bammmotif2_tpu.refinement.em import em_step, prepare_data
from bammmotif2_tpu.refinement.gibbs import gibbs_step
from bammmotif2_tpu.refinement.multi import make_batched_step
from bammmotif2_tpu.utils.alphabet import Alphabet
from bammmotif2_tpu.utils.fasta import SequenceSet, write_fasta

N_SEQS = 10_000
SEQ_LEN = 200
N_SCAN = 100_000
W = 12
ORDERS = (0, 2, 4, 5)
N_REF = 256
# planted motifs of widths 8/10/12, one per third of the rows
MOTIFS = ("TGACTCAG", "CACGTGACTT", "GGGGCGGGGCCA")
N_SEEDS = 10

# parity limits and why.  Window scores, responsibilities and the
# log-likelihood: float32 sums of at most a few hundred terms per value,
# or tree reductions over the sequences.  Counts and q: one float32
# accumulator per LUT row takes up to ~10^6 responsibilities, in an order
# that differs between backends and, on the GPU, from run to run (the
# segment_sum adds with atomics); at order 0 (4 rows) the card measured
# 4.8e-5 against float64.  Probabilities after one step inherit the
# count error; probabilities written to model files carry four
# significant digits (models.motif._FLOAT_FMT).
RTOL_SUM = 1e-5
RTOL_COUNT = 1e-4
ATOL_V_STEP = 1e-5
ATOL_MODEL_FILE = 1e-4


class Checks:
    """Prints each error beside its limit; raises at the end of a phase
    if any exceeded it."""

    def __init__(self, phase: str):
        self.phase = phase
        self.failed: list = []

    def __call__(self, name: str, err: float, limit: float) -> None:
        ok = bool(err <= limit)
        print(f"  {name:<46s} {err:10.3e}  limit {limit:.0e}  "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            self.failed.append(name)

    def done(self) -> None:
        if self.failed:
            raise AssertionError(f"{self.phase}: {', '.join(self.failed)}")


def rel_norm(a, b) -> float:
    """max |a - b| / max |b| (normwise relative error)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def max_abs(a, b) -> float:
    return max(
        float(np.max(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64))))
        for x, y in zip(a, b)
    )


# ---------------------------------------------------------------------- #
# data
# ---------------------------------------------------------------------- #


def planted_set(n: int, length: int, motifs=MOTIFS, rate: float = 0.8,
                seed: int = 0) -> tuple:
    """Uniform random sequences; motif i is planted in a ``rate`` share of
    rows i, i + len(motifs), ... Returns (SequenceSet, planted row mask)."""
    rng = np.random.default_rng(seed)
    alphabet = Alphabet.from_type("STANDARD")
    codes = rng.integers(0, 4, (n, length)).astype(np.int8)
    planted = np.zeros(n, bool)
    for i, mot in enumerate(motifs):
        enc = alphabet.encode(mot)
        rows = np.arange(i, n, len(motifs))
        rows = rows[rng.random(rows.size) < rate]
        pos = rng.integers(0, length - len(enc) + 1, rows.size)
        codes[rows[:, None], pos[:, None] + np.arange(len(enc))] = enc
        planted[rows] = True
    sset = SequenceSet(
        codes=codes, lens=np.full(n, length, np.int32),
        headers=[f"s{i}" for i in range(n)], alphabet=alphabet,
    )
    return sset, planted


def write_meme(path: str, pwms: list) -> None:
    with open(path, "w") as fh:
        fh.write("MEME version 4\n\n")
        for i, pwm in enumerate(pwms):
            fh.write(f"MOTIF seed{i + 1}\n")
            fh.write(f"letter-probability matrix: alength= 4 w= {pwm.shape[0]}"
                     " nsites= 100\n")
            for row in pwm:
                fh.write(" ".join(f"{p:.4f}" for p in row) + "\n")
            fh.write("\n")


def config4_seeds(n_seeds: int = N_SEEDS, seed: int = 0) -> list:
    """A ranked seed list as PEnG would give it: the planted motifs as
    softened IUPAC PWMs, then perturbed copies (three (W, K) groups)."""
    rng = np.random.default_rng(seed)
    pwms = []
    for s in range(n_seeds):
        pwm = seeds_mod.iupac_to_pwm(MOTIFS[s % len(MOTIFS)], soft=0.7)
        if s >= len(MOTIFS):
            pwm = pwm * rng.uniform(0.8, 1.25, pwm.shape)
        pwms.append(pwm / pwm.sum(axis=1, keepdims=True))
    return pwms


def with_context(motif: Motif, seed: int = 0) -> Motif:
    """Mix random conditionals into every order k >= 1, so that rows of one
    order that share their last base score differently (a motif lifted
    from a PWM has identical rows there)."""
    rng = np.random.default_rng(seed)
    A, W = motif.A, motif.W
    for k in range(1, motif.K + 1):
        rnd = rng.dirichlet(np.ones(A), size=(A ** k, W)).transpose(0, 2, 1)
        motif.v[k] = 0.5 * motif.v[k] + 0.5 * rnd.reshape(A ** (k + 1), W)
    return motif


def consensus(m: Motif) -> str:
    return "".join("ACGT"[i] for i in m.v[0].argmax(axis=0))


def mismatches(site: str, motif: str) -> int:
    """Hamming distance of ``site`` to ``motif`` or its reverse complement,
    whichever is closer."""
    rc = motif[::-1].translate(str.maketrans("ACGT", "TGCA"))
    return min(sum(a != b for a, b in zip(site, m)) for m in (motif, rc))


# ---------------------------------------------------------------------- #
# phases
# ---------------------------------------------------------------------- #


def phase_device() -> dict:
    devs = jax.devices()
    d = devs[0]
    print(f"jax {jax.__version__} devices: {devs}")
    print(f"platform={d.platform} device_kind={d.device_kind} count={len(devs)}")
    if d.platform != "gpu":
        raise RuntimeError(f"needs a GPU; JAX's platform is {d.platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    for line in smi.splitlines():
        print(f"card: {line}")
    print(f"compile cache: {cli.compilation_cache_dir()}", flush=True)
    return {"platform": d.platform, "kind": d.device_kind, "count": len(devs),
            "card": smi.splitlines()[0]}


def _on(tree, dev):
    return jax.device_put(tree, dev)


def _matmuls(compiled_text: str) -> int:
    return compiled_text.count(" dot(") + compiled_text.count("gemm")


def parity_order(K: int, sset: SequenceSet, bg: BackgroundModel, dev, cpu,
                 check: Checks, n_ref: int = N_REF, width: int = W) -> None:
    """Card vs CPU backend and vs the float64 reference at order K."""
    A = 4
    R = encode.num_rows(A, K)
    print(f" order K={K} (R+1 = {R + 1} LUT rows)", flush=True)
    motif = with_context(seeds_mod.motif_from_pwm(
        seeds_mod.iupac_to_pwm(MOTIFS[-1][:width].ljust(width, "N"), soft=0.7),
        K=K, f_bg=sset.base_frequencies(),
    ), seed=K)
    data_d = _on(prepare_data(sset, bg, K, False), dev)
    data_c = _on(data_d, cpu)
    cidx_host = np.stack([
        encode.combined_kmer_index_np(c, A, K)
        for c in (sset.codes, encode.revcomp_codes(
            sset.codes, sset.lens, encode.comp_table(sset.alphabet)))
    ])
    check("cidx mismatches (exact)",
          float(np.sum(np.asarray(data_d["cidx"]) != cidx_host)), 0)

    def inputs(d):
        return _on((
            tuple(jnp.asarray(vk, jnp.float32) for vk in motif.v),
            jnp.float32(0.5), jnp.asarray(motif.alphas, jnp.float32),
            jnp.asarray(motif.f_bg, jnp.float32), jnp.float32(sset.n),
        ), d)

    (v_d, q_d, a_d, f_d, n_d), (v_c, q_c, a_c, f_c, n_c) = inputs(dev), inputs(cpu)
    statics = dict(A=A, K=K, W=width, optimize_q=True)

    # window scores, ZOOPS posterior, M-step counts
    lut_d = motif_mod.log_odds_lut(v_d, data_d["bg_flat"])
    lut_c = motif_mod.log_odds_lut(v_c, data_c["bg_flat"])
    sc_d, mk_d = escore.window_scores(lut_d, data_d["cidx"], data_d["lens"], width)
    sc_c, mk_c = escore.window_scores(lut_c, data_c["cidx"], data_c["lens"], width)
    mk = np.asarray(mk_c)
    sel = np.broadcast_to(mk[None], sc_c.shape)
    check("mask mismatches (exact)", float(np.sum(np.asarray(mk_d) != mk)), 0)
    check("window_scores vs CPU (normwise)",
          rel_norm(np.asarray(sc_d)[sel], np.asarray(sc_c)[sel]), RTOL_SUM)
    r_d, r0_d, ll_d = escore.zoops_posterior(sc_d, mk_d, q_d)
    r_c, r0_c, ll_c = escore.zoops_posterior(sc_c, mk_c, q_c)
    check("zoops r vs CPU (normwise)", rel_norm(r_d, r_c), RTOL_SUM)
    check("zoops r0 vs CPU (normwise)", rel_norm(r0_d, r0_c), RTOL_SUM)
    check("zoops ll vs CPU (relative)", rel(ll_d, ll_c), RTOL_SUM)
    C_d = escore.mstep_counts(r_d, data_d["cidx"], R, width)
    C_c = escore.mstep_counts(_on(r_d, cpu), data_c["cidx"], R, width)
    check("mstep_counts vs CPU, same r (normwise)", rel_norm(C_d, C_c), RTOL_COUNT)

    # one EM step
    out_d = em_step(v_d, q_d, data_d, a_d, f_d, n_d, **statics)
    out_c = em_step(v_c, q_c, data_c, a_c, f_c, n_c, **statics)
    check("em_step ll vs CPU (relative)", rel(out_d[2], out_c[2]), RTOL_SUM)
    check("em_step q vs CPU (relative)", rel(out_d[1], out_c[1]), RTOL_COUNT)
    check("em_step v vs CPU (max abs)", max_abs(out_d[0], out_c[0]), ATOL_V_STEP)
    hlo = em_step.lower(v_d, q_d, data_d, a_d, f_d, n_d, **statics).compile().as_text()
    print(f"  matrix products in the compiled em_step: {_matmuls(hlo)}")

    # one 3-seed batched EM step
    rng = np.random.default_rng(K)
    stack = tuple(
        jnp.stack([vk] + [
            jnp.asarray(np.asarray(vk) * rng.uniform(0.9, 1.1, vk.shape), jnp.float32)
            for _ in range(2)
        ])
        for vk in inputs(cpu)[0]
    )
    step = jax.jit(make_batched_step(A, K, width, True))

    def batched(d, data, f, n):
        return step(_on(stack, d), _on(jnp.asarray([0.3, 0.5, 0.7], jnp.float32), d),
                    data, _on(jnp.stack([jnp.asarray(motif.alphas, jnp.float32)] * 3), d),
                    f, n)

    b_d, b_c = batched(dev, data_d, f_d, n_d), batched(cpu, data_c, f_c, n_c)
    check("3-seed step ll vs CPU (normwise)", rel_norm(b_d[2], b_c[2]), RTOL_SUM)
    check("3-seed step v vs CPU (max abs)", max_abs(b_d[0], b_c[0]), ATOL_V_STEP)

    # one CGS sweep with a fixed key
    def sweep(d, data, v, q, a, f, n):
        return gibbs_step(v, q, jnp.log(a), _on(jax.random.PRNGKey(7), d), data,
                          f, a, n, A=A, K=K, W=width, sample_z=True,
                          sample_q=True, learn_alpha=True)

    g_d = sweep(dev, data_d, v_d, q_d, a_d, f_d, n_d)
    g_c = sweep(cpu, data_c, v_c, q_c, a_c, f_c, n_c)
    n_flip = abs(int(g_d[5]) - int(g_c[5]))
    print(f"  CGS sampled occupancy: card {int(g_d[5])}, CPU {int(g_c[5])}")
    check("CGS ll vs CPU (relative)", rel(g_d[4], g_c[4]), RTOL_SUM)
    check("CGS occupied-count difference", n_flip, 1)
    check("CGS hard counts vs CPU (max abs)", max_abs(g_d[6], g_c[6]), 2)
    check("CGS v vs CPU (max abs)", max_abs(g_d[0], g_c[0]), 1e-3)

    # float64 numpy reference on the first n_ref sequences
    sub = sset.subset(np.arange(n_ref))
    rows = reference.strand_rows(sub.codes, sub.lens, encode.comp_table(sub.alphabet),
                                 A, K, False)
    bg_flat = bg.conditional_flat(K)
    sc_r, mk_r = reference.window_scores(reference.log_odds_lut(motif.v, bg_flat),
                                         rows, sub.lens, width)
    sel_r = np.broadcast_to(mk_r[None], sc_r.shape)
    check("window_scores vs f64 reference (normwise)",
          rel_norm(np.asarray(sc_d)[:, :n_ref][sel_r], sc_r[sel_r]), RTOL_SUM)
    data_s = _on(prepare_data(sub, bg, K, False), dev)
    o_s = em_step(v_d, q_d, data_s, a_d, f_d, _on(jnp.float32(n_ref), dev), **statics)
    v_r, q_r, ll_r = reference.em_step(
        motif.v, 0.5, rows, sub.lens, bg_flat, motif.alphas, motif.f_bg,
        A=A, K=K, W=width, optimize_q=True,
    )
    sc_s, mk_s = escore.window_scores(lut_d, data_s["cidx"], data_s["lens"], width)
    r_s, _r0, _ll = escore.zoops_posterior(sc_s, mk_s, q_d)
    r_r, _r0r, _llr = reference.zoops_posterior(sc_r, mk_r, 0.5)
    check("mstep_counts vs f64 reference (normwise)",
          rel_norm(escore.mstep_counts(r_s, data_s["cidx"], R, width),
                   reference.mstep_counts(r_r, rows, R, width)), RTOL_COUNT)
    check("em_step ll vs f64 reference (relative)", rel(o_s[2], ll_r), RTOL_SUM)
    check("em_step q vs f64 reference (relative)", rel(o_s[1], q_r), RTOL_COUNT)
    check("em_step v vs f64 reference (max abs)", max_abs(o_s[0], v_r), ATOL_V_STEP)

    if K == 2:
        again = em_step(v_d, q_d, data_d, a_d, f_d, n_d, **statics)
        print(f"  finding, card run-to-run at K=2: max |dv| "
              f"{max_abs(out_d[0], again[0]):.3e}, |dll| "
              f"{abs(float(out_d[2]) - float(again[2])):.3e}")


def phase_parity(n_seqs: int = N_SEQS, seq_len: int = SEQ_LEN,
                 orders=ORDERS, n_ref: int = N_REF, width: int = W,
                 dev=None) -> None:
    dev = dev or jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    print(f"[parity] {n_seqs} x {seq_len} bp, both strands, W={width}, "
          f"{dev.platform} vs {cpu.platform}, f32, matmul precision highest",
          flush=True)
    sset, _planted = planted_set(n_seqs, seq_len)
    bg = BackgroundModel.from_sequence_set(sset, order=2)
    check = Checks("parity")
    with jax.default_matmul_precision("highest"):
        for K in orders:
            parity_order(K, sset, bg, dev, cpu, check, n_ref=n_ref, width=width)
    check.done()


def _timed_main(argv: list) -> float:
    t0 = time.perf_counter()
    if cli.main(argv) != 0:
        raise RuntimeError(f"cli.main failed: {argv}")
    return time.perf_counter() - t0


def _cold_warm(name: str, argv_of, card: str) -> str:
    """Runs the CLI twice (cold, then warm compile state); returns the
    second run's output directory."""
    walls = []
    for run in ("cold", "warm"):
        out = argv_of(run)
        walls.append(_timed_main(out))
    print(f"  {name}: cold {walls[0]:.2f} s, warm {walls[1]:.2f} s "
          f"(smoke times, {card})", flush=True)
    return argv_of("warm")[0]


def _read_stats(path: str) -> np.ndarray:
    with open(path) as fh:
        header = fh.readline().split()
        rows = np.loadtxt(fh, ndmin=2)
    if header != ["score", "TP", "FP", "precision", "recall", "p-value"] \
            or rows.shape[0] < 2 or not np.isfinite(rows).all():
        raise AssertionError(f"{path}: malformed stats")
    return rows


def _read_occurrences(path: str) -> list:
    with open(path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        rows = [line.rstrip("\n").split("\t") for line in fh]
    if header[:3] != ["header", "length", "strand"] or any(len(r) != 8 for r in rows):
        raise AssertionError(f"{path}: malformed occurrences")
    return rows


def phase_pipeline(workdir: str, card: str, n_seqs: int = N_SEQS,
                   seq_len: int = SEQ_LEN, n_scan: int = N_SCAN,
                   n_seeds: int = N_SEEDS, extra: tuple = ()) -> None:
    print(f"[pipeline] cli.main, {n_seqs} x {seq_len} bp; scan {n_scan} "
          f"x {seq_len} bp", flush=True)
    sset, _planted = planted_set(n_seqs, seq_len)
    pos = os.path.join(workdir, "pos.fasta")
    write_fasta(pos, sset)
    one = os.path.join(workdir, "one.meme")
    write_meme(one, config4_seeds(len(MOTIFS))[-1:])
    ten = os.path.join(workdir, "ten.meme")
    write_meme(ten, config4_seeds(n_seeds))
    check = Checks("pipeline")

    # (a) config 3: order-4 BaMM, order-2 background, EM
    out_a = _cold_warm(f"config 3 (order-4 EM, {n_seqs} seqs)", lambda run: [
        os.path.join(workdir, f"c3_{run}"), pos, "--PWMFile", one,
        "-k", "4", "-K", "2", "--EM", "-q", "0.3", "--saveBaMMs",
        "--basename", "c3", *extra], card)
    model = Motif.read(os.path.join(out_a, "c3_motif_1.ihbcp"))
    Motif.read(os.path.join(out_a, "c3_motif_1.ihbp"))
    BackgroundModel.read(os.path.join(out_a, "c3.hbcp"))
    check("config 3 order / width mismatch", float((model.K, model.W) != (4, W)), 0)
    check("config 3 consensus mismatches", mismatches(consensus(model), MOTIFS[-1]), 0)

    # (b) config 4: ten seeds, EM + optimizeQ + 5-fold FDR.  q starts
    # below the planted share (0.27): from q = 0.5 the W = 12 seeds settle
    # on a chimera of the GC motif and the AP-1 site, on the CPU too
    out_b = _cold_warm(f"config 4 ({n_seeds} seeds, EM + 5-fold FDR)", lambda run: [
        os.path.join(workdir, f"c4_{run}"), pos, "--PWMFile", ten,
        "--maxPWM", str(n_seeds), "--EM", "--optimizeQ", "--FDR",
        "--cvFold", "5", "-q", "0.1", "--basename", "c4", *extra], card)
    # every seed must come back to its planted motif up to one position:
    # TGACTCAG shares TGACT with CACGTGACTT, and its seeds settle on
    # TGACTCCG at 10k sequences on the CPU backend as well
    wrong, found = 0, []
    for i in range(1, n_seeds + 1):
        m = Motif.read(os.path.join(out_b, f"c4_motif_{i}.ihbcp"))
        Motif.read(os.path.join(out_b, f"c4_motif_{i}.ihbp"))
        found.append(consensus(m))
        wrong += mismatches(found[-1], MOTIFS[(i - 1) % len(MOTIFS)]) > 1
        for tag in ("zoops", "mops"):
            _read_stats(os.path.join(out_b, f"c4_motif_{i}.{tag}.stats"))
    print(f"  config 4 refined consensus: {' '.join(found)}")
    check("config 4 seeds not recovering their motif", float(wrong), 0)

    # (c) config 5: the config-3 model scanned over 100k sequences
    scan_set, planted = planted_set(n_scan, seq_len, motifs=MOTIFS[-1:],
                                    rate=0.2, seed=1)
    scan_fa = os.path.join(workdir, "scan.fasta")
    write_fasta(scan_fa, scan_set)
    cutoff = 1e-5
    out_c = _cold_warm(f"config 5 (scan of {n_scan} seqs, p-values)", lambda run: [
        os.path.join(workdir, f"c5_{run}"), scan_fa, "--BaMMFile",
        os.path.join(out_a, "c3_motif_1.ihbcp"), "--scoreSeqset",
        "--pvalCutoff", str(cutoff), "--basename", "c5", *extra], card)
    occ = _read_occurrences(os.path.join(out_c, "c5_motif_1.occurrence"))
    hit_rows = {int(r[0][1:]) for r in occ}
    pv = np.array([float(r[6]) for r in occ])
    print(f"  config 5: {len(occ)} occurrences in {len(hit_rows)} sequences; "
          f"{int(planted.sum())} sequences carry the motif")
    check("config 5 p-values above the cutoff", float(np.sum(pv > cutoff)), 0)
    check("config 5 planted rows missed (share)",
          1.0 - len(hit_rows & set(np.nonzero(planted)[0])) / planted.sum(), 0.05)
    check("config 5 hits outside planted rows (share)",
          len(hit_rows - set(np.nonzero(planted)[0])) / max(len(hit_rows), 1), 0.05)
    check.done()


def _model_files(outdir: str, basename: str) -> dict:
    return {
        os.path.basename(p): Motif.read(p)
        for p in sorted(glob.glob(os.path.join(outdir, f"{basename}_*.ihbcp")))
    }


def phase_four_cards(workdir: str, n_devices: int = 4, n_seqs: int = N_SEQS,
                     seq_len: int = SEQ_LEN, n_seeds: int = N_SEEDS,
                     n_iters: int = 150) -> None:
    """Mesh against one device, both running exactly ``n_iters`` EM
    iterations (``-e 0``): the float32 stop rule fires on a likelihood
    plateau, so converged runs whose sums are taken in another order can
    stop an iteration apart, and a slowly converging seed moves by up to
    ~3e-4 in that iteration.  Equal iteration counts leave only the
    summation order between the two."""
    from bammmotif2_tpu.parallel import distributed
    from bammmotif2_tpu.parallel import mesh as mesh_mod

    devs = jax.devices()
    if len(devs) < n_devices:
        raise RuntimeError(f"needs {n_devices} devices, JAX sees {len(devs)}")
    print(f"[four_cards] {n_seqs} x {seq_len} bp on {len(devs)} devices; "
          "FDR and scanning stay on one device (ROADMAP 2.2)", flush=True)
    sset, _planted = planted_set(n_seqs, seq_len)
    pos = os.path.join(workdir, "pos.fasta")
    write_fasta(pos, sset)
    bg = BackgroundModel.from_sequence_set(sset, order=2)
    check = Checks("four_cards")
    runs = (
        ("one seed, order 2", config4_seeds(len(MOTIFS))[-1:]),
        (f"{n_seeds} seeds, EM", config4_seeds(n_seeds)),
    )
    for name, pwms in runs:
        meme = os.path.join(workdir, f"{len(pwms)}.meme")
        write_meme(meme, pwms)
        mesh = distributed.auto_mesh(n_seeds=len(pwms))
        K = 2
        cidx = mesh_mod.shard_em_data(
            mesh, prepare_data(sset, bg, K, False), encode.num_rows(4, K)
        )["cidx"]
        print(f"  {name}: mesh {dict(mesh.shape)}; code tensor "
              f"{tuple(cidx.shape)} on devices "
              f"{sorted(d.id for d in cidx.sharding.device_set)}, shard "
              f"{tuple(cidx.sharding.shard_shape(cidx.shape))}", flush=True)
        models = {}
        for mode, flags in (("mesh", []), ("single", ["--single-device"])):
            out = os.path.join(workdir, f"{len(pwms)}_{mode}")
            wall = _timed_main([out, pos, "--PWMFile", meme, "--EM", "-q", "0.5",
                                "-e", "0", "--maxEMIterations", str(n_iters),
                                "--basename", "m", *flags])
            models[mode] = _model_files(out, "m")
            print(f"  {name}, {mode}: {wall:.2f} s", flush=True)
        if sorted(models["mesh"]) != sorted(models["single"]) \
                or len(models["mesh"]) != len(pwms):
            raise AssertionError(f"{name}: model files differ in number or name")
        err = max(
            max_abs(models["mesh"][f].v, models["single"][f].v)
            for f in models["mesh"]
        )
        check(f"{name}: mesh vs single-device models (max abs)", err,
              ATOL_MODEL_FILE)
    check.done()


def select_phases(argv: list) -> list:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the 4-device mesh phase and its "
                             "single-device comparison")
    args = parser.parse_args(argv)
    return ["device", "four_cards"] if args.four_cards else [
        "device", "parity", "pipeline"]


def result_line(info: dict) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}})


def main(argv=None) -> int:
    phases = select_phases(sys.argv[1:] if argv is None else argv)
    # the card is the default backend; the CPU backend is the parity
    # comparison
    jax.config.update("jax_platforms", "cuda,cpu")
    cli._enable_compilation_cache()
    info = phase_device()
    with tempfile.TemporaryDirectory() as workdir:
        if "parity" in phases:
            phase_parity()
        if "pipeline" in phases:
            phase_pipeline(workdir, info["card"])
        if "four_cards" in phases:
            phase_four_cards(workdir)
    print(result_line(info), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
