"""Command-line driver: the reference's ``BaMMmotif`` pipeline.

JAX equivalent of ``src/main.cpp`` + ``src/Global/Global.cpp``:
parse reference-compatible flags, load sequence sets, build/load the
background model, fan out seeds, refine (EM and/or CGS — all seeds of a
width group in one batched program instead of OpenMP threads), write model
files, then optionally scan for occurrences and run FDR evaluation.

Reference command lines run unmodified, e.g.:

    bammmotif2-tpu OUTDIR positives.fasta --PWMFile seeds.meme \
        --EM --FDR --scoreSeqset -k 2 -K 2 -q 0.9 --mFold 10 --cvFold 5
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

from bammmotif2_tpu.evaluation.fdr import evaluate_motifs
from bammmotif2_tpu.evaluation.prcurve import average_recall
from bammmotif2_tpu.generator import seqgen
from bammmotif2_tpu.models.background import BackgroundModel
from bammmotif2_tpu.models.motifset import load_motifs
from bammmotif2_tpu.refinement.em import run_em
from bammmotif2_tpu.refinement.gibbs import run_gibbs_multi
from bammmotif2_tpu.refinement.multi import run_em_multi
from bammmotif2_tpu.scoring import scan
from bammmotif2_tpu.utils.alphabet import Alphabet
from bammmotif2_tpu.utils.config import Params
from bammmotif2_tpu.utils.fasta import read_fasta


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bammmotif2-tpu",
        description="Bayesian Markov Model motif discovery in JAX "
        "(BaMMmotif2-compatible)",
    )
    p.add_argument("outputDirectory")
    p.add_argument("posSequenceFile")
    # sequence options
    p.add_argument("--negSeqFile", dest="negSequenceFile", default=None)
    p.add_argument("--alphabet", dest="alphabetType", default="STANDARD")
    p.add_argument("--ss", action="store_true")
    # init
    p.add_argument("--bindingSiteFile", default=None)
    p.add_argument("--PWMFile", default=None)
    p.add_argument("--BaMMFile", default=None)
    p.add_argument("--baseBgModelFile", default=None, metavar="HBCP",
                   help="background model (.hbcp) paired with --BaMMFile: "
                        "its mono-nucleotide frequencies seed the order-0 "
                        "interpolation base instead of the positive set's")
    p.add_argument("--pattern", default=None,
                   help="IUPAC seed pattern(s), ';'-separated (e.g. TGASTCA)")
    p.add_argument("--maxPWM", type=int, default=None)
    # model
    p.add_argument("-k", "--order", dest="modelOrder", type=int, default=2)
    p.add_argument("-a", "--alpha", dest="modelAlpha", type=float, default=1.0)
    p.add_argument("-b", "--beta", dest="modelBeta", type=float, default=7.0)
    p.add_argument("-r", "--gamma", dest="modelGamma", type=float, default=3.0)
    p.add_argument("--extend", nargs=2, type=int, default=[0, 0], metavar=("L", "R"))
    # background
    p.add_argument("-K", "--Order", dest="bgModelOrder", type=int, default=2)
    p.add_argument("-A", "--Alpha", dest="bgModelAlpha", type=float, default=10.0)
    p.add_argument("--bgModelFile", default=None)
    # EM
    p.add_argument("--EM", action="store_true")
    p.add_argument("-e", "--epsilon", dest="epsilon", type=float, default=1e-3)
    p.add_argument("--maxEMIterations", type=int, default=1000)
    p.add_argument("-q", dest="q", type=float, default=0.9)
    p.add_argument("--optimizeQ", action="store_true")
    # CGS
    p.add_argument("--CGS", action="store_true")
    p.add_argument("--maxCGSIterations", type=int, default=100)
    p.add_argument("--noAlphaOptimization", action="store_true")
    p.add_argument("--noZSampling", action="store_true")
    p.add_argument("--noQSampling", action="store_true")
    p.add_argument("--cgsBurnIn", type=int, default=0, metavar="N",
                   help="discard the first N CGS sweeps and estimate the "
                        "model from counts averaged over the rest "
                        "(0 = final-sweep behavior)")
    # FDR
    p.add_argument("--FDR", action="store_true")
    p.add_argument("-m", "--mFold", dest="mFold", type=int, default=10)
    p.add_argument("-n", "--cvFold", dest="cvFold", type=int, default=5)
    p.add_argument("-s", "--sOrder", dest="sOrder", type=int, default=2)
    # scanning
    p.add_argument("--scoreSeqset", action="store_true")
    p.add_argument("--pvalCutoff", type=float, default=1e-4)
    # output
    p.add_argument("--basename", default=None)
    # opt-out-able outputs (the reference's Global booleans gate these):
    # --saveBaMMs/--savePRs are on by default, --no-saveBaMMs/--no-savePRs
    # suppress the respective files
    p.add_argument("--saveBaMMs", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--saveInitialBaMMs", action="store_true")
    p.add_argument("--savePRs", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--savePvalues", action="store_true")
    p.add_argument("--saveLogOdds", action="store_true")
    p.add_argument("--verbose", action="store_true")
    # extensions (absent in the reference)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument(
        "--single-device", dest="multiDevice", action="store_false", default=True
    )
    p.add_argument("--jsonl", action="store_true",
                   help="write structured metrics to BASENAME.metrics.jsonl")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a jax.profiler trace of the run into DIR")
    p.add_argument("--checkpointEvery", type=int, default=0, metavar="N",
                   help="write the model file every N EM iterations "
                        "(a saved BaMM is a valid --BaMMFile resume point)")
    return p


def params_from_args(argv: list) -> Params:
    args = build_parser().parse_args(argv)
    d = vars(args)
    d["extend"] = tuple(d["extend"])
    return Params(**{k: v for k, v in d.items() if k in Params.__dataclass_fields__})


def run_pipeline(params: Params, mesh=None) -> dict:
    """Execute the full pipeline; returns a dict of produced artifacts.

    With ``params.profile`` set, the whole run is captured as a
    ``jax.profiler`` trace (open with TensorBoard / xprof); with
    ``params.jsonl``, every stage appends one event to
    ``BASENAME.metrics.jsonl`` (utils.metrics).
    """
    if params.profile:
        import jax

        with jax.profiler.trace(params.profile):
            return _run_pipeline(params, mesh)
    return _run_pipeline(params, mesh)


def _run_pipeline(params: Params, mesh=None) -> dict:
    from bammmotif2_tpu.utils.metrics import MetricsLogger

    # library callers (benchmarks, notebooks) get the persistent XLA
    # compile cache too, not just the console entry point (idempotent)
    _enable_compilation_cache()

    t_start = time.perf_counter()
    out: dict = {"motifs": [], "files": []}
    os.makedirs(params.outputDirectory, exist_ok=True)
    alphabet = Alphabet.from_type(params.alphabetType)
    basename = params.basename or os.path.splitext(
        os.path.basename(params.posSequenceFile)
    )[0]
    metrics = MetricsLogger(
        os.path.join(params.outputDirectory, f"{basename}.metrics.jsonl")
        if params.jsonl
        else None
    )
    try:
        return _pipeline_stages(
            params, mesh, metrics, alphabet, basename, t_start, out
        )
    finally:
        # exception-safe: a failing stage must not leak the handle or
        # leave the .metrics.jsonl without a terminal event
        metrics.close()


def _pipeline_stages(params, mesh, metrics, alphabet, basename,
                     t_start, out) -> dict:
    metrics.event("run_start", params={
        # identity checks, not ==: 0/0.0 compare equal to False and an
        # explicitly-set falsy override (--seed 0, -q 0) must still log
        k: v for k, v in dataclasses.asdict(params).items()
        if v is not None and v is not False
    })

    pos_set = read_fasta(params.posSequenceFile, alphabet)
    metrics.event(
        "sequences_loaded", n=pos_set.n,
        min_len=pos_set.min_len, max_len=pos_set.max_len,
    )
    neg_set = (
        read_fasta(params.negSequenceFile, alphabet)
        if params.negSequenceFile
        else None
    )
    if params.verbose:
        print(
            f"Loaded {pos_set.n} positive sequences "
            f"(len {pos_set.min_len}..{pos_set.max_len})"
        )

    # background model: loaded or fit on negatives if given, else positives
    if params.bgModelFile:
        bg = BackgroundModel.read(params.bgModelFile, alphabet)
    else:
        bg = BackgroundModel.from_sequence_set(
            neg_set if neg_set is not None else pos_set,
            order=params.bgModelOrder,
            alpha=params.bgModelAlpha,
            ss=params.ss,
        )
    bg_paths = bg.write(params.outputDirectory, basename)
    out["files"] += list(bg_paths)
    out["bg"] = bg

    motifs = load_motifs(params, pos_set.base_frequencies(), alphabet)
    out["motifs"] = motifs

    if params.saveInitialBaMMs:
        for m in motifs:
            out["files"] += list(
                m.write(params.outputDirectory, f"{basename}_init_{m.name}")
            )

    if params.EM:
        if params.checkpointEvery > 0:
            # restartable path: per-motif EM, model file rewritten every
            # N iterations (a saved BaMM is a valid --BaMMFile resume point)
            results = []
            for m in motifs:
                def _ckpt(motif=None, iteration=0, _m=m):
                    (_m if motif is None else motif).write(
                        params.outputDirectory, f"{basename}_{_m.name}"
                    )
                    metrics.event(
                        "em_checkpoint", motif=_m.name, iteration=iteration
                    )

                results.append(
                    run_em(m, bg, pos_set, params, mesh=mesh, checkpoint_fn=_ckpt)
                )
        else:
            results = run_em_multi(motifs, bg, pos_set, params, mesh=mesh)
        out["em_results"] = results
        for m, r in zip(motifs, results):
            metrics.event(
                "em_done", motif=m.name, iterations=r.iterations,
                ll=r.ll, q=r.q, converged=r.converged,
                windows_per_sec=round(r.windows_per_sec),
                seconds=round(r.seconds, 3),
            )
            if params.verbose:
                print(
                    f"EM {m.name}: {r.iterations} iters, ll={r.ll:.2f}, "
                    f"q={r.q:.3f}, {r.windows_per_sec:,.0f} windows/s"
                )
    if params.CGS:
        # an INDEPENDENT `if`, not elif: the reference driver runs EM and
        # CGS as separate stages (SURVEY.md 3.1 "EM and/or CGS"), so
        # --EM --CGS Gibbs-refines the EM-refined models; all seeds of a
        # (W, K) group sweep in one batched device program, data-sharded
        # over the mesh (the OpenMP-over-motifs analogue)
        out["cgs_results"] = run_gibbs_multi(motifs, bg, pos_set, params, mesh=mesh)
        for m, r in zip(motifs, out["cgs_results"]):
            metrics.event(
                "cgs_done", motif=m.name,
                iterations=getattr(r, "iterations", params.maxCGSIterations),
                q=getattr(r, "q", None),
            )

    if params.saveBaMMs:
        for m in motifs:
            out["files"] += list(
                m.write(params.outputDirectory, f"{basename}_{m.name}")
            )

    if params.scoreSeqset:
        # p-value calibration scores: user-provided negatives when given
        # (--negSeqFile, deterministic), else sampled from a background fit
        if neg_set is not None:
            neg_sample = neg_set
        else:
            bg_fit = BackgroundModel.from_sequence_set(
                pos_set, order=params.sOrder, alpha=params.bgModelAlpha,
                ss=params.ss,
            )
            neg_sample = seqgen.generate_neg_set(
                bg_fit, pos_set.lens, m_fold=max(params.mFold, 1),
                seed=params.seed,
            )
        # motifs of equal (W, K) scan in ONE seed-stacked pass per chunk
        # (scan.score_set_multi) — the stacked form of the reference
        # driver's per-motif ScoreSeqSet loop
        scan_groups: dict = {}
        for m in motifs:
            scan_groups.setdefault((m.W, m.K), []).append(m)
        scan_pairs: list = []
        for group in scan_groups.values():
            res_list = scan.score_set_multi(group, bg, pos_set, ss=params.ss)
            neg_list = scan.score_set_multi(group, bg, neg_sample, ss=params.ss)
            scan_pairs += list(zip(group, res_list, neg_list))
        for m, res, neg_res in scan_pairs:
            # per-window occurrence p-values rank against the negatives'
            # PER-WINDOW score distribution (ScoreSeqSet::calcPvalues ranks
            # calcLogOdds window scores, SURVEY.md 3.3) — NOT the ZOOPS
            # per-sequence maxima, which are a different distribution
            # family (pinned by tests/test_scan_fdr.py).  Passing the
            # ScanResult keeps the pool on device (window_pool_device).
            occs = scan.find_occurrences(
                res, pos_set, neg_res, params.pvalCutoff
            )
            path = os.path.join(
                params.outputDirectory, f"{basename}_{m.name}.occurrence"
            )
            scan.write_occurrences(path, occs)
            out["files"].append(path)
            metrics.event(
                "scan_done", motif=m.name, hits=len(occs),
                windows=int(np.sum(np.maximum(pos_set.lens - m.W + 1, 0)))
                * (1 if params.ss else 2),
            )
            if params.saveLogOdds:
                # per-WINDOW log-odds rows, chunk-streamed (the per-seq
                # ZOOPS maxima are a different statistic; scan.write_logodds)
                lo_path = os.path.join(
                    params.outputDirectory, f"{basename}_{m.name}.logOdds"
                )
                scan.write_logodds(lo_path, res, pos_set)
                out["files"].append(lo_path)

    if params.FDR:
        seed_motifs = load_motifs(params, pos_set.base_frequencies(), alphabet)
        # all seeds of a (W, K) group evaluate through ONE fused device
        # program: fold scan + seed-stacked EM/CGS + scoring + in-program
        # negative sampling + device MOPS sweeps (evaluation.fdr)
        fdr_list = evaluate_motifs(seed_motifs, bg, pos_set, params,
                                   neg_set=neg_set)
        for m, fdr_res in zip(seed_motifs, fdr_list):
            if params.savePRs:
                out["files"] += fdr_res.write(
                    params.outputDirectory, f"{basename}_{m.name}"
                )
            if params.savePvalues:
                pv_path = os.path.join(
                    params.outputDirectory, f"{basename}_{m.name}.pvalues"
                )
                np.savetxt(pv_path, fdr_res.pos_pvalues, fmt="%.4e")
                out["files"].append(pv_path)
            out.setdefault("fdr_results", []).append(fdr_res)
            metrics.event(
                "fdr_done", motif=m.name,
                avrec_zoops=round(average_recall(fdr_res.zoops), 4),
                avrec_mops=round(average_recall(fdr_res.mops), 4),
            )

    out["runtime_seconds"] = time.perf_counter() - t_start
    metrics.event("run_done", runtime_seconds=round(out["runtime_seconds"], 3))
    if params.verbose:
        print(f"Runtime: {out['runtime_seconds']:.2f}s")
    return out


# the checkout's own persistent compile cache (git-ignored); a fixed path,
# because the cache directory is part of what a later run must find again
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def compilation_cache_dir() -> str:
    """The persistent XLA compile cache directory this process uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CACHE_DIR


def _enable_compilation_cache() -> None:
    """Persistent XLA compilation cache: a full --EM --FDR --scoreSeqset
    pipeline compiles ~10 distinct programs, so repeat runs on the same
    input sizes start hot.  JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself;
    only without it does the cache go to the checkout's ``.jax_cache``."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)


def _estimate_n_seeds(params: Params) -> int:
    """Cheap seed-count estimate for the mesh's seed-axis width.

    Sizing the axis by --maxPWM alone either over-pads (maxPWM larger
    than the file) — replicated model rows and a starved data axis — or
    never engages seed parallelism (no --maxPWM with a multi-motif PWM
    file).  A textual peek costs nothing next to a compile.
    """
    n = 1
    try:
        if params.PWMFile:
            with open(params.PWMFile) as fh:
                n = sum(1 for line in fh if line.startswith("MOTIF"))
        elif params.pattern:
            n = len([p for p in params.pattern.split(";") if p.strip()])
    except OSError:
        pass  # unreadable file errors meaningfully later, in load_motifs
    if params.maxPWM:
        n = min(n, params.maxPWM)
    return max(n, 1)


def main(argv=None) -> int:
    params = params_from_args(sys.argv[1:] if argv is None else argv)
    _enable_compilation_cache()
    mesh = None
    if params.multiDevice:
        from bammmotif2_tpu.parallel import distributed

        distributed.initialize()
        mesh = distributed.auto_mesh(n_seeds=_estimate_n_seeds(params))
        if params.verbose and mesh is not None:
            import jax

            print(
                f"mesh {dict(mesh.shape)} over {jax.device_count()} devices "
                f"({jax.process_count()} hosts)"
            )
    run_pipeline(params, mesh=mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
