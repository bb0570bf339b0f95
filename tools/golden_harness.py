"""Golden-file harness vs the C++ reference binary (when one exists).

The single compatibility bar in BASELINE.json — "outputs must match the
C++ reference on its test FASTA sets to numerical tolerance" — has been
unverifiable for three rounds because /root/reference/ mounts empty
(SURVEY.md provenance caveat).  This harness is the ready-to-run
protocol for the moment a reference binary appears:

    python tools/golden_harness.py /path/to/BaMMmotif [workdir]

It generates deterministic inputs, runs the FIVE BASELINE configs
through BOTH the reference binary and this framework's CLI with the
same flags, and numerically diffs the artifacts:

  * .ihbcp / .ihbp   — conditional/full motif probabilities, atol 1e-4
                        (SURVEY.md 4: tolerance tiers; f32 vs the
                        reference's double accumulation)
  * .hbcp / .hbp     — background probabilities, atol 1e-6
  * .occurrence      — exact coordinates/strand/site per row; scores to
                        1e-3 (p-values excluded: the negative sets are
                        sampled with different RNGs — SURVEY.md 2.1)
  * .zoops.stats     — excluded for the same RNG reason; compared
                        distributionally by AvRec when both exist

Self-chosen conventions that MUST be checked against the reference the
moment a binary appears (each is a pinned deviation in its docstring):

  * .stats row thinning — evaluation.fdr.MAX_STATS_ROWS uniform
    thinning of the WRITTEN table (the reference plausibly writes one
    row per pooled score; diff row counts and interpolate if so)
  * p-value tie handling — tie-block-midpoint interpolation
    (scoring.scan.empirical_pvalues, frac = (lo+hi)/2) vs the survey's
    "linear interpolation between adjacent negative scores [MED]"
  * .logOdds layout — per-WINDOW rows (header/strand/1-based
    start/score, scoring.scan.write_logodds) vs whatever
    ScoreSeqSet::write emits under --saveLogOdds
  * MOPS pool convention — per-window scores pooled over both strands
    with mFold FP normalization (evaluation.fdr; see the synthetic
    multi-occurrence discrimination test in tests/test_scan_fdr.py)
  * .ihbp j=0 convention and the context denominator in update_v
    (models/motif.py), IUPAC softening (models/seeds.py)

Deterministic-path configs (EM from a PWM seed, no sampling) must pass
strictly; sampled-path configs report distributional summaries only.
The comparison helpers are unit-tested (tests/test_scan_fdr.py uses
parse_model_file round-trips) so the harness itself is exercised in CI
even while no binary exists.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def parse_model_file(path: str) -> list:
    """Parse .ihbcp/.ihbp/.hbcp/.hbp into a list of per-block float rows.

    Both the reference and this framework write blank-line-separated
    blocks of whitespace-separated floats with optional '#' headers;
    values are compared, formatting is not.
    """
    blocks, cur = [], []
    with open(path) as fh:
        for line in fh:
            s = line.strip()
            if not s:
                if cur:
                    blocks.append(cur)
                    cur = []
                continue
            if s.startswith("#"):
                continue
            cur.append(np.array([float(x) for x in s.split()]))
    if cur:
        blocks.append(cur)
    return blocks


def compare_model_files(a: str, b: str, atol: float) -> list:
    """Return a list of mismatch descriptions (empty == match)."""
    try:
        ba, bb = parse_model_file(a), parse_model_file(b)
    except FileNotFoundError as e:
        return [f"missing file: {e.filename}"]
    out = []
    if len(ba) != len(bb):
        out.append(f"block count {len(ba)} != {len(bb)}")
        return out
    for i, (xa, xb) in enumerate(zip(ba, bb)):
        if len(xa) != len(xb):
            out.append(f"block {i}: row count {len(xa)} != {len(xb)}")
            continue
        for j, (ra, rb) in enumerate(zip(xa, xb)):
            if ra.shape != rb.shape:
                out.append(f"block {i} row {j}: width {ra.size} != {rb.size}")
            elif not np.allclose(ra, rb, atol=atol):
                out.append(
                    f"block {i} row {j}: max|d| = {np.abs(ra - rb).max():.2e}"
                )
    return out


def compare_occurrences(a: str, b: str) -> list:
    """Exact coordinate/strand/site match per row; score atol 1e-3."""
    def rows(path):
        out = {}
        with open(path) as fh:
            next(fh)  # header
            for line in fh:
                f = line.rstrip("\n").split("\t")
                out[(f[0], f[2], f[3])] = float(f[5])  # (header, strand, span)
        return out

    try:
        ra, rb = rows(a), rows(b)
    except FileNotFoundError as e:
        return [f"missing file: {e.filename}"]
    out = []
    only_a = set(ra) - set(rb)
    only_b = set(rb) - set(ra)
    if only_a:
        out.append(f"{len(only_a)} rows only in {a}")
    if only_b:
        out.append(f"{len(only_b)} rows only in {b}")
    for k in set(ra) & set(rb):
        if abs(ra[k] - rb[k]) > 1e-3:
            out.append(f"{k}: score {ra[k]} vs {rb[k]}")
    return out


# the five BASELINE.json configs as (name, extra CLI flags, n_seqs, seq_len)
CONFIGS = [
    ("c1_order0_pwm", ["--EM", "-k", "0"], 1000, 200),
    ("c2_order2", ["--EM", "-k", "2"], 1000, 200),
    ("c3_order4_bg2", ["--EM", "-k", "4", "-K", "2"], 10000, 200),
    ("c4_multiseed_fdr",
     ["--EM", "--FDR", "--maxPWM", "10", "-k", "2"], 10000, 200),
    ("c5_scan", ["--EM", "--scoreSeqset", "-k", "2"], 100000, 200),
]

DETERMINISTIC = {"c1_order0_pwm", "c2_order2", "c3_order4_bg2"}


def build_inputs(workdir: str, n: int, l: int) -> tuple:
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_em import planted_set

    from bammmotif2_tpu.models import seeds as seeds_mod
    from bammmotif2_tpu.utils.fasta import write_fasta

    sset = planted_set(n=n, l=l, motif="TGACTCAG", q=0.8, noise=0.05, seed=1)
    fasta = os.path.join(workdir, f"pos_{n}.fasta")
    write_fasta(fasta, sset)
    meme = os.path.join(workdir, f"seed_{n}.meme")
    pwm = seeds_mod.iupac_to_pwm("TGACTCAG", soft=0.6)
    with open(meme, "w") as fh:
        fh.write("MEME version 4\n\nMOTIF seed1\n")
        fh.write("letter-probability matrix: alength= 4 w= 8 nsites= 50\n")
        for row in pwm:
            fh.write(" ".join(f"{p:.3f}" for p in row) + "\n")
    return fasta, meme


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__)
        return 2
    ref_bin = sys.argv[1]
    if not os.access(ref_bin, os.X_OK):
        print(f"reference binary not executable: {ref_bin}")
        return 2
    workdir = sys.argv[2] if len(sys.argv) > 2 else tempfile.mkdtemp("golden")
    os.makedirs(workdir, exist_ok=True)
    failures = 0
    for name, flags, n, l in CONFIGS:
        fasta, meme = build_inputs(workdir, n, l)
        ref_out = os.path.join(workdir, f"{name}_ref")
        our_out = os.path.join(workdir, f"{name}_jax")
        os.makedirs(ref_out, exist_ok=True)
        args = [fasta, "--PWMFile", meme] + flags
        print(f"== {name}: {' '.join(args)}")
        r = subprocess.run([ref_bin, ref_out] + args, capture_output=True,
                           text=True, timeout=3600)
        if r.returncode != 0:
            print(f"  reference binary failed: {r.stderr[-500:]}")
            failures += 1
            continue
        from bammmotif2_tpu.cli import main as cli_main

        cli_main([our_out] + args + ["--basename",
                                     os.path.splitext(os.path.basename(fasta))[0]])
        base = os.path.splitext(os.path.basename(fasta))[0]
        problems: list = []
        for suffix, atol in ((".hbcp", 1e-6), (".hbp", 1e-6)):
            problems += compare_model_files(
                os.path.join(ref_out, base + suffix),
                os.path.join(our_out, base + suffix), atol)
        if name in DETERMINISTIC:
            for suffix in ("_motif_1.ihbcp", "_motif_1.ihbp"):
                problems += compare_model_files(
                    os.path.join(ref_out, base + suffix),
                    os.path.join(our_out, base + suffix), 1e-4)
        if "--scoreSeqset" in flags:
            problems += compare_occurrences(
                os.path.join(ref_out, base + "_motif_1.occurrence"),
                os.path.join(our_out, base + "_motif_1.occurrence"))
        if problems:
            failures += 1
            print("  MISMATCH:")
            for p in problems[:20]:
                print(f"    {p}")
        else:
            print("  OK")
    print(f"{len(CONFIGS) - failures}/{len(CONFIGS)} configs match")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
