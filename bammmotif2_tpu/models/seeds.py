"""Seed motif initialization: PWM/MEME files, IUPAC patterns, binding sites.

JAX equivalent of ``Motif::initFromPWM`` / ``initFromBindingSites``
and the MEME/PEnG ``.meme`` seed reader consumed via ``--PWMFile``
(SURVEY.md 2: MotifSet loads N seeds from the chosen init source).
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

from bammmotif2_tpu.models.motif import Motif, update_v
from bammmotif2_tpu.ops import encode
from bammmotif2_tpu.utils.alphabet import Alphabet
from bammmotif2_tpu.utils.fasta import SequenceSet

import jax.numpy as jnp

# IUPAC nucleotide codes -> member bases
IUPAC = {
    "A": "A", "C": "C", "G": "G", "T": "T", "U": "T",
    "R": "AG", "Y": "CT", "S": "CG", "W": "AT", "K": "GT", "M": "AC",
    "B": "CGT", "D": "AGT", "H": "ACT", "V": "ACG", "N": "ACGT",
}


@dataclasses.dataclass
class PWMSeed:
    name: str
    pwm: np.ndarray  # [W, A] probabilities
    nsites: float = 100.0
    evalue: float | None = None


def read_meme(path: str, alphabet: Alphabet | None = None) -> list:
    """Parse a (minimal) MEME-format PWM file, as produced by MEME and PEnG.

    Recognizes ``MOTIF <name>`` headers and ``letter-probability matrix:``
    blocks with optional ``alength= w= nsites= E=`` attributes.
    """
    alphabet = alphabet or Alphabet.standard()
    A = alphabet.size
    seeds: list = []
    name = None
    attrs: dict = {}
    rows: list | None = None

    def flush():
        nonlocal rows
        if rows is not None and rows:
            pwm = np.array(rows, dtype=np.float64)
            if pwm.shape[1] != A:
                raise ValueError(
                    f"{path}: PWM width {pwm.shape[1]} != alphabet size {A}"
                )
            seeds.append(
                PWMSeed(
                    name=name or f"motif_{len(seeds) + 1}",
                    pwm=pwm,
                    nsites=float(attrs.get("nsites", 100.0)),
                    evalue=float(attrs["E"]) if "E" in attrs else None,
                )
            )
        rows = None

    with open(path) as fh:
        for line in fh:
            s = line.strip()
            if s.upper().startswith("MOTIF"):
                flush()
                parts = s.split()
                name = parts[1] if len(parts) > 1 else None
                attrs = {}
            elif s.lower().startswith("letter-probability matrix"):
                flush()  # a second header without MOTIF still keeps block 1
                attrs = dict(re.findall(r"(\w+)\s*=\s*([-\d.eE+]+)", s))
                rows = []
            elif rows is not None:
                vals = s.split()
                if vals and all(_is_float(v) for v in vals):
                    rows.append([float(v) for v in vals])
                elif rows:
                    # only a non-numeric line AFTER rows ends the block —
                    # a blank line between the header and the matrix must
                    # not silently drop the motif
                    flush()
    flush()
    if not seeds:
        raise ValueError(f"{path}: no PWM motifs found")
    return seeds


def _is_float(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def iupac_to_pwm(pattern: str, soft: float = 0.7) -> np.ndarray:
    """IUPAC pattern -> PWM as a soft/uniform mixture:

        p = soft * uniform(members) + (1 - soft) * uniform(all bases)

    so a single-base letter gets soft + (1-soft)/4 (A at soft=0.7 ->
    [0.775, 0.075, 0.075, 0.075]) and member bases ALWAYS outweigh
    non-members for every code cardinality.  (The previous
    share-soft-among-members form inverted 3-member codes: B/D/H/V gave
    the explicitly EXCLUDED base the highest probability whenever
    soft < 3/4.)  The exact softening of the reference toolchain (PEnG)
    could not be verified against the empty mount; this is a
    conventional, order-correct seed softening.
    """
    letters = "ACGT"
    W = len(pattern)
    pwm = np.empty((W, 4))
    for j, ch in enumerate(pattern.upper()):
        members = IUPAC.get(ch)
        if members is None:
            raise ValueError(f"invalid IUPAC letter {ch!r} in pattern {pattern!r}")
        m = len(members)
        pwm[j] = (1.0 - soft) / 4.0
        for b in members:
            pwm[j, letters.index(b)] += soft / m
    return pwm


def motif_from_pwm(
    pwm: np.ndarray,
    K: int,
    f_bg: np.ndarray,
    alphas: np.ndarray | None = None,
    nsites: float = 100.0,
    alphabet: Alphabet | None = None,
    name: str = "motif",
) -> Motif:
    """Lift a PWM to a BaMM of order K (``Motif::initFromPWM``).

    The PWM rows scaled by nsites act as order-0 counts; with zero
    higher-order counts the interpolated estimator collapses every
    higher-order conditional onto the order below, so
    v^(k)(y) = v^(0)(last base) at init.
    """
    alphabet = alphabet or Alphabet.standard()
    A = alphabet.size
    W = pwm.shape[0]
    if pwm.shape[1] != A:
        raise ValueError(
            f"PWM has {pwm.shape[1]} columns but alphabet "
            f"{alphabet.name!r} has {A} letters — pass the matching "
            f"Alphabet to motif_from_pwm"
        )
    if alphas is None:
        alphas = Motif.default_alphas(K, W)
    counts = [np.asarray(pwm.T, np.float64) * nsites]
    for k in range(1, K + 1):
        counts.append(np.zeros((A ** (k + 1), W)))
    m = Motif(W, K, [np.zeros_like(c) for c in counts], alphas, f_bg, alphabet, name=name)
    m.set_v_from_counts(counts)
    return m


def motif_from_binding_sites(
    path: str,
    K: int,
    f_bg: np.ndarray,
    alphas: np.ndarray | None = None,
    alphabet: Alphabet | None = None,
    name: str = "motif",
) -> Motif:
    """Init from a file of aligned binding sites, one per line
    (``Motif::initFromBindingSites``).  Counts the (k+1)-mer at every site
    position (context truncated at the site start) and applies calculateV.
    """
    alphabet = alphabet or Alphabet.standard()
    A = alphabet.size
    sites = []
    with open(path) as fh:
        for line in fh:
            s = line.strip().split()[0] if line.strip() else ""
            if s and not s.startswith("#"):
                sites.append(s)
    if not sites:
        raise ValueError(f"{path}: no binding sites found")
    W = len(sites[0])
    if any(len(s) != W for s in sites):
        raise ValueError(f"{path}: binding sites have unequal lengths")
    sset = SequenceSet.from_sequences(sites, alphabet=alphabet)
    # pure-host counting (combined_kmer_index_np): the device encoder
    # would pay an upload + dispatch + fetch for a numpy bincount
    cidx = encode.combined_kmer_index_np(sset.codes, A, K)  # [N, W]
    R = encode.num_rows(A, K)
    C = np.zeros((R + 1, W))
    np.add.at(C, (cidx, np.broadcast_to(np.arange(W), cidx.shape)), 1.0)
    if alphas is None:
        alphas = Motif.default_alphas(K, W)
    from bammmotif2_tpu.models.motif import counts_from_combined

    counts = [np.asarray(c) for c in counts_from_combined(jnp.asarray(C[:R]), A, K)]
    m = Motif(W, K, [np.zeros_like(c) for c in counts], alphas, f_bg, alphabet, name=name)
    m.set_v_from_counts(counts)
    return m
