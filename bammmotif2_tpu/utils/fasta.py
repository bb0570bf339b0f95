"""FASTA parsing and one-shot host-side tensorization.

JAX equivalent of ``src/init/SequenceSet.{h,cpp}`` and
``src/init/Sequence.{h,cpp}``: instead of a vector of per-sequence objects,
the whole set is tensorized once into

    codes : int8 [N, L_max]   (0-based letter codes, PAD = -2, ambig = -1)
    lens  : int32 [N]

which is the layout every device kernel consumes (BASELINE.json: "FASTA
parser -> one-shot host-side tensorization").  Reverse-complement handling
differs from the reference (which appends the revcomp to the same array,
``Sequence::appendRevComp``): we keep the forward codes canonical and
materialize the revcomp view where scanning needs it, so strand logic is
explicit in the kernels rather than baked into storage.

A native C fast path (``bammmotif2_tpu.io.native``) parses+encodes large
FASTA files in C; this module transparently uses it when the extension is
built and falls back to the pure-numpy path otherwise.
"""

from __future__ import annotations

import dataclasses
import io
import os

import numpy as np

from bammmotif2_tpu.utils.alphabet import AMBIG, Alphabet

PAD = -2  # padding code beyond each sequence's length


@dataclasses.dataclass
class SequenceSet:
    """A tensorized FASTA set.

    Attributes:
      codes: int8 [N, L_max]; values in [0, |A|), AMBIG (-1) for N-like
        letters, PAD (-2) past each sequence's end.
      lens: int32 [N] true sequence lengths.
      headers: list of FASTA headers (without '>').
      alphabet: the Alphabet used to encode.
    """

    codes: np.ndarray
    lens: np.ndarray
    headers: list
    alphabet: Alphabet

    @property
    def n(self) -> int:
        return int(self.codes.shape[0])

    @property
    def l_max(self) -> int:
        return int(self.codes.shape[1])

    @property
    def min_len(self) -> int:
        return int(self.lens.min()) if self.n else 0

    @property
    def max_len(self) -> int:
        return int(self.lens.max()) if self.n else 0

    def base_frequencies(self) -> np.ndarray:
        """Mono-nucleotide frequencies over the whole set (AMBIG excluded).

        Parity: ``SequenceSet::getBaseFrequencies`` — used for order-0
        pseudo-counts and PWM->BaMM lifting.
        """
        a = self.alphabet.size
        valid = self.codes >= 0
        counts = np.bincount(self.codes[valid].astype(np.int64), minlength=a)[:a]
        total = counts.sum()
        if total == 0:
            return np.full(a, 1.0 / a)
        return counts / total

    def sequence_str(self, i: int) -> str:
        return self.alphabet.decode(self.codes[i, : self.lens[i]])

    def subset(self, idx: np.ndarray) -> "SequenceSet":
        idx = np.asarray(idx)
        return SequenceSet(
            codes=self.codes[idx],
            lens=self.lens[idx],
            headers=[self.headers[int(i)] for i in idx],
            alphabet=self.alphabet,
        )

    @staticmethod
    def from_sequences(
        seqs: list, headers: list | None = None, alphabet: Alphabet | None = None
    ) -> "SequenceSet":
        """Build from a list of strings or code arrays (testing/generation)."""
        alphabet = alphabet or Alphabet.standard()
        if headers is None:
            headers = [f"seq_{i}" for i in range(len(seqs))]
        enc = [
            alphabet.encode(s) if isinstance(s, (str, bytes)) else np.asarray(s, np.int8)
            for s in seqs
        ]
        lens = np.array([len(e) for e in enc], dtype=np.int32)
        l_max = int(lens.max()) if len(enc) else 0
        codes = np.full((len(enc), l_max), PAD, dtype=np.int8)
        for i, e in enumerate(enc):
            codes[i, : len(e)] = e
        return SequenceSet(codes=codes, lens=lens, headers=list(headers), alphabet=alphabet)


def _parse_fasta_text(text: str) -> tuple[list, list]:
    headers, seqs = [], []
    cur: list | None = None
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            headers.append(line[1:].strip())
            cur = []
            seqs.append(cur)
        elif line.startswith(";"):
            continue  # old-style FASTA comment
        else:
            if cur is None:  # sequence data before any header
                headers.append("unnamed")
                cur = []
                seqs.append(cur)
            cur.append(line)
    return headers, ["".join(s) for s in seqs]


def read_fasta(
    path: str | os.PathLike | io.TextIOBase,
    alphabet: Alphabet | None = None,
    use_native: bool = True,
) -> SequenceSet:
    """Parse a FASTA file into a SequenceSet.

    Parity: ``SequenceSet::SequenceSet(path, ss)`` — including tolerance of
    blank/comment lines, lower-case letters, and headerless leading data.
    """
    alphabet = alphabet or Alphabet.standard()
    if isinstance(path, io.TextIOBase):
        headers, seqs = _parse_fasta_text(path.read())
        return SequenceSet.from_sequences(seqs, headers, alphabet)

    if use_native:
        try:
            from bammmotif2_tpu.io import native

            parsed = native.read_fasta_encoded(os.fspath(path), alphabet)
            if parsed is not None:
                codes, lens, headers = parsed
                if not headers:
                    raise ValueError(f"no sequences found in FASTA file {path!r}")
                return SequenceSet(codes=codes, lens=lens, headers=headers, alphabet=alphabet)
        except ImportError:
            pass

    with open(path, "r") as fh:
        headers, seqs = _parse_fasta_text(fh.read())
    if not headers:
        raise ValueError(f"no sequences found in FASTA file {path!r}")
    return SequenceSet.from_sequences(seqs, headers, alphabet)


def write_fasta(path: str | os.PathLike, sset: SequenceSet, width: int = 60) -> None:
    with open(path, "w") as fh:
        for i in range(sset.n):
            fh.write(f">{sset.headers[i]}\n")
            s = sset.sequence_str(i)
            for off in range(0, len(s), width):
                fh.write(s[off : off + width] + "\n")
