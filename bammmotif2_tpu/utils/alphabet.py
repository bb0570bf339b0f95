"""Alphabet: letter <-> integer-code maps, complement tables.

JAX equivalent of the reference's ``src/init/Alphabet.{h,cpp}``
(``Alphabet::init(type)``, ``getCode``, ``getBase``, ``getComplementCode``).
Codes are 0-based contiguous integers so that k-mers index dense tensors;
ambiguous/unknown letters (N, ...) map to the sentinel ``Alphabet.AMBIG``
(-1) and are masked out of every count and score downstream.

Supported alphabet types mirror the reference: STANDARD (ACGT) plus the
methylation-extended variants.  Extended alphabets are not
reverse-complement-closed in general; ``complement_code`` maps 5mC <-> G on
the opposite strand convention and is documented per-type.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Sentinel code for ambiguous letters (N etc.).  Stored as -1 in int8 code
# arrays; every kernel masks it.
AMBIG = -1

_TYPES = {
    # name: (letters, complements)
    "STANDARD": ("ACGT", "TGCA"),
    # 5mC on both strands: M = methylated C, its complement position holds G
    # (we encode the partner strand's methyl state only when the input uses
    # the paired-letter convention).  Not revcomp-closed; scanning with
    # --ss is recommended for extended alphabets.
    "METHYLC": ("ACGTM", "TGCAG"),
    "HYDROXYMETHYLC": ("ACGTMH", "TGCAGG"),
}


@dataclasses.dataclass(frozen=True)
class Alphabet:
    """Immutable alphabet with vectorized encode/decode tables."""

    name: str
    letters: str
    complements: str

    AMBIG = AMBIG

    @staticmethod
    def standard() -> "Alphabet":
        return Alphabet.from_type("STANDARD")

    @staticmethod
    def from_type(name: str) -> "Alphabet":
        if name not in _TYPES:
            raise ValueError(
                f"unknown alphabet type {name!r}; choose from {sorted(_TYPES)}"
            )
        letters, comps = _TYPES[name]
        return Alphabet(name=name, letters=letters, complements=comps)

    @property
    def size(self) -> int:
        """|A| — number of concrete letters (4 for STANDARD)."""
        return len(self.letters)

    # ------------------------------------------------------------------ #
    # host-side vectorized tables (numpy; built lazily, cached on self)
    # ------------------------------------------------------------------ #

    def _encode_table(self) -> np.ndarray:
        tab = np.full(256, AMBIG, dtype=np.int8)
        for i, c in enumerate(self.letters):
            tab[ord(c)] = i
            tab[ord(c.lower())] = i
        return tab

    def _complement_table(self) -> np.ndarray:
        tab = np.full(self.size, AMBIG, dtype=np.int8)
        for i, c in enumerate(self.complements):
            tab[i] = self.letters.index(c)
        return tab

    def encode(self, s: str | bytes) -> np.ndarray:
        """String -> int8 code array; unknown letters become AMBIG."""
        if isinstance(s, str):
            s = s.encode("ascii", errors="replace")
        raw = np.frombuffer(s, dtype=np.uint8)
        return self._encode_table()[raw]

    def decode(self, codes: np.ndarray) -> str:
        """int code array -> string; AMBIG renders as 'N'."""
        letters = np.array(list(self.letters + "N"))
        codes = np.asarray(codes)
        return "".join(letters[np.where(codes < 0, self.size, codes)])

    def complement_code(self, codes: np.ndarray) -> np.ndarray:
        """Elementwise complement of a code array (AMBIG stays AMBIG)."""
        codes = np.asarray(codes)
        tab = self._complement_table()
        out = np.where(codes >= 0, tab[np.clip(codes, 0, self.size - 1)], AMBIG)
        return out.astype(np.int8)

    def revcomp(self, codes: np.ndarray) -> np.ndarray:
        """Reverse complement along the last axis."""
        return self.complement_code(np.flip(codes, axis=-1))

    # ------------------------------------------------------------------ #
    # k-mer helpers (lexicographic encoding: oldest base most significant)
    # ------------------------------------------------------------------ #

    def kmer_to_index(self, kmer: str) -> int:
        idx = 0
        for c in kmer:
            code = int(self.encode(c)[0])
            if code < 0:
                raise ValueError(f"ambiguous base in k-mer {kmer!r}")
            idx = idx * self.size + code
        return idx

    def index_to_kmer(self, idx: int, k: int) -> str:
        out = []
        for _ in range(k):
            out.append(self.letters[idx % self.size])
            idx //= self.size
        return "".join(reversed(out))
