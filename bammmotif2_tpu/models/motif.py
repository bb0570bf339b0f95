"""Inhomogeneous Bayesian Markov motif model (the BaMM).

JAX equivalent of ``src/init/Motif.{h,cpp}``.  State per motif
position j = 0..W-1 and order k = 0..K:

    v[k] : conditional probs, shape [|A|^(k+1), W]   (lexicographic k-mers,
           oldest base most significant — matches ops.encode)
    n[k] : fractional counts, same shape
    alphas : pseudo-count strengths, shape [K+1, W]
             (defaults alpha_0, beta*gamma^(k-1); learned only by CGS)

The interpolated pseudo-count estimator (Siebert & Soeding 2016 eq. 4-6;
``Motif::calculateV``; SURVEY.md 2.9):

    v_j^(k)(y) = ( n_j^(k)(y) + alpha_k(j) * v_j^(k-1)(y') )
               / ( ctx_j^(k)(x) + alpha_k(j) )

with y' = y minus oldest base, x = y minus newest base, and context counts
ctx_j(x) = sum_a n_j^(k)(x.a) (keeps every conditional row normalized).
Base case: v_j^(0)(a) = (n_j^(0)(a) + alpha_0 * f_bg(a)) / (N_j + alpha_0)
with f_bg the positive set's mono-nucleotide frequencies.

The update runs in jnp so an entire EM iteration jits into one program;
the host-side ``Motif`` class wraps state, seeding and the ``.ihbcp`` /
``.ihbp`` text formats (the interchange AND checkpoint format —
``Motif::write`` / ``initFromBaMM``).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from bammmotif2_tpu.ops import encode
from bammmotif2_tpu.utils.alphabet import Alphabet

_FLOAT_FMT = "%.4e"


# ---------------------------------------------------------------------- #
# device-side model math (pure jnp; tuples keyed by static order K)
# ---------------------------------------------------------------------- #


def counts_from_combined(C: jnp.ndarray, A: int, K: int) -> tuple:
    """Split combined count rows [R(+1), W] into per-order count tensors.

    Order-k totals = direct counts at truncated positions of exactly order k
    + marginalization over the oldest base of order-(k+1) counts.
    """
    off = encode.order_offsets(A, K)
    direct = [C[off[k] : off[k + 1]] for k in range(K + 1)]
    out = [None] * (K + 1)
    out[K] = direct[K]
    for k in range(K - 1, -1, -1):
        W = C.shape[1]
        out[k] = direct[k] + out[k + 1].reshape(A, -1, W).sum(axis=0)
    return tuple(out)


def update_v(counts: tuple, alphas: jnp.ndarray, f_bg: jnp.ndarray) -> tuple:
    """The interpolated pseudo-count estimator, all orders (calculateV)."""
    K = len(counts) - 1
    A = f_bg.shape[0]
    n0 = counts[0]
    a0 = alphas[0][None, :]
    N_j = n0.sum(axis=0, keepdims=True)
    v = [(n0 + a0 * f_bg[:, None]) / (N_j + a0)]
    for k in range(1, K + 1):
        nk = counts[k]
        ak = alphas[k][None, :]
        W = nk.shape[1]
        ctx = nk.reshape(-1, A, W).sum(axis=1)  # [A^k, W]
        denom = jnp.repeat(ctx, A, axis=0) + ak
        y = jnp.arange(nk.shape[0])
        lower = v[k - 1][y % (A ** k)]
        v.append((nk + ak * lower) / denom)
    return tuple(v)


def combined_v(v: tuple) -> jnp.ndarray:
    """Stack per-order conditionals into the combined LUT [R, W]."""
    return jnp.concatenate(v, axis=0)


def log_odds_lut(v: tuple, bg_flat: jnp.ndarray) -> jnp.ndarray:
    """s_flat [R+1, W]: log(v / v_bg) per combined row + zero sentinel row.

    Parity: ``Motif::calculateLogS`` / ``EM``'s score LUT ``s_[y][j]``.
    bg_flat: [R] background conditional per combined row
    (``BackgroundModel.conditional_flat``).
    """
    vf = combined_v(v)
    s = jnp.log(vf) - jnp.log(bg_flat)[:, None]
    return jnp.concatenate([s, jnp.zeros((1, s.shape[1]), s.dtype)], axis=0)


@functools.partial(jax.jit, static_argnames=("A", "K"))
def update_v_from_combined(C, alphas, f_bg, *, A: int, K: int) -> tuple:
    """calculateV directly from M-step output C [R+1, W] (sentinel row last)."""
    return update_v(counts_from_combined(C[: encode.num_rows(A, K)], A, K), alphas, f_bg)


# ---------------------------------------------------------------------- #
# host-side Motif
# ---------------------------------------------------------------------- #


class Motif:
    def __init__(
        self,
        W: int,
        K: int,
        v: list,
        alphas: np.ndarray,
        f_bg: np.ndarray,
        alphabet: Alphabet | None = None,
        name: str = "motif",
        counts: list | None = None,
    ):
        self.W = int(W)
        self.K = int(K)
        self.alphabet = alphabet or Alphabet.standard()
        A = self.alphabet.size
        self.v = [np.asarray(vk, np.float64).reshape(A ** (k + 1), W) for k, vk in enumerate(v)]
        self.alphas = np.asarray(alphas, np.float64).reshape(K + 1, W)
        self.f_bg = np.asarray(f_bg, np.float64).reshape(A)
        self.name = name
        self.counts = counts

    @property
    def A(self) -> int:
        return self.alphabet.size

    def copy(self) -> "Motif":
        return Motif(
            self.W,
            self.K,
            [vk.copy() for vk in self.v],
            self.alphas.copy(),
            self.f_bg.copy(),
            self.alphabet,
            self.name,
            counts=(
                [c.copy() for c in self.counts]
                if self.counts is not None
                else None
            ),
        )

    @staticmethod
    def default_alphas(K: int, W: int, alpha0: float = 1.0, beta: float = 7.0, gamma: float = 3.0) -> np.ndarray:
        """alpha_0 = alpha0; alpha_k = beta * gamma^(k-1) (SURVEY.md 2.9)."""
        rows = [np.full(W, alpha0 if k == 0 else beta * gamma ** (k - 1)) for k in range(K + 1)]
        return np.stack(rows)

    # ------------------------------------------------------------------ #
    # derived
    # ------------------------------------------------------------------ #

    def set_v_from_counts(self, counts: list) -> None:
        v = update_v(
            tuple(jnp.asarray(c) for c in counts),
            jnp.asarray(self.alphas),
            jnp.asarray(self.f_bg),
        )
        self.v = [np.asarray(vk, np.float64) for vk in v]
        self.counts = [np.asarray(c, np.float64) for c in counts]

    def pwm(self) -> np.ndarray:
        """Order-0 view [W, A] (rows = positions)."""
        return self.v[0].T.copy()

    def full_probs(self) -> list:
        """p^(k)[y, j] for .ihbp: chain rule within the motif window.

        p^(0) = v^(0); for k >= 1 and j >= 1:
        p^(k)[y, j] = v^(k)[y, j] * p^(k-1)[y div A, j-1]; at j = 0 the
        (unobservable) left context is taken uniform: p^(k)[y, 0] =
        v^(k)[y, 0] / A^k.  (Reference's exact j<k convention could not be
        verified — mount empty; documented deviation.)
        """
        A = self.A
        p = [self.v[0].copy()]
        for k in range(1, self.K + 1):
            vk = self.v[k]
            pk = np.empty_like(vk)
            pk[:, 0] = vk[:, 0] / (A ** k)
            prefix = np.repeat(p[k - 1][:, :-1], A, axis=0)  # p^(k-1)[y div A, j-1]
            pk[:, 1:] = vk[:, 1:] * prefix
            p.append(pk)
        return p

    # ------------------------------------------------------------------ #
    # file IO: .ihbcp (conditionals) / .ihbp (full probs)
    # ------------------------------------------------------------------ #

    def write(self, outdir: str, basename: str | None = None) -> tuple:
        """Write .ihbcp + .ihbp. Blocks = positions (blank-line separated);
        each block has K+1 lines, line k holding |A|^(k+1) probabilities in
        lexicographic k-mer order. Parity: ``Motif::write``.

        ``#`` header lines carry order/width/alphabet metadata (mirroring
        the ``.hbcp`` background header); all readers — ours and the
        reference's — skip ``#`` lines, so headered files stay
        interchange-compatible."""
        base = basename or self.name
        os.makedirs(outdir, exist_ok=True)
        header = [
            f"# W = {self.W}",
            f"# K = {self.K}",
            f"# alphabet = {self.alphabet.name}",
        ]
        p_cond = os.path.join(outdir, base + ".ihbcp")
        p_full = os.path.join(outdir, base + ".ihbp")
        _write_position_blocks(p_cond, self.v, self.W, header)
        _write_position_blocks(p_full, self.full_probs(), self.W, header)
        return p_cond, p_full

    @staticmethod
    def read(
        path: str,
        f_bg: np.ndarray | None = None,
        alphas: np.ndarray | None = None,
        alphabet: Alphabet | None = None,
    ) -> "Motif":
        """Init from a saved BaMM (.ihbcp) — ``Motif::initFromBaMM``; a
        saved model re-loaded this way is the resume/checkpoint path.
        When no explicit ``alphabet`` is passed, the '# alphabet =' header
        that Motif.write emits is honored (extended-alphabet round-trips
        would otherwise fail against the STANDARD default)."""
        if alphabet is None:
            with open(path) as fh:
                for line in fh:
                    s = line.strip()
                    if not s.startswith("#"):
                        break
                    body = s.lstrip("#").strip()
                    if "=" in body:
                        key, val = (t.strip() for t in body.split("=", 1))
                        if key.lower() == "alphabet":
                            alphabet = Alphabet.from_type(val)
        alphabet = alphabet or Alphabet.standard()
        A = alphabet.size
        blocks = _read_position_blocks(path)
        W = len(blocks)
        if W == 0:
            raise ValueError(f"{path}: no position blocks found")
        K = len(blocks[0]) - 1
        v = []
        for k in range(K + 1):
            rows = []
            for j, block in enumerate(blocks):
                if len(block) != K + 1:
                    raise ValueError(f"{path}: position {j} has {len(block)} orders, want {K + 1}")
                if block[k].size != A ** (k + 1):
                    raise ValueError(
                        f"{path}: position {j} order {k} has {block[k].size} values"
                    )
                rows.append(block[k])
            v.append(np.stack(rows, axis=1))  # [A^(k+1), W]
        if alphas is None:
            alphas = Motif.default_alphas(K, W)
        if f_bg is None:
            f_bg = np.full(A, 1.0 / A)
        name = os.path.basename(path)
        for suffix in (".ihbcp",):
            if name.endswith(suffix):
                name = name[: -len(suffix)]
        return Motif(W, K, v, alphas, f_bg, alphabet, name=name)


def _write_position_blocks(
    path: str, tables: list, W: int, header: list | None = None
) -> None:
    with open(path, "w") as fh:
        for line in header or ():
            fh.write(line + "\n")
        if header:
            fh.write("\n")
        for j in range(W):
            for tab in tables:
                fh.write(" ".join(_FLOAT_FMT % x for x in tab[:, j]) + "\n")
            fh.write("\n")


def _read_position_blocks(path: str) -> list:
    blocks, cur = [], []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith("#"):
                continue
            if not line:
                if cur:
                    blocks.append(cur)
                    cur = []
                continue
            cur.append(np.array([float(x) for x in line.split()]))
    if cur:
        blocks.append(cur)
    return blocks
