"""Device-mesh sharding for multi-chip / multi-host scaling.

The reference is a single-process OpenMP tool (SURVEY.md 2.1); here the
sequence set is sharded over a ``data`` mesh axis, the (tiny) motif +
background models are replicated, and the one collective per EM iteration
is the all-reduce of the combined count tensor — inserted automatically by
GSPMD because the segment-sum reduces over the sharded sequence axis.  A
second ``seed`` axis shards independent seed motifs (the device analogue
of the reference's OpenMP-over-motifs driver loop, done with sharding
instead of threads).

Multi-host entry: call ``jax.distributed.initialize()`` before building the
mesh; everything below is host-count agnostic.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_data: int | None = None, n_seed: int = 1, devices=None) -> Mesh:
    """Build a ('data', 'seed') mesh over the available devices.

    With n_seed=1 this degrades to pure data parallelism; a single device
    yields a (1, 1) mesh so all code paths are mesh-agnostic.
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    total = devices.size
    if n_data is None:
        n_data = total // n_seed
    if n_data * n_seed != total:
        raise ValueError(f"mesh {n_data}x{n_seed} != {total} devices")
    return Mesh(devices.reshape(n_data, n_seed), ("data", "seed"))


def _put(x, sharding: NamedSharding):
    """Multi-process-safe device placement.

    ``jax.device_put`` only works when every device of the sharding is
    addressable; across processes each host instead lays down just ITS
    shards via make_array_from_callback (every host holds the full array —
    hosts load the whole FASTA, see parallel.distributed docstring).
    """
    if jax.process_count() > 1:
        xh = np.asarray(x)
        return jax.make_array_from_callback(
            xh.shape, sharding, lambda idx: xh[idx]
        )
    return jax.device_put(x, sharding)


def shard_em_data(mesh: Mesh, data: dict, sentinel: int) -> dict:
    """Shard a prepare_data() dict: the index tensor + lens over 'data',
    bg_flat replicated.  Pads N so GSPMD partitions evenly; pad
    sequences have length 0 and all-invalid positions."""
    import jax.numpy as jnp

    n_data = mesh.shape["data"]
    S, N, L = data["cidx"].shape
    pad = (-N) % n_data
    cidx, lens = data["cidx"], data["lens"]
    if pad:
        cidx = jnp.concatenate(
            [cidx, jnp.full((S, pad, L), sentinel, cidx.dtype)], axis=1
        )
        lens = jnp.concatenate([lens, jnp.zeros((pad,), lens.dtype)])
    seq_sh = NamedSharding(mesh, P(None, "data", None))
    rep = NamedSharding(mesh, P())
    return {
        "cidx": _put(cidx, seq_sh),
        "lens": _put(lens, NamedSharding(mesh, P("data"))),
        "bg_flat": _put(data["bg_flat"], rep),
    }


def replicate(mesh: Mesh, tree):
    """Replicate a pytree (model state) across the whole mesh."""
    rep = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: _put(x, rep), tree)


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int, fill) -> np.ndarray:
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=fill)
