"""Multi-host bring-up: jax.distributed + automatic mesh construction.

The reference has no distributed runtime (single-process OpenMP,
SURVEY.md 2.1).  Here multi-host is first-class: every host runs the same
CLI command; ``initialize()`` wires the JAX coordination service from
JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID, after which
``jax.devices()`` spans every host's GPUs and the ('data', 'seed') mesh in
``parallel.mesh`` shards sequences across them with one count all-reduce
per EM iteration (NCCL on GPUs).  On one host with several GPUs no
launch variables are needed: one process drives all of its devices.

Input sharding: each host loads the full FASTA (host RAM is not the
bottleneck for <=100k sequences) and lays down only its addressable shards
(``parallel.mesh`` uses jax.make_array_from_callback when
process_count > 1); outputs are gathered implicitly because the model
tensors are replicated.

CPU multi-process (the hermetic test path, tests/test_multiprocess.py)
needs the gloo cross-process collective backend; ``initialize`` turns it
on before the first backend touch.
"""

from __future__ import annotations

import os

import jax

_initialized = False


def initialize(force: bool = False) -> bool:
    """Initialize jax.distributed when running under a multi-process launch.

    Returns True if distributed mode is active.  Safe to call always: a
    launch without JAX_COORDINATOR_ADDRESS/JAX_NUM_PROCESSES (and without
    ``force``) is treated as single-process and nothing is touched.

    Must run BEFORE anything initializes the JAX backends — probing
    ``jax.process_count()`` first would itself create the backends and
    make ``jax.distributed.initialize`` fail, so the env vars alone decide
    whether to initialize.
    """
    global _initialized
    coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = os.environ.get("JAX_NUM_PROCESSES")
    if not (force or (coord and nproc)):
        return False  # single-process launch: don't touch the backends
    if not _initialized:
        # cross-process collectives on the CPU backend (the multi-process
        # tests) need gloo; GPU collectives are unaffected
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
        kwargs = {}
        if coord:
            kwargs = dict(
                coordinator_address=coord,
                num_processes=int(nproc),
                process_id=int(os.environ.get("JAX_PROCESS_ID", "0")),
            )
        if not jax.distributed.is_initialized():  # a launcher may have
            jax.distributed.initialize(**kwargs)
        _initialized = True
    return jax.process_count() > 1


def auto_mesh(n_seeds: int = 1):
    """Mesh over all devices: seed axis as wide as useful, rest data.

    The seed axis never exceeds the seed count (extra devices do more
    data-parallel work instead); it also must divide the device count.
    """
    from bammmotif2_tpu.parallel import mesh as mesh_mod

    n_dev = jax.device_count()
    if n_dev == 1:
        return None
    n_seed_axis = 1
    for cand in range(min(n_seeds, n_dev), 0, -1):
        if n_dev % cand == 0:
            n_seed_axis = cand
            break
    return mesh_mod.make_mesh(n_data=n_dev // n_seed_axis, n_seed=n_seed_axis)
