"""Subprocess worker for the 2-process distributed test.

Launched by tests/test_multiprocess.py as

    python tests/mp_worker.py <pid> <nproc> <port> <out.npz>

Each process brings up jax.distributed through the framework's own entry
point (parallel.distributed.initialize), builds the SAME deterministic
planted sequence set, and runs EM over a mesh spanning BOTH processes
(2 local CPU devices each -> 4 global).  Process 0 writes the refined
model + diagnostics for the parent to compare against a single-process
run.
"""

import os
import sys

pid, nproc, port, out_path = (
    int(sys.argv[1]),
    int(sys.argv[2]),
    sys.argv[3],
    sys.argv[4],
)
# env BEFORE the jax backend initializes (the framework reads these)
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_COORDINATOR_ADDRESS"] = f"localhost:{port}"
os.environ["JAX_NUM_PROCESSES"] = str(nproc)
os.environ["JAX_PROCESS_ID"] = str(pid)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)

from bammmotif2_tpu.parallel import distributed  # noqa: E402

assert distributed.initialize(), "distributed bring-up failed"
assert jax.process_count() == nproc, jax.process_count()
assert jax.device_count() == 2 * nproc, jax.device_count()

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_em import planted_set  # noqa: E402

from bammmotif2_tpu.models import seeds as seeds_mod  # noqa: E402
from bammmotif2_tpu.models.background import BackgroundModel  # noqa: E402
from bammmotif2_tpu.refinement.em import run_em  # noqa: E402
from bammmotif2_tpu.utils.config import Params  # noqa: E402

sset = planted_set(n=90, l=50, motif="TGACTCAG", q=0.8, seed=3, noise=0.05)
bg = BackgroundModel.from_sequence_set(sset, order=2)
m = seeds_mod.motif_from_pwm(
    seeds_mod.iupac_to_pwm("TGACTCAG", soft=0.6), K=2,
    f_bg=sset.base_frequencies(),
)
params = Params(EM=True, q=0.5, maxEMIterations=25)
mesh = distributed.auto_mesh(n_seeds=1)
assert mesh is not None and mesh.shape["data"] == 2 * nproc
res = run_em(m, bg, sset, params, mesh=mesh)

if pid == 0:
    np.savez(
        out_path,
        ll=res.ll,
        q=res.q,
        iterations=res.iterations,
        **{f"v{k}": m.v[k] for k in range(m.K + 1)},
    )
print(f"worker {pid}: ok iters={res.iterations} ll={res.ll:.4f}", flush=True)
