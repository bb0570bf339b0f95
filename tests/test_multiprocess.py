"""REAL multi-process distributed execution (2 processes, CPU, gloo).

SURVEY.md 2.1 comm row / 4 point 3: the multi-host path must be exercised
with process_count > 1, not only with virtual devices in one process.
Two subprocesses each own 2 virtual CPU devices; jax.distributed wires
them into one 4-device platform; EM runs sharded over a mesh spanning
both processes and must match a single-process run on the same data.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS_DIR)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_em_matches_single_process(tmp_path):
    # bounded by the workers' communicate(timeout=480) below
    port = _free_port()
    out = tmp_path / "mp_result.npz"
    env = {
        k: v
        for k, v in os.environ.items()
        # hermetic: the worker sets its own JAX/backend env
        if not k.startswith(("JAX_", "XLA_"))
    }
    env["PYTHONPATH"] = REPO
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(TESTS_DIR, "mp_worker.py"),
             str(pid), "2", str(port), str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=480)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process worker timed out")
        logs.append(stdout)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"
    assert out.exists(), logs[0][-2000:]
    mp = np.load(out)

    # single-process reference on the same deterministic data
    sys.path.insert(0, TESTS_DIR)
    from test_em import planted_set

    from bammmotif2_tpu.models import seeds as seeds_mod
    from bammmotif2_tpu.models.background import BackgroundModel
    from bammmotif2_tpu.refinement.em import run_em
    from bammmotif2_tpu.utils.config import Params

    sset = planted_set(n=90, l=50, motif="TGACTCAG", q=0.8, seed=3, noise=0.05)
    bg = BackgroundModel.from_sequence_set(sset, order=2)
    m = seeds_mod.motif_from_pwm(
        seeds_mod.iupac_to_pwm("TGACTCAG", soft=0.6), K=2,
        f_bg=sset.base_frequencies(),
    )
    res = run_em(
        m, bg, sset, Params(EM=True, q=0.5, maxEMIterations=25)
    )

    assert int(mp["iterations"]) == res.iterations
    assert float(mp["ll"]) == pytest.approx(res.ll, rel=1e-4)
    assert float(mp["q"]) == pytest.approx(res.q, rel=1e-4)
    for k in range(m.K + 1):
        np.testing.assert_allclose(mp[f"v{k}"], m.v[k], rtol=2e-4, atol=1e-6)
