"""chip_smoke.py's phases, rehearsed on the CPU at tiny sizes, plus the
same parity check on a GPU where one is visible (marker ``gpu``)."""

import json
import os

import jax
import pytest

import chip_smoke
from bammmotif2_tpu import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_device_phase_refuses_cpu():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.phase_device()


def test_main_on_cpu_fails_without_result(capsys):
    old = jax.config.jax_platforms
    try:
        with pytest.raises(RuntimeError, match="needs a GPU"):
            chip_smoke.main([])
    finally:
        jax.config.update("jax_platforms", old)
    assert '"ok"' not in capsys.readouterr().out


def test_cache_dir_from_environment(monkeypatch, tmp_path):
    updates = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax.config, "update", lambda *a: updates.append(a))
    cli._enable_compilation_cache()
    assert updates == []  # JAX reads the variable itself
    assert cli.compilation_cache_dir() == str(tmp_path)


def test_cache_dir_in_checkout_without_environment(monkeypatch):
    updates = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update", lambda *a: updates.append(a))
    cli._enable_compilation_cache()
    assert updates == [("jax_compilation_cache_dir", cli.CACHE_DIR)]
    assert cli.compilation_cache_dir() == cli.CACHE_DIR
    assert cli.CACHE_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


@pytest.mark.parametrize("argv,phases", [
    ([], ["device", "parity", "pipeline"]),
    (["--four-cards"], ["device", "four_cards"]),
])
def test_phase_selection(argv, phases):
    assert chip_smoke.select_phases(argv) == phases


def test_result_line_shape():
    line = chip_smoke.result_line(
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
         "card": "NVIDIA H100 80GB HBM3, 700.00 W"}
    )
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1


def test_parity_phase_cpu_rehearsal(capsys):
    chip_smoke.phase_parity(n_seqs=120, seq_len=40, orders=(0, 3),
                            n_ref=16, width=8, dev=jax.devices("cpu")[0])
    assert "FAIL" not in capsys.readouterr().out


def test_pipeline_phase_cpu_rehearsal(tmp_path, capsys):
    chip_smoke.phase_pipeline(str(tmp_path), "cpu", n_seqs=600, seq_len=60,
                              n_scan=3000, n_seeds=4)
    assert "FAIL" not in capsys.readouterr().out


def test_four_cards_phase_cpu_rehearsal(tmp_path, capsys):
    chip_smoke.phase_four_cards(str(tmp_path), n_devices=4, n_seqs=300,
                                seq_len=50, n_seeds=4, n_iters=30)
    out = capsys.readouterr().out
    assert "FAIL" not in out and "mesh {'data': 8, 'seed': 1}" in out


@pytest.mark.gpu
def test_parity_phase_on_gpu(gpu_device, capsys):
    chip_smoke.phase_parity(n_seqs=2000, dev=gpu_device)
    assert "FAIL" not in capsys.readouterr().out
