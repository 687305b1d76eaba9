"""chip_smoke.py on the CPU: it refuses to run without a GPU, and each
of its phases runs at a tiny size (the kernel through the Pallas
interpreter, the multi-card paths on four virtual devices)."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke
    return chip_smoke


def _phase_lines(capsys):
    return [json.loads(s) for s in capsys.readouterr().out.splitlines()
            if s.startswith("{")]


def test_chip_smoke_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "no GPU" in p.stderr


def test_bench_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, os.path.join(REPO, "bench.py")],
                       env=env, capture_output=True, text=True, timeout=300,
                       cwd=REPO)
    assert p.returncode != 0 and p.stdout == ""


def test_phase_device(smoke, monkeypatch, capsys):
    monkeypatch.setattr(smoke, "nvidia_smi",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    assert smoke.phase_device() == "NVIDIA H100 80GB HBM3, 700.00 W"
    (line,) = _phase_lines(capsys)
    assert line["phase"] == "device" and line["count"] >= 1
    assert line["nvidia_smi"].endswith("700.00 W")


def test_phase_scenario(smoke, capsys):
    smoke.phase_scenario(batch=256, oracle_lanes=16)
    (line,) = _phase_lines(capsys)
    assert line["oracle_flags_agree"] and line["certified_frac"] == 1.0
    assert line["engine"] == "xla"


def test_phase_kernel(smoke, capsys):
    smoke.phase_kernel(shapes=((29, 7, 70), (29, 16, 20), (32, 32, 8)),
                       reps=1, interpret=True)
    lines = _phase_lines(capsys)
    assert [ln["N"] for ln in lines] == [28, 64, 128]
    assert all(ln["same_certified_set"] for ln in lines[:2])
    assert lines[2]["fused"] == "not supported at this N"


def test_phase_closed_loop(smoke, capsys):
    smoke.phase_closed_loop(steps=4,
                            horizons={"condensed": 8, "stagewise": 16})
    lines = _phase_lines(capsys)
    assert [ln["backend"] for ln in lines] == ["condensed", "stagewise"]
    assert all(ln["certified_frac"] == 1.0 and ln["finite"] for ln in lines)


def test_phase_large_n(smoke, capsys):
    smoke.phase_large_n(N=128, M=32, B=4)
    (line,) = _phase_lines(capsys)
    assert line["f32_certified"] == line["mixed_certified"] == 4


def test_phase_serve(smoke, capsys):
    smoke.phase_serve(gen_dims=(8, 24))
    (line,) = _phase_lines(capsys)
    assert line["replies"] == 3 and line["errors"] == []


def test_phase_four_on_virtual_devices(smoke, capsys):
    import jax
    assert len(jax.devices()) >= 4
    smoke.phase_four(n_dev=4, batch_per_card=16, N=64, M=16, B=4)
    lines = _phase_lines(capsys)
    assert [ln["phase"] for ln in lines] == [
        "four_data_parallel", "four_row_sharded", "four_row_sharded"]
    assert len(lines[0]["u_devices"]) == 4
    assert lines[0]["same_flags_and_iters"]
