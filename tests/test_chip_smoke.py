"""chip_smoke.py on the CPU: it refuses to run without a GPU, its oracle
comparison passes at a tiny size in f64, and its last line carries exactly
the contract's keys."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_exits_nonzero_and_names_the_missing_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PATH=str(tmp_path))
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         env=env, capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert out.returncode != 0
    assert "no GPU" in out.stdout
    assert '"ok"' not in out.stdout  # no result line


def test_env_phase_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.env_phase()


def test_oracle_parity_passes_on_cpu_f64(tmp_path):
    log = open(tmp_path / "engine.log", "w")
    res = chip_smoke.oracle_parity(str(tmp_path), n=120, m=200, iterations=3,
                                   dtype="float64", log=log)
    assert set(res["worst"]) >= {"alpha1", "gam2", "gamw", "x1"}
    assert max(res["worst"].values()) < 1e-6
    assert len(res["params"]) == 3


def test_result_line_has_exactly_the_contract_keys():
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    obj = json.loads(line)
    assert obj == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


def test_positional_csv_check_rejects_misplaced_rows(tmp_path):
    from vampomi_tpu.io.csv_writer import PositionalCSV

    path = str(tmp_path / "p.csv")
    c = PositionalCSV(path, ["iteration", "a", "b"])
    c.write_row(1, [1.5, -0.25])
    c.write_row(3, [2.0, 4.0])
    rows = chip_smoke.check_positional_csv(path)
    assert [r[0] for r in rows] == [1.0, 3.0]
    raw = bytearray(open(path, "rb").read())
    raw[-2:-1] = b"x"  # corrupt the last row
    open(path, "wb").write(bytes(raw))
    with pytest.raises(AssertionError, match="bad row"):
        chip_smoke.check_positional_csv(path)
