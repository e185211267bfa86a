"""CLI smoke tests (run / rerun / compare / profile plumbing)."""

import subprocess
import sys
import pytest

pytestmark = pytest.mark.usefixtures("ref_decks")


def run_cli(args, cwd=None):
    return subprocess.run(
        [sys.executable, "-m", "lammps_user_conp2_tpu"] + args,
        capture_output=True, text=True, timeout=900,
        env={"JAX_PLATFORMS": "cpu", "JAX_PLATFORM_NAME": "cpu",
             "PATH": "/usr/bin:/bin:/usr/local/bin",
             "PYTHONPATH": ".", "HOME": "/root"},
        cwd=cwd)


def test_cli_run_and_compare(tmp_path):
    log1 = str(tmp_path / "log1")
    r = run_cli(["run", "dilute", "0", "--steps", "4", "--thermo", "2",
                 "--log", log1])
    assert r.returncode == 0, r.stderr[-2000:]
    body = open(log1).read()
    assert "Step Temp" in body and "Loop time" in body
    r2 = run_cli(["compare", log1, log1, "--column", "c_qleft"])
    assert r2.returncode == 0
    assert "max|diff|=0.000e+00" in r2.stdout


def test_cli_rerun(tmp_path):
    traj = str(tmp_path / "t.traj")
    r = run_cli(["run", "dilute", "2", "--steps", "2", "--thermo", "2",
                 "--dump", traj, "--log", str(tmp_path / "l")])
    assert r.returncode == 0, r.stderr[-2000:]
    r2 = run_cli(["rerun", "dilute", "2", traj])
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "c_qleft" in r2.stdout
