"""CPU tests of chip_smoke.py's parts at tiny size, on explicitly passed
CPU devices (the script itself refuses to run without a GPU)."""

import pathlib
import sys

import jax
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).parents[1]))

import chip_smoke  # noqa: E402
import lammps_user_conp2_tpu as pkg  # noqa: E402
from lammps_user_conp2_tpu.ops import pppm as pppm_ops  # noqa: E402
from lammps_user_conp2_tpu.utils.config import MDConfig  # noqa: E402


@pytest.fixture
def cpu():
    return jax.devices("cpu")[0]


def test_device_check_refuses_cpu(cpu):
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.require_gpu([cpu])
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main([])


@pytest.mark.parametrize("env", [None, "/some/shared/cache"])
def test_compile_cache_dir(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        root = pathlib.Path(pkg.__file__).resolve().parents[1]
        assert pkg.compile_cache_dir() == str(root / ".jax_cache")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
        assert pkg.compile_cache_dir() is None
        assert pkg.enable_compile_cache() is None


def test_tile_pair_path_raises():
    with pytest.raises(ValueError, match="pair_path"):
        MDConfig(pair_path="tile")


def test_cell_a_tiny(cpu):
    rep = chip_smoke.cell_a(cpu, cpu, steps=5, n_elyte=216, nele_side=5,
                            lz=40.0, lxy=16.0)
    assert rep["cell"] == "A" and rep["steps"] == 5
    assert rep["step0_dq_rel"] <= chip_smoke.STEP0_RTOL
    assert rep["traj_dq_final_rel"] <= chip_smoke.TRAJ_RTOL


def test_cell_b_tiny(cpu, monkeypatch):
    # the tiled mesh engages only at production mesh sizes: force it
    monkeypatch.setattr(pppm_ops, "_use_dense", lambda grid, n: False)
    rep = chip_smoke.cell_b(cpu, cpu, steps=30, n_elyte=320, nele_side=6,
                            lz=40.0, lxy=16.0)
    assert rep["cell"] == "B"
    assert rep["step0_df_rel"] <= chip_smoke.STEP0_RTOL


def test_shake_phase_interpret(cpu):
    (rep,) = chip_smoke.shake_phase(cpu, sizes=(130,), interpret=True)
    assert rep["clusters"] == 130
    assert rep["dx_rel"] <= chip_smoke.SHAKE_RTOL


def test_four_phase_virtual_devices():
    devices = jax.devices("cpu")[:4]
    assert len(devices) == 4
    rep = chip_smoke.four_phase(devices, steps=3, n_elyte=512, nele_side=6,
                                lz=40.0, lxy=20.0)
    assert rep["devices"] == 4
    assert rep["dq_rel"] <= chip_smoke.FOUR_RTOL
