"""Checkpoint/resume bit-exactness and rerun determinism (the reference's
N=7 rerun trials: charges regenerate from dumped positions,
tests/il_onelayer/input:131-135)."""

import io

import jax
import jax.numpy as jnp
import numpy as np

from lammps_user_conp2_tpu import workloads
from lammps_user_conp2_tpu.models.conp import setup_conp
from lammps_user_conp2_tpu.models.md import build_engine
from lammps_user_conp2_tpu.utils import dump
from lammps_user_conp2_tpu.utils.checkpoint import load_checkpoint, save_checkpoint
import pytest

pytestmark = pytest.mark.usefixtures("ref_decks")


def test_checkpoint_roundtrip_bit_exact(tmp_path):
    system, md, cfg = workloads.dilute(0)
    solver = setup_conp(system, md, cfg)
    eng = build_engine(system, md, solver)
    st = eng.init_state()
    mid, _ = eng.run(st, 5)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, eng, mid)
    restored = load_checkpoint(path, eng)
    # continue both 5 more steps: identical trajectories
    a, _ = eng.run(mid, 5)
    b, _ = eng.run(restored, 5)
    np.testing.assert_array_equal(np.asarray(a.x), np.asarray(b.x))
    np.testing.assert_array_equal(np.asarray(a.q), np.asarray(b.q))
    np.testing.assert_array_equal(np.asarray(a.nhc_vxi), np.asarray(b.nhc_vxi))


def test_checkpoint_rejects_mismatched_setup(tmp_path):
    system, md, cfg = workloads.dilute(0)
    solver = setup_conp(system, md, cfg)
    eng = build_engine(system, md, solver)
    st = eng.init_state()
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, eng, st)
    import dataclasses
    md2 = dataclasses.replace(md, dt=2.0)
    eng2 = build_engine(system, md2, setup_conp(system, md2, cfg))
    import pytest
    with pytest.raises(ValueError):
        load_checkpoint(path, eng2)


def test_rerun_reproduces_trajectory_charges(tmp_path):
    """Dump a short trajectory with charges, rerun from positions only, and
    check the re-solved charges match the dumped ones."""
    system, md, cfg = workloads.dilute(2)   # ffield, like the rerun trials
    solver = setup_conp(system, md, cfg)
    eng = build_engine(system, md, solver)
    st = eng.init_state()
    frames = []
    path = str(tmp_path / "sol.traj")
    with open(path, "w") as f:
        for k in range(3):
            st = jax.jit(eng.step)(st)
            dump.write_dump_frame(f, int(st.step), system.natoms,
                                  system.box_lo, system.box_hi, system.tag,
                                  np.asarray(st.x), np.asarray(st.q))
    frames = dump.read_dump(path)
    assert len(frames) == 3
    out = dump.rerun_charges(solver, frames, system.q0, tags=system.tag)
    for (step, tags, cols), (_, qn, _) in zip(frames, out):
        # frame columns are tag-sorted (read_dump); qn is in SYSTEM order,
        # which differs under the electrodes-first reorder — map via tags
        pos = np.searchsorted(tags, np.asarray(system.tag))
        np.testing.assert_allclose(qn[system.ele_mask],
                                   cols["q"][pos][system.ele_mask],
                                   atol=2e-7)  # dump format: 8 significant digits
