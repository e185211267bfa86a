"""The reference's probe-potential rerun workflow, composed end-to-end
(tests/il_onelayer/input_rerun_comp_test:42-74):

  1. run the il_onelayer conq+pppm deck and dump positions+charges,
  2. rerun the dumped trajectory with a PINNED gewald (0.35) and regenerate
     the electrode charges from positions alone,
  3. place probe atoms at the cell midplane (z=0, the slab gap) and read
     ``compute potential/atom`` at the probes and electrodes,
  4. assert consistency: rerun charges match the dumped ones, probe
     potentials agree with each other, and the electrode potential gap
     equals the fix scalar (the conq-required voltage).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from lammps_user_conp2_tpu import workloads
from lammps_user_conp2_tpu.models.conp import setup_conp
from lammps_user_conp2_tpu.models.diagnostics import potential_atom
from lammps_user_conp2_tpu.models.md import build_engine
from lammps_user_conp2_tpu.utils import dump as dumpio

pytestmark = pytest.mark.usefixtures("ref_decks")

pytestmark = pytest.mark.slow

GEW = 0.35  # the deck's kspace_modify gewald pin


def test_rerun_probe_potential_consistency(tmp_path):
    system, md, cfg = workloads.il_onelayer(2)      # conq + pppm (sol2.traj)
    solver = setup_conp(system, md, cfg, g_ewald=GEW)
    assert abs(solver.ksp.g_ewald - GEW) < 1e-12
    eng = build_engine(system, md, solver)

    # --- 1. short run, dumping positions + charges each step -------------
    st = eng.init_state()
    traj = tmp_path / "sol2.traj"
    with open(traj, "w") as f:
        for _ in range(2):
            st = eng.step(st)
            dumpio.write_dump_frame(
                f, int(st.step), system.natoms, system.box_lo,
                np.asarray(system.box_lo) + np.asarray(system.box),
                system.tag, np.asarray(st.x), q=np.asarray(st.q))
    q_final = np.asarray(st.q)
    scalar = float(st.scalar_out)

    # --- 2. rerun: regenerate charges from dumped positions --------------
    frames = dumpio.read_dump(str(traj))
    assert len(frames) == 2
    out = dumpio.rerun_charges(solver, frames, system.q0, tags=system.tag)
    _, q_re, fe_re = out[-1]
    # dump format carries 8 significant digits; charges are O(1e-2) e
    np.testing.assert_allclose(np.asarray(q_re)[system.ele_mask],
                               q_final[system.ele_mask], atol=5e-6)
    assert abs(float(fe_re) - scalar) < 1e-5

    # --- 3. probes at the cell midplane (z=0, boundary p p f) ------------
    lx, ly = system.box[0], system.box[1]
    zlo = system.box_lo[2]
    probes = np.array([
        [lx / 2, ly / 2, zlo],
        [lx / 2 + 0.01, ly / 2, zlo],
        [lx / 2, ly / 2 + 0.01, zlo],
        [lx / 2 + 0.01, ly / 2 + 0.01, zlo],
    ])
    xp = np.concatenate([np.asarray(st.x), probes], axis=0)
    qp = np.concatenate([q_final, np.zeros(4)])
    elecheck = np.concatenate([np.asarray(system.elecheck), np.zeros(4, int)])
    group = np.zeros(len(xp), bool)
    group[system.natoms:] = True           # probes
    group |= np.concatenate([system.ele_mask, np.zeros(4, bool)])

    pot = np.asarray(potential_atom(
        jnp.asarray(xp), jnp.asarray(qp),
        group_mask=group, elecheck=jnp.asarray(elecheck),
        box=system.box, periodic=system.periodic, cutoff=md.cutoff,
        g_ewald=GEW, evscale=solver.evscale, volume=solver.ksp.volume,
        eta=cfg.eta, slabflag=solver.ksp.slabflag,
        pppm_grid=solver.pppm_grid))

    # --- 4. consistency oracles ------------------------------------------
    ppro = pot[system.natoms:]
    assert np.isfinite(ppro).all()
    # four probes 0.01 A apart read the same field
    assert ppro.max() - ppro.min() < 1e-3, ppro
    # electrode potential gap == the conq fix scalar (required voltage)
    pl = pot[:system.natoms][system.ele_left_mask]
    pr = pot[:system.natoms][system.ele_right_mask]
    assert pl.std() < 5e-3 and pr.std() < 5e-3
    assert abs((pr.mean() - pl.mean()) - scalar) < 5e-3
