"""End-to-end oracles on the dilute workload (432 atoms, tests/dilute).

The reference records a run in tests/dilute/persist.log: step-0 charges are
deterministic given the data file, so they anchor absolute parity; the
temperature trajectory over the first steps validates the whole force +
integrator substrate (identical initial conditions, chaos not yet grown).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from lammps_user_conp2_tpu import workloads
from lammps_user_conp2_tpu.models.conp import setup_conp
from lammps_user_conp2_tpu.models.electrodes import assemble_amatrix
from lammps_user_conp2_tpu.models.md import build_engine

pytestmark = pytest.mark.usefixtures("ref_decks")

REF_QLEFT_STEP0 = 0.044057154     # tests/dilute/persist.log step 0
REF_TEMP_STEP20 = 1009.3219       # tests/dilute/persist.log step 20
REF_TEMPSL_STEP20 = 1820.1579


@pytest.fixture(scope="module")
def dilute0():
    system, md, cfg = workloads.dilute(0)
    solver = setup_conp(system, md, cfg)
    return system, md, cfg, solver


def test_amatrix_properties(dilute0):
    system, md, cfg, solver = dilute0
    ele_idx = solver.ele_idx
    xe = jnp.asarray(system.x0[ele_idx])
    a = assemble_amatrix(
        xe, jnp.asarray(system.type[ele_idx]),
        solver.kernels.self_diag[ele_idx], solver.ksp, solver.kernels,
        box=system.box, periodic=system.periodic, cut_coulsq=solver.cut_coulsq)
    a = np.asarray(a)
    # symmetric
    np.testing.assert_allclose(a, a.T, atol=1e-12)
    # positive definite
    w = np.linalg.eigvalsh(a)
    assert w.min() > 0
    # projected inverse annihilates the uniform vector
    ainv = np.asarray(solver.ctx.ainv)
    assert np.abs(ainv @ np.ones(len(a))).max() < 1e-10
    # projector idempotence: projecting again changes nothing
    e = ainv.sum(axis=1)
    tot = e.sum()
    assert abs(tot) < 1e-10


def test_step0_charges_match_reference(dilute0):
    system, md, cfg, solver = dilute0
    q, scal = solver.solve(jnp.asarray(system.x0), jnp.asarray(system.q0), 0)
    qleft = float(q[system.ele_left_mask].sum())
    qright = float(q[system.ele_right_mask].sum())
    assert abs(qleft - REF_QLEFT_STEP0) < 1e-5
    assert abs(qleft + qright) < 1e-12      # electroneutrality
    assert abs(float(scal) - qleft) < 1e-12  # f_e == induced charge at dV=1


def test_charges_g_invariant(dilute0):
    system, md, cfg, solver = dilute0
    q1, _ = solver.solve(jnp.asarray(system.x0), jnp.asarray(system.q0), 0)
    solver2 = setup_conp(system, md, cfg, g_ewald=solver.ksp.g_ewald * 1.15)
    q2, _ = solver2.solve(jnp.asarray(system.x0), jnp.asarray(system.q0), 0)
    # physics is independent of the Ewald splitting parameter up to the
    # truncation floor set by the deck's 4 A cutoff (erfc tail ~1e-5)
    ele = system.ele_mask
    rmse = float(np.sqrt(np.mean((np.asarray(q1[ele]) - np.asarray(q2[ele])) ** 2)))
    assert rmse < 1e-5
    # at tight accuracy the truncation floor drops and invariance reaches the
    # north-star charge-RMSE bar (BASELINE.md): solver physics is g-independent
    md8 = dataclasses.replace(md, kspace_accuracy=1e-8)
    qa, _ = setup_conp(system, md8, cfg, g_ewald=0.76).solve(
        jnp.asarray(system.x0), jnp.asarray(system.q0), 0)
    qb, _ = setup_conp(system, md8, cfg, g_ewald=0.80).solve(
        jnp.asarray(system.x0), jnp.asarray(system.q0), 0)
    rmse8 = float(np.sqrt(np.mean((np.asarray(qa[ele]) - np.asarray(qb[ele])) ** 2)))
    assert rmse8 < 2e-7


def test_md_20steps_matches_reference_temperature(dilute0):
    system, md, cfg, solver = dilute0
    eng = build_engine(system, md, solver)
    st = eng.init_state()
    final, th = eng.run(st, 20)
    t20 = float(th["temp"][-1])
    assert abs(t20 - REF_TEMP_STEP20) / REF_TEMP_STEP20 < 2e-4
    # group temperature of the electrolyte
    from lammps_user_conp2_tpu.models.integrate import group_temperature
    sol = jnp.asarray(system.groups["sol"])
    dof = 3 * int(system.groups["sol"].sum()) - 3
    tsl = float(group_temperature(final.v, eng.integrator.mass, sol, float(dof),
                                  system.units()))
    assert abs(tsl - REF_TEMPSL_STEP20) / REF_TEMPSL_STEP20 < 2e-4
    # the thermo row carries the same c_tempsl column (and c_dipole) —
    # column-for-column parity with thermo_style custom step temp c_tempsl
    # c_qleft c_qright c_dipole f_e (tests/cond/input:74, dilute persist.log)
    assert abs(float(th["tempsl"][-1]) - tsl) < 1e-8
    dip = float(jnp.sum(jnp.where(sol, final.q * final.x[:, 2], 0.0)))
    assert abs(float(th["dipole"][-1]) - dip) < 1e-10
    # charges stay neutral along the trajectory
    assert float(np.abs(np.asarray(th["qleft"]) + np.asarray(th["qright"])).max()) < 1e-10


def test_conq_consistency(dilute0):
    """CONQ with target = the charge CONP produced must output dV = conp's dV."""
    system, md, cfg, solver = dilute0
    qp, _ = solver.solve(jnp.asarray(system.x0), jnp.asarray(system.q0), 0)
    qright = float(qp[system.ele_right_mask].sum())
    from lammps_user_conp2_tpu.utils.config import Mode
    cfgq = dataclasses.replace(cfg, mode=Mode.CONQ, target=qright)
    solverq = setup_conp(system, md, cfgq)
    qq, dv = solverq.solve(jnp.asarray(system.x0), jnp.asarray(system.q0), 0)
    assert abs(float(dv) - 1.0) < 1e-9   # conp ran at dV = 1 V
    np.testing.assert_allclose(np.asarray(qq[system.ele_mask]),
                               np.asarray(qp[system.ele_mask]), atol=1e-12)
