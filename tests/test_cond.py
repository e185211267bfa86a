"""CONQ/COND feedback-rule tests on the tests/cond workload (3776 atoms,
ffield trials only — the slab trials duplicate the dilute coverage)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from lammps_user_conp2_tpu import workloads
from lammps_user_conp2_tpu.models.conp import setup_conp
from lammps_user_conp2_tpu.utils.config import Mode

pytestmark = pytest.mark.usefixtures("ref_decks")


@pytest.fixture(scope="module")
def cond4():
    system, md, cfg = workloads.cond(4)
    solver = setup_conp(system, md, cfg)
    return system, md, cfg, solver


def test_cond_setup_gain(cond4):
    system, md, cfg, solver = cond4
    # setzvec = d/evscale = -z/Lz (+1 shift for lower-half left electrode)
    zvec = np.asarray(solver.ctx.setzvec)
    ele_idx = solver.ele_idx
    z = system.x0[ele_idx, 2]
    lz = system.box[2]
    expected = -z / lz
    left_low = (system.elecheck[ele_idx] == 1) & (z < system.box_lo[2] + lz / 2)
    expected = np.where(left_low, expected - 1.0, expected)
    np.testing.assert_allclose(zvec, expected, atol=1e-12)
    assert np.isfinite(float(solver.ctx.vmult))


def test_cond_equals_conp_at_same_potdiff(cond4):
    """fix cond applies q = A^-1 b + dV*elesetq with its own dV feedback;
    replaying fix conp (ffield) at that dV must give identical charges."""
    system, md, cfg, solver = cond4
    x0 = jnp.asarray(system.x0)
    q0 = jnp.asarray(system.q0)
    qc, dv = solver.solve(x0, q0, 0)
    cfgp = dataclasses.replace(cfg, mode=Mode.CONP, target=float(dv))
    solverp = setup_conp(system, md, cfgp)
    qp, _ = solverp.solve(x0, q0, 0)
    np.testing.assert_allclose(np.asarray(qc[system.ele_mask]),
                               np.asarray(qp[system.ele_mask]), atol=1e-12)


def test_conq_ffield_feedback_consistency(cond4):
    """CONQ target = right-electrode charge produced by CONP at dV must
    output that dV (ffield variant of the dilute conq test)."""
    system, md, cfg, solver = cond4
    x0 = jnp.asarray(system.x0)
    q0 = jnp.asarray(system.q0)
    cfgp = dataclasses.replace(cfg, mode=Mode.CONP, target=2.0)
    solverp = setup_conp(system, md, cfgp)
    qp, _ = solverp.solve(x0, q0, 0)
    qright = float(qp[system.ele_right_mask].sum())
    cfgq = dataclasses.replace(cfg, mode=Mode.CONQ, target=qright)
    solverq = setup_conp(system, md, cfgq)
    qq, dv = solverq.solve(x0, q0, 0)
    assert abs(float(dv) - 2.0) < 1e-8
    np.testing.assert_allclose(np.asarray(qq[system.ele_mask]),
                               np.asarray(qp[system.ele_mask]), atol=1e-10)
