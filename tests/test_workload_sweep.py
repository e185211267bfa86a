"""Setup + one charge solve across the remaining untested deck configs."""

import jax.numpy as jnp
import numpy as np
import pytest

from lammps_user_conp2_tpu import workloads
from lammps_user_conp2_tpu.models.conp import setup_conp

pytestmark = pytest.mark.usefixtures("ref_decks")


@pytest.mark.parametrize("wl,n", [
    ("il_onelayer", 4),   # ffield + pppm + EHGO (fix_modify kappa 0 / auto)
    ("il_twolayer", 2),   # ffield at the north-star scale
    ("cond", 0),          # conp slab + pppm b-vector
])
def test_workload_solves(wl, n):
    system, md, cfg = getattr(workloads, wl)(n)
    solver = setup_conp(system, md, cfg)
    q, scal = solver.solve(jnp.asarray(system.x0), jnp.asarray(system.q0), 0)
    qe = np.asarray(q[system.ele_mask])
    assert np.isfinite(qe).all()
    assert abs(qe.sum()) < 1e-8          # electroneutrality
    assert np.isfinite(float(scal))
