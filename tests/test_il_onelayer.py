"""il_onelayer deck smoke + mode equivalence at full scale (3776 atoms)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lammps_user_conp2_tpu import workloads
from lammps_user_conp2_tpu.models.conp import setup_conp
from lammps_user_conp2_tpu.models.md import build_engine

pytestmark = pytest.mark.usefixtures("ref_decks")


def test_il_onelayer_slab_vs_ffield_step0():
    qs = {}
    for n in (0, 3):
        system, md, cfg = workloads.il_onelayer(n)
        s = setup_conp(system, md, cfg)
        q, _ = s.solve(jnp.asarray(system.x0), jnp.asarray(system.q0), 0)
        qs[n] = float(q[system.ele_left_mask].sum())
    assert abs(qs[0] - qs[3]) < 5e-4 * max(1.0, abs(qs[0]))


def test_il_onelayer_conq_pppm_steps():
    """n=2: conq + pppm + slab + shake together, 2 MD steps."""
    system, md, cfg = workloads.il_onelayer(2)
    s = setup_conp(system, md, cfg)
    assert s.pppm_grid is not None
    eng = build_engine(system, md, s)
    st = eng.init_state()
    qright0 = float(st.q[system.ele_right_mask].sum())
    # conq holds the right electrode at the target charge
    assert abs(qright0 - cfg.target) < 1e-8
    for _ in range(2):
        st = jax.jit(eng.step)(st)
    assert abs(float(st.q[system.ele_right_mask].sum()) - cfg.target) < 1e-8
    assert np.isfinite(float(st.energy))


def test_cond2_workload_parses():
    system, md, cfg = workloads.cond(4, suite="cond2")
    assert system.natoms > 3776  # larger system
    assert cfg.target == 50.0
