"""End-to-end zmirror deck (tests/zmirror): the pos half mirrors the neg half
every step, so mirror symmetry — including the per-half electrode charges —
is exactly preserved along the trajectory."""

import jax
import numpy as np
import pytest

pytestmark = pytest.mark.slow

from lammps_user_conp2_tpu import workloads
from lammps_user_conp2_tpu.models.conp import setup_conp
from lammps_user_conp2_tpu.models.md import build_engine

pytestmark = pytest.mark.usefixtures("ref_decks")


@pytest.mark.parametrize("n", [2])
def test_zmirror_preserves_symmetry(n):
    system, md, cfg = workloads.zmirror(n)
    solver = setup_conp(system, md, cfg)
    eng = build_engine(system, md, solver)
    st = eng.init_state()
    for _ in range(3):
        st = jax.jit(eng.step)(st)
    x = np.asarray(st.x)
    q = np.asarray(st.q)
    # solpos == mirror(solneg), paired by tag offset
    zm = eng.zmirror
    src = np.asarray(zm.src_idx)
    dst = np.asarray(zm.dst_idx)
    np.testing.assert_allclose(x[dst, 0], x[src, 0], atol=1e-12)
    np.testing.assert_allclose(x[dst, 1], x[src, 1], atol=1e-12)
    np.testing.assert_allclose(x[dst, 2], zm.zoffset - x[src, 2], atol=1e-12)
    # per-half electrode charges are mirror-equal: qln == qlp, qrn == qrp
    pos = x[:, 2] > 0
    qln = q[system.ele_left_mask & ~pos].sum()
    qlp = q[system.ele_left_mask & pos].sum()
    qrn = q[system.ele_right_mask & ~pos].sum()
    qrp = q[system.ele_right_mask & pos].sum()
    assert abs(qln - qlp) < 5e-6
    assert abs(qrn - qrp) < 5e-6
    assert abs(qln + qrn) < 1e-9   # zneutr half-neutrality
    assert np.isfinite(float(st.energy))
