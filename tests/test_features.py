"""Keyword-feature coverage: ehgo, qinit, matout/org/inv file IO, equal-style
(time-varying) targets, nonneutral."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest

from lammps_user_conp2_tpu import workloads
from lammps_user_conp2_tpu.models.conp import setup_conp
from lammps_user_conp2_tpu.utils.config import EhgoConfig, PairMode

pytestmark = pytest.mark.usefixtures("ref_decks")


@pytest.fixture(scope="module")
def dilute0():
    system, md, cfg = workloads.dilute(0)
    solver = setup_conp(system, md, cfg)
    return system, md, cfg, solver


def test_ehgo_kappa0_auto_equals_eta(dilute0):
    """EHGO with kappa=0 and u0='auto' degenerates exactly to ETA mode
    (combination rules fix_conp.cpp:1517-1551: eta_ij(ele,ele)=eta/sqrt(2),
    eta_ij(ele,elyte)=eta, fo=0, u0=sqrt(2/pi)*eta)."""
    system, md, cfg, solver = dilute0
    cfge = dataclasses.replace(
        cfg, pairmode=PairMode.EHGO,
        ehgo=EhgoConfig(kappa=0.0, eta_by_type=((3, cfg.eta, None),)))
    se = setup_conp(system, md, cfge)
    x0 = jnp.asarray(system.x0)
    q0 = jnp.asarray(system.q0)
    q1, f1 = solver.solve(x0, q0, 0)
    q2, f2 = se.solve(x0, q0, 0)
    np.testing.assert_allclose(np.asarray(q2), np.asarray(q1), atol=1e-10)
    assert abs(float(f1) - float(f2)) < 1e-12


def test_ehgo_requires_coeffs_falls_back_to_eta():
    system, md, cfg = workloads.dilute(0)
    cfge = dataclasses.replace(cfg, pairmode=PairMode.EHGO, ehgo=None)
    # reference warns and falls back (fix_conp.cpp:1553-1558)
    assert cfge.pairmode is PairMode.ETA


def test_qinit_adds_baseline(dilute0):
    system, md, cfg, solver = dilute0
    q0 = system.q0.copy()
    rng = np.random.default_rng(0)
    baseline = rng.normal(size=system.ele_mask.sum()) * 0.01
    q0[system.ele_mask] = baseline
    cfgq = dataclasses.replace(cfg, qinit=True)
    sq = setup_conp(system, md, cfgq, q0=q0)
    qq, _ = sq.solve(jnp.asarray(system.x0), jnp.asarray(q0), 0)
    # without qinit (same initial charges in b? electrode q doesn't enter b)
    s0 = setup_conp(system, md, cfg, q0=q0)
    qp, _ = s0.solve(jnp.asarray(system.x0), jnp.asarray(q0), 0)
    np.testing.assert_allclose(np.asarray(qq[system.ele_mask]),
                               np.asarray(qp[system.ele_mask]) + baseline,
                               atol=1e-10)


def test_matout_and_readback(tmp_path, dilute0, monkeypatch):
    system, md, cfg, solver = dilute0
    monkeypatch.chdir(tmp_path)
    cfgm = dataclasses.replace(cfg, matout=True)
    sm = setup_conp(system, md, cfgm)
    assert os.path.exists("amatrix") and os.path.exists("inv_a_matrix")
    x0 = jnp.asarray(system.x0)
    q0 = jnp.asarray(system.q0)
    q_ref, _ = sm.solve(x0, q0, 0)
    # org: read A back, re-invert
    sa = setup_conp(system, md, dataclasses.replace(cfg, a_file="amatrix"))
    qa, _ = sa.solve(x0, q0, 0)
    np.testing.assert_allclose(np.asarray(qa), np.asarray(q_ref), atol=1e-8)
    # inv: read A^-1 directly (already projected)
    si = setup_conp(system, md, dataclasses.replace(cfg, ainv_file="inv_a_matrix"))
    qi, _ = si.solve(x0, q0, 0)
    np.testing.assert_allclose(np.asarray(qi), np.asarray(q_ref), atol=1e-7)
    # permutation robustness: shuffle rows/cols by tag in the file
    from lammps_user_conp2_tpu.utils import matio
    tags, mat = matio.read_matrix("amatrix", system.tag[system.ele_mask])
    perm = np.random.default_rng(1).permutation(len(tags))
    matio.write_matrix("amatrix_shuf", tags[perm], mat[np.ix_(perm, perm)])
    ss = setup_conp(system, md, dataclasses.replace(cfg, a_file="amatrix_shuf"))
    qs, _ = ss.solve(x0, q0, 0)
    np.testing.assert_allclose(np.asarray(qs), np.asarray(q_ref), atol=1e-8)


def test_equal_style_target(dilute0):
    """v_-style variables: target may be a function of the step
    (fix_conp.cpp:112-117, 1143)."""
    system, md, cfg, solver = dilute0
    cfgv = dataclasses.replace(cfg, target=lambda step: 1.0 + 0.5 * step)
    sv = setup_conp(system, md, cfgv)
    x0 = jnp.asarray(system.x0)
    q0 = jnp.asarray(system.q0)
    q5, _ = sv.solve(x0, q0, jnp.asarray(4))
    s3 = setup_conp(system, md, dataclasses.replace(cfg, target=3.0))
    q3, _ = s3.solve(x0, q0, 0)
    np.testing.assert_allclose(np.asarray(q5), np.asarray(q3), atol=1e-12)


def test_nonneutral_skips_projection(dilute0):
    system, md, cfg, solver = dilute0
    sn = setup_conp(system, md, dataclasses.replace(cfg, nonneutral=True))
    # unprojected inverse does not annihilate the uniform vector
    assert float(np.abs(np.asarray(sn.ctx.ainv).sum(axis=1)).max()) > 1e-6
    q, _ = sn.solve(jnp.asarray(system.x0), jnp.asarray(system.q0), 0)
    assert np.isfinite(np.asarray(q)).all()


def test_one_electrode_setup():
    """group1 == group2 (fix_conp.cpp:295): single electrode, projection
    deferred until after setq (fix_conp.cpp:958,1115), conq doubling."""
    from lammps_user_conp2_tpu.models.system import build_system
    from lammps_user_conp2_tpu.utils import data_io
    from lammps_user_conp2_tpu.utils.config import Mode
    from lammps_user_conp2_tpu.workloads import REF_TESTS, _DILUTE_PAIR_COEFFS
    data = data_io.parse_data_file(f"{REF_TESTS}/dilute/data")
    groups = {"sol": np.isin(data.type, [1, 2, 4])}
    system = build_system(
        data, units="real", periodic=(True, True, False), mix="geometric",
        pair_coeff_overrides=_DILUTE_PAIR_COEFFS,
        ele_left=[81, 82], ele_right=[81, 82], groups=groups)
    assert not system.ele_right_mask.any()
    assert (system.elecheck[system.ele_mask] == 1).all()
    from lammps_user_conp2_tpu.utils.config import MDConfig, ThermostatConfig
    md = MDConfig(units="real", dt=1.0, cutoff=4.0, kspace_accuracy=1e-6,
                  slab=3.0, thermostats=(ThermostatConfig("sol", 298., 298., 100.),))
    cfg = dataclasses.replace(workloads.dilute(0)[2])
    solver = setup_conp(system, md, cfg)
    q, scal = solver.solve(jnp.asarray(system.x0), jnp.asarray(system.q0), 0)
    assert np.isfinite(np.asarray(q)).all()
    # projected AFTER setq: totsetq reflects the unprojected inverse
    assert abs(float(solver.ctx.totsetq)) > 1e-6
    # the projected matvec keeps the single electrode exactly neutral at dV=0
    cfg0 = dataclasses.replace(cfg, target=0.0)
    s0 = setup_conp(system, md, cfg0)
    q0, _ = s0.solve(jnp.asarray(system.x0), jnp.asarray(system.q0), 0)
    assert abs(float(q0[system.ele_mask].sum())) < 1e-9
    # conq one-electrode: scalar gets the 2*target/totsetq shift (fix_conq.cpp:79)
    cfgq = dataclasses.replace(cfg, mode=Mode.CONQ, target=0.05)
    sq = setup_conp(system, md, cfgq)
    qq, dv = sq.solve(jnp.asarray(system.x0), jnp.asarray(system.q0), 0)
    assert np.isfinite(float(dv))


def test_ehgo_nonzero_kappa_overlap_term(dilute0):
    """kappa != 0 activates the Gaussian-overlap fo term; the A matrix stays
    symmetric positive definite and the solve remains neutral."""
    system, md, cfg, solver = dilute0
    # note: with u0='auto', f_i = u0 - sqrt(2/pi)*eta == 0 and the overlap
    # term vanishes for ANY kappa (fix_conp.cpp:1530-1535); use explicit u0
    import math
    u0 = 1.2 * math.sqrt(2 / math.pi) * cfg.eta / system.units().evscale
    cfge = dataclasses.replace(
        cfg, pairmode=PairMode.EHGO,
        ehgo=EhgoConfig(kappa=0.5, eta_by_type=((3, cfg.eta, u0),)))
    se = setup_conp(system, md, cfge)
    from lammps_user_conp2_tpu.models.electrodes import assemble_amatrix
    ele_idx = se.ele_idx
    xe = jnp.asarray(system.x0[ele_idx])
    a = np.asarray(assemble_amatrix(
        xe, jnp.asarray(system.type[ele_idx]), se.kernels.self_diag[ele_idx],
        se.ksp, se.kernels, box=system.box, periodic=system.periodic,
        cut_coulsq=se.cut_coulsq))
    np.testing.assert_allclose(a, a.T, atol=1e-12)
    assert np.linalg.eigvalsh(a).min() > 0
    q, _ = se.solve(jnp.asarray(system.x0), jnp.asarray(system.q0), 0)
    qe = np.asarray(q[system.ele_mask])
    assert abs(qe.sum()) < 1e-10
    # and it differs from kappa=0 (the term is active)
    q0, _ = solver.solve(jnp.asarray(system.x0), jnp.asarray(system.q0), 0)
    assert np.abs(qe - np.asarray(q0[system.ele_mask])).max() > 1e-8


def test_nevery_gating(dilute0):
    """Nevery=2: charges update only on even steps (fix conp Nevery arg)."""
    system, md, cfg, solver = dilute0
    from lammps_user_conp2_tpu.models.md import build_engine
    cfg2 = dataclasses.replace(cfg, nevery=2)
    s2 = setup_conp(system, md, cfg2)
    eng = build_engine(system, md, s2)
    st = eng.init_state()
    q0 = np.asarray(st.q[system.ele_mask])
    st1 = eng.step(st)        # step 1: no solve
    np.testing.assert_array_equal(np.asarray(st1.q[system.ele_mask]), q0)
    st2 = eng.step(st1)       # step 2: solve
    assert np.abs(np.asarray(st2.q[system.ele_mask]) - q0).max() > 1e-8
