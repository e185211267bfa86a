"""Mode-lattice equivalence oracles (the reference's physics-level test
strategy, SURVEY.md section 4): the same physical cell solved as
slab / ffield / doubled-cell(noslab+zneutr) must produce the same electrode
charges at identical configurations."""

import jax.numpy as jnp
import numpy as np
import pytest

from lammps_user_conp2_tpu import workloads
from lammps_user_conp2_tpu.models.conp import setup_conp



def _solve(n):
    system, md, cfg = workloads.dilute(n)
    s = setup_conp(system, md, cfg)
    q, scal = s.solve(jnp.asarray(system.x0), jnp.asarray(system.q0), 0)
    return system, np.asarray(q), float(scal)


@pytest.fixture(scope="module")
def slab_charges():
    system, q, _ = _solve(0)
    return float(q[system.ele_left_mask].sum())


@pytest.mark.usefixtures("ref_decks")
def test_ffield_matches_slab(slab_charges):
    system, q, _ = _solve(2)
    qleft = float(q[system.ele_left_mask].sum())
    assert abs(qleft - slab_charges) < 1e-5


@pytest.mark.usefixtures("ref_decks")
def test_doubled_sym_matches_slab(slab_charges):
    system, q, _ = _solve(3)
    pos = system.x0[:, 2] > 0
    for half in (pos, ~pos):
        ql = float(q[system.ele_left_mask & half].sum())
        qr = float(q[system.ele_right_mask & half].sum())
        assert abs(ql - slab_charges) < 1e-5
        assert abs(ql + qr) < 1e-9     # zneutr: each half neutral


@pytest.mark.usefixtures("ref_decks")
def test_doubled_anti_neg_half_matches_slab(slab_charges):
    system, q, _ = _solve(4)
    neg = system.x0[:, 2] < 0        # the unmodified original cell
    ql = float(q[system.ele_left_mask & neg].sum())
    qr = float(q[system.ele_right_mask & neg].sum())
    assert abs(ql - slab_charges) < 1e-5
    assert abs(ql + qr) < 1e-9


@pytest.mark.usefixtures("ref_decks")
def test_cg_solver_matches_inverse():
    """The neutrality-projected CG (fix_conp.cpp:864-930) must agree with the
    projected-inverse solve to its own tolerance."""
    import dataclasses
    import jax.numpy as jnp
    from lammps_user_conp2_tpu.utils.config import Solver
    system, md, cfg = workloads.dilute(0)
    s_inv = setup_conp(system, md, cfg)
    # reference default tolerance (1e-6 on <r,p>/Ne) is loose; crank it to
    # machine level to compare against the exact projected inverse
    s_cg = setup_conp(system, md, dataclasses.replace(
        cfg, solver=Solver.CG, cg_tolerance=1e-18, cg_maxiter=500))
    x0 = jnp.asarray(system.x0)
    q0 = jnp.asarray(system.q0)
    qi, fi = s_inv.solve(x0, q0, 0)
    qc, fc = s_cg.solve(x0, q0, 0)
    ele = system.ele_mask
    rmse = float(np.sqrt(np.mean((np.asarray(qi[ele]) - np.asarray(qc[ele])) ** 2)))
    assert rmse < 1e-7
    assert abs(float(fi) - float(fc)) < 1e-7
    # CG iterates stay exactly charge-neutral (de-meaned residuals)
    assert abs(float(qc[ele].sum())) < 1e-10


@pytest.mark.usefixtures("ref_decks")
def test_cg_warm_start_converges_same_and_faster():
    """cg_solve(x0=near-solution) must return the same answer (to the CG
    tolerance) in strictly fewer iterations than a cold start — the per-step
    warm start reconstructed from the previous charges (ConpSolver.
    _cg_warm_start) relies on both properties."""
    import dataclasses
    import jax.numpy as jnp
    from lammps_user_conp2_tpu.models.conp import cg_solve
    from lammps_user_conp2_tpu.utils.config import Solver
    system, md, cfg = workloads.dilute(0)
    s_cg = setup_conp(system, md, dataclasses.replace(cfg, solver=Solver.CG))
    x0 = jnp.asarray(system.x0)
    q0 = jnp.asarray(system.q0)
    b = s_cg.b_vector(x0, q0)
    sol_cold, it_cold = cg_solve(s_cg.ctx.amat, b, cfg.cg_tolerance, 100)
    rng = np.random.default_rng(0)
    guess = sol_cold + 1e-4 * jnp.asarray(
        rng.normal(size=sol_cold.shape[0]) * float(jnp.abs(sol_cold).max()))
    guess = guess - jnp.mean(guess)
    sol_warm, it_warm = cg_solve(s_cg.ctx.amat, b, cfg.cg_tolerance, 100,
                                 x0=guess)
    assert int(it_warm) < int(it_cold), (int(it_warm), int(it_cold))
    rmse = float(np.sqrt(np.mean((np.asarray(sol_warm) -
                                  np.asarray(sol_cold)) ** 2)))
    assert rmse < 1e-5
    # engine-level: a CG trajectory (warm starts active) tracks INV.
    # The default 1e-6 tolerance leaves ~1e-4 solver-level charge
    # differences vs the exact inverse (warm or cold); crank it so the
    # comparison isolates the warm start.
    from lammps_user_conp2_tpu.models.md import build_engine
    mdx = md
    s_cg_tight = setup_conp(system, mdx, dataclasses.replace(
        cfg, solver=Solver.CG, cg_tolerance=1e-16, cg_maxiter=500))
    e_inv = build_engine(system, mdx, setup_conp(system, mdx, cfg))
    e_cg = build_engine(system, mdx, s_cg_tight)
    st_i, _ = e_inv.run(e_inv.init_state(), 10)
    st_c, _ = e_cg.run(e_cg.init_state(), 10)
    np.testing.assert_allclose(np.asarray(st_c.q), np.asarray(st_i.q),
                               atol=2e-5)


@pytest.mark.usefixtures("ref_decks")
def test_matfree_cg_matches_inverse():
    """Matrix-free CG (A.p via factored Ewald, no k-space assembly) must
    agree with the projected inverse — the production-scale solver."""
    import dataclasses
    import jax.numpy as jnp
    from lammps_user_conp2_tpu.utils.config import Solver
    system, md, cfg = workloads.dilute(0)
    s_inv = setup_conp(system, md, cfg)
    s_mf = setup_conp(system, md, dataclasses.replace(
        cfg, solver=Solver.CG_MATFREE, cg_tolerance=1e-18, cg_maxiter=500))
    x0 = jnp.asarray(system.x0)
    q0 = jnp.asarray(system.q0)
    qi, fi = s_inv.solve(x0, q0, 0)
    qm, fm = s_mf.solve(x0, q0, 0)
    ele = system.ele_mask
    rmse = float(np.sqrt(np.mean((np.asarray(qi[ele]) - np.asarray(qm[ele])) ** 2)))
    assert rmse < 1e-7
    assert abs(float(fi) - float(fm)) < 1e-7


@pytest.mark.usefixtures("ref_decks")
def test_matfree_mobile_electrodes():
    """CG_MATFREE with mobile_electrodes rebuilds the operator from live
    positions: solving at perturbed electrode coordinates must match a full
    re-setup at those coordinates (true mobile electrodes — the reference
    freezes A at setup)."""
    import dataclasses
    import jax.numpy as jnp
    from lammps_user_conp2_tpu.utils.config import Solver
    system, md, cfg = workloads.dilute(0)
    cfgm = dataclasses.replace(cfg, solver=Solver.CG_MATFREE,
                               mobile_electrodes=True,
                               cg_tolerance=1e-16, cg_maxiter=400)
    s_mf = setup_conp(system, md, cfgm)
    rng = np.random.default_rng(0)
    x2 = system.x0.copy()
    x2[system.ele_mask] += rng.normal(scale=0.05,
                                      size=(int(system.ele_mask.sum()), 3))
    q_live, _ = s_mf.solve(jnp.asarray(x2), jnp.asarray(system.q0), 0)
    # ground truth: full re-setup at the perturbed coordinates
    s_ref = setup_conp(system, md, dataclasses.replace(
        cfg, solver=Solver.CG_MATFREE, cg_tolerance=1e-16, cg_maxiter=400),
        x0=x2)
    q_ref, _ = s_ref.solve(jnp.asarray(x2), jnp.asarray(system.q0), 0)
    # d/elesetq/totsetq are position-dependent too; compare the A^-1 b part
    b = s_ref.b_vector(jnp.asarray(x2), jnp.asarray(system.q0))
    ele = system.ele_mask
    # the difference between q_live and q_ref comes only from the setup-time
    # elesetq (frozen d vector); at dV the gap is dV*(delta elesetq) — check
    # the solve itself by comparing at dV=0
    cfg0m = dataclasses.replace(cfgm, target=0.0)
    cfg0r = dataclasses.replace(cfg, solver=Solver.CG_MATFREE, target=0.0,
                                cg_tolerance=1e-16, cg_maxiter=400)
    q0_live, _ = setup_conp(system, md, cfg0m).solve(
        jnp.asarray(x2), jnp.asarray(system.q0), 0)
    q0_ref, _ = setup_conp(system, md, cfg0r, x0=x2).solve(
        jnp.asarray(x2), jnp.asarray(system.q0), 0)
    rmse = float(np.sqrt(np.mean(
        (np.asarray(q0_live[ele]) - np.asarray(q0_ref[ele])) ** 2)))
    assert rmse < 1e-7


@pytest.mark.slow
def test_inv_matches_matfree_production_config():
    """Engine-level INV == CG_MATFREE on the production configuration
    (PPPM mesh k-space + Verlet nlist pair path) at a mid-size synthetic
    capacitor — the configuration workloads.capacitor_100k runs with INV
    now that the host plane-factored A assembly makes the inverse viable
    at production K counts."""
    import dataclasses
    import jax.numpy as jnp
    from lammps_user_conp2_tpu.models.md import build_engine
    from lammps_user_conp2_tpu.utils.config import KSpaceStyle, Solver
    system, md, cfg = workloads.synthetic(n_elyte=2048, nele_side=7,
                                          lz=48.0, lxy=32.0)
    md = dataclasses.replace(md, pair_path="nlist",
                             kspace_style=KSpaceStyle.PPPM)
    qs = {}
    for sv in (Solver.INV, Solver.CG_MATFREE):
        cfgx = dataclasses.replace(cfg, solver=sv, kspace=KSpaceStyle.PPPM,
                                   cg_tolerance=1e-14, cg_maxiter=500)
        conp = setup_conp(system, md, cfgx, solve_dtype=jnp.float64)
        eng = build_engine(system, md, conp, dtype=jnp.float64)
        st = eng.init_state()
        st, _ = eng.run(st, 5, thermo_every=0)
        qs[sv] = np.asarray(st.q)[np.asarray(system.ele_mask)]
    # the gap is CG-tolerance-limited and compounds over the 5-step
    # trajectory (charges feed back into forces); observed ~1e-8
    assert np.abs(qs[Solver.INV] - qs[Solver.CG_MATFREE]).max() < 5e-8
