"""potential/atom, nghosts analogue, zmirror, and the PPPM engine path.

Physics oracle for potential/atom + CONP combined (the reference's
input_rerun_comp_test idea): at the converged constant-potential solution
the total potential evaluated at each electrode atom equals the prescribed
value -+dV/2 (up to one uniform constant from the neutrality projection),
with near-zero spread across each electrode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lammps_user_conp2_tpu import workloads
from lammps_user_conp2_tpu.models.conp import setup_conp
from lammps_user_conp2_tpu.models.diagnostics import nghosts, potential_atom
from lammps_user_conp2_tpu.models.md import build_engine
from lammps_user_conp2_tpu.models.zmirror import build_zmirror
from lammps_user_conp2_tpu.utils.config import KSpaceStyle


@pytest.fixture(scope="module")
def dilute_solved():
    system, md, cfg = workloads.dilute(0)
    solver = setup_conp(system, md, cfg)
    q, _ = solver.solve(jnp.asarray(system.x0), jnp.asarray(system.q0), 0)
    return system, md, cfg, solver, q


def _potential(system, solver, q, **kw):
    return potential_atom(
        jnp.asarray(system.x0), q,
        group_mask=np.ones(system.natoms, bool),
        elecheck=jnp.asarray(system.elecheck),
        box=system.box, periodic=system.periodic,
        cutoff=4.0, g_ewald=solver.ksp.g_ewald,
        evscale=solver.evscale, volume=solver.ksp.volume,
        eta=solver.cfg.eta, slabflag=solver.ksp.slabflag,
        kvecs=jnp.asarray(solver.ksp.kvecs), ug=jnp.asarray(solver.ksp.ug),
        **kw)


@pytest.mark.usefixtures("ref_decks")
def test_electrode_potentials_equal_applied_voltage(dilute_solved):
    system, md, cfg, solver, q = dilute_solved
    pot = np.asarray(_potential(system, solver, q))
    pl = pot[system.ele_left_mask]
    pr = pot[system.ele_right_mask]
    # constant within each electrode...
    assert pl.std() < 2e-4
    assert pr.std() < 2e-4
    # ...and group2 (right) sits exactly DV = 1.0 V ABOVE group1 (left)
    # (README.md:52 sign convention)
    dv = pr.mean() - pl.mean()
    assert abs(dv - 1.0) < 1e-3


@pytest.mark.usefixtures("ref_decks")
def test_potential_atom_pppm_matches_ewald(dilute_solved):
    system, md, cfg, solver, q = dilute_solved
    cfgp = dataclasses.replace(cfg, kspace=KSpaceStyle.PPPM)
    solverp = setup_conp(system, md, cfgp)
    p1 = np.asarray(_potential(system, solver, q))
    p2 = np.asarray(_potential(system, solverp, q, pppm_grid=solverp.pppm_grid))
    # mesh discretization noise on +-9 V potentials is ~1e-3 V at this grid
    assert np.abs(p1 - p2).max() < 3e-3


@pytest.mark.usefixtures("ref_decks")
def test_pppm_engine_short_trajectory_matches_ewald():
    system, md, cfg = workloads.dilute(0)
    s_e = setup_conp(system, md, cfg)
    cfgp = dataclasses.replace(cfg, kspace=KSpaceStyle.PPPM)
    s_p = setup_conp(system, md, cfgp)
    import dataclasses as dc
    mdp = dc.replace(md, kspace_style=KSpaceStyle.PPPM)
    e1 = build_engine(system, md, s_e)
    e2 = build_engine(system, mdp, s_p)
    st1, _ = e1.run(e1.init_state(), 10)
    st2, _ = e2.run(e2.init_state(), 10)
    # same physics through a completely different k-space discretization
    np.testing.assert_allclose(np.asarray(st2.x), np.asarray(st1.x), atol=5e-5)
    np.testing.assert_allclose(np.asarray(st2.q), np.asarray(st1.q), atol=5e-5)


@pytest.mark.usefixtures("ref_decks")
def test_pppm_ad_engine_trajectory_matches_ik():
    """Engine-level wiring of MDConfig.pppm_diff='ad' (the production
    large-mesh force path): a short dilute trajectory under ad
    differentiation tracks the ik one to discretization error, and the
    charge solve (which never uses the force differentiation) stays
    essentially identical at step 0."""
    system, md, cfg = workloads.dilute(0)
    cfgp = dataclasses.replace(cfg, kspace=KSpaceStyle.PPPM)
    mdik = dataclasses.replace(md, kspace_style=KSpaceStyle.PPPM,
                               pppm_diff="ik")
    mdad = dataclasses.replace(md, kspace_style=KSpaceStyle.PPPM,
                               pppm_diff="ad")
    s_p = setup_conp(system, mdik, cfgp)
    e1 = build_engine(system, mdik, s_p)
    e2 = build_engine(system, mdad, s_p)
    st1_0 = e1.init_state()
    st2_0 = e2.init_state()
    np.testing.assert_allclose(np.asarray(st2_0.q), np.asarray(st1_0.q),
                               atol=1e-12)
    st1, _ = e1.run(st1_0, 10)
    st2, _ = e2.run(st2_0, 10)
    np.testing.assert_allclose(np.asarray(st2.x), np.asarray(st1.x),
                               atol=5e-5)
    np.testing.assert_allclose(np.asarray(st2.q), np.asarray(st1.q),
                               atol=5e-5)


def test_nghosts_counts_images():
    x = np.array([[0.5, 5.0, 5.0],    # near x-lo face -> 1 ghost
                  [5.0, 5.0, 5.0],    # interior -> 0
                  [0.5, 0.5, 5.0]])   # near two faces -> 3 ghosts
    c = nghosts(x, box=(10.0, 10.0, 10.0), box_lo=(0, 0, 0), cutoff=2.0,
                periodic=(True, True, False))
    assert list(c) == [1, 0, 3]


@pytest.mark.usefixtures("ref_decks")
def test_zmirror_pairing_and_transform():
    system, md, cfg = workloads.dilute(3)   # doubled cell
    pos = system.x0[:, 2] > 0
    system.groups["solneg"] = system.groups["sol"] & ~pos
    system.groups["solpos"] = system.groups["sol"] & pos
    zm = build_zmirror(system, "solneg", "solpos", every=1)
    x = jnp.asarray(system.x0)
    x2 = np.asarray(zm.apply(x))
    src = np.asarray(zm.src_idx)
    dst = np.asarray(zm.dst_idx)
    np.testing.assert_allclose(x2[dst, 0], system.x0[src, 0])
    np.testing.assert_allclose(x2[dst, 2],
                               zm.zoffset - system.x0[src, 2])
    # the symmetric doubled cell is already mirror-symmetric: apply == no-op
    np.testing.assert_allclose(x2[dst, 2], system.x0[dst, 2], atol=1e-9)


@pytest.mark.usefixtures("ref_decks")
@pytest.mark.slow
def test_pppm_slab_z_resolution_converged():
    """Pin the documented z-grid deviation (ops/pppm.py docstring) as safe:
    step-0 charges on dilute trial 0 must be converged in the slab z mesh —
    doubling nz changes electrode charges by < 1e-6 e."""
    import dataclasses
    from lammps_user_conp2_tpu.ops import pppm as pppm_ops
    from lammps_user_conp2_tpu.utils.config import KSpaceStyle

    system, md, cfg = workloads.dilute(0)
    cfgp = dataclasses.replace(cfg, kspace=KSpaceStyle.PPPM)
    mdp = dataclasses.replace(md, kspace_style=KSpaceStyle.PPPM)
    solver = setup_conp(system, mdp, cfgp)
    g1 = solver.pppm_grid
    u = system.units()
    q2sum = float((system.q0 ** 2).sum()) * u.qqr2e
    g_fine = pppm_ops.setup_pppm(
        box=system.box, box_lo=tuple(system.box_lo),
        accuracy_abs=mdp.kspace_accuracy * u.qqr2e, natoms=system.natoms,
        q2=max(q2sum, 1e-10), cutoff=mdp.cutoff, slabflag=True,
        slab_volfactor=mdp.slab,
        g_ewald=g1.g_ewald,
        grid=(g1.lammps_grid[0], g1.lammps_grid[1], 2 * g1.lammps_grid[2]))
    assert g_fine.nz >= 2 * g1.lammps_grid[2]
    # the electrode z-plane tables are grid-derived — regenerate for g_fine
    zp_f = pppm_ops.electrode_zplanes(g_fine, system.x0[solver.ele_idx])
    solver_fine = dataclasses.replace(
        solver, pppm_grid=g_fine, ele_zplanes=zp_f,
        ele_zpinv=pppm_ops.zplane_inverse(g_fine, zp_f))

    x = jnp.asarray(system.x0)
    q = jnp.asarray(system.q0)
    q1, _, _ = solver.solve_full(x, q, 0)
    q2_, _, _ = solver_fine.solve_full(x, q, 0)
    dq = np.abs(np.asarray(q1) - np.asarray(q2_)).max()
    assert dq < 1e-6, f"slab z-mesh not converged: max charge shift {dq:.2e} e"


def test_pppm_tiled_spread_gather_match_dense():
    """The tiled scatter-free spread/gather (large-mesh path) is a pure
    reassociation of the dense-separable formulation."""
    import numpy as np
    from lammps_user_conp2_tpu.ops import pppm as pppm_ops

    rng = np.random.default_rng(3)
    n = 500
    box = (30.0, 25.0, 40.0)
    x = jnp.asarray(rng.uniform(0, 1, (n, 3)) * np.array(box))
    q = jnp.asarray(rng.normal(size=n))
    QQR2E = 332.06371
    g = pppm_ops.setup_pppm(
        box=box, box_lo=(0.0, 0.0, 0.0), accuracy_abs=1e-5 * QQR2E,
        natoms=n, q2=float((np.asarray(q) ** 2).sum()) * QQR2E, cutoff=8.0,
        slabflag=True, slab_volfactor=3.0)
    WX, WY, WZ = pppm_ops._axis_weight_matrices(g, x)
    wxy = (WX[:, :, None] * WY[:, None, :]).reshape(n, g.nx * g.ny)
    rho_ref = jnp.matmul(wxy.T, q[:, None] * WZ,
                         precision=jax.lax.Precision.HIGHEST).reshape(g.shape)
    rho_t = pppm_ops.spread_tiled(g, x, q)
    np.testing.assert_allclose(np.asarray(rho_t), np.asarray(rho_ref),
                               atol=1e-14)
    brick = jnp.asarray(rng.normal(size=g.shape))
    val_ref = jnp.sum(wxy * jnp.matmul(
        WZ, brick.reshape(g.nx * g.ny, g.nz).T,
        precision=jax.lax.Precision.HIGHEST), axis=1)
    val_t = pppm_ops.gather_tiled(g, [brick], x)[0]
    np.testing.assert_allclose(np.asarray(val_t), np.asarray(val_ref),
                               atol=1e-14)


@pytest.mark.usefixtures("ref_decks")
def test_capacitance_static_matches_solve_linearity():
    """tools/capacitance.py's static estimator: dQ_left/dV must equal the
    finite difference of two actual charge solves at different potentials
    (the update rule q = A^-1 b + dV elesetq is linear in dV,
    fix_conp.cpp:1153-1158)."""
    import dataclasses
    import sys
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parents[1]))
    from tools.capacitance import static_capacitance
    from lammps_user_conp2_tpu import workloads
    from lammps_user_conp2_tpu.models.conp import setup_conp

    system, md, cfg = workloads.dilute(0)
    left = np.asarray(system.elecheck[system.ele_mask]) == 1
    x0 = jnp.asarray(system.x0)
    q0 = jnp.asarray(system.q0)
    qs = {}
    for dv in (1.0, 3.0):
        s = setup_conp(system, md, dataclasses.replace(cfg, target=dv))
        qn, _ = s.solve(x0, q0, 0)
        qs[dv] = np.asarray(qn)[np.asarray(system.ele_mask)][left].sum()
        c_static = static_capacitance(s)
    dq_dv = (qs[3.0] - qs[1.0]) / 2.0
    np.testing.assert_allclose(dq_dv, c_static, rtol=1e-8)
