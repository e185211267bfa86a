"""Verlet neighbor-list pair path: forces match the dense sweep, and the
engine trajectory with skin-based reneighboring matches the dense engine.
Path against path, on the synthetic capacitor (no deck file)."""

import dataclasses

import jax.numpy as jnp
import numpy as np

from lammps_user_conp2_tpu import workloads
from lammps_user_conp2_tpu.models.conp import setup_conp
from lammps_user_conp2_tpu.models.md import build_engine
from lammps_user_conp2_tpu.models.system import exclusion_lists
from lammps_user_conp2_tpu.ops.neighbors import (build_neighbor_list,
                                                 make_neighbor_config,
                                                 nlist_pair_forces)
from lammps_user_conp2_tpu.ops.pairs import dense_pair_forces, make_pair_tables

G = 0.7723634128


def _capacitor():
    """The synthetic capacitor with its ion lattice jittered: on the bare
    lattice some pair distances equal the cutoff exactly, and which side
    of it they land on is roundoff."""
    system, md, cfg = workloads.synthetic(n_elyte=512, nele_side=8, lz=60.0,
                                          lxy=24.0)
    rng = np.random.default_rng(7)
    jit = rng.uniform(-0.2, 0.2, system.x0.shape) * (~system.ele_mask)[:, None]
    return dataclasses.replace(system, x0=system.x0 + jit), md, cfg


def test_nlist_forces_match_dense():
    system, md, cfg = _capacitor()
    u = system.units()
    x = jnp.asarray(system.x0)
    q = jnp.asarray(system.q0) + 0.01
    ti = jnp.asarray(system.type)
    tables = make_pair_tables(system.lj_eps, system.lj_sigma, system.type)
    excl = tuple(jnp.asarray(a) for a in exclusion_lists(system))
    kw = dict(box=system.box, periodic=system.periodic, cutoff=md.cutoff,
              g_ewald=G, qqr2e=u.qqr2e)
    f1, ev1, ec1 = dense_pair_forces(x, q, ti, tables, excl, **kw)
    ncfg = make_neighbor_config(system.box, tuple(system.box_lo), md.cutoff,
                                system.natoms, periodic=system.periodic)
    nl = build_neighbor_list(ncfg, x, tables, ti)
    assert not bool(nl.overflow)
    f2, ev2, ec2, ov = nlist_pair_forces(ncfg, nl, x, q, ti, tables, excl,
                                         g_ewald=G, qqr2e=u.qqr2e)
    scale = float(jnp.abs(f1).max())
    np.testing.assert_allclose(np.asarray(f2) / scale, np.asarray(f1) / scale,
                               atol=1e-12)
    np.testing.assert_allclose(float(ev2), float(ev1), rtol=1e-9)
    np.testing.assert_allclose(float(ec2), float(ec1), rtol=1e-12, atol=1e-12)


def test_nlist_engine_trajectory_matches_dense():
    """20 steps through the jitted scan incl. the lax.cond reneighbor check:
    positions/charges/temperature agree with the dense engine to roundoff."""
    system, md, cfg = _capacitor()
    conp = setup_conp(system, md, cfg)
    e1 = build_engine(system, md, conp)
    md2 = dataclasses.replace(md, pair_path="nlist", neighbor_skin=1.0)
    e2 = build_engine(system, md2, conp)
    assert e2.ncfg is not None
    s1f, th1 = e1.run(e1.init_state(), 20)
    s2f, th2 = e2.run(e2.init_state(), 20)
    assert abs(float(th1["temp"][-1] - th2["temp"][-1])) < 1e-7
    assert abs(float(th1["qleft"][-1] - th2["qleft"][-1])) < 1e-10
    assert float(jnp.abs(s1f.x - s2f.x).max()) < 1e-9


def test_overflow_recovery_grows_capacity():
    """A deliberately undersized K NaN-poisons the physics (fail-loud);
    Engine.run detects the sticky overflow flag at the host boundary, grows
    the capacity, heals derived state, and completes with correct physics —
    the analogue of LAMMPS neighbor-page reallocation (SURVEY.md 2.3-1)."""
    system, md, cfg = _capacitor()
    md_ok = dataclasses.replace(md, pair_path="nlist")
    md_bad = dataclasses.replace(md_ok, neighbor_kmax=4)
    conp = setup_conp(system, md_ok, cfg)
    eng_ok = build_engine(system, md_ok, conp)
    eng_bad = build_engine(system, md_bad, conp)
    st_bad = eng_bad.init_state()
    # K=8 overflows at the very first build: init state is poisoned
    assert bool(st_bad.nbr.overflow)
    assert not np.isfinite(float(st_bad.energy))
    k0 = eng_bad.ncfg.k_max
    f_bad, th_bad = eng_bad.run(st_bad, 3)
    f_ok, th_ok = eng_ok.run(eng_ok.init_state(), 3)
    assert eng_bad.ncfg.k_max > k0                  # capacity actually grew
    assert np.isfinite(float(f_bad.energy))
    assert not bool(f_bad.nbr.overflow)
    np.testing.assert_allclose(np.asarray(f_bad.x), np.asarray(f_ok.x),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(f_bad.q), np.asarray(f_ok.q),
                               atol=1e-10)
    assert abs(float(th_bad["temp"][-1] - th_ok["temp"][-1])) < 1e-8


def test_nlist_rebuild_fires_on_motion():
    """Moving one atom farther than skin/2 flips needs_rebuild."""
    from lammps_user_conp2_tpu.ops.neighbors import needs_rebuild

    system, md, cfg = _capacitor()
    ti = jnp.asarray(system.type)
    tables = make_pair_tables(system.lj_eps, system.lj_sigma, system.type)
    ncfg = make_neighbor_config(system.box, tuple(system.box_lo), md.cutoff,
                                system.natoms, periodic=system.periodic,
                                skin=1.0)
    x = jnp.asarray(system.x0)
    nl = build_neighbor_list(ncfg, x, tables, ti)
    assert not bool(needs_rebuild(ncfg, nl, x))
    x2 = x.at[5, 0].add(0.51)
    assert bool(needs_rebuild(ncfg, nl, x2))
    assert not bool(needs_rebuild(ncfg, nl, x.at[5, 0].add(0.49)))


def test_block_forces_match_nlist():
    """The block (cluster) sweep covers exactly the same pair set as the
    per-atom (N, K) sweep — forces/energies agree to roundoff."""
    from lammps_user_conp2_tpu.ops.neighbors import block_pair_forces

    system, md, cfg = _capacitor()
    u = system.units()
    x = jnp.asarray(system.x0)
    q = jnp.asarray(system.q0) + 0.01
    ti = jnp.asarray(system.type)
    tables = make_pair_tables(system.lj_eps, system.lj_sigma, system.type)
    excl = tuple(jnp.asarray(a) for a in exclusion_lists(system))
    ncfg = make_neighbor_config(system.box, tuple(system.box_lo), md.cutoff,
                                system.natoms, periodic=system.periodic,
                                block=8)
    assert ncfg.u_max > 0
    nl = build_neighbor_list(ncfg, x, tables, ti)
    assert not bool(nl.overflow)
    assert nl.bun is not None
    assert nl.lj is None        # block lists drop the (4, N, K) LJ planes
    # the per-atom sweep needs the LJ planes — rebuild the same list in its
    # non-block form (identical (N, K) pair set; block fields are additive)
    import dataclasses
    nl_p = build_neighbor_list(dataclasses.replace(ncfg, block=0, u_max=0),
                               x, tables, ti)
    np.testing.assert_array_equal(np.asarray(nl_p.idx), np.asarray(nl.idx))
    f1, ev1, ec1, _ = nlist_pair_forces(ncfg, nl_p, x, q, ti, tables, excl,
                                        g_ewald=G, qqr2e=u.qqr2e)
    f2, ev2, ec2, _ = block_pair_forces(ncfg, nl, x, q, ti, tables, excl,
                                        g_ewald=G, qqr2e=u.qqr2e)
    scale = float(jnp.abs(f1).max())
    np.testing.assert_allclose(np.asarray(f2) / scale, np.asarray(f1) / scale,
                               atol=1e-12)
    np.testing.assert_allclose(float(ev2), float(ev1), rtol=1e-10)
    np.testing.assert_allclose(float(ec2), float(ec1), rtol=1e-10)


def test_block_engine_trajectory_matches_nlist():
    """20 steps through the jitted scan (incl. reneighbor conds) on the
    block path track the nlist engine to roundoff."""
    system, md, cfg = _capacitor()
    conp = setup_conp(system, md, cfg)
    md1 = dataclasses.replace(md, pair_path="nlist", neighbor_skin=1.0)
    md2 = dataclasses.replace(md, pair_path="block", neighbor_skin=1.0)
    e1 = build_engine(system, md1, conp)
    e2 = build_engine(system, md2, conp)
    assert e2.ncfg.block == 8 and e2.ncfg.u_max % 8 == 0
    s1f, th1 = e1.run(e1.init_state(), 20)
    s2f, th2 = e2.run(e2.init_state(), 20)
    assert abs(float(th1["temp"][-1] - th2["temp"][-1])) < 1e-7
    assert abs(float(th1["qleft"][-1] - th2["qleft"][-1])) < 1e-10
    assert float(jnp.abs(s1f.x - s2f.x).max()) < 1e-9


def test_block_union_overflow_recovers():
    """An undersized union width U NaN-poisons (fail-loud) and Engine.run's
    grow-and-retry heals it, like the K overflow path."""
    system, md, cfg = _capacitor()
    md_ok = dataclasses.replace(md, pair_path="block")
    conp = setup_conp(system, md_ok, cfg)
    eng_ok = build_engine(system, md_ok, conp)
    eng_bad = build_engine(system, md_ok, conp)
    # shrink ONLY u_max on the bad engine (post-build, so k_max stays valid)
    object.__setattr__(eng_bad, "ncfg",
                       dataclasses.replace(eng_bad.ncfg, u_max=8))
    st_bad = eng_bad.init_state()
    assert bool(st_bad.nbr.overflow)
    assert not np.isfinite(float(st_bad.energy))
    f_bad, th_bad = eng_bad.run(st_bad, 3)
    f_ok, th_ok = eng_ok.run(eng_ok.init_state(), 3)
    assert eng_bad.ncfg.u_max > 8
    assert np.isfinite(float(f_bad.energy))
    np.testing.assert_allclose(np.asarray(f_bad.x), np.asarray(f_ok.x),
                               atol=1e-10)
    assert abs(float(th_bad["temp"][-1] - th_ok["temp"][-1])) < 1e-8
