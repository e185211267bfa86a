"""Persistent tile assignment: refresh_tile_slots under drift.

The engine amortizes the packed-key binning sort over the Verlet skin
interval (ops/pppm.py TileAssign): the assignment is built on reneighbor
events, and each step only refreshes the per-atom payload (local coords
relative to the ASSIGNED tile + B-spline fractions) — atoms that drifted
across a tile boundary land in the dm-cell patch margin.  Oracle: the
dense spread/gather at the drifted positions (exact equality — the tiled
path computes the same weights, only the binning is stale).

The reference's analogue is LAMMPS's particle_map/rho caching per
reneighbor (pppm_conp.cpp:318-344 aaa_map_rho), which likewise assumes
positions move only between neighbor rebuilds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lammps_user_conp2_tpu.ops import pppm as P


@pytest.fixture(scope="module")
def slab_setup():
    rng = np.random.default_rng(11)
    box = (30.0, 30.0, 90.0)
    n = 2500
    x_ely = rng.uniform([0, 0, 2], [30, 30, 88], size=(n, 3))
    side = 10
    gx, gy = np.meshgrid(np.arange(side) * 3.0, np.arange(side) * 3.0)
    wall = np.stack([gx.ravel(), gy.ravel(), np.full(side * side, 1.0)], 1)
    x = np.concatenate([x_ely, wall])
    q = rng.normal(size=len(x))
    q -= q.mean()
    grid = P.setup_pppm(box=box, box_lo=(0.0, 0.0, 0.0), accuracy_abs=1e-4,
                        natoms=len(x), q2=float((q ** 2).sum()), cutoff=8.0,
                        slabflag=True, slab_volfactor=3.0)
    return grid, np.asarray(x), jnp.asarray(q)


def _dense_spread(grid, x, q):
    WX, WY, WZ = P._axis_weight_matrices(grid, x)
    wxy = (WX[:, :, None] * WY[:, None, :]).reshape(
        x.shape[0], grid.nx * grid.ny)
    return jnp.matmul(wxy.T, q[:, None] * WZ).reshape(grid.shape)


def _drift(grid, x, rng, frac):
    """Displace every atom by frac * (min mesh cell) in a random direction,
    clipping z into the slab interior (the non-periodic axis)."""
    cells = (grid.box[0] / grid.nx, grid.box[1] / grid.ny,
             grid.zprd_grid / grid.nz)
    step = frac * min(cells)
    d = rng.normal(size=x.shape)
    d *= step / np.linalg.norm(d, axis=1, keepdims=True)
    x2 = x + d
    x2[:, 2] = np.clip(x2[:, 2], 0.3, grid.box[2] - 0.3)
    return x2


def test_refresh_spread_matches_dense_after_drift(slab_setup):
    grid, x0, q = slab_setup
    rng = np.random.default_rng(5)
    asg = jax.jit(lambda a: P.tile_assign(grid, a))(jnp.asarray(x0))
    # drift just under the dm-cell margin: atoms cross tile boundaries
    x2 = jnp.asarray(_drift(grid, x0, rng, frac=0.9 * P.TILE_DM))
    slots = jax.jit(lambda a, b: P.refresh_tile_slots(grid, asg, a, b))(x2, q)
    assert not bool(slots.overflow)
    rho_t = jax.jit(lambda a: P.spread_tiled(grid, a, slots=slots))(x2)
    rho_d = _dense_spread(grid, x2, q)
    np.testing.assert_allclose(np.asarray(rho_t), np.asarray(rho_d),
                               atol=1e-11)


def test_refresh_gather_matches_dense_after_drift(slab_setup):
    grid, x0, q = slab_setup
    rng = np.random.default_rng(6)
    asg = jax.jit(lambda a: P.tile_assign(grid, a))(jnp.asarray(x0))
    x2 = jnp.asarray(_drift(grid, x0, rng, frac=0.8 * P.TILE_DM))
    slots = jax.jit(lambda a, b: P.refresh_tile_slots(grid, asg, a, b))(x2, q)
    rho = _dense_spread(grid, x2, q)
    _, u = P.pppm_energy_u(grid, rho)
    # plain stencil readout
    g_t = jax.jit(lambda b, xx: P.gather_tiled(
        grid, [b], xx, slots=slots)[0])(u, x2)
    g_d = jax.jit(lambda b, xx: P.gather(grid, b, xx))(u, x2)
    np.testing.assert_allclose(np.asarray(g_t), np.asarray(g_d), atol=1e-11)
    # ad-differentiated force readout
    f_t = jax.jit(lambda b, xx: P.gather3_ad_tiled(
        grid, b, xx, slots=slots))(u, x2)
    f_d = jax.jit(lambda b, xx: P.gather3_ad(grid, b, xx))(u, x2)
    scale = float(jnp.max(jnp.abs(f_d)))
    np.testing.assert_allclose(np.asarray(f_t), np.asarray(f_d),
                               atol=1e-12 * scale)


def test_refresh_identity_matches_fresh_build(slab_setup):
    """Refreshing at the binning positions reproduces tile_slots exactly."""
    grid, x0, q = slab_setup
    x0 = jnp.asarray(x0)
    asg = jax.jit(lambda a: P.tile_assign(grid, a))(x0)
    s_r = jax.jit(lambda a, b: P.refresh_tile_slots(grid, asg, a, b))(x0, q)
    s_f = jax.jit(lambda a, b: P.tile_slots(grid, a, b))(x0, q)
    for a, b in zip(s_r, s_f):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_drift_beyond_margin_fails_loud(slab_setup):
    """An atom that moved more than dm cells past the patch margin poisons
    the mesh instead of silently losing its weight."""
    grid, x0, q = slab_setup
    asg = jax.jit(lambda a: P.tile_assign(grid, a))(jnp.asarray(x0))
    geom = P._tile_geometry(grid, len(x0))
    x_bad = np.array(x0)
    # teleport one atom several tiles away along an axis with nt > 1 —
    # an axis covered by a SINGLE periodic tile wraps every position into
    # range, so no drift is detectable (or harmful) there.  The lane-
    # aligned _pick_tile can legitimately choose tlx == nx (ntx == 1), so
    # pick the axis dynamically.
    axes = [(geom.ntx, 0, geom.tlx, grid.box[0] / grid.nx, grid.box[0]),
            (geom.nty, 1, geom.tly, grid.box[1] / grid.ny, grid.box[1]),
            (geom.ntz, 2, geom.tlz, grid.zprd_grid / grid.nz, grid.box[2])]
    nt, ax, tl, cell, width = max(axes)
    assert nt > 1, "fixture grid needs a multi-tile axis"
    x_bad[0, ax] = (x_bad[0, ax] + (tl + 3 * geom.dm + 2) * cell) % width
    slots = jax.jit(lambda a, b: P.refresh_tile_slots(
        grid, asg, a, b))(jnp.asarray(x_bad), q)
    assert bool(slots.overflow)
    rho = jax.jit(lambda a: P.spread_tiled(grid, a, slots=slots))(
        jnp.asarray(x_bad))
    assert not np.isfinite(np.asarray(rho)).all()


def test_fully_periodic_grid_refresh(slab_setup):
    """Non-slab grid (single z tile spans the axis): refresh under drift,
    including atoms wrapping across the periodic boundary."""
    rng = np.random.default_rng(3)
    box = (30.0, 30.0, 30.0)
    n = 1200
    x0 = rng.uniform(0, 30, size=(n, 3))
    q = rng.normal(size=n)
    q -= q.mean()
    q = jnp.asarray(q)
    grid = P.setup_pppm(box=box, box_lo=(0.0, 0.0, 0.0), accuracy_abs=1e-4,
                        natoms=n, q2=float(np.sum(np.asarray(q) ** 2)),
                        cutoff=8.0, slabflag=False)
    asg = jax.jit(lambda a: P.tile_assign(grid, a))(jnp.asarray(x0))
    cells = (grid.box[0] / grid.nx, grid.box[1] / grid.ny,
             grid.zprd_grid / grid.nz)
    d = rng.normal(size=x0.shape)
    d *= 0.9 * P.TILE_DM * min(cells) / np.linalg.norm(d, axis=1,
                                                       keepdims=True)
    x2 = jnp.asarray((x0 + d) % 30.0)   # wrap: periodic in every axis
    slots = jax.jit(lambda a, b: P.refresh_tile_slots(grid, asg, a, b))(x2, q)
    assert not bool(slots.overflow)
    rho_t = jax.jit(lambda a: P.spread_tiled(grid, a, slots=slots))(x2)
    rho_d = _dense_spread(grid, x2, q)
    np.testing.assert_allclose(np.asarray(rho_t), np.asarray(rho_d),
                               atol=1e-11)
