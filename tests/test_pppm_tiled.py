"""Tiled scatter-free PPPM spread/gather vs the dense reference path.

The tiled path (ops/pppm.py spread_tiled/gather_tiled) only engages on
meshes with nx*ny > DENSE_XY_LIMIT, which the reference-deck tests never
reach — so it gets direct unit coverage here: a slab grid in z-span mode
(the production large-N configuration), an electrode-like z-concentrated
charge layer, and the fail-loud tile-capacity overflow.  Dense-path
equivalence is the oracle (the dense path itself is validated against the
reference decks: make_rho/fieldforce parity, pppm_conp.cpp:385-450).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lammps_user_conp2_tpu.ops import pppm as P


@pytest.fixture(scope="module")
def slab_setup():
    rng = np.random.default_rng(7)
    box = (30.0, 30.0, 90.0)
    n = 3000
    # electrolyte filling the interior + electrode walls at z=1 / z=89
    x_ely = rng.uniform([0, 0, 2], [30, 30, 88], size=(n, 3))
    side = 12
    gx, gy = np.meshgrid(np.arange(side) * 2.5, np.arange(side) * 2.5)
    wall_lo = np.stack([gx.ravel(), gy.ravel(),
                        np.full(side * side, 1.0)], 1)
    wall_hi = np.stack([gx.ravel(), gy.ravel(),
                        np.full(side * side, 89.0)], 1)
    x = np.concatenate([x_ely, wall_lo, wall_hi])
    q = rng.normal(size=len(x))
    q -= q.mean()
    grid = P.setup_pppm(box=box, box_lo=(0.0, 0.0, 0.0), accuracy_abs=1e-4,
                        natoms=len(x), q2=float((q ** 2).sum()), cutoff=8.0,
                        slabflag=True, slab_volfactor=3.0)
    return grid, jnp.asarray(x), jnp.asarray(q), n


def _dense_spread(grid, x, q):
    WX, WY, WZ = P._axis_weight_matrices(grid, x)
    wxy = (WX[:, :, None] * WY[:, None, :]).reshape(
        x.shape[0], grid.nx * grid.ny)
    return jnp.matmul(wxy.T, q[:, None] * WZ).reshape(grid.shape), wxy, WZ


def test_span_mode_engages(slab_setup):
    grid, x, q, _ = slab_setup
    geom = P._tile_geometry(grid, x.shape[0])
    assert geom.z_span, "slab grid must use the z-span tiling"
    assert geom.ntz > 1


def test_spread_tiled_matches_dense(slab_setup):
    grid, x, q, _ = slab_setup
    rho_d, _, _ = _dense_spread(grid, x, q)
    rho_t = jax.jit(lambda a, b: P.spread_tiled(grid, a, b))(x, q)
    np.testing.assert_allclose(np.asarray(rho_t), np.asarray(rho_d),
                               atol=1e-11)


def test_spread_tiled_electrode_subset(slab_setup):
    """The engine re-spreads only the electrode rows per step (models/md.py
    compute_forces); the wall layer concentrates in one z bin per wall —
    the tile-capacity heuristic must hold for that distribution too."""
    grid, x, q, n = slab_setup
    xe, qe = x[n:], q[n:]
    rho_d, _, _ = _dense_spread(grid, xe, qe)
    rho_t = jax.jit(lambda a, b: P.spread_tiled(grid, a, b))(xe, qe)
    assert np.isfinite(np.asarray(rho_t)).all(), "tile capacity overflowed"
    np.testing.assert_allclose(np.asarray(rho_t), np.asarray(rho_d),
                               atol=1e-11)


def test_gather_tiled_matches_dense(slab_setup):
    grid, x, q, _ = slab_setup
    rho_d, wxy, WZ = _dense_spread(grid, x, q)
    g_t = jax.jit(lambda b, xx: P.gather_tiled(grid, [b], xx)[0])(rho_d, x)
    t = jnp.matmul(WZ, rho_d.reshape(grid.nx * grid.ny, grid.nz).T)
    g_d = jnp.sum(wxy * t, axis=1)
    np.testing.assert_allclose(np.asarray(g_t), np.asarray(g_d), atol=1e-11)


def test_energy_efield_rfft_roundtrip(slab_setup):
    """rfft half-spectrum Poisson == full-spectrum reference on the same
    mesh (energy + all three field components)."""
    grid, x, q, _ = slab_setup
    rho, _, _ = _dense_spread(grid, x, q)
    e, (ex, ey, ez) = P.pppm_energy_efield(grid, rho)
    # full-spectrum oracle, computed inline
    cplx = jnp.complex128
    rhok = jnp.fft.fftn(rho.astype(cplx))
    gk = jnp.asarray(grid.greens, rho.dtype)
    e_ref = 0.5 * jnp.sum(gk * jnp.abs(rhok) ** 2) / grid.volume
    np.testing.assert_allclose(float(e), float(e_ref), rtol=1e-12)
    phik = rhok * gk
    scale = grid.nx * grid.ny * grid.nz / grid.volume
    for got, fk, ax in ((ex, grid.fkx, 0), (ey, grid.fky, 1),
                        (ez, grid.fkz, 2)):
        shape = [1, 1, 1]
        shape[ax] = -1
        ik = (1j * jnp.asarray(fk, rho.dtype)).reshape(shape).astype(cplx)
        ref = jnp.real(jnp.fft.ifftn(-ik * phik)) * scale
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   atol=1e-12 * float(jnp.abs(ref).max()))


def test_slot_sharing_equivalence(slab_setup):
    """tile_slots built once and passed to both spread and gather gives
    bit-identical results to the build-inside path (the engine shares the
    binning between the b-vector spread and the force gather3)."""
    grid, x, q, _ = slab_setup
    slots = jax.jit(lambda a, b: P.tile_slots(grid, a, b))(x, q)
    rho_a = jax.jit(lambda a, b: P.spread_tiled(grid, a, b))(x, q)
    rho_b = jax.jit(lambda a: P.spread_tiled(grid, a, slots=slots))(x)
    np.testing.assert_array_equal(np.asarray(rho_a), np.asarray(rho_b))
    g_a = jax.jit(lambda b, xx: P.gather_tiled(grid, [b], xx)[0])(rho_a, x)
    g_b = jax.jit(lambda b, xx: P.gather_tiled(
        grid, [b], xx, slots=slots)[0])(rho_a, x)
    np.testing.assert_array_equal(np.asarray(g_a), np.asarray(g_b))


def test_tiled_periodic_z_grid():
    """Non-slab (fully periodic) grid: z_span is False and the z overlap-add
    uses the periodic roll branch."""
    rng = np.random.default_rng(3)
    box = (30.0, 30.0, 30.0)
    n = 1500
    x = jnp.asarray(rng.uniform(0, 30, size=(n, 3)))
    q = rng.normal(size=n)
    q -= q.mean()
    q = jnp.asarray(q)
    grid = P.setup_pppm(box=box, box_lo=(0.0, 0.0, 0.0), accuracy_abs=1e-4,
                        natoms=n, q2=float(np.sum(np.asarray(q) ** 2)),
                        cutoff=8.0, slabflag=False)
    geom = P._tile_geometry(grid, n)
    assert not geom.z_span
    rho_d, wxy, WZ = _dense_spread(grid, x, q)
    rho_t = jax.jit(lambda a, b: P.spread_tiled(grid, a, b))(x, q)
    np.testing.assert_allclose(np.asarray(rho_t), np.asarray(rho_d),
                               atol=1e-11)
    g_t = jax.jit(lambda b, xx: P.gather_tiled(grid, [b], xx)[0])(rho_d, x)
    t = jnp.matmul(WZ, rho_d.reshape(grid.nx * grid.ny, grid.nz).T)
    g_d = jnp.sum(wxy * t, axis=1)
    np.testing.assert_allclose(np.asarray(g_t), np.asarray(g_d), atol=1e-11)


def test_ad_force_is_exact_mesh_energy_gradient(slab_setup):
    """The ad scheme differentiates the B-spline interpolant analytically —
    q*gather3_ad must equal -d(mesh energy)/dx via jax autodiff to float
    roundoff (this is the property that makes ad forces exactly
    conservative on the mesh; LAMMPS kspace_modify diff ad)."""
    grid, x, q, _ = slab_setup
    x = x[:400]
    q = q[:400]

    def energy(xx):
        rho = P.spread(grid, xx, q)
        return P.pppm_energy(grid, rho)

    e, g = jax.value_and_grad(energy)(x)
    _, u = jax.jit(lambda xx: P.pppm_energy_u(grid, P.spread(grid, xx, q)))(x)
    f_ad = q[:, None] * P.gather3_ad(grid, u, x)
    scale = float(jnp.max(jnp.abs(g)))
    np.testing.assert_allclose(np.asarray(f_ad), -np.asarray(g),
                               atol=1e-9 * scale)


def test_ad_tiled_matches_dense(slab_setup):
    """Tiled and dense gather3_ad compute the same discretization."""
    grid, x, q, _ = slab_setup
    rho, _, _ = _dense_spread(grid, x, q)
    _, u = P.pppm_energy_u(grid, rho)
    g_t = jax.jit(lambda b, xx: P.gather3_ad_tiled(grid, b, xx))(u, x)
    # dense formulation via the public dispatcher on a small subset check:
    # force the dense branch by calling the internals
    gd = jax.jit(lambda b, xx: P.gather3_ad(grid, b, xx))(u, x)
    # public dispatcher picks tiled for this mesh; build dense explicitly
    (ix, iy, iz), (wx, wy, wz), (dxx, dxy, dxz), _, _ = P._stencil_full(grid, x)
    cf = jnp.asarray(grid.coeffs, x.dtype)
    n = x.shape[0]
    rows = jnp.arange(n)[:, None]
    WX = jnp.zeros((n, grid.nx), x.dtype).at[rows, ix].add(wx)
    WY = jnp.zeros((n, grid.ny), x.dtype).at[rows, iy].add(wy)
    WZ = jnp.zeros((n, grid.nz), x.dtype).at[rows, iz].add(wz)
    DWX = jnp.zeros((n, grid.nx), x.dtype).at[rows, ix].add(P._horner_dw(dxx, cf))
    DWY = jnp.zeros((n, grid.ny), x.dtype).at[rows, iy].add(P._horner_dw(dxy, cf))
    DWZ = jnp.zeros((n, grid.nz), x.dtype).at[rows, iz].add(P._horner_dw(dxz, cf))
    bf = u.reshape(grid.nx * grid.ny, grid.nz).T
    t = jnp.matmul(WZ, bf)
    tz = jnp.matmul(DWZ, bf)
    gx = jnp.sum((DWX[:, :, None] * WY[:, None, :]).reshape(n, -1) * t, axis=1)
    gy = jnp.sum((WX[:, :, None] * DWY[:, None, :]).reshape(n, -1) * t, axis=1)
    gz = jnp.sum((WX[:, :, None] * WY[:, None, :]).reshape(n, -1) * tz, axis=1)
    g_ref = jnp.stack([gx, gy, gz], 1) * jnp.asarray(P._delinv(grid),
                                                     x.dtype)[None, :]
    scale = float(jnp.max(jnp.abs(g_ref)))
    np.testing.assert_allclose(np.asarray(g_t), np.asarray(g_ref),
                               atol=1e-12 * scale)
    np.testing.assert_allclose(np.asarray(gd), np.asarray(g_ref),
                               atol=1e-12 * scale)


def test_ad_close_to_ik(slab_setup):
    """ad and ik forces agree to discretization error (both converge to the
    true k-space force; the difference is bounded by the B-spline
    interpolation error at order 5)."""
    grid, x, q, _ = slab_setup
    rho, _, _ = _dense_spread(grid, x, q)
    _, efield = P.pppm_energy_efield(grid, rho)
    f_ik = q[:, None] * P.gather3(grid, efield, x)
    _, u = P.pppm_energy_u(grid, rho)
    f_ad = q[:, None] * P.gather3_ad(grid, u, x)
    scale = float(jnp.max(jnp.abs(f_ik)))
    # loose: differentiation-scheme difference, not roundoff
    np.testing.assert_allclose(np.asarray(f_ad), np.asarray(f_ik),
                               atol=2e-3 * scale)


def test_zplane_forward_transform_matches_rfftn(slab_setup):
    """rhok_from_zplanes (P tiny 2-D FFTs + small z-DFT matmul) equals the
    full rfftn of the z-sparse mesh."""
    grid, x, q, n = slab_setup
    xe, qe = x[n:], q[n:]
    zp = P.electrode_zplanes(grid, np.asarray(xe))
    zpi = P.zplane_inverse(grid, zp)
    rho_p = P.spread_zplanes(grid, xe, qe, zpi)
    assert np.isfinite(np.asarray(rho_p)).all()
    # full-mesh oracle
    rho_full, _, _ = _dense_spread(grid, xe, qe)
    full_p = np.zeros(grid.shape)
    full_p[:, :, zp] = np.asarray(rho_p)
    np.testing.assert_allclose(full_p, np.asarray(rho_full), atol=1e-12)
    rhok = P.rhok_from_zplanes(grid, rho_p, zp)
    rhok_ref = jnp.fft.rfftn(rho_full)
    scale = float(jnp.abs(rhok_ref).max())
    np.testing.assert_allclose(np.asarray(rhok), np.asarray(rhok_ref),
                               atol=1e-11 * scale)


def test_zplane_potential_matches_full_inverse(slab_setup):
    """u_on_zplanes equals poisson_u's values on the plane set, and
    gather_zplanes equals the full gather at the electrodes."""
    grid, x, q, n = slab_setup
    xe = x[n:]
    rho, _, _ = _dense_spread(grid, x, q)
    rhok = jnp.fft.rfftn(rho)
    u_full = P.poisson_u_from_k(grid, rhok)
    np.testing.assert_allclose(np.asarray(u_full),
                               np.asarray(P.poisson_u(grid, rho)), atol=1e-12)
    zp = P.electrode_zplanes(grid, np.asarray(xe))
    zpi = P.zplane_inverse(grid, zp)
    up = P.u_on_zplanes(grid, rhok, zp)
    scale = float(jnp.abs(u_full).max())
    np.testing.assert_allclose(np.asarray(up),
                               np.asarray(u_full[:, :, zp]),
                               atol=1e-11 * scale)
    g_fast = P.gather_zplanes(grid, up, xe, zpi)
    g_ref = P.gather(grid, u_full, xe)
    np.testing.assert_allclose(np.asarray(g_fast), np.asarray(g_ref),
                               atol=1e-11 * scale)


def test_zplane_out_of_set_fails_loud(slab_setup):
    """An atom whose stencil leaves the plane set poisons the output."""
    grid, x, q, n = slab_setup
    xe = x[n:]
    zp = P.electrode_zplanes(grid, np.asarray(xe))
    zpi = P.zplane_inverse(grid, zp)
    x_bad = jnp.concatenate([xe, jnp.asarray([[5.0, 5.0, 45.0]])])
    q_bad = jnp.concatenate([q[n:], jnp.asarray([1.0])])
    rho_p = P.spread_zplanes(grid, x_bad, q_bad, zpi)
    assert not np.isfinite(np.asarray(rho_p)).all()
    g = P.gather_zplanes(grid, jnp.zeros((grid.nx, grid.ny, len(zp))),
                         x_bad, zpi)
    assert not np.isfinite(np.asarray(g)).all()


def test_energy_u_from_k_matches(slab_setup):
    grid, x, q, _ = slab_setup
    rho, _, _ = _dense_spread(grid, x, q)
    e_ref, u_ref = P.pppm_energy_u(grid, rho)
    e2, u2 = P.pppm_energy_u_from_k(grid, jnp.fft.rfftn(rho))
    np.testing.assert_allclose(float(e2), float(e_ref), rtol=1e-13)
    np.testing.assert_allclose(np.asarray(u2), np.asarray(u_ref), atol=1e-13)
    e3, ef3 = P.pppm_energy_efield_from_k(grid, jnp.fft.rfftn(rho))
    e_ref2, ef_ref = P.pppm_energy_efield(grid, rho)
    np.testing.assert_allclose(float(e3), float(e_ref2), rtol=1e-13)
    for a, b in zip(ef3, ef_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-13)


def test_tile_overflow_fails_loud(slab_setup):
    """More atoms in one tile than cap -> NaN-poisoned mesh, not silent
    truncation (the analogue of LAMMPS's out-of-range atom check,
    pppm_conp.cpp:167)."""
    grid, x, q, _ = slab_setup
    geom = P._tile_geometry(grid, 64)
    # put 10x the 64-atom capacity inside a single tile
    nn = min(geom.cap * 10, 4000)
    xx = jnp.asarray(np.full((nn, 3), 3.0) +
                     np.random.default_rng(1).uniform(0, 0.5, (nn, 3)))
    qq = jnp.ones((nn,))
    geom_n = P._tile_geometry(grid, nn)
    if geom_n.cap >= nn:
        pytest.skip("capacity heuristic covers this n; cannot force overflow")
    rho = jax.jit(lambda a, b: P.spread_tiled(grid, a, b))(xx, qq)
    assert not np.isfinite(np.asarray(rho)).all()


def test_greens_matches_bruteforce_brillouin():
    """compute_greens (separable axis tables + underflow-pruned jitted scan)
    must match the straightforward Hockney-Eastwood triple Brillouin loop
    (LAMMPS compute_gf_ik, pppm.cpp) to f64 roundoff."""
    import math

    def brute(nx, ny, nz, box_grid, g_ewald, order, eps_hoc=1e-7):
        xprd, yprd, zprd_g = box_grid
        unitk = 2 * math.pi / np.array([xprd, yprd, zprd_g])
        nb = [int((g_ewald * L / (math.pi * n)) * ((-math.log(eps_hoc)) ** 0.25)) + 2
              for n, L in ((nx, xprd), (ny, yprd), (nz, zprd_g))]
        nbx, nby, nbz = nb
        ax = lambda n: np.where(np.arange(n) <= n // 2, np.arange(n),
                                np.arange(n) - n)
        mx = ax(nx)[:, None, None]; my = ax(ny)[None, :, None]
        mz = ax(nz)[None, None, :]
        kx, ky, kz = unitk[0] * mx, unitk[1] * my, unitk[2] * mz
        ksq = kx ** 2 + ky ** 2 + kz ** 2
        num = np.zeros((nx, ny, nz)); den = np.zeros((nx, ny, nz))
        for bx in range(-nbx, nbx + 1):
            qx = kx + unitk[0] * nx * bx
            wx2 = P._wk2(mx + nx * bx, nx, order)
            for by in range(-nby, nby + 1):
                qy = ky + unitk[1] * ny * by
                wy2 = P._wk2(my + ny * by, ny, order)
                for bz in range(-nbz, nbz + 1):
                    qz = kz + unitk[2] * nz * bz
                    wz2 = P._wk2(mz + nz * bz, nz, order)
                    w2 = wx2 * wy2 * wz2
                    qsq = qx ** 2 + qy ** 2 + qz ** 2
                    qsq_s = np.where(qsq == 0, 1.0, qsq)
                    dot = kx * qx + ky * qy + kz * qz
                    num += np.where(qsq == 0, 0.0, w2 * dot *
                                    np.exp(-0.25 * qsq / g_ewald ** 2) / qsq_s)
                    den += w2
        ksq_s = np.where(ksq == 0, 1.0, ksq)
        return np.where(ksq == 0, 0.0, 4 * math.pi * num / (ksq_s * den * den))

    for (nx, ny, nz, box, g) in [(16, 12, 20, (10.0, 11.0, 20.0), 0.45),
                                 (15, 12, 18, (9.0, 8.0, 13.0), 0.9),
                                 (12, 12, 36, (8.0, 8.0, 24.0), 0.2)]:
        want = brute(nx, ny, nz, box, g, 5)
        got = P.compute_greens(nx, ny, nz, box, g, 5)
        scale = np.abs(want).max()
        assert np.abs(got - want).max() / scale < 1e-14


def test_zspan_bottom_stencil_fails_loud(slab_setup):
    """An atom so far below box_lo that part of its stencil falls below the
    span ring's coverage (mz < hw - tlz) must set the overflow flag — the
    overlap-add drops bin 0's lower border, so proceeding would silently
    lose stencil weight (fail loud, never silent)."""
    grid, x, q, n = slab_setup
    geom = P._tile_geometry(grid, x.shape[0])
    if not geom.z_span:
        pytest.skip("span mode not engaged at this grid")
    dz = grid.zprd_grid / grid.nz
    # just below the coverage limit: mz ~ (hw - tlz) - 2 cells
    zbad = (geom.hw - geom.tlz - 2) * dz
    xbad = jnp.asarray(np.asarray(x).copy())
    xbad = xbad.at[0, 2].set(zbad)
    asg = P.tile_assign(grid, xbad)
    assert bool(asg.overflow)
    # slightly below box_lo (wrap spill) must still be fine
    xok = jnp.asarray(np.asarray(x).copy()).at[0, 2].set(-0.4 * dz)
    asg2 = P.tile_assign(grid, xok)
    assert not bool(asg2.overflow)
    # and the spill atom's spread must still match the dense path exactly
    sl = P.refresh_tile_slots(grid, asg2, xok, q)
    rho_t = P.spread_tiled(grid, xok, q, slots=sl)
    rho_d, _, _ = _dense_spread(grid, xok, q)
    np.testing.assert_allclose(np.asarray(rho_t), np.asarray(rho_d),
                               atol=5e-13)


def test_rfft3_irfft3_match_fft_f32(slab_setup):
    """The f32 z-DFT-matmul transform pair (the float32 production path) agrees with
    jnp.fft.rfftn/irfftn to f32 roundoff, both directions, odd and even nz
    Nyquist handling included (grid nz from setup_pppm is even; the second
    grid below forces an odd nz)."""
    import dataclasses
    grid, x, q, n = slab_setup
    for g in (grid, dataclasses.replace(
            grid, nz=grid.nz + 1,
            greens=np.pad(grid.greens, ((0, 0), (0, 0), (0, 1))))):
        r = np.random.default_rng(3).standard_normal(g.shape)
        vk_ref = np.fft.rfftn(r)
        vk = np.asarray(P.rfft3(g, jnp.asarray(r, jnp.float32)))
        assert np.abs(vk - vk_ref).max() / np.abs(vk_ref).max() < 2e-6
        u_ref = np.fft.irfftn(vk_ref * g.greens[..., :g.nz // 2 + 1],
                              axes=(0, 1, 2), s=g.shape)
        u = np.asarray(P.irfft3(
            g, jnp.asarray(vk_ref * g.greens[..., :g.nz // 2 + 1],
                           jnp.complex64)))
        assert np.abs(u - u_ref).max() / np.abs(u_ref).max() < 2e-6


def test_spread_rhok_matches_fft_of_spread(slab_setup):
    """spread_rhok (z overlap-add folded into the shifted z-DFT) equals
    rfft3(spread(...)) to f32 roundoff on the span-mode slab grid."""
    grid, x, q, n = slab_setup
    x32, q32 = x.astype(jnp.float32), q.astype(jnp.float32)
    slots = jax.jit(lambda a, b: P.tile_slots(grid, a, b))(x32, q32)
    rho = jax.jit(lambda a, b: P.spread_tiled(grid, a, b))(x32, q32)
    ref = np.asarray(P.rfft3(grid, rho))
    got = np.asarray(jax.jit(
        lambda a: P._spread_rhok_tiled(grid, a, slots=slots))(x32))
    sc = np.abs(ref).max()
    assert np.abs(got - ref).max() < 4e-6 * sc


def test_spread_rhok_periodic_grid():
    """Fully periodic z (roll-merge branch): the shifted-DFT row mapping
    must agree with the rolled overlap-add."""
    rng = np.random.default_rng(5)
    box = (30.0, 30.0, 30.0)
    n = 1500
    x = jnp.asarray(rng.uniform(0, 30, size=(n, 3)), jnp.float32)
    q = jnp.asarray(rng.normal(size=n), jnp.float32)
    grid = P.setup_pppm(box=box, box_lo=(0.0, 0.0, 0.0), accuracy_abs=1e-4,
                        natoms=n, q2=float(np.sum(np.asarray(q) ** 2)),
                        cutoff=8.0, slabflag=False)
    assert not P._tile_geometry(grid, n).z_span
    rho = jax.jit(lambda a, b: P.spread_tiled(grid, a, b))(x, q)
    ref = np.asarray(P.rfft3(grid, rho))
    got = np.asarray(jax.jit(
        lambda a, b: P._spread_rhok_tiled(grid, a, b))(x, q))
    sc = np.abs(ref).max()
    assert np.abs(got - ref).max() < 4e-6 * sc


def test_gather3_ad_zbin_matches_dense_mesh(slab_setup):
    """pppm_energy_u_zbin + gather3_ad_zbin == pppm_energy_u_from_k +
    gather3_ad_tiled on the span-mode slab grid (f32 roundoff)."""
    grid, x, q, n = slab_setup
    x32, q32 = x.astype(jnp.float32), q.astype(jnp.float32)
    slots = jax.jit(lambda a, b: P.tile_slots(grid, a, b))(x32, q32)
    rhok = jax.jit(
        lambda a: P._spread_rhok_tiled(grid, a, slots=slots))(x32)
    e_ref, u_ref = jax.jit(
        lambda r: P.pppm_energy_u_from_k(grid, r))(rhok)
    f_ref = np.asarray(jax.jit(
        lambda u, a: P.gather3_ad_tiled(grid, u, a, slots=slots))(
            u_ref, x32))
    e_got, uz = jax.jit(
        lambda r: P.pppm_energy_u_zbin(grid, r, x32.shape[0]))(rhok)
    f_got = np.asarray(jax.jit(
        lambda u, a: P.gather3_ad_zbin(grid, u, a, slots=slots))(uz, x32))
    assert abs(float(e_got) - float(e_ref)) < 2e-5 * abs(float(e_ref))
    sc = np.abs(f_ref).max()
    assert np.abs(f_got - f_ref).max() < 4e-6 * sc


def test_gather3_ad_zbin_periodic_grid():
    """Periodic-z (roll-merge) geometry: the inverse z-bin row mapping must
    agree with the wrap-padded dense mesh."""
    rng = np.random.default_rng(11)
    box = (30.0, 30.0, 30.0)
    n = 1500
    x = jnp.asarray(rng.uniform(0, 30, size=(n, 3)), jnp.float32)
    q = jnp.asarray(rng.normal(size=n), jnp.float32)
    q = q - q.mean()
    grid = P.setup_pppm(box=box, box_lo=(0.0, 0.0, 0.0), accuracy_abs=1e-4,
                        natoms=n, q2=float(np.sum(np.asarray(q) ** 2)),
                        cutoff=8.0, slabflag=False)
    assert not P._tile_geometry(grid, n).z_span
    slots = jax.jit(lambda a, b: P.tile_slots(grid, a, b))(x, q)
    rhok = jax.jit(lambda a, b: P._spread_rhok_tiled(grid, a, b))(x, q)
    _, u_ref = jax.jit(lambda r: P.pppm_energy_u_from_k(grid, r))(rhok)
    f_ref = np.asarray(jax.jit(
        lambda u, a: P.gather3_ad_tiled(grid, u, a, slots=slots))(u_ref, x))
    _, uz = jax.jit(
        lambda r: P.pppm_energy_u_zbin(grid, r, n))(rhok)
    f_got = np.asarray(jax.jit(
        lambda u, a: P.gather3_ad_zbin(grid, u, a, slots=slots))(uz, x))
    sc = np.abs(f_ref).max()
    assert np.abs(f_got - f_ref).max() < 4e-6 * sc


def test_engine_ad_zbin_branch(monkeypatch):
    """Engine-level wiring of the z-binned ad path: an f32 engine on the
    production config (tiled PPPM + ad + nlist + INV) must route mesh
    forces through pppm_energy_u_zbin/gather3_ad_zbin, and the forces must
    match the f64 engine (dense-mesh ad path) to f32 roundoff."""
    import dataclasses
    from lammps_user_conp2_tpu import workloads
    from lammps_user_conp2_tpu.models.conp import setup_conp
    from lammps_user_conp2_tpu.models.md import build_engine
    from lammps_user_conp2_tpu.utils.config import KSpaceStyle, Solver

    monkeypatch.setattr(P, "_use_dense", lambda grid, n: False)
    calls = {"n": 0}
    real = P.pppm_energy_u_zbin

    def spy(grid, rhok, natoms):
        calls["n"] += 1
        return real(grid, rhok, natoms)

    monkeypatch.setattr(P, "pppm_energy_u_zbin", spy)
    system, md, cfg = workloads.synthetic(n_elyte=512, nele_side=5,
                                          lz=36.0, lxy=20.0)
    md = dataclasses.replace(md, pair_path="nlist",
                             kspace_style=KSpaceStyle.PPPM, pppm_diff="ad")
    cfg = dataclasses.replace(cfg, solver=Solver.INV,
                              kspace=KSpaceStyle.PPPM, target=0.0)

    def forces(dtype):
        solver = setup_conp(system, md, cfg, solve_dtype=dtype)
        eng = build_engine(system, md, solver, dtype=dtype)
        st = eng.init_state()
        q, scal, kcache = solver.solve_full(
            st.x, st.q, 0, st.nbr, eng.ncfg, tasg=st.tasg)
        f, pe = eng.compute_forces(st.x, q, scal, kcache, st.nbr, st.tasg)
        return np.asarray(f, np.float64)

    f32 = forces(jnp.float32)
    assert calls["n"] >= 1          # the zbin branch actually ran
    n32 = calls["n"]
    f64 = forces(jnp.float64)
    assert calls["n"] == n32        # ...and the f64 engine did NOT take it
    sc = np.abs(f64).max()
    assert np.abs(f32 - f64).max() < 5e-5 * sc
