"""Factorized Ewald: the matmul fast path.

The reference's lowmem mode factorizes trig tables as xy * z products
(km_ewald.cpp:360-363, kz_expand at 533-558) to save CPU memory.  Taken to
its logical conclusion, the same factorization e^{ik.r} =
e^{i(kx x + ky y)} * e^{i kz z} turns EVERY k-space sum into dense complex
matmuls over (N, nxy) x (nxy, nz) tables:

    S(kxy, kz)   = P^T diag(q) Z               [structure factors]
    E            = sum ug |S|^2
    F_j          = 2 q_j sum ug k Im[P_j Z_j conj(S)]   (3 matmul chains)
    phi(points)  = sum 2 ug Re[S conj(Pe) conj(Ze)]     [b-vector readout]

with P (N, nxy), Z (N, nz) built from O(N*(kxmax+kymax+kzmax))
transcendentals.  Per-step cost drops from O(N*K) transcendentals to
O(N*nxy*nz) matmul flops — far fewer operations at slab-geometry K
counts.

The (kxy, kz) grid covers exactly the same half-space set as
ops.ewald.setup_ewald (excluded combinations get ug=0), so results are
bitwise-equivalent physics; tests assert agreement to f64 roundoff.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from .ewald import EwaldKSpace


@dataclasses.dataclass(frozen=True)
class FactoredKSpace:
    """Static factorized tables; built from an EwaldKSpace's parameters."""
    g_ewald: float
    volume: float
    slabflag: bool
    box: tuple
    unitk: tuple             # (ux, uy, uz) with uz slab-extended
    kxy: np.ndarray          # (nxy, 2) int — (kx, ky) integer pairs
    kz: np.ndarray           # (nz,) int — -kzmax..kzmax
    ug: np.ndarray           # (nxy, nz) weights; 0 where excluded
    ug_tot: float

    @property
    def nxy(self) -> int:
        return len(self.kxy)

    @property
    def nz(self) -> int:
        return len(self.kz)


def factorize(ksp: EwaldKSpace) -> FactoredKSpace:
    """Build the (kxy, kz) factorization covering ksp's half-space set."""
    xprd, yprd, zprd = ksp.box
    zprd_slab = zprd * (ksp.slab_volfactor if ksp.slabflag else 1.0)
    unitk = (2 * math.pi / xprd, 2 * math.pi / yprd, 2 * math.pi / zprd_slab)
    kxm, kym, kzm = ksp.kxmax, ksp.kymax, ksp.kzmax
    gsqmx = max((unitk[0] * kxm) ** 2, (unitk[1] * kym) ** 2,
                (unitk[2] * kzm) ** 2) * 1.00001

    xy = []
    for kx in range(0, kxm + 1):
        for ky in range(-kym, kym + 1):
            if kx == 0 and ky < 0:
                continue
            xy.append((kx, ky))
    xy = np.array(xy, np.int64)
    kz = np.arange(-kzm, kzm + 1, dtype=np.int64)

    kxc = xy[:, 0] * unitk[0]
    kyc = xy[:, 1] * unitk[1]
    kzc = kz * unitk[2]
    sqk = (kxc ** 2 + kyc ** 2)[:, None] + (kzc ** 2)[None, :]
    # half-space rule: (kx>0) | (kx==0 & ky>0) | (kx==0 & ky==0 & kz>0)
    half = (xy[:, 0] > 0)[:, None] | ((xy[:, 0] == 0) & (xy[:, 1] > 0))[:, None] \
        | (((xy[:, 0] == 0) & (xy[:, 1] == 0))[:, None] & (kz > 0)[None, :])
    inc = half & (sqk <= gsqmx) & (sqk > 0)
    preu = 4.0 * math.pi / ksp.volume
    sqk_safe = np.where(inc, sqk, 1.0)
    ug = np.where(inc, preu * np.exp(-0.25 * sqk_safe / ksp.g_ewald ** 2) / sqk_safe, 0.0)
    # drop all-zero xy rows (e.g. xy pairs fully outside the sphere)
    keep = ug.any(axis=1)
    return FactoredKSpace(
        g_ewald=ksp.g_ewald, volume=ksp.volume, slabflag=ksp.slabflag,
        box=ksp.box, unitk=unitk, kxy=xy[keep], kz=kz,
        ug=ug[keep], ug_tot=float(2.0 * ug.sum()),
    )


# ---------------------------------------------------------------------------
# device-side
# ---------------------------------------------------------------------------

def _frac_ku(coord, inv_l, k_int):
    """frac(k * coord/L) in [-0.5, 0.5) with f32-safe precision.

    Naive k*u loses ~k*ulp(u) of phase (k up to several hundred -> 1e-4 rad
    in f32, visible as ~1e-3 charge errors).  Split u into a 12-bit head
    (k*u_hi is EXACT in f32 for |k| <= 4096) and a small tail, reduce the
    head modulo 1 exactly, and add the tail: phase error ~ ulp, not k*ulp.
    """
    u = coord * inv_l
    u = u - jnp.floor(u)
    scale = 4096.0
    u_hi = jnp.round(u * scale) * (1.0 / scale)
    u_lo = u - u_hi
    a = k_int[None, :] * u_hi[:, None]
    a = a - jnp.floor(a)
    ph = a + k_int[None, :] * u_lo[:, None]
    return ph - jnp.round(ph)


def _xy_tables(x, kxy, unitk):
    """(Pr, Pi) (N, nxy) phase tables for the xy axis only."""
    dtype = x.dtype
    ux, uy, _ = unitk
    two_pi = 2.0 * math.pi
    kxi = jnp.asarray(kxy[:, 0], dtype)
    kyi = jnp.asarray(kxy[:, 1], dtype)
    # unitk = 2*pi/L -> coord/L = coord * unitk / (2*pi)
    fx = _frac_ku(x[:, 0], ux / two_pi, kxi)
    fy = _frac_ku(x[:, 1], uy / two_pi, kyi)
    fxy = fx + fy
    phase_xy = two_pi * (fxy - jnp.round(fxy))
    return jnp.cos(phase_xy), jnp.sin(phase_xy)


def _z_tables(x, kz, unitk):
    """(Zr, Zi) (N, nz) phase tables for the z axis only."""
    dtype = x.dtype
    two_pi = 2.0 * math.pi
    fz = _frac_ku(x[:, 2], unitk[2] / two_pi, jnp.asarray(kz, dtype))
    phase_z = two_pi * fz
    return jnp.cos(phase_z), jnp.sin(phase_z)


def axis_tables_kv(x, kxy, kz, unitk):
    """Array-level phase tables — kxy may be a device-local shard."""
    return _xy_tables(x, kxy, unitk), _z_tables(x, kz, unitk)


# Above this kxy count the (N, nxy) tables are scanned in chunks instead of
# materialized (at 100k atoms x 5000+ kxy vectors they are GBs of HBM and the
# sums become memory-bound; S itself is only (nxy, nz) — always small)
KXY_CHUNK = 1024


def _pad_kxy(kxy, chunk):
    """Pad the kxy axis to a chunk multiple.  Trace-safe: shapes are static
    under jit even for traced arrays (the sharded step passes the device-
    local k-shard as a shard_map argument), so jnp.pad works for both
    concrete and traced inputs — np.asarray on a tracer would raise
    TracerArrayConversionError."""
    kxy = jnp.asarray(kxy)
    nxy = kxy.shape[0]
    npad = (-nxy) % chunk
    if npad:
        kxy = jnp.pad(kxy, ((0, npad), (0, 0)))
    return kxy, nxy


def axis_tables(fk: FactoredKSpace, x):
    """(Pr, Pi) (N, nxy) and (Zr, Zi) (N, nz) phase tables."""
    return axis_tables_kv(x, fk.kxy, fk.kz, fk.unitk)


def structure_factor_f(fk: FactoredKSpace, x, q):
    """S(kxy, kz): returns (Sr, Si) each (nxy, nz). 4 real matmuls."""
    return structure_factor_fkv(x, q, fk.kxy, fk.kz, fk.unitk)


def structure_factor_fkv(x, q, kxy, kz, unitk):
    # HIGHEST matmul precision: a reduced-precision default (TF32 on a GPU)
    # injects ~1e-3 relative error into the charge solve
    mm = lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
    if len(kxy) > KXY_CHUNK:
        return _structure_factor_chunked(x, q, kxy, kz, unitk)
    (pr, pi), (zr, zi) = axis_tables_kv(x, kxy, kz, unitk)
    qzr = q[:, None] * zr
    qzi = q[:, None] * zi
    sr = mm(pr.T, qzr) - mm(pi.T, qzi)
    si = mm(pr.T, qzi) + mm(pi.T, qzr)
    return sr, si


def _structure_factor_chunked(x, q, kxy, kz, unitk, chunk=KXY_CHUNK):
    """S(kxy, kz) via a lax.scan over kxy chunks: peak memory O(N*chunk)
    instead of O(N*nxy) — required above ~10^4 atoms where the full xy
    tables are GBs."""
    mm = lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
    kxy_p, nxy = _pad_kxy(kxy, chunk)
    blocks = kxy_p.reshape(-1, chunk, 2)
    zr, zi = _z_tables(x, kz, unitk)
    qzr = q[:, None] * zr
    qzi = q[:, None] * zi

    def body(_, kxy_c):
        pr, pi = _xy_tables(x, kxy_c, unitk)
        sr = mm(pr.T, qzr) - mm(pi.T, qzi)
        si = mm(pr.T, qzi) + mm(pi.T, qzr)
        return None, (sr, si)

    _, (sr, si) = jax.lax.scan(body, None, blocks)
    nz = zr.shape[1]
    return sr.reshape(-1, nz)[:nxy], si.reshape(-1, nz)[:nxy]


def potential_on_points_f(fk: FactoredKSpace, xe, sr, si):
    """phi(xe) = sum 2 ug Re[S conj(Pe) conj(Ze)] — the b-vector readout."""
    return potential_on_points_fkv(xe, sr, si, fk.kxy, fk.kz, fk.unitk, fk.ug)


def potential_on_points_fkv(xe, sr, si, kxy, kz, unitk, ug):
    mm = lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
    (per, pei), (zer, zei) = axis_tables_kv(xe, kxy, kz, unitk)
    ug = jnp.asarray(ug, xe.dtype)
    mr = 2.0 * ug * sr
    mi = 2.0 * ug * si
    # T(e, xy) = sum_z M(xy,z) conj(Ze)(z) -> (Ne, nxy)
    tr = mm(zer, mr.T) + mm(zei, mi.T)
    ti = -mm(zei, mr.T) + mm(zer, mi.T)
    # Re[conj(Pe) T] summed over xy
    return jnp.sum(per * tr + pei * ti, axis=1)


def structure_factor_tab(tabs, q):
    """S(kxy, kz) from precomputed axis tables (2 matmuls, no table build).

    The per-step reuse path: the charge solve's b-vector and the force
    evaluation run at the SAME positions, so the transcendental-heavy phase
    tables are built once per step and shared (the Ewald analogue of the
    pppm rhok_elyte reuse invariant, pppm_conp.cpp:428-450).  The four
    (nxy, N) x (N, nz) products ride TWO matmuls with the real/imag z
    columns concatenated — identical per-element reductions (the contraction
    axis is untouched), half the kernel launches; at il sizes the chain is
    launch-bound, not flop-bound."""
    (pr, pi), (zr, zi) = tabs
    nz = zr.shape[1]
    mm = lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
    qz = q[:, None] * jnp.concatenate([zr, zi], axis=1)     # (N, 2nz)
    a = mm(pr.T, qz)                                        # (nxy, 2nz)
    b = mm(pi.T, qz)
    sr = a[:, :nz] - b[:, nz:]
    si = a[:, nz:] + b[:, :nz]
    return sr, si


def potential_on_points_tab(tabs_pts, sr, si, ug):
    """b-vector readout from precomputed POINT tables (rows of the full
    per-step tables sliced at the electrode indices).  2 matmuls (see
    structure_factor_tab for the concatenated-columns scheme)."""
    (per, pei), (zer, zei) = tabs_pts
    nxy = sr.shape[0]
    mm = lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
    ug = jnp.asarray(ug, per.dtype)
    mr = 2.0 * ug * sr
    mi = 2.0 * ug * si
    m = jnp.concatenate([mr.T, mi.T], axis=1)               # (nz, 2nxy)
    tzr = mm(zer, m)                                        # (Ne, 2nxy)
    tzi = mm(zei, m)
    tr = tzr[:, :nxy] + tzi[:, nxy:]
    ti = tzr[:, nxy:] - tzi[:, :nxy]
    return jnp.sum(per * tr + pei * ti, axis=1)


def energy_forces_cached(fk: FactoredKSpace, q, tabs, sr_elyte, si_elyte,
                         ele_idx, contig=False):
    """(energy, forces) with the per-step caches from the charge solve:
    ``tabs`` are the full-atom axis tables and (sr_elyte, si_elyte) the
    electrolyte structure factor, both computed at the same positions.
    Only the ELECTRODE rows contribute new structure factor (the solve
    changed only electrode charges), so S_all = S_elyte + S_ele costs
    4 matmuls over Ne rows instead of N.  ``contig``: electrodes occupy
    rows [0, Ne) (models.system.electrodes_first layout) — the five row
    gathers become static slices."""
    (pr, pi), (zr, zi) = tabs
    dtype = pr.dtype
    nz = zr.shape[1]
    nxy = pr.shape[1]
    mm = lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
    if contig:
        ne = ele_idx.shape[0]
        per, pei = pr[:ne], pi[:ne]
        zer, zei = zr[:ne], zi[:ne]
        qe = q[:ne]
    else:
        per, pei = pr[ele_idx], pi[ele_idx]
        zer, zei = zr[ele_idx], zi[ele_idx]
        qe = q[ele_idx]
    # electrode S update: 2 concatenated matmuls (see structure_factor_tab)
    qz = qe[:, None] * jnp.concatenate([zer, zei], axis=1)  # (Ne, 2nz)
    ar = mm(per.T, qz)
    br = mm(pei.T, qz)
    sr = sr_elyte + ar[:, :nz] - br[:, nz:]
    si = si_elyte + ar[:, nz:] + br[:, :nz]

    ug = jnp.asarray(fk.ug, dtype)
    e = jnp.sum(ug * (sr * sr + si * si))
    wr = ug * sr
    wi = -ug * si
    ux, uy, uz = fk.unitk
    kzv = jnp.asarray(fk.kz, dtype) * uz
    # G chain: the eight (N, nz) x (nz, nxy) products ride TWO matmuls with
    # the four weighted-S variants concatenated along columns — identical
    # per-element reductions, 4x fewer launches (the il-size chain is
    # launch-bound)
    w4 = jnp.concatenate([wr.T, wi.T, (wr * kzv).T, (wi * kzv).T],
                         axis=1)                             # (nz, 4nxy)
    A = mm(zr, w4)                                           # (N, 4nxy)
    B = mm(zi, w4)
    gr = A[:, :nxy] - B[:, nxy:2 * nxy]
    gi = A[:, nxy:2 * nxy] + B[:, :nxy]
    gzr = A[:, 2 * nxy:3 * nxy] - B[:, 3 * nxy:]
    gzi = A[:, 3 * nxy:] + B[:, 2 * nxy:3 * nxy]
    im_pg = pr * gi + pi * gr
    im_pgz = pr * gzi + pi * gzr
    kmat = jnp.stack([jnp.asarray(fk.kxy[:, 0], dtype) * ux,
                      jnp.asarray(fk.kxy[:, 1], dtype) * uy],
                     axis=1)                                 # (nxy, 2)
    fxy = mm(im_pg, kmat)                                    # (N, 2)
    fz = jnp.sum(im_pgz, axis=1)
    f = 2.0 * q[:, None] * jnp.concatenate([fxy, fz[:, None]], axis=1)
    return e, f


def energy_forces_f(fk: FactoredKSpace, x, q):
    """(energy, forces) without qqr2e prefactor — plain Ewald k-space."""
    return energy_forces_fkv(x, q, fk.kxy, fk.kz, fk.unitk, fk.ug)


def energy_forces_fkv(x, q, kxy, kz, unitk, ug):
    dtype = x.dtype
    mm = lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
    if len(kxy) > KXY_CHUNK:
        return _energy_forces_chunked(x, q, kxy, kz, unitk, ug)
    (pr, pi), (zr, zi) = axis_tables_kv(x, kxy, kz, unitk)
    ug = jnp.asarray(ug, dtype)
    qzr = q[:, None] * zr
    qzi = q[:, None] * zi
    sr = mm(pr.T, qzr) - mm(pi.T, qzi)
    si = mm(pr.T, qzi) + mm(pi.T, qzr)
    e = jnp.sum(ug * (sr * sr + si * si))

    # W = ug conj(S); G_j(xy) = sum_z W Z_j ; Gz with extra kz weight
    wr = ug * sr
    wi = -ug * si
    gr = mm(zr, wr.T) - mm(zi, wi.T)    # (N, nxy)
    gi = mm(zr, wi.T) + mm(zi, wr.T)
    ux, uy, uz = unitk
    kzv = jnp.asarray(kz, dtype) * uz
    gzr = mm(zr, (wr * kzv).T) - mm(zi, (wi * kzv).T)
    gzi = mm(zr, (wi * kzv).T) + mm(zi, (wr * kzv).T)

    # Im[P G] per (j, xy)
    im_pg = pr * gi + pi * gr
    im_pgz = pr * gzi + pi * gzr
    kxv = jnp.asarray(kxy[:, 0], dtype) * ux
    kyv = jnp.asarray(kxy[:, 1], dtype) * uy
    fx = mm(im_pg, kxv)
    fy = mm(im_pg, kyv)
    fz = jnp.sum(im_pgz, axis=1)
    f = 2.0 * q[:, None] * jnp.stack([fx, fy, fz], axis=1)
    return e, f


def _energy_forces_chunked(x, q, kxy, kz, unitk, ug, chunk=KXY_CHUNK):
    """energy_forces_fkv with the kxy axis scanned in chunks.

    Two passes over the chunks (forces need the COMPLETE structure factor),
    each O(N*chunk) memory; S and ug are (nxy, nz) — always small.  The
    z tables (N, nz) are built once and reused by both passes."""
    dtype = x.dtype
    mm = lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
    kxy_p, nxy = _pad_kxy(kxy, chunk)
    nc = kxy_p.shape[0] // chunk
    blocks = kxy_p.reshape(nc, chunk, 2)
    ug = jnp.asarray(ug, dtype)                  # pad rows: ug=0, no effect
    ug_b = jnp.pad(ug, ((0, nc * chunk - nxy), (0, 0))).reshape(nc, chunk, -1)

    zr, zi = _z_tables(x, kz, unitk)
    qzr = q[:, None] * zr
    qzi = q[:, None] * zi

    # pass 1: structure factors per chunk (kept — they are small)
    def sf_body(_, kxy_c):
        pr, pi = _xy_tables(x, kxy_c, unitk)
        sr = mm(pr.T, qzr) - mm(pi.T, qzi)
        si = mm(pr.T, qzi) + mm(pi.T, qzr)
        return None, (sr, si)

    _, (sr_b, si_b) = jax.lax.scan(sf_body, None, blocks)   # (nc, chunk, nz)
    e = jnp.sum(ug_b * (sr_b * sr_b + si_b * si_b))

    ux, uy, uz = unitk
    kzv = jnp.asarray(kz, dtype) * uz

    # pass 2: force accumulation per chunk
    def f_body(carry, inp):
        fx, fy, fz = carry
        kxy_c, ug_c, sr, si = inp
        pr, pi = _xy_tables(x, kxy_c, unitk)
        wr = ug_c * sr
        wi = -ug_c * si
        gr = mm(zr, wr.T) - mm(zi, wi.T)         # (N, chunk)
        gi = mm(zr, wi.T) + mm(zi, wr.T)
        gzr = mm(zr, (wr * kzv).T) - mm(zi, (wi * kzv).T)
        gzi = mm(zr, (wi * kzv).T) + mm(zi, (wr * kzv).T)
        im_pg = pr * gi + pi * gr
        im_pgz = pr * gzi + pi * gzr
        kxv = kxy_c[:, 0].astype(dtype) * ux
        kyv = kxy_c[:, 1].astype(dtype) * uy
        fx = fx + mm(im_pg, kxv)
        fy = fy + mm(im_pg, kyv)
        fz = fz + jnp.sum(im_pgz, axis=1)
        return (fx, fy, fz), None

    n = x.shape[0]
    zero = jnp.zeros((n,), dtype)
    (fx, fy, fz), _ = jax.lax.scan(
        f_body, (zero, zero, zero), (blocks, ug_b, sr_b, si_b))
    f = 2.0 * q[:, None] * jnp.stack([fx, fy, fz], axis=1)
    return e, f


def make_phi_operator_kv(xe, kxy, kz, unitk, ug):
    """p -> phi(xe) for charges p placed AT xe (the self-adjoint k-space
    operator used by matrix-free CG): phi = sum_k 2 ug Re[S(p) conj(E_e)].

    The phase tables of xe are hoisted out of the returned closure so CG
    reuses them across iterations (they dominate the per-apply cost
    otherwise).  With a kxy/ug device shard this returns the shard's partial
    sum — the caller psums over the k axis."""
    mm = lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
    (pr, pi), (zr, zi) = axis_tables_kv(xe, kxy, kz, unitk)
    ug = jnp.asarray(ug, xe.dtype)

    def apply_phi(p):
        qzr = p[:, None] * zr
        qzi = p[:, None] * zi
        sr = mm(pr.T, qzr) - mm(pi.T, qzi)
        si = mm(pr.T, qzi) + mm(pi.T, qzr)
        mr = 2.0 * ug * sr
        mi = 2.0 * ug * si
        tr = mm(zr, mr.T) + mm(zi, mi.T)
        ti = -mm(zi, mr.T) + mm(zr, mi.T)
        return jnp.sum(pr * tr + pi * ti, axis=1)

    return apply_phi


def amatrix_kspace_f(fk: FactoredKSpace, xe, dtype=jnp.float64):
    """K-space A block via factorized tables (for mobile-electrode rebuilds).

    A_ij = sum_k 2 ug (c_i c_j + s_i s_j) = Re sum_k 2 ug e^{ik(ri-rj)};
    computed as real matmuls over the expanded (nxy*nz) axis is O(Ne^2 K) —
    instead contract per-z: A = sum_z [C_z C_z^T + ...] which is still big;
    for setup-time use ops.ewald.amatrix_kspace (direct) — this helper exists
    for parity testing of the factored tables."""
    (pr, pi), (zr, zi) = axis_tables(fk, xe)
    ug = jnp.asarray(fk.ug, dtype)
    # expand E_j(k) = P_j Z_j lazily per z-slab and accumulate
    def body(acc, idx):
        uz_col = ug[:, idx]                      # (nxy,)
        czr = zr[:, idx]                         # (Ne,)
        czi = zi[:, idx]
        er = pr * czr[:, None] - pi * czi[:, None]   # (Ne, nxy)
        ei = pr * czi[:, None] + pi * czr[:, None]
        acc = acc + (er * (2.0 * uz_col)) @ er.T + (ei * (2.0 * uz_col)) @ ei.T
        return acc, None

    acc0 = jnp.zeros((xe.shape[0], xe.shape[0]), dtype)
    acc, _ = jax.lax.scan(body, acc0, jnp.arange(fk.nz))
    return acc


# ---------------------------------------------------------------------------
# host-side (numpy) A-matrix assembly for large K
# ---------------------------------------------------------------------------

PLANE_MAX = 64


def amatrix_kspace_host(xe, ksp: EwaldKSpace, *, plane_max: int = PLANE_MAX,
                        chunk: int = 8192) -> np.ndarray:
    """K-space A block on the host (numpy/BLAS) for production-scale K.

    The device path (ops.ewald.amatrix_kspace) materializes (Ne, K) trig
    tables — ~20 GB each at the 100k-atom config's K≈2.3e6 — and costs
    O(Ne^2 K) flops.  This host path exploits the xy*z factorization
    (reference lowmem mode, km_ewald.cpp:360-363) plus the observation that
    electrode atoms occupy a handful of distinct z values (lattice planes):

        A_ij = Re sum_a Pxy_i,a conj(Pxy_j,a) G_a(plane_i, plane_j)
        G_a(p, q) = sum_b 2 ug[a,b] exp(i kz_b uz (z_p - z_q))

    which is O(Ne^2 nxy + nxy nz P^2) — an ~nz-fold flop reduction (and no
    (Ne, K) tables at all).  Falls back to a K-chunked direct sum (per-axis
    complex power tables gathered per chunk — no transcendentals in the hot
    loop) when the electrodes are NOT plane-structured (P > plane_max).

    Returns the full k-space block INCLUDING the ug_tot diagonal and the
    slab correction, matching ops.ewald.amatrix_kspace bit-for-bit up to
    f64 summation order.
    """
    xe = np.asarray(xe, np.float64)
    ne = xe.shape[0]
    zu, zinv = np.unique(xe[:, 2], return_inverse=True)
    if len(zu) <= plane_max:
        a = _amatrix_host_planes(xe, ksp, zu, zinv)
    else:
        a = _amatrix_host_chunked(xe, ksp, chunk)
    diag = ksp.ug_tot - (2.0 / math.sqrt(math.pi)) * ksp.g_ewald
    np.fill_diagonal(a, diag)
    if ksp.slabflag:
        z = xe[:, 2]
        a = a + (4.0 * math.pi / ksp.volume) * np.outer(z, z)
    return a


def _amatrix_host_planes(xe, ksp, zu, zinv):
    fk = factorize(ksp)
    ux, uy, uz = fk.unitk
    nxy = fk.nxy
    p_cnt = len(zu)
    # G[a, p, q] = sum_b 2 ug[a,b] e^{i kz_b uz (zu_p - zu_q)}  — one zgemm
    dz = (zu[:, None] - zu[None, :]).ravel()                 # (P*P,)
    ez = np.exp(1j * uz * np.outer(fk.kz.astype(np.float64), dz))  # (nz, P*P)
    g = (2.0 * fk.ug) @ ez                                   # (nxy, P*P)
    g = g.reshape(nxy, p_cnt, p_cnt)
    # xy phase tables (Ne, nxy)
    phase = np.outer(xe[:, 0] * ux, fk.kxy[:, 0]) + \
        np.outer(xe[:, 1] * uy, fk.kxy[:, 1])
    pxy = np.exp(1j * phase)
    a = np.zeros((xe.shape[0], xe.shape[0]))
    groups = [np.nonzero(zinv == p)[0] for p in range(p_cnt)]
    for p in range(p_cnt):
        ip = groups[p]
        if not len(ip):
            continue
        for q in range(p, p_cnt):
            jq = groups[q]
            if not len(jq):
                continue
            blk = ((pxy[ip] * g[:, p, q][None, :]) @ pxy[jq].conj().T).real
            a[np.ix_(ip, jq)] = blk
            if q != p:
                a[np.ix_(jq, ip)] = blk.T
    return a


def _amatrix_host_chunked(xe, ksp, chunk):
    """Direct half-space sum, K-chunked: per-axis complex power tables are
    gathered per chunk (no per-element cos/sin — glibc transcendentals are
    ~50x slower than the dgemm this feeds)."""
    xprd, yprd, zprd = ksp.box
    zprd_slab = zprd * (ksp.slab_volfactor if ksp.slabflag else 1.0)
    unitk = np.array([2 * math.pi / xprd, 2 * math.pi / yprd,
                      2 * math.pi / zprd_slab])
    kint = np.rint(ksp.kvecs / unitk).astype(np.int64)       # (K, 3)
    axp = np.exp(1j * unitk[0] * np.outer(xe[:, 0], np.arange(ksp.kxmax + 1)))
    ayp = np.exp(1j * unitk[1] * np.outer(
        xe[:, 1], np.arange(-ksp.kymax, ksp.kymax + 1)))
    azp = np.exp(1j * unitk[2] * np.outer(
        xe[:, 2], np.arange(-ksp.kzmax, ksp.kzmax + 1)))
    ne = xe.shape[0]
    a = np.zeros((ne, ne))
    kcount = ksp.kcount
    for lo in range(0, kcount, chunk):
        hi = min(lo + chunk, kcount)
        ki = kint[lo:hi]
        e = axp[:, ki[:, 0]] * ayp[:, ki[:, 1] + ksp.kymax] \
            * azp[:, ki[:, 2] + ksp.kzmax]                   # (Ne, Kc)
        tw = 2.0 * ksp.ug[lo:hi]
        c = np.ascontiguousarray(e.real)
        s = np.ascontiguousarray(e.imag)
        a += (c * tw) @ c.T + (s * tw) @ s.T
    return a
