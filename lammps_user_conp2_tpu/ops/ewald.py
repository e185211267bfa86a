"""Classic Ewald summation.

Replaces the reference's KSpaceModuleEwald (reference: km_ewald.cpp) with a
dense-linear-algebra formulation:

  * k-vectors are enumerated once on the host (static shapes) using the same
    accuracy-driven kmax search (reference: km_ewald.cpp:97-113, rms at
    km_ewald.cpp:277-283) and Green's-function weights
    ``ug_k = (4 pi / V) exp(-k^2/4g^2)/k^2`` (reference: km_ewald.cpp:366-381).
  * per-atom trig tables cos(k.x), sin(k.x) are computed directly (no
    recurrences -- the reference's cos/sin recurrences (km_ewald.cpp:446-476)
    are a CPU trick; here a fused transcendental over an (N, K) phase matrix
    produced by an (N,3)@(3,K) matmul),
  * structure factors, b-vectors and the k-space block of the A matrix are
    matmuls over the k axis (reference equivalents: km_ewald.cpp:668-786
    sincos_b + MPI_Allreduce -> here one matmul (+psum when sharded);
    km_ewald.cpp:584-666 aaa_from_sincos_a parity checkerboard -> one
    C diag(2u) C^T + S diag(2u) S^T).

The half-space enumeration convention matches LAMMPS: each +-k pair appears
once with an implicit factor 2 (carried in ``2*ug`` / ``ug_tot``).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

MY_PIS = math.sqrt(math.pi)


# ---------------------------------------------------------------------------
# host-side static setup
# ---------------------------------------------------------------------------

def ewald_rms(km: int, prd: float, natoms: int, q2: float, g_ewald: float) -> float:
    """Standard Ewald k-space RMS force error estimate.

    Mirrors KSpaceModuleEwald::rms (reference: km_ewald.cpp:277-283).
    """
    natoms = max(natoms, 1)
    return (
        2.0 * q2 * g_ewald / prd
        * math.sqrt(1.0 / (math.pi * km * natoms))
        * math.exp(-(math.pi ** 2) * km * km / (g_ewald ** 2 * prd ** 2))
    )


def determine_g_ewald_box(accuracy: float, cutoff: float, natoms: int, q2: float,
                          xprd: float, yprd: float, zprd: float) -> float:
    """g_ewald from the LAMMPS formula (ewald.cpp:init / pppm.cpp:set_grid_global).

    ``accuracy`` is absolute (relative accuracy * two-charge force);
    ``q2 = qsqsum * qqr2e``.
    """
    natoms = max(natoms, 1)
    g = accuracy * math.sqrt(natoms * cutoff * xprd * yprd * zprd) / (2.0 * q2)
    if g >= 1.0:
        g = (1.35 - 0.15 * math.log(accuracy)) / cutoff
    else:
        g = math.sqrt(-math.log(g)) / cutoff
    return g


@dataclasses.dataclass(frozen=True)
class EwaldKSpace:
    """Static k-space tables (host numpy; fed to jit as constants).

    ``kvecs`` holds the half-space k-vectors in Cartesian units (K, 3);
    ``ug`` the Green's weights; ``ug_tot = sum(2*ug)``.
    """
    g_ewald: float
    volume: float           # slab-corrected volume (V * slab_volfactor)
    slabflag: bool
    slab_volfactor: float
    box: tuple              # (xprd, yprd, zprd) -- physical box
    kxmax: int
    kymax: int
    kzmax: int
    kvecs: np.ndarray       # (K, 3) float64, Cartesian 2*pi*n/L
    ug: np.ndarray          # (K,)  float64
    ug_tot: float

    @property
    def kcount(self) -> int:
        return self.kvecs.shape[0]


def setup_ewald(
    *,
    box: tuple,
    accuracy_abs: float,
    g_ewald: float,
    natoms: int,
    q2: float,
    slabflag: bool = False,
    slab_volfactor: float = 1.0,
) -> EwaldKSpace:
    """Accuracy-driven kmax search + half-space k enumeration.

    Mirrors KSpaceModuleEwald::conp_setup (reference: km_ewald.cpp:63-132)
    and make_kvecs_ewald (km_ewald.cpp:285-364); the 7 symmetry groups are
    collapsed into 'one representative of each +-k pair'.
    """
    xprd, yprd, zprd = box
    zprd_slab = zprd * slab_volfactor if slabflag else zprd
    volume = xprd * yprd * zprd_slab
    unitk = np.array([2 * math.pi / xprd, 2 * math.pi / yprd, 2 * math.pi / zprd_slab])

    kmaxes = []
    for prd in (xprd, yprd, zprd_slab):
        km = 1
        while ewald_rms(km, prd, natoms, q2, g_ewald) > accuracy_abs:
            km += 1
        kmaxes.append(km)
    kxmax, kymax, kzmax = kmaxes

    gsqmx = max(
        (unitk[0] * kxmax) ** 2,
        (unitk[1] * kymax) ** 2,
        (unitk[2] * kzmax) ** 2,
    ) * 1.00001

    # Half-space enumeration: one of each +-pair. The set {(k,l,m)} with
    # (k>0) or (k==0 and l>0) or (k==0 and l==0 and m>0), |k_cart|^2 <= gsqmx.
    ks = np.arange(0, kxmax + 1)
    ls = np.arange(-kymax, kymax + 1)
    ms = np.arange(-kzmax, kzmax + 1)
    K, L, M = np.meshgrid(ks, ls, ms, indexing="ij")
    K, L, M = K.ravel(), L.ravel(), M.ravel()
    half = (K > 0) | ((K == 0) & (L > 0)) | ((K == 0) & (L == 0) & (M > 0))
    kc = np.stack([K * unitk[0], L * unitk[1], M * unitk[2]], axis=1)
    sqk = (kc ** 2).sum(axis=1)
    sel = half & (sqk <= gsqmx)
    kvecs = kc[sel]
    sqk = sqk[sel]
    # sort by |k| for stable summation order and better blocking
    order = np.argsort(sqk, kind="stable")
    kvecs = kvecs[order]
    sqk = sqk[order]

    preu = 4.0 * math.pi / volume
    ug = preu * np.exp(-0.25 * sqk / g_ewald ** 2) / sqk
    ug_tot = float((2.0 * ug).sum())

    return EwaldKSpace(
        g_ewald=g_ewald,
        volume=volume,
        slabflag=slabflag,
        slab_volfactor=slab_volfactor,
        box=(xprd, yprd, zprd),
        kxmax=kxmax,
        kymax=kymax,
        kzmax=kzmax,
        kvecs=kvecs,
        ug=ug,
        ug_tot=ug_tot,
    )


# ---------------------------------------------------------------------------
# device-side compute
# ---------------------------------------------------------------------------

def trig_tables(x, kvecs):
    """cos/sin tables (N, K) from positions (N, 3) and kvecs (K, 3)."""
    phase = x @ kvecs.T
    return jnp.cos(phase), jnp.sin(phase)


def structure_factor(x, q, kvecs, *, chunk: int = 4096):
    """S(k) = sum_j q_j e^{i k.x_j} as (ReS, ImS), chunked over k.

    Equivalent of sincos_b + sfac reduce (reference: km_ewald.cpp:668-786);
    on a sharded atom axis callers psum the result.
    """
    K = kvecs.shape[0]
    chunk = min(chunk, max(K, 1))
    nchunk = -(-K // chunk)
    pad = nchunk * chunk - K
    kp = jnp.pad(kvecs, ((0, pad), (0, 0)))
    kp = kp.reshape(nchunk, chunk, 3)

    def body(carry, kblk):
        phase = x @ kblk.T                      # (N, chunk)
        re = q @ jnp.cos(phase)
        im = q @ jnp.sin(phase)
        return carry, (re, im)

    _, (re, im) = jax.lax.scan(body, None, kp)
    return re.reshape(-1)[:K], im.reshape(-1)[:K]


def kspace_potential_on_points(xe, kvecs, ug, sre, sim, *, chunk: int = 4096):
    """phi_k(x_i) = sum_k 2 ug_k (cos_i ReS + sin_i ImS) at points xe (Ne,3).

    The b-vector k-space part is -phi (reference: km_ewald.cpp:789-825
    bbb_from_sincos_b, with csk premultiplied by 2*ug at km_ewald.cpp:501-507).
    """
    K = kvecs.shape[0]
    chunk = min(chunk, max(K, 1))
    nchunk = -(-K // chunk)
    pad = nchunk * chunk - K
    kp = jnp.pad(kvecs, ((0, pad), (0, 0))).reshape(nchunk, chunk, 3)
    wre = jnp.pad(2.0 * ug * sre, (0, pad)).reshape(nchunk, chunk)
    wim = jnp.pad(2.0 * ug * sim, (0, pad)).reshape(nchunk, chunk)

    def body(acc, blk):
        kblk, wr, wi = blk
        phase = xe @ kblk.T                     # (Ne, chunk)
        acc = acc + jnp.cos(phase) @ wr + jnp.sin(phase) @ wi
        return acc, None

    acc0 = jnp.zeros(xe.shape[0], dtype=xe.dtype)
    acc, _ = jax.lax.scan(body, acc0, (kp, wre, wim))
    return acc


def amatrix_kspace(xe, ksp: EwaldKSpace, dtype=jnp.float64):
    """K-space block of the electrode-electrode A matrix.

    A_ij = sum_k 2 ug_k (c_i c_j + s_i s_j);  diagonal = ug_tot - (2/sqrt(pi)) g
    (reference: km_ewald.cpp:584-666).  Slab correction (4pi/V) z_i z_j is
    added when slabflag (km_ewald.cpp:647-665).
    """
    kvecs = jnp.asarray(ksp.kvecs, dtype)
    ug = jnp.asarray(ksp.ug, dtype)
    c, s = trig_tables(xe, kvecs)               # (Ne, K)
    cw = c * (2.0 * ug)
    a = cw @ c.T + (s * (2.0 * ug)) @ s.T
    ne = xe.shape[0]
    diag = ksp.ug_tot - (2.0 / MY_PIS) * ksp.g_ewald
    a = a.at[jnp.arange(ne), jnp.arange(ne)].set(diag)
    if ksp.slabflag:
        z = xe[:, 2]
        a = a + (4.0 * math.pi / ksp.volume) * z[:, None] * z[None, :]
    return a


def ewald_energy_forces(x, q, ksp: EwaldKSpace, *, chunk: int = 2048):
    """Plain Ewald k-space energy and forces for all atoms.

    Half-space formulation: E = sum_halfk ug_k |S(k)|^2 (the +-k doubling
    cancels the 1/2); F_i = 2 q_i sum_halfk 2 ug_k k [sin(k.x_i) ReS -
    cos(k.x_i) ImS] / 2.  Returns (energy, force) WITHOUT the qqr2e
    prefactor; self/background terms are handled by the caller.
    """
    return ewald_energy_forces_kv(
        x, q, jnp.asarray(ksp.kvecs, x.dtype), jnp.asarray(ksp.ug, x.dtype),
        chunk=chunk)


def ewald_energy_forces_kv(x, q, kvecs, ug, *, chunk: int = 2048):
    """ewald_energy_forces over explicit (possibly device-sharded) k arrays."""
    K = kvecs.shape[0]
    chunk = min(chunk, max(K, 1))
    nchunk = -(-K // chunk)
    pad = nchunk * chunk - K
    kp = jnp.pad(kvecs, ((0, pad), (0, 0))).reshape(nchunk, chunk, 3)
    ugp = jnp.pad(ug, (0, pad)).reshape(nchunk, chunk)

    def body(carry, blk):
        e_acc, f_acc = carry
        kblk, ublk = blk
        phase = x @ kblk.T                      # (N, chunk)
        cph = jnp.cos(phase)
        sph = jnp.sin(phase)
        re = q @ cph                            # (chunk,)
        im = q @ sph
        e_acc = e_acc + jnp.sum(ublk * (re * re + im * im))
        # F_i = 2 q_i sum_k ug_k k (sin_i Re - cos_i Im)
        w = sph * (ublk * re)[None, :] - cph * (ublk * im)[None, :]
        f_acc = f_acc + w @ kblk                # (N, 3)
        return (e_acc, f_acc), None

    e0 = jnp.zeros((), x.dtype)
    f0 = jnp.zeros_like(x)
    (e, f), _ = jax.lax.scan(body, (e0, f0), (kp, ugp))
    f = 2.0 * q[:, None] * f
    return e, f


def slab_correction_energy_forces(x, q, volume):
    """Yeh-Berkowitz EW3DC slab correction (kspace_modify slab).

    E = (2 pi / V) M_z^2, F_z_i = -(4 pi / V) q_i M_z (neutral systems).
    ``volume`` must already include the slab volfactor.
    """
    mz = jnp.sum(q * x[:, 2])
    e = 2.0 * math.pi / volume * mz * mz
    fz = -(4.0 * math.pi / volume) * q * mz
    f = jnp.zeros_like(x).at[:, 2].set(fz)
    return e, f
