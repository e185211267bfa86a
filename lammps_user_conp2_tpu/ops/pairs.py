"""Dense real-space pair interactions (LJ + Coulomb/long + CONP corrections).

Design note: the reference consumes LAMMPS half neighbor lists
(fix_conp.cpp:1209-1444).  At the test-suite scales (400-8000 atoms) this
uses an all-pairs (N x N) masked formulation instead of a sparse list:
the distance matrix is one dense batched op, masks fuse into the
elementwise chain, and there is no dynamic shape anywhere.  We block over
rows (lax.scan single-device; one row-shard per device under shard_map) to
bound memory at (block x N).

Physics matches lj/cut/coul/long (LAMMPS pair_lj_cut_coul_long.cpp) with
special_bonds 0 0 0: excluded pairs keep the k-space compensation term
(-erf(g r)/r), i.e. forcecoul -= (1-factor)*prefactor.

The CONP Gaussian correction (blist_coul_cal_post_force,
fix_conp.cpp:1368-1444) subtracts the point-charge/Gaussian difference on
electrode<->electrolyte pairs.  Deviation from the reference, documented:
the reference applies `delx*forcecoul` (missing the 1/r^2; its virial uses
the correct fpair=forcecoul/rsq) and gates on eta^2 r^2 < ERFC_MAX (a typo
for ERFC_MAX^2, limiting the term to r < 1.22 A where no pair ever exists).
We apply the dimensionally correct force delx*forcecoul/rsq with the
intended gate (the ferfcr clamp), which is the behavior the term was
written to produce; at test geometries both versions evaluate to ~0.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .erfc import EWALD_F, ERFC_MAX, erfc_as, erfcr_sqrt, ferfcr_sqrt

# force reductions stay in float32: a GPU's default TF32 contraction keeps
# ~3 decimal digits, far too few for sums over cancelling LJ-wall terms
_HP = jax.lax.Precision.HIGHEST


def min_image(dx, box, periodic):
    """Minimum-image displacement for an orthogonal box.

    box: (3,) lengths; periodic: static tuple of bools.
    """
    out = []
    for ax in range(3):
        d = dx[..., ax]
        if periodic[ax]:
            L = box[ax]
            d = d - L * jnp.round(d / L)
        out.append(d)
    return jnp.stack(out, axis=-1)


class PairTables(NamedTuple):
    """Static per-type tables, prepared on host.

    ``onehot`` (N, nt+1) turns per-pair (itype, jtype) table lookups into
    (B, nt+1) @ (nt+1, N) matmuls instead of a gather over (B, N)
    indices."""
    lj1: jnp.ndarray   # 48 eps sig^12 (force)  (nt+1, nt+1)
    lj2: jnp.ndarray   # 24 eps sig^6
    lj3: jnp.ndarray   # 4 eps sig^12 (energy)
    lj4: jnp.ndarray   # 4 eps sig^6
    onehot: jnp.ndarray  # (N, nt+1)


def make_pair_tables(lj_eps: np.ndarray, lj_sigma: np.ndarray, type_idx,
                     dtype=jnp.float64) -> PairTables:
    s6 = lj_sigma ** 6
    s12 = s6 * s6
    nt1 = lj_eps.shape[0]
    onehot = np.zeros((len(type_idx), nt1))
    onehot[np.arange(len(type_idx)), np.asarray(type_idx)] = 1.0
    return PairTables(
        lj1=jnp.asarray(48.0 * lj_eps * s12, dtype),
        lj2=jnp.asarray(24.0 * lj_eps * s6, dtype),
        lj3=jnp.asarray(4.0 * lj_eps * s12, dtype),
        lj4=jnp.asarray(4.0 * lj_eps * s6, dtype),
        onehot=jnp.asarray(onehot, dtype),
    )


def pair_rowblock(xi, qi, ti, exi, exv, rowvalid, i0, x, q, type_idx, tables, *,
                  box, periodic, cutoff, g_ewald, qqr2e):
    """LJ + real-space Coulomb for one row block.

    xi (B,3), qi (B,), ti (B,); exi/exv (B,m) special-bond exclusion index/
    factor lists (index n = none); rowvalid (B,) bool; i0 () global index of
    the first row.  Returns (f_rows (B,3), evdwl, ecoul) with energies
    already halved for the double count.
    """
    n = x.shape[0]
    bsz = xi.shape[0]
    # scatter the sparse special factors into this block's (B, N) row slice
    si = jnp.ones((bsz, n), x.dtype).at[
        jnp.arange(bsz)[:, None], exi].set(exv.astype(x.dtype), mode="drop")
    cutsq = cutoff * cutoff
    boxj = jnp.asarray(box, x.dtype)
    idx_all = jnp.arange(n)
    dx = min_image(xi[:, None, :] - x[None, :, :], boxj, periodic)  # (B,N,3)
    rsq = jnp.sum(dx * dx, axis=-1)
    iidx = i0 + jnp.arange(xi.shape[0])
    notself = iidx[:, None] != idx_all[None, :]
    inrange = (rsq < cutsq) & notself & rowvalid[:, None]
    rsq_safe = jnp.where(inrange, rsq, 1.0)
    r2inv = 1.0 / rsq_safe
    # LJ — per-pair coefficients via one-hot matmuls (see PairTables)
    r6inv = r2inv * r2inv * r2inv
    lj_on = inrange & (si > 0.0)
    oh = tables.onehot.T                      # (nt+1, N)
    # HIGHEST: bf16 default would round the LJ coefficients (up to ~1e7) at
    # ~0.4% relative — visible in forces
    mm = lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
    l1 = mm(tables.lj1[ti], oh)
    l2 = mm(tables.lj2[ti], oh)
    l3 = mm(tables.lj3[ti], oh)
    l4 = mm(tables.lj4[ti], oh)
    flj = jnp.where(lj_on, si * r6inv * (l1 * r6inv - l2) * r2inv, 0.0)
    elj = jnp.where(lj_on, si * r6inv * (l3 * r6inv - l4), 0.0)
    # Coulomb (erfc + kspace compensation for excluded pairs)
    r = jnp.sqrt(rsq_safe)
    grij = g_ewald * r
    expm2 = jnp.exp(-grij * grij)
    t = 1.0 / (1.0 + 0.3275911 * grij)
    erfc = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
                + t * (-1.453152027 + t * 1.061405429)))) * expm2
    prefactor = qqr2e * qi[:, None] * q[None, :] / r
    fcoul = prefactor * (erfc + EWALD_F * grij * expm2)
    fcoul = fcoul - (1.0 - si) * prefactor
    ecoul_pair = prefactor * erfc - (1.0 - si) * prefactor
    fcoul = jnp.where(inrange, fcoul, 0.0)
    ecoul_pair = jnp.where(inrange, ecoul_pair, 0.0)
    fpair = flj + fcoul * r2inv             # F/r
    f_rows = jnp.einsum("bn,bnc->bc", fpair, dx,
                        precision=_HP)
    return f_rows, 0.5 * jnp.sum(elj), 0.5 * jnp.sum(ecoul_pair)


def _pad_rows(n, block):
    nb = -(-n // block)
    return nb, nb * block - n


def dense_pair_forces(
    x, q, type_idx, tables: PairTables, exclusions, *,
    box, periodic, cutoff, g_ewald, qqr2e, block=512,
):
    """All-pairs LJ + real-space Ewald Coulomb via lax.scan over row blocks.

    exclusions: (excl_idx, excl_val) from models.system.exclusion_lists.
    Returns (forces (N,3), evdwl, ecoul)."""
    n = x.shape[0]
    exi, exv = exclusions
    block = min(block, n)
    nb, pad = _pad_rows(n, block)
    xp = jnp.pad(x, ((0, pad), (0, 0)))
    qp = jnp.pad(q, (0, pad))
    tp = jnp.pad(type_idx, (0, pad))
    exip = jnp.pad(exi, ((0, pad), (0, 0)), constant_values=n)
    exvp = jnp.pad(exv, ((0, pad), (0, 0)))
    rowvalid = jnp.pad(jnp.ones(n, bool), (0, pad))

    def body(carry, blk):
        ev, ec = carry
        xi, qi, ti, ei, evl, rv, i0 = blk
        f_rows, dev, dec = pair_rowblock(
            xi, qi, ti, ei, evl, rv, i0, x, q, type_idx, tables,
            box=box, periodic=periodic, cutoff=cutoff, g_ewald=g_ewald,
            qqr2e=qqr2e)
        return (ev + dev, ec + dec), f_rows

    m = exi.shape[1]
    (ev, ec), fb = jax.lax.scan(
        body, (jnp.zeros((), x.dtype), jnp.zeros((), x.dtype)),
        (xp.reshape(nb, block, 3), qp.reshape(nb, block), tp.reshape(nb, block),
         exip.reshape(nb, block, m), exvp.reshape(nb, block, m),
         rowvalid.reshape(nb, block), jnp.arange(nb) * block),
    )
    return fb.reshape(nb * block, 3)[:n], ev, ec


def conp_correction_rowblock(xi, qi, ti, ei, rowvalid, x, q, is_ele,
                             pair_force_fn, pair_potential_fn, type_idx, *,
                             box, periodic, cutoff, qqr2e):
    """Gaussian correction for one row block; see conp_correction_forces."""
    cutsq = cutoff * cutoff
    boxj = jnp.asarray(box, x.dtype)
    dx = min_image(xi[:, None, :] - x[None, :, :], boxj, periodic)
    rsq = jnp.sum(dx * dx, axis=-1)
    xor = (ei[:, None] != 0) ^ is_ele[None, :]
    mask = xor & (rsq < cutsq) & rowvalid[:, None]
    rsq_safe = jnp.where(mask, rsq, 1.0)
    prefactor = qqr2e * qi[:, None] * q[None, :]
    fk = pair_force_fn(rsq_safe, ti[:, None], type_idx[None, :])
    ek = pair_potential_fn(rsq_safe, ti[:, None], type_idx[None, :])
    forcecoul = jnp.where(mask, prefactor * fk, 0.0)
    epair = jnp.where(mask, prefactor * ek, 0.0)
    fpair = forcecoul / rsq_safe
    f_rows = jnp.einsum("bn,bnc->bc", fpair, dx,
                        precision=_HP)
    return f_rows, 0.5 * jnp.sum(epair)


def conp_correction_forces(
    x, q, elecheck, pair_force_fn, pair_potential_fn, type_idx, *,
    box, periodic, cutoff, qqr2e, ele_idx=None, block=512,
):
    """Gaussian correction force on electrode<->electrolyte pairs.

    pair_force_fn/pair_potential_fn: (rsq, itype, jtype) -> kernel value
    (ETA: fix_conp.cpp:1472-1480; EHGO: fix_conp.cpp:1560-1573).
    Returns (forces, ecoul_correction).

    With ``ele_idx`` given, only the (Ne x N) electrode-row block is swept —
    the electrolyte side comes from the same block's column sums (Newton's
    third law), turning an O(N^2) sweep into O(Ne*N).
    """
    n = x.shape[0]
    is_ele = elecheck != 0
    if ele_idx is not None:
        xi = x[ele_idx]
        qi = q[ele_idx]
        ti = type_idx[ele_idx]
        boxj = jnp.asarray(box, x.dtype)
        dx = min_image(xi[:, None, :] - x[None, :, :], boxj, periodic)
        rsq = jnp.sum(dx * dx, axis=-1)
        # ele rows vs elyte columns only (the xor condition with ele rows)
        mask = (~is_ele)[None, :] & (rsq < cutoff * cutoff)
        rsq_safe = jnp.where(mask, rsq, 1.0)
        prefactor = qqr2e * qi[:, None] * q[None, :]
        fk = pair_force_fn(rsq_safe, ti[:, None], type_idx[None, :])
        ek = pair_potential_fn(rsq_safe, ti[:, None], type_idx[None, :])
        forcecoul = jnp.where(mask, prefactor * fk, 0.0)
        epair = jnp.where(mask, prefactor * ek, 0.0)
        fpair = forcecoul / rsq_safe
        f_rows = jnp.einsum("en,enc->ec", fpair, dx, precision=_HP)
        f_cols = -jnp.einsum("en,enc->nc", fpair, dx, precision=_HP)
        f = f_cols.at[ele_idx].add(f_rows)
        return f, jnp.sum(epair)

    block = min(block, n)
    nb, pad = _pad_rows(n, block)
    xp = jnp.pad(x, ((0, pad), (0, 0)))
    qp = jnp.pad(q, (0, pad))
    tp = jnp.pad(type_idx, (0, pad))
    ep = jnp.pad(elecheck, (0, pad))
    rowvalid = jnp.pad(jnp.ones(n, bool), (0, pad))

    def body(ecoul, blk):
        xi, qi, ti, ei, rv = blk
        f_rows, de = conp_correction_rowblock(
            xi, qi, ti, ei, rv, x, q, is_ele, pair_force_fn, pair_potential_fn,
            type_idx, box=box, periodic=periodic, cutoff=cutoff, qqr2e=qqr2e)
        return ecoul + de, f_rows

    ec, fb = jax.lax.scan(
        body, jnp.zeros((), x.dtype),
        (xp.reshape(nb, block, 3), qp.reshape(nb, block), tp.reshape(nb, block),
         ep.reshape(nb, block), rowvalid.reshape(nb, block)))
    return fb.reshape(nb * block, 3)[:n], ec


def eta_pair_kernels(eta: float):
    """ETA-mode kernels (single Gaussian width).

    potential: -erfc(eta r)/r   force: -(erfc(eta r)/r + 2 eta/sqrt(pi) e^-..)
    (fix_conp.cpp:1472-1480).  The A-matrix variant uses eta/sqrt(2)
    (fix_conp.cpp:1467-1470)."""
    def potential(rsq, itype, jtype):
        return -erfcr_sqrt(eta * eta * rsq) * eta

    def force(rsq, itype, jtype):
        return -ferfcr_sqrt(eta * eta * rsq) * eta

    def potential_A(rsq, itype, jtype):
        e2 = eta * eta * rsq / 2.0
        return -erfcr_sqrt(e2) * eta / math.sqrt(2.0)

    return potential, force, potential_A


def ehgo_pair_kernels(eta_ij: jnp.ndarray, fo_ij: jnp.ndarray, u0_i: jnp.ndarray):
    """EHGO-mode kernels with per-type-pair widths and overlap term
    (fix_conp.cpp:1560-1573).  eta_ij/fo_ij indexed by 1-based types."""
    nt1 = eta_ij.shape[0]

    def lookup(tab, itype, jtype):
        # (R,1) x (1,N) index pattern -> one-hot contraction instead of
        # a (R,N) gather
        if (hasattr(itype, "ndim") and hasattr(jtype, "ndim")
                and itype.ndim == 2 and jtype.ndim == 2
                and itype.shape[1] == 1 and jtype.shape[0] == 1):
            oh = (jtype[0][:, None] == jnp.arange(nt1)[None, :])
            rows = tab[itype[:, 0]]                  # (R, T)
            return jnp.matmul(rows, oh.T.astype(tab.dtype),
                              precision=jax.lax.Precision.HIGHEST)
        return tab[itype, jtype]

    def potential(rsq, itype, jtype):
        et = lookup(eta_ij, itype, jtype)
        fo = lookup(fo_ij, itype, jtype)
        e2 = et * et * rsq
        return fo * jnp.exp(-0.5 * e2) - erfcr_sqrt(e2) * et

    def force(rsq, itype, jtype):
        et = lookup(eta_ij, itype, jtype)
        fo = lookup(fo_ij, itype, jtype)
        e2 = et * et * rsq
        return e2 * fo * jnp.exp(-0.5 * e2) - ferfcr_sqrt(e2) * et

    # A-matrix off-diagonal uses the same pairwise kernel in EHGO mode
    return potential, force, potential


def build_ehgo_tables(ntypes: int, kappa: float, coeffs, evscale: float):
    """eta_ij combination rules and fo_ij overlap prefactors
    (FixConp::ehgo_setup_tables, fix_conp.cpp:1517-1551).

    coeffs: iterable of (type, eta, u0_or_None); u0 None -> 'auto'
    = sqrt(2/pi)*eta/evscale, stored internally *evscale (fix_conp.cpp:1504-1506).
    Returns (eta_i, u0_i, eta_ij, fo_ij) as numpy (ntypes+1 indexed)."""
    s2pis = math.sqrt(2.0) / math.sqrt(math.pi)
    eta_i = np.zeros(ntypes + 1)
    u0_i = np.zeros(ntypes + 1)
    for (t, eta_one, u0_one) in coeffs:
        eta_i[t] = eta_one
        u0 = s2pis * eta_one / evscale if u0_one is None else u0_one
        u0_i[t] = u0 * evscale
    if not (eta_i.any() or u0_i.any()):
        raise ValueError("no EHGO settings found")  # reference falls back to ETA
    f_i = u0_i - s2pis * eta_i
    eta_ij = np.zeros((ntypes + 1, ntypes + 1))
    fo_ij = np.zeros((ntypes + 1, ntypes + 1))
    sq8 = math.sqrt(8.0)
    for i in range(1, ntypes + 1):
        for j in range(1, i + 1):
            if eta_i[i] and eta_i[j]:
                etasq = eta_i[i] ** 2 + eta_i[j] ** 2
                etaprod = eta_i[i] * eta_i[j]
                eta_ij[i, j] = etaprod / math.sqrt(etasq)
                o_ij = sq8 * eta_ij[i, j] ** 3 / (etaprod * math.sqrt(etaprod))
                fo_ij[i, j] = 0.5 * kappa * (f_i[i] + f_i[j]) * o_ij
            else:
                eta_ij[i, j] = eta_i[i] + eta_i[j]
            eta_ij[j, i] = eta_ij[i, j]
            fo_ij[j, i] = fo_ij[i, j]
    return eta_i, u0_i, eta_ij, fo_ij
