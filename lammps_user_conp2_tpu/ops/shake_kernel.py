"""SHAKE / RATTLE constraint iteration as one Pallas-Triton kernel.

The plain path (models/shake.py) is a ``fori_loop`` of small gathers and
elementwise ops: every one of the Gauss-Seidel sweeps over the C
constraint slots is its own chain of tiny device operations.  Clusters
are independent, so here one program owns a block of ``BLOCK`` clusters,
one cluster per thread: it gathers its atoms' coordinates straight from
the global (N, 3) arrays, runs every sweep in registers, and scatters the
corrected rows back into a copy of the input.  One launch per call.

The arithmetic follows models/shake.py slot for slot (same Gauss-Seidel
order, masking and omega); the minimum image rounds half away from zero
where ``jnp.round`` rounds half to even, which only differs for a bond of
exactly half a box length.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

#: clusters per program (one per thread at 4 warps)
BLOCK = 128


def _pack(cons):
    """Cluster tables transposed to (rows, Mp), Mp a multiple of BLOCK:
    atom ids and validity (K rows each), constraint columns ci/cj (2C
    rows) and float parameters [invmi, invmj, dist2, cmask] (4C rows)."""
    atoms = np.asarray(cons.atoms)
    m, k = atoms.shape
    ci, cj = np.asarray(cons.ci), np.asarray(cons.cj)
    c = ci.shape[1]
    mp = -(-m // BLOCK) * BLOCK

    def cols(a, fill=0):
        a = np.asarray(a).T
        return np.pad(a, ((0, 0), (0, mp - m)), constant_values=fill)

    invm = np.asarray(cons.invm)
    prm = np.concatenate([
        cols(np.take_along_axis(invm, ci, axis=1)),
        cols(np.take_along_axis(invm, cj, axis=1)),
        cols(cons.dist2, fill=1.0),
        cols(np.asarray(cons.cmask, np.float64))])
    return dict(
        k=k, c=c, mp=mp,
        atoms=cols(atoms).astype(np.int32),
        amask=cols(np.asarray(cons.amask, np.int32)).astype(np.int32),
        cij=np.concatenate([cols(ci), cols(cj)]).astype(np.int32),
        prm=prm)


def _get_pack(cons):
    if not hasattr(cons, "_triton_pack"):
        object.__setattr__(cons, "_triton_pack", _pack(cons))
    return cons._triton_pack


def _mi(d, length, periodic_ax):
    if periodic_ax:
        return d - length * jnp.floor(d / length + 0.5)
    return d


def _pick(cols, sel):
    """Value of the selected cluster-local column, per cluster."""
    out = cols[0]
    for kk in range(1, len(cols)):
        out = jnp.where(sel[kk], cols[kk], out)
    return out


def _gather(ref, idx):
    return [plgpu.load(ref.at[idx * 3 + a]) for a in range(3)]


def _block_tables(atoms_ref, amask_ref, cij_ref, prm_ref, k, c):
    rows = pl.ds(pl.program_id(0) * BLOCK, BLOCK)
    idx = [atoms_ref[kk, rows] for kk in range(k)]
    valid = [amask_ref[kk, rows] != 0 for kk in range(k)]
    ci = [cij_ref[s, rows] for s in range(c)]
    cj = [cij_ref[c + s, rows] for s in range(c)]
    seli = [[ci[s] == kk for kk in range(k)] for s in range(c)]
    selj = [[cj[s] == kk for kk in range(k)] for s in range(c)]
    prm = [prm_ref[r, rows] for r in range(4 * c)]
    return idx, valid, seli, selj, prm


def _apply(xc, s, seli, selj, invmi, invmj, corr):
    """xc[col i] -= invmi corr; xc[col j] += invmj corr (flat lists)."""
    k = len(xc) // 3
    out = list(xc)
    for kk in range(k):
        for a in range(3):
            v = out[kk * 3 + a]
            v = jnp.where(seli[s][kk], v - invmi * corr[a], v)
            out[kk * 3 + a] = jnp.where(selj[s][kk], v + invmj * corr[a], v)
    return tuple(out)


def _shake_kernel(atoms_ref, amask_ref, cij_ref, prm_ref, xnew_ref, xold_ref,
                  xin_ref, out_ref, *, k, c, iters, omega, box, periodic):
    del xin_ref    # aliased to out_ref: rows outside the clusters pass through
    idx, valid, seli, selj, prm = _block_tables(
        atoms_ref, amask_ref, cij_ref, prm_ref, k, c)
    invmi, invmj, dist2, cmask = (prm[:c], prm[c:2 * c], prm[2 * c:3 * c],
                                  prm[3 * c:])
    xc = tuple(v for kk in range(k) for v in _gather(xnew_ref, idx[kk]))
    xo = [_gather(xold_ref, idx[kk]) for kk in range(k)]
    rold = [[_mi(_pick([xo[kk][a] for kk in range(k)], seli[s])
                 - _pick([xo[kk][a] for kk in range(k)], selj[s]),
                 box[a], periodic[a]) for a in range(3)] for s in range(c)]

    def sweep(_, xc):
        for s in range(c):
            rn = [_mi(_pick(xc[a::3], seli[s]) - _pick(xc[a::3], selj[s]),
                      box[a], periodic[a]) for a in range(3)]
            diff = rn[0] * rn[0] + rn[1] * rn[1] + rn[2] * rn[2] - dist2[s]
            dot = (rn[0] * rold[s][0] + rn[1] * rold[s][1]
                   + rn[2] * rold[s][2])
            denom = 2.0 * (invmi[s] + invmj[s]) * dot
            lam = omega * diff / jnp.where(jnp.abs(denom) > 1e-12, denom,
                                           1e-12)
            lam = jnp.where(cmask[s] != 0, lam, 0.0)
            xc = _apply(xc, s, seli, selj, invmi[s], invmj[s],
                        [lam * rold[s][a] for a in range(3)])
        return xc

    xc = jax.lax.fori_loop(0, iters, sweep, xc)
    for kk in range(k):
        for a in range(3):
            plgpu.store(out_ref.at[idx[kk] * 3 + a], xc[kk * 3 + a],
                        mask=valid[kk])


def _rattle_kernel(atoms_ref, amask_ref, cij_ref, prm_ref, x_ref, vin_ref,
                   out_ref, *, k, c, iters, omega, box, periodic):
    idx, valid, seli, selj, prm = _block_tables(
        atoms_ref, amask_ref, cij_ref, prm_ref, k, c)
    invmi, invmj, cmask = prm[:c], prm[c:2 * c], prm[3 * c:]
    xs = [_gather(x_ref, idx[kk]) for kk in range(k)]
    vc = tuple(v for kk in range(k) for v in _gather(vin_ref, idx[kk]))
    r = [[_mi(_pick([xs[kk][a] for kk in range(k)], seli[s])
              - _pick([xs[kk][a] for kk in range(k)], selj[s]),
              box[a], periodic[a]) for a in range(3)] for s in range(c)]
    denom = []
    for s in range(c):
        dn = (invmi[s] + invmj[s]) * (r[s][0] * r[s][0] + r[s][1] * r[s][1]
                                      + r[s][2] * r[s][2])
        denom.append(jnp.where(dn > 1e-12, dn, 1e-12))

    def sweep(_, vc):
        for s in range(c):
            vij = [_pick(vc[a::3], seli[s]) - _pick(vc[a::3], selj[s])
                   for a in range(3)]
            mu = omega * (vij[0] * r[s][0] + vij[1] * r[s][1]
                          + vij[2] * r[s][2]) / denom[s]
            mu = jnp.where(cmask[s] != 0, mu, 0.0)
            vc = _apply(vc, s, seli, selj, invmi[s], invmj[s],
                        [mu * r[s][a] for a in range(3)])
        return vc

    vc = jax.lax.fori_loop(0, iters, sweep, vc)
    for kk in range(k):
        for a in range(3):
            plgpu.store(out_ref.at[idx[kk] * 3 + a], vc[kk * 3 + a],
                        mask=valid[kk])


def _call(kernel, pk, dtype, flat_args, n3, alias, interpret):
    tables = (jnp.asarray(pk["atoms"]), jnp.asarray(pk["amask"]),
              jnp.asarray(pk["cij"]), jnp.asarray(pk["prm"], dtype))
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((n3,), dtype),
        grid=(pk["mp"] // BLOCK,),
        input_output_aliases={alias: 0},
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name=kernel.func.__name__.strip("_"),
    )(*tables, *flat_args)


def shake_positions_triton(cons, x_new, x_old, dt, *, box, periodic,
                           iters=12, omega=1.0, interpret=False):
    """Drop-in for models.shake.shake_positions: returns (x, dv)."""
    pk = _get_pack(cons)
    n = x_new.shape[0]
    kern = functools.partial(
        _shake_kernel, k=pk["k"], c=pk["c"], iters=iters, omega=omega,
        box=tuple(float(b) for b in box), periodic=tuple(periodic))
    xf = x_new.reshape(-1)
    out = _call(kern, pk, x_new.dtype,
                (xf, x_old.reshape(-1), xf), 3 * n, 6, interpret)
    x = out.reshape(n, 3)
    return x, (x - x_new) / dt


def rattle_velocities_triton(cons, x, v, *, box, periodic, iters=12,
                             omega=1.0, interpret=False):
    """Drop-in for models.shake.rattle_velocities."""
    pk = _get_pack(cons)
    kern = functools.partial(
        _rattle_kernel, k=pk["k"], c=pk["c"], iters=iters, omega=omega,
        box=tuple(float(b) for b in box), periodic=tuple(periodic))
    out = _call(kern, pk, v.dtype, (x.reshape(-1), v.reshape(-1)),
                v.size, 5, interpret)
    return out.reshape(v.shape)
