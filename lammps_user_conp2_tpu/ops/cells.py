"""Cell-list pair interactions for large N (beyond the reference's scales).

The dense all-pairs path (ops/pairs.py) is optimal up to ~10^4 atoms; past
that the O(N^2) sweep loses to a cell list.  This is a jit-static cell
list:

  * cells of edge >= cutoff; atoms binned and sorted by cell id (one sort),
  * fixed per-cell capacity (host-estimated; overflow detected and reported),
  * per atom, candidates = the 27 neighboring cells' slots -> a padded
    (N, 27*cap) candidate matrix processed with the same fused arithmetic as
    the dense path, fully masked, no dynamic shapes.

Cost O(N * 27 * cap) — the crossover vs dense is around box/cutoff ~ 4.
LAMMPS equivalent: neighbor bins + half lists (we use full candidate lists;
each pair evaluated from both sides, matching the dense path's convention).
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from .erfc import EWALD_F
from .pairs import PairTables

EWALD_P = 0.3275911
A1, A2, A3, A4, A5 = (0.254829592, -0.284496736, 1.421413741,
                      -1.453152027, 1.061405429)


@dataclasses.dataclass(frozen=True)
class CellGrid:
    """Static cell decomposition (host-derived)."""
    ncells: tuple          # (cx, cy, cz)
    cap: int               # max atoms per cell (static)
    box: tuple
    box_lo: tuple
    periodic: tuple
    cutoff: float

    @property
    def total(self):
        cx, cy, cz = self.ncells
        return cx * cy * cz


def build_cell_grid(box, box_lo, cutoff, natoms, *, periodic,
                    density_safety=3.0, cap=None) -> CellGrid:
    ns = tuple(max(1, int(b // cutoff)) for b in box)
    vol_cell = (box[0] / ns[0]) * (box[1] / ns[1]) * (box[2] / ns[2])
    mean_per_cell = natoms * vol_cell / (box[0] * box[1] * box[2])
    if cap is None:
        cap = int(math.ceil(mean_per_cell * density_safety)) + 8
    return CellGrid(ncells=ns, cap=cap, box=tuple(box), box_lo=tuple(box_lo),
                    periodic=periodic, cutoff=cutoff)


def bin_atoms(grid: CellGrid, x):
    """Returns (cell_table (C, cap) atom indices padded with N, overflow flag)."""
    n = x.shape[0]
    cx, cy, cz = grid.ncells
    ids = []
    for ax, nc in enumerate(grid.ncells):
        u = (x[:, ax] - grid.box_lo[ax]) / grid.box[ax]
        if grid.periodic[ax]:
            u = u - jnp.floor(u)       # wrap into [0,1)
        # non-periodic axes clip only: an atom drifting past a slab boundary
        # must bin at the boundary cell (wrapping would place it at the
        # opposite end where its real neighbors fall outside the stencil)
        ids.append(jnp.clip((u * nc).astype(jnp.int32), 0, nc - 1))
    cell = (ids[0] * cy + ids[1]) * cz + ids[2]            # (N,)
    order = jnp.argsort(cell)
    cell_sorted = cell[order]
    # rank within cell = position - first position of this cell value,
    # via cummax of segment starts (searchsorted's N binary-search gathers
    # cost several ms at 100k atoms)
    iota = jnp.arange(n, dtype=jnp.int32)
    changed = jnp.concatenate([jnp.ones((1,), bool),
                               cell_sorted[1:] != cell_sorted[:-1]])
    rank = iota - jax.lax.cummax(jnp.where(changed, iota, 0))
    overflow = jnp.max(rank) >= grid.cap
    table = jnp.full((grid.total * grid.cap,), n, jnp.int32)
    slot = cell_sorted * grid.cap + jnp.minimum(rank, grid.cap - 1)
    table = table.at[slot].set(order.astype(jnp.int32))
    return table.reshape(grid.total, grid.cap), cell, overflow


def _neighbor_cells(grid: CellGrid):
    """(C, 27) neighbor cell ids (host numpy, static)."""
    cx, cy, cz = grid.ncells
    idx = np.arange(cx * cy * cz)
    ix, iy, iz = idx // (cy * cz), (idx // cz) % cy, idx % cz
    out = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                jx = (ix + dx) % cx
                jy = (iy + dy) % cy
                jz = (iz + dz) % cz
                out.append((jx * cy + jy) * cz + jz)
    nb = np.stack(out, axis=1)
    # duplicated neighbors when an axis has <3 cells: mask duplicates so a
    # pair is never counted twice
    uniq = np.ones_like(nb, dtype=bool)
    for c in range(nb.shape[0]):
        seen = set()
        for k in range(27):
            if nb[c, k] in seen:
                uniq[c, k] = False
            else:
                seen.add(nb[c, k])
    return nb, uniq


def candidate_columns(grid: CellGrid, x):
    """Bin atoms and build the per-cell candidate matrix.

    Returns (table (C, cap) atom ids padded with N, cols (C, 27*cap)
    candidate atom ids with duplicate-cell slots masked to N, overflow)."""
    n = x.shape[0]
    table, _cell, overflow = bin_atoms(grid, x)
    nb, uniq = _neighbor_cells(grid)
    from ..utils.hoistconst import devconst
    nbd = devconst(grid, "nbcells", lambda: np.asarray(nb))
    uniqd = devconst(grid, "nbuniq", lambda: np.asarray(uniq))
    cols = table[nbd]                            # (C, 27, cap)
    cols = jnp.where(uniqd[:, :, None], cols, n)
    return table, cols.reshape(grid.total, 27 * grid.cap), overflow


TYPE_BITS = 5  # id<<TYPE_BITS | type packing (same budget as ops/neighbors.py)


def cell_slab_tables(grid: CellGrid, x, q, type_idx):
    """Slot-ordered per-cell tables for the slab sweep.

    Returns (table, xq (C, cap, 4) = positions + charge, pt (C, cap) int32 =
    (id << TYPE_BITS) | type, overflow).  Built with ONE (C*cap)-row gather
    each; the sweep then reads candidates as whole-cell SLABS (27 contiguous
    (cap, .) blocks per cell) -- ~cap x fewer gather descriptors than the
    per-atom-id candidate matrix."""
    n = x.shape[0]
    dtype = x.dtype
    table, _cell, overflow = bin_atoms(grid, x)
    sentinel = jnp.asarray([[1e6, 1e6, 1e6, 0.0]], dtype)
    xqp = jnp.concatenate(
        [jnp.concatenate([x, q[:, None].astype(dtype)], axis=1), sentinel],
        axis=0)
    tp = jnp.pad(type_idx, (0, 1)).astype(jnp.int32)     # tp[n] = 0
    xq = xqp[table]                                      # (C, cap, 4)
    pt = (table << TYPE_BITS) | tp[table]
    return table, xq, pt, overflow


def pad_slab_tables(grid: CellGrid, xq, pt, padc: int, n: int):
    """Pad the cell axis to a block multiple: pad cells are empty (ids n,
    type 0, sentinel positions) with no unique neighbors, so padded blocks
    contribute exactly nothing."""
    nb, uniq = _neighbor_cells(grid)
    from ..utils.hoistconst import devconst
    nb_j = devconst(grid, "nbcells", lambda: np.asarray(nb))
    uq_j = devconst(grid, "nbuniq", lambda: np.asarray(uniq))
    if padc:
        xq = jnp.pad(xq, ((0, padc), (0, 0), (0, 0)),
                     constant_values=1e6)
        pt = jnp.pad(pt, ((0, padc), (0, 0)),
                     constant_values=np.int32(n << TYPE_BITS))
        nb_j = jnp.pad(nb_j, ((0, padc), (0, 0)))
        uq_j = jnp.pad(uq_j, ((0, padc), (0, 0)))  # False: all masked
    return xq, pt, nb_j, uq_j


def sweep_cell_slabs(grid: CellGrid, tables: PairTables, xq, pt,
                     nb_blocks, uniq_blocks, c0, *, g_ewald, qqr2e, n):
    """Cell-tile pair sweep, slab formulation: per block of B cells the
    candidates are the 27 neighbor cells' slot slabs, gathered as whole
    (cap, .) blocks from the replicated (C, cap, .) tables -- 27 descriptors
    per cell instead of 27*cap per-atom rows.  Row cells are the contiguous
    range starting at c0 (each device passes its block offset).

    Returns (evdwl, ecoul, fslots (nblk, B, cap, 3)) with the 0.5 full-list
    energy factor applied.  Pair semantics identical to the previous
    id-gather sweep: empty/duplicate candidate slots carry q=0 and type 0
    (zero coefficients), self pairs masked by id equality, sentinel rows
    masked by id < n."""
    dtype = xq.dtype
    cap = xq.shape[1]
    B = nb_blocks.shape[1]
    cutsq = grid.cutoff ** 2
    nt1 = tables.lj1.shape[0]
    hp = jax.lax.Precision.HIGHEST
    tmask = (1 << TYPE_BITS) - 1

    def body(carry, blk):
        ev, ec, kblk = carry
        nbc, uq = blk                            # (B, 27), (B, 27)
        row0 = c0 + kblk * B
        xqi = jax.lax.dynamic_slice_in_dim(xq, row0, B)      # (B, cap, 4)
        pti = jax.lax.dynamic_slice_in_dim(pt, row0, B)      # (B, cap)
        xqj = xq[nbc]                            # (B, 27, cap, 4) slab gather
        ptj = pt[nbc]                            # (B, 27, cap)
        # duplicate-cell slots -> empty (id n, type 0); the id test then
        # masks them out of the pair set exactly like the old cols mask
        ptj = jnp.where(uq[:, :, None], ptj, jnp.int32(n << TYPE_BITS))
        m = 27 * cap
        xqj = xqj.reshape(B, m, 4)
        ptj = ptj.reshape(B, m)
        idi = pti >> TYPE_BITS
        idj = ptj >> TYPE_BITS
        ti = pti & tmask
        tj = ptj & tmask
        d = []
        rsq = jnp.zeros((B, cap, m), dtype)
        for ax in range(3):
            da = xqi[:, :, None, ax] - xqj[:, None, :, ax]   # (B, cap, m)
            if grid.periodic[ax]:
                L = grid.box[ax]
                da = da - L * jnp.round(da * (1.0 / L))
            d.append(da)
            rsq = rsq + da * da
        mask = (rsq < cutsq) & (idi[:, :, None] != idj[:, None, :]) \
            & (idi[:, :, None] < n)
        rsq_safe = jnp.where(mask, rsq, 1.0)
        r2inv = 1.0 / rsq_safe
        r6inv = r2inv * r2inv * r2inv
        # per-pair LJ coefficients via one-hot batched matmuls instead of a
        # (B,cap,m) gather
        ohj = (tj[:, :, None] == jnp.arange(nt1)[None, None, :]).astype(dtype)
        ein = lambda tab: jnp.einsum("bit,bjt->bij", tab[ti], ohj,
                                     precision=hp)
        l1, l2, l3, l4 = (ein(tables.lj1), ein(tables.lj2),
                          ein(tables.lj3), ein(tables.lj4))
        flj = jnp.where(mask, r6inv * (l1 * r6inv - l2) * r2inv, 0.0)
        elj = jnp.where(mask, r6inv * (l3 * r6inv - l4), 0.0)
        r = jnp.sqrt(rsq_safe)
        grij = g_ewald * r
        expm2 = jnp.exp(-grij * grij)
        tt = 1.0 / (1.0 + EWALD_P * grij)
        erfc = tt * (A1 + tt * (A2 + tt * (A3 + tt * (A4 + tt * A5)))) * expm2
        qi = xqi[:, :, 3]
        qj = xqj[:, :, 3]
        pref = qqr2e * qi[:, :, None] * qj[:, None, :] / r
        fcoul = jnp.where(mask, pref * (erfc + EWALD_F * grij * expm2), 0.0)
        ecoul = jnp.where(mask, pref * erfc, 0.0)
        fpair = flj + fcoul * r2inv
        frow = jnp.stack([jnp.sum(fpair * d[0], axis=2),
                          jnp.sum(fpair * d[1], axis=2),
                          jnp.sum(fpair * d[2], axis=2)], axis=2)  # (B,cap,3)
        return (ev + 0.5 * jnp.sum(elj), ec + 0.5 * jnp.sum(ecoul),
                kblk + 1), frow

    (ev, ec, _), fb = jax.lax.scan(
        body, (jnp.zeros((), dtype), jnp.zeros((), dtype), jnp.int32(0)),
        (nb_blocks, uniq_blocks))
    return ev, ec, fb


def cell_pair_forces(grid: CellGrid, x, q, type_idx, tables: PairTables,
                     exclusions, *, g_ewald, qqr2e, cell_block=32):
    """Cell-list LJ + real-space Coulomb; same returns as dense_pair_forces.

    Cell-blocked formulation: per cell, its atoms (cap) interact with the
    27 neighbor cells' atoms (27*cap) as a DENSE tile — gathers are O(N*28)
    elements, the pair
    math is fused elementwise over (cell_block, cap, 27*cap) tiles, and the
    result scatters back through the sort permutation once.

    Also returns the overflow flag as a 4th output (callers should surface
    it; physics is silently wrong if a cell overflows its capacity)."""
    n = x.shape[0]
    dtype = x.dtype
    table, xq, pt, overflow = cell_slab_tables(grid, x, q, type_idx)
    C, cap = table.shape
    nblk = -(-C // cell_block)
    padc = nblk * cell_block - C
    xq_p, pt_p, nb_p, uq_p = pad_slab_tables(grid, xq, pt, padc, n)

    ev, ec, fb = sweep_cell_slabs(
        grid, tables, xq_p, pt_p,
        nb_p.reshape(nblk, cell_block, 27),
        uq_p.reshape(nblk, cell_block, 27),
        jnp.int32(0), g_ewald=g_ewald, qqr2e=qqr2e, n=n)
    # scatter per-slot forces back to atom order (each atom owns one slot)
    fslots = fb.reshape(nblk * cell_block * cap, 3)[:C * cap]
    f = jnp.zeros((n + 1, 3), dtype).at[table.reshape(-1)].add(fslots)[:n]

    df, dev, dec = exclusion_correction(
        x, q, type_idx, tables, exclusions, box=grid.box,
        periodic=grid.periodic, cutsq=grid.cutoff ** 2, qqr2e=qqr2e)
    return f + df, ev + dev, ec + dec, overflow


def exclusion_correction(x, q, type_idx, tables: PairTables, exclusions, *,
                         box, periodic, cutsq, qqr2e):
    """Special-bond corrections applied after an exclusion-blind pair sweep.

    Returns (df (N,3), devdwl, decoul) to ADD to the sweep's outputs; the
    Coulomb part keeps the k-space compensation convention of ops/pairs.py
    (excluded pairs retain -erf(g r)/r)."""
    n = x.shape[0]
    dtype = x.dtype
    boxj = jnp.asarray(box, dtype)
    exi, exv = exclusions
    me = exi.shape[1]
    rows = jnp.repeat(jnp.arange(n), me)
    cols = exi.reshape(-1)
    sval = exv.reshape(-1).astype(dtype)
    valid = cols < n
    cols_safe = jnp.where(valid, cols, 0)
    from .pairs import min_image
    dx_ = min_image(x[rows] - x[cols_safe], boxj, periodic)
    rsq = jnp.sum(dx_ * dx_, axis=1)
    valid = valid & (rsq < cutsq)
    rsq_safe = jnp.where(valid, rsq, 1.0)
    r2inv = 1.0 / rsq_safe
    r6inv = r2inv ** 3
    ti = type_idx[rows]
    tj = type_idx[cols_safe]
    ds = sval - 1.0
    dflj = ds * r6inv * (tables.lj1[ti, tj] * r6inv - tables.lj2[ti, tj]) * r2inv
    delj = ds * r6inv * (tables.lj3[ti, tj] * r6inv - tables.lj4[ti, tj])
    r = jnp.sqrt(rsq_safe)
    pref = qqr2e * q[rows] * q[cols_safe] / r
    dfpair = jnp.where(valid, dflj + ds * pref * r2inv, 0.0)
    df = jnp.zeros((n, 3), dtype).at[rows].add(
        jnp.where(valid[:, None], dfpair[:, None] * dx_, 0.0))
    dev = 0.5 * jnp.sum(jnp.where(valid, delj, 0.0))
    dec = 0.5 * jnp.sum(jnp.where(valid, ds * pref, 0.0))
    return df, dev, dec
