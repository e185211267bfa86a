"""Compacted Verlet neighbor lists with skin — the large-N pair path.

The cell-block sweep (ops/cells.py) evaluates the full pair chain on every
padded candidate slot: at 100k atoms that is ~270M slots per step for ~15M
real pairs (LAMMPS's own answer is half neighbor lists rebuilt on a skin
criterion — SURVEY.md section 2.3-1).  This module compacts the candidates
ONCE into a per-atom (N, K) index list (top_k on candidate distances within
cutoff+skin) and runs the expensive erfc/LJ chain only on those slots; the
list is reused until any atom moves more than skin/2 (checked inside the
jitted step, rebuild via lax.cond with identical shapes).

LJ coefficient pairs are pre-gathered into (N, K) tables at build time, so
the per-step work is three gathers (x, q at the neighbor indices) plus the
fused chain on (N, K).

Reference analogue: LAMMPS neighbor bins + skin + check_distance
(neighbor list machinery the plugin relies on, fix_conp.cpp:1242-1276 loops).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .cells import CellGrid, candidate_columns, exclusion_correction
from .erfc import EWALD_F
from .pairs import PairTables, min_image

EWALD_P = 0.3275911
A1, A2, A3, A4, A5 = (0.254829592, -0.284496736, 1.421413741,
                      -1.453152027, 1.061405429)


class NeighborList(NamedTuple):
    """Pytree carried through the scan (all shapes static).

    The optional block fields (None unless NeighborConfig.block > 0) hold
    the BLOCK (cluster) form of the same list: i-blocks of B cell-sorted
    atoms share one j-union row of width U, so the per-step sweep gather
    drops from N*K to (N/B)*U rows (5.56M -> 1.6M at the 100k config, B=8)
    for ~1.8x more masked pair slots."""
    idx: jnp.ndarray        # (N, K) neighbor atom ids, padded with N
    x_ref: jnp.ndarray      # (N, 3) positions at build time
    lj: jnp.ndarray         # (4, N, K) pre-gathered lj1/lj2/lj3/lj4 pairs
    overflow: jnp.ndarray   # () bool — K/U or cell capacity exceeded
    bun: jnp.ndarray = None    # (NB, U) union neighbor ids, padded with N
    brows: jnp.ndarray = None  # (NB, B) block atom ids, padded with N
    binv: jnp.ndarray = None   # (N,) original atom -> flat (block, slot)
    bcr: jnp.ndarray = None    # (4, NB, B, nt+1) lj coeff rows per block atom
    btu: jnp.ndarray = None    # (NB, U) union neighbor types (nt = pad)


@dataclasses.dataclass(frozen=True)
class NeighborConfig:
    """Static list parameters; grid cells have edge >= cutoff + skin."""
    grid: CellGrid
    k_max: int
    cutoff: float           # force cutoff (list radius = grid.cutoff)
    skin: float
    block: int = 0          # i-block size B (0 = no block list)
    u_max: int = 0          # j-union width U per block


def make_neighbor_config(box, box_lo, cutoff, natoms, *, periodic,
                         skin=1.0, k_max=None,
                         density_safety=3.0, x0=None, block=0,
                         u_max=None) -> NeighborConfig:
    from .cells import build_cell_grid
    grid = build_cell_grid(box, box_lo, cutoff + skin, natoms,
                           periodic=periodic, density_safety=density_safety)
    if x0 is not None:
        # tighten the per-cell capacity to the ACTUAL max occupancy at x0
        # (+30% headroom, lane-rounded): cap sets both the candidate sort
        # width (27*cap) and the rsq sweep of every rebuild, and the 3x
        # mean-density default over-sizes it ~2x.  Engine.run's overflow
        # recovery (grow-and-retry) is the backstop for density drift.
        occ = _max_cell_occupancy(grid, np.asarray(x0))
        cap = int(np.ceil(occ * 1.3 / 8.0) * 8) + 8
        grid = dataclasses.replace(grid, cap=min(cap, natoms))
    if k_max is None:
        if x0 is not None:
            # size from the ACTUAL max neighbor count at x0: conp systems
            # are strongly inhomogeneous (dense electrode lattice planes vs
            # dilute electrolyte), so a mean-density estimate can undersize
            # the list for electrode atoms and NaN-poison mid-run.  1.5x
            # headroom for density fluctuations; Engine.run's overflow
            # recovery (grow-and-retry) is the backstop.
            nmax = count_max_neighbors(grid, np.asarray(x0))
            k_max = int(np.ceil(nmax * 1.5 / 8.0) * 8) + 8
        else:
            # expected neighbors in the list sphere x 1.6 safety, lane-rounded
            rho = natoms / (box[0] * box[1] * box[2])
            nexp = rho * 4.0 / 3.0 * np.pi * (cutoff + skin) ** 3
            k_max = int(np.ceil(nexp * 1.6 / 8.0) * 8) + 8
    if block and u_max is None:
        # fallback heuristic when no positions are given (build_engine
        # replaces this with 1.3x the EXACT union count at x0, via
        # max_union_count); measured at the 100k config the B=8 union maxes
        # at ~1.8x k_max (tools/exp_block_union.py) — 2.4x covers drift.
        # Engine.run's overflow recovery regrows U like it regrows K.
        u_max = int(np.ceil(2.4 * k_max * (block / 8.0) ** 0.585 / 8.0) * 8)
    return NeighborConfig(grid=grid, k_max=int(k_max), cutoff=float(cutoff),
                          skin=float(skin), block=int(block),
                          u_max=int(u_max or 0))


def _max_cell_occupancy(grid: CellGrid, x: np.ndarray) -> int:
    """Host-side max atoms per cell at positions x (mirrors bin_atoms's
    wrap/clip binning exactly)."""
    ids = []
    for ax, nc in enumerate(grid.ncells):
        u = (x[:, ax] - grid.box_lo[ax]) / grid.box[ax]
        if grid.periodic[ax]:
            u = u - np.floor(u)
        ids.append(np.clip((u * nc).astype(np.int64), 0, nc - 1))
    cx, cy, cz = grid.ncells
    cell = (ids[0] * cy + ids[1]) * cz + ids[2]
    return int(np.bincount(cell, minlength=grid.total).max())


def count_max_neighbors(grid: CellGrid, x, cell_chunk: int = 256) -> int:
    """Exact max per-atom neighbor count within grid.cutoff at positions x
    (setup-time sizing).  Scanned over cell chunks: the full (C, cap, m)
    candidate cube is GBs at 100k atoms and OOMs the device in one shot."""
    x = jnp.asarray(x)
    n = x.shape[0]
    table, cols, _ = candidate_columns(grid, x)
    c = table.shape[0]
    padc = (-c) % cell_chunk
    table = jnp.pad(table, ((0, padc), (0, 0)), constant_values=n)
    cols = jnp.pad(cols, ((0, padc), (0, 0)), constant_values=n)
    sentinel = jnp.asarray([[1e6, 1e6, 1e6]], x.dtype)
    xp = jnp.concatenate([x, sentinel], axis=0)
    boxj = jnp.asarray(grid.box, x.dtype)
    nblk = table.shape[0] // cell_chunk

    def body(_, blk):
        tb, cb = blk
        d = xp[tb][:, :, None, :] - xp[cb][:, None, :, :]
        d = min_image(d, boxj, grid.periodic)
        rsq = jnp.sum(d * d, axis=-1)
        inr = (tb[:, :, None] != cb[:, None, :]) \
            & (tb[:, :, None] < n) & (cb[:, None, :] < n) \
            & (rsq < grid.cutoff ** 2)
        return None, jnp.max(jnp.sum(inr, axis=2))

    _, maxes = jax.lax.scan(
        body, None,
        (table.reshape(nblk, cell_chunk, -1), cols.reshape(nblk, cell_chunk, -1)))
    return int(jnp.max(maxes))


# bits reserved for the neighbor's atom type in the packed sort key
_TYPE_BITS = 5
_TYPE_MASK = (1 << _TYPE_BITS) - 1


# atom rows per scan block of the rebuild sweep: bounds the (chunk, m, 3)
# displacement transient to ~90 MB at the production m
_ROW_CHUNK = 8192


def build_neighbor_list(ncfg: NeighborConfig, x, tables: PairTables,
                        type_idx) -> NeighborList:
    """Compact candidates into (N, K) with ONE int32 sort per row.

    The candidate's atom id and type are packed into a single key
    ``(id << 5) | type``; an ascending lax.sort brings the in-range
    candidates to the front of each row, and the selected ids AND neighbor
    types decode straight out of the sorted keys.  This replaces the
    previous top_k + take_along_axis + (N, K) table gathers; the LJ
    coefficient pairs are then accumulated per type with dense masked
    FMAs, no gathers.

    ATOM-MAJOR: the candidate sweep and the compaction sort run on
    (N, 27*cap) rows — one row per REAL atom — not on the (C*cap, 27*cap)
    cell-slot layout, which is padded cap/mean-occupancy ~ 2.5-5x at
    production densities and made the rebuild memory-traffic-bound (both
    the rsq sweep and the sort ran on mostly-pad rows).
    Cell-major candidate tables are built once with slab gathers (27
    descriptors per cell); each atom then row-gathers its cell's candidate
    row (N descriptors total).  Chunked over row blocks (lax.scan) to
    bound the transients.  The sharded engine keeps the cell-block variant
    (_cell_block_keys) — its device split is over cells."""
    grid = ncfg.grid
    n = x.shape[0]
    k = ncfg.k_max
    dtype = x.dtype
    from .cells import _neighbor_cells, bin_atoms
    table, cell, overflow = bin_atoms(grid, x)           # (C, cap), (N,)
    nb, uniq = _neighbor_cells(grid)
    tp = jnp.pad(type_idx, (0, 1)).astype(jnp.int32)     # tp[n] = 0
    ptab = (table << _TYPE_BITS) | tp[table]             # packed (id, type)
    sentinel = jnp.asarray([[1e6, 1e6, 1e6]], dtype)
    xp = jnp.concatenate([x, sentinel], axis=0)
    xi = xp[table]                                       # (C, cap, 3)
    cap = table.shape[1]
    m = 27 * cap
    # hoisted device constants (utils/hoistconst): ~1.7 MB at the 100k grid
    from ..utils.hoistconst import devconst
    nbd = devconst(grid, "nbcells", lambda: np.asarray(nb))
    uniqd = devconst(grid, "nbuniq", lambda: np.asarray(uniq))
    pcols = jnp.where(uniqd[:, :, None],
                      ptab[nbd],
                      jnp.int32(n << _TYPE_BITS)).reshape(-1, m)   # (C, m)
    xj = xi[nbd].reshape(-1, m, 3)                       # (C, m, 3)
    miss = jnp.int32((n + 1) << _TYPE_BITS)
    rlistsq = grid.cutoff ** 2
    boxj = jnp.asarray(grid.box, dtype)

    chunk = min(_ROW_CHUNK, n)
    npad = (-n) % chunk
    xr = jnp.concatenate([x, jnp.tile(sentinel, (npad, 1))], axis=0)
    cellr = jnp.pad(cell, (0, npad))
    rowid = jnp.arange(n + npad, dtype=jnp.int32)

    def body(_, blk):
        xb, cb, rb = blk
        pc = pcols[cb]                                   # (chunk, m)
        d = min_image(xb[:, None, :] - xj[cb], boxj, grid.periodic)
        rsq = jnp.sum(d * d, axis=-1)
        colsb = pc >> _TYPE_BITS
        valid = (colsb != rb[:, None]) & (colsb < n) & (rb[:, None] < n)
        inr = valid & (rsq < rlistsq)
        key = jnp.where(inr, pc, miss)
        sk = jax.lax.sort(key, dimension=1)[:, :k]
        return None, (sk, jnp.max(jnp.sum(inr, axis=1)) > k)

    _, (sks, ovfs) = jax.lax.scan(
        body, None,
        (xr.reshape(-1, chunk, 3), cellr.reshape(-1, chunk),
         rowid.reshape(-1, chunk)))
    sk = sks.reshape(-1, k)[:n]
    # block mode: the sweep reads bcr/btu, never the per-atom LJ planes —
    # skip building them ((4, N, K) is ~90 MB at the 100k config, and every
    # carried byte is copied through the per-step reneighbor lax.cond)
    nlist = _decode_list(ncfg, x, sk, overflow | jnp.any(ovfs),
                         type_idx, tables, build_lj=not ncfg.block)
    if ncfg.block:
        nlist = _attach_block_list(ncfg, x, nlist, cell, type_idx, tables)
    return nlist


def _block_union_sorted(ncfg: NeighborConfig, x, idx, cell):
    """Shared core of the union build: cell-sorted block rows, the
    ascending-id sort of the blocks' concatenated (B*K) neighbor rows, the
    first-occurrence mask, and per-block unique counts."""
    n = x.shape[0]
    B, k = ncfg.block, ncfg.k_max
    perm = jnp.argsort(cell).astype(jnp.int32)            # cell-sorted atoms
    nb_ = -(-n // B)
    rows = jnp.concatenate(
        [perm, jnp.full((nb_ * B - n,), n, jnp.int32)]).reshape(nb_, B)
    idxp = jnp.concatenate([idx, jnp.full((1, k), n, idx.dtype)])
    cand = idxp[rows].reshape(nb_, B * k)                 # row gather (NB*B)
    su = jax.lax.sort(cand, dimension=1)
    first = jnp.concatenate(
        [jnp.ones((nb_, 1), bool), su[:, 1:] != su[:, :-1]], axis=1) & (su < n)
    return perm, rows, su, first, jnp.sum(first, axis=1)


def max_union_count(ncfg: NeighborConfig, x, nlist: NeighborList) -> int:
    """Exact max block-union width at positions x — build_engine uses this
    to size u_max (1.3x headroom) the same way k_max is sized from the
    exact neighbor count at x0."""
    from .cells import bin_atoms
    _, cell, _ = bin_atoms(ncfg.grid, x)
    _, _, _, _, cnt = _block_union_sorted(ncfg, x, nlist.idx, cell)
    return int(jnp.max(cnt))


def _attach_block_list(ncfg: NeighborConfig, x, nlist: NeighborList, cell,
                       type_idx, tables: PairTables) -> NeighborList:
    """Derive the block (cluster) form of the list: i-blocks of B
    consecutive CELL-SORTED atoms share the sorted-unique union of their
    (N, K) rows.  Runs at rebuild cadence; the per-step win is the
    descriptor count of the sweep gather (see NeighborList docstring).

    Union construction is two row sorts on (NB, B*K): ascending id sort
    brings duplicates together; a second key sort by first-occurrence
    position compacts the unique ids to the row front.  Union width
    overflow (> U real uniques) NaN-poisons via the shared overflow flag —
    Engine.run regrows u_max exactly like k_max."""
    n = x.shape[0]
    B, U = ncfg.block, ncfg.u_max
    k = ncfg.k_max
    perm, rows, su, first, cnt = _block_union_sorted(ncfg, x, nlist.idx, cell)
    nb_ = rows.shape[0]
    ovf = jnp.max(cnt) > U
    big = jnp.int32(B * k)
    pos = jnp.where(first, jnp.arange(B * k, dtype=jnp.int32)[None, :], big)
    _, uvals = jax.lax.sort((pos, su), dimension=1, num_keys=1)
    un = jnp.where(jnp.arange(U)[None, :] < cnt[:, None], uvals[:, :U], n)
    # inverse map back to original atom order (flat rows[:n] == perm)
    binv = jnp.zeros((n,), jnp.int32).at[perm].set(
        jnp.arange(n, dtype=jnp.int32))
    # LJ coefficient rows + union types; the (4, NB, B, U) pre-typed planes
    # are NOT materialized — at 100k they are ~240 MB of resident state and
    # per-step HBM stream where the per-type masked FMA the sweep needs is
    # 4*nt cheap elementwise passes, expanded on the fly.
    dtype = x.dtype
    ti = jnp.asarray(type_idx)
    c_at = jnp.stack([tables.lj1[ti], tables.lj2[ti],
                      tables.lj3[ti], tables.lj4[ti]]).astype(dtype)
    nt1 = c_at.shape[2]
    c_rows = jnp.concatenate(
        [c_at, jnp.zeros((4, 1, nt1), dtype)], axis=1)[:, rows]  # (4,NB,B,nt)
    tp = jnp.pad(ti, (0, 1)).astype(jnp.int32)
    tu = tp[un]                                           # (NB, U)
    return nlist._replace(bun=un, brows=rows, binv=binv, bcr=c_rows, btu=tu,
                          overflow=nlist.overflow | ovf)


def _nlist_prep(ncfg: NeighborConfig, x, table, type_idx):
    """Whole-domain inputs of the candidate selection: packed (id, type)
    table, binned positions, neighbor-cell map.  Small ((C, cap)-sized) —
    computed replicated; the (C, cap, 27*cap) selection itself can then be
    sharded over cell blocks (_cell_block_keys)."""
    grid = ncfg.grid
    n = x.shape[0]
    from .cells import _neighbor_cells
    nb, uniq = _neighbor_cells(grid)
    tp = jnp.pad(type_idx, (0, 1)).astype(jnp.int32)     # tp[n] = 0
    ptab = (table << _TYPE_BITS) | tp[table]             # packed (id, type)
    sentinel = jnp.asarray([[1e6, 1e6, 1e6]], x.dtype)
    xp = jnp.concatenate([x, sentinel], axis=0)
    xi = xp[table]                                       # (C, cap, 3)
    # hoisted device constants: the (C, 27) cell map is ~1.7 MB at the 100k
    # grid and appears in every program that rebuilds the list
    from ..utils.hoistconst import devconst
    nbd = devconst(grid, "nbcells", lambda: np.asarray(nb))
    uniqd = devconst(grid, "nbuniq", lambda: np.asarray(uniq))
    return table, ptab, xi, nbd, uniqd


def _cell_block_keys(ncfg: NeighborConfig, x, prep, c0, cblk):
    """Sorted candidate keys for cells [c0, c0+cblk): (cblk*cap, k) int32
    plus the block's capacity-overflow flag.  The O(C cap^2 27) distance
    sweep and the row sort — the expensive parts of a rebuild — run on the
    block only, so devices can split the cell axis (parallel/sharded.py)."""
    grid = ncfg.grid
    n = x.shape[0]
    dtype = x.dtype
    k = ncfg.k_max
    table, ptab, xi, nb, uniq = prep
    cap = table.shape[1]
    table_b = jax.lax.dynamic_slice_in_dim(table, c0, cblk)
    nb_b = jax.lax.dynamic_slice_in_dim(nb, c0, cblk)
    uniq_b = jax.lax.dynamic_slice_in_dim(uniq, c0, cblk)
    xi_b = jax.lax.dynamic_slice_in_dim(xi, c0, cblk)
    pcols = ptab[nb_b]                                   # (cblk, 27, cap)
    pcols = jnp.where(uniq_b[:, :, None], pcols,
                      jnp.int32(n << _TYPE_BITS))
    m = 27 * cap
    pcols = pcols.reshape(cblk, m)
    cols = pcols >> _TYPE_BITS                           # candidate ids
    # candidate positions by gathering whole CELL SLABS (27 contiguous
    # (cap, 3) blocks per cell) instead of m scattered per-atom rows —
    # 27x fewer gather descriptors on the same data.  Duplicate-cell slots
    # carry real positions here but their ids are masked to n in pcols, so
    # `valid` already excludes them.
    xj = xi[nb_b].reshape(cblk, m, 3)                    # (cblk, 27, cap, 3)
    boxj = jnp.asarray(grid.box, dtype)
    d = xi_b[:, :, None, :] - xj[:, None, :, :]
    d = min_image(d, boxj, grid.periodic)
    rsq = jnp.sum(d * d, axis=-1)                        # (cblk, cap, m)
    valid = (table_b[:, :, None] != cols[:, None, :]) \
        & (table_b[:, :, None] < n) & (cols[:, None, :] < n)
    rlistsq = grid.cutoff ** 2
    inr = valid & (rsq < rlistsq)
    ovf = jnp.max(jnp.sum(inr, axis=2)) > k
    miss = jnp.int32((n + 1) << _TYPE_BITS)
    key = jnp.where(inr, pcols[:, None, :], miss)        # (cblk, cap, m)
    skey = jax.lax.sort(key.reshape(cblk * cap, m), dimension=1)[:, :k]
    return skey, ovf


def _scatter_rows(prep, skey, c0, cblk, *, n, k):
    """Block keys -> per-atom rows (n, k): each real atom owns exactly one
    slot (pad/empty slots land on the discarded row n).  Rows outside the
    block stay at `miss`, so sharded blocks merge with an elementwise
    minimum (parallel/sharded.py uses lax.pmin)."""
    table = prep[0]
    miss = jnp.int32((n + 1) << _TYPE_BITS)
    table_b = jax.lax.dynamic_slice_in_dim(table, c0, cblk)
    return jnp.full((n + 1, k), miss, jnp.int32).at[
        table_b.reshape(-1)].set(skey)[:n]


def _decode_list(ncfg, x, sk, overflow, type_idx, tables,
                 build_lj=True) -> NeighborList:
    """(n, k) packed keys -> NeighborList (ids, LJ coefficient planes).

    ``build_lj=False`` skips the (4, N, K) coefficient planes entirely —
    the block sweep never reads them (it carries bcr/btu instead), and at
    100k atoms they are ~90 MB of rebuild work + per-step cond-copy
    traffic."""
    n = x.shape[0]
    k = ncfg.k_max
    dtype = x.dtype
    miss = jnp.int32((n + 1) << _TYPE_BITS)
    hit = sk < miss
    idx = jnp.where(hit, sk >> _TYPE_BITS, n)
    if not build_lj:
        return NeighborList(idx=idx, x_ref=x, lj=None, overflow=overflow)
    tj = sk & _TYPE_MASK                                 # 0 on misses
    # LJ pair coefficients without gathers: per-type masked accumulation
    # (nt is a small static; types are static between rebuilds)
    ti = jnp.asarray(type_idx)
    c_at = jnp.stack([tables.lj1[ti], tables.lj2[ti],
                      tables.lj3[ti], tables.lj4[ti]]).astype(dtype)
    nt1 = c_at.shape[2]
    if nt1 > (1 << _TYPE_BITS):
        raise ValueError(f"{nt1} atom types exceed the packed-key budget "
                         f"({1 << _TYPE_BITS}); raise _TYPE_BITS")
    lj = jnp.zeros((4, n, k), dtype)
    for t in range(nt1):
        mask_t = (tj == t).astype(dtype)
        lj = lj + mask_t[None] * c_at[:, :, t][:, :, None]
    return NeighborList(idx=idx, x_ref=x, lj=lj,
                        overflow=overflow)


def needs_rebuild(ncfg: NeighborConfig, nlist: NeighborList, x) -> jnp.ndarray:
    """True when any atom moved more than skin/2 since the list was built."""
    disp = x - nlist.x_ref
    return jnp.max(jnp.sum(disp * disp, axis=1)) > (0.5 * ncfg.skin) ** 2


def nlist_pair_rows(ncfg: NeighborConfig, x, q, xi, qi, idx_rows, lj_rows, *,
                    g_ewald, qqr2e):
    """Row-block Verlet-list sweep: forces on the block's atoms plus the
    block's energy partial sums.  The multi-chip path shards the N axis
    with this (each device owns N/D rows; forces all_gather, energies psum).

    ``xi``/``qi``/``idx_rows`` are the block's (nrow,)-leading slices;
    ``lj_rows`` is (4, nrow, K).  Returns (f_rows (nrow, 3), ev, ec) with
    the 0.5 full-list energy factor applied."""
    n = x.shape[0]
    dtype = x.dtype
    # packed position+charge gather: one descriptor set, not two (see
    # nlist_pair_forces)
    sentinel = jnp.asarray([[1e6, 1e6, 1e6, 0.0]], dtype)
    xqp = jnp.concatenate(
        [jnp.concatenate([x, q[:, None].astype(dtype)], axis=1), sentinel],
        axis=0)
    xqj = xqp[idx_rows]
    xj = xqj[..., :3]
    qj = xqj[..., 3]
    boxj = jnp.asarray(ncfg.grid.box, dtype)
    d = min_image(xi[:, None, :] - xj, boxj, ncfg.grid.periodic)
    rsq = jnp.sum(d * d, axis=-1)
    mask = (idx_rows < n) & (rsq < ncfg.cutoff ** 2)
    rsq_safe = jnp.where(mask, rsq, 1.0)
    r2inv = 1.0 / rsq_safe
    r6inv = r2inv * r2inv * r2inv
    l1, l2, l3, l4 = lj_rows
    flj = jnp.where(mask, r6inv * (l1 * r6inv - l2) * r2inv, 0.0)
    elj = jnp.where(mask, r6inv * (l3 * r6inv - l4), 0.0)
    r = jnp.sqrt(rsq_safe)
    grij = g_ewald * r
    expm2 = jnp.exp(-grij * grij)
    tt = 1.0 / (1.0 + EWALD_P * grij)
    erfc = tt * (A1 + tt * (A2 + tt * (A3 + tt * (A4 + tt * A5)))) * expm2
    pref = qqr2e * qi[:, None] * qj / r
    fcoul = jnp.where(mask, pref * (erfc + EWALD_F * grij * expm2), 0.0)
    ecoul = jnp.where(mask, pref * erfc, 0.0)
    fpair = flj + fcoul * r2inv
    f_rows = jnp.sum(fpair[:, :, None] * d, axis=1)
    return f_rows, 0.5 * jnp.sum(elj), 0.5 * jnp.sum(ecoul)


def nlist_pair_forces(ncfg: NeighborConfig, nlist: NeighborList, x, q,
                      type_idx, tables: PairTables, exclusions, *,
                      g_ewald, qqr2e):
    """LJ + real-space Coulomb from the compacted list; same returns as
    dense_pair_forces plus the overflow flag.  Each pair appears in both
    atoms' lists (full list): energies carry the usual 0.5."""
    n = x.shape[0]
    dtype = x.dtype
    idx = nlist.idx
    # ONE packed (N, K)-row gather for positions AND charges — two separate
    # gathers through the same index matrix would read the indices twice
    sentinel = jnp.asarray([[1e6, 1e6, 1e6, 0.0]], dtype)
    xqp = jnp.concatenate(
        [jnp.concatenate([x, q[:, None].astype(dtype)], axis=1), sentinel],
        axis=0)
    xqj = xqp[idx]                                       # (N, K, 4)
    xj = xqj[..., :3]
    qj = xqj[..., 3]
    boxj = jnp.asarray(ncfg.grid.box, dtype)
    d = min_image(x[:, None, :] - xj, boxj, ncfg.grid.periodic)
    rsq = jnp.sum(d * d, axis=-1)
    mask = (idx < n) & (rsq < ncfg.cutoff ** 2)
    rsq_safe = jnp.where(mask, rsq, 1.0)
    r2inv = 1.0 / rsq_safe
    r6inv = r2inv * r2inv * r2inv
    l1, l2, l3, l4 = nlist.lj
    flj = jnp.where(mask, r6inv * (l1 * r6inv - l2) * r2inv, 0.0)
    elj = jnp.where(mask, r6inv * (l3 * r6inv - l4), 0.0)
    r = jnp.sqrt(rsq_safe)
    grij = g_ewald * r
    expm2 = jnp.exp(-grij * grij)
    tt = 1.0 / (1.0 + EWALD_P * grij)
    erfc = tt * (A1 + tt * (A2 + tt * (A3 + tt * (A4 + tt * A5)))) * expm2
    pref = qqr2e * q[:, None] * qj / r
    fcoul = jnp.where(mask, pref * (erfc + EWALD_F * grij * expm2), 0.0)
    ecoul = jnp.where(mask, pref * erfc, 0.0)
    fpair = flj + fcoul * r2inv
    f = jnp.sum(fpair[:, :, None] * d, axis=1)           # (N, 3)
    ev = 0.5 * jnp.sum(elj)
    ec = 0.5 * jnp.sum(ecoul)

    df, dev, dec = exclusion_correction(
        x, q, type_idx, tables, exclusions, box=ncfg.grid.box,
        periodic=ncfg.grid.periodic, cutsq=ncfg.cutoff ** 2, qqr2e=qqr2e)
    ov = nlist.overflow
    f = jnp.where(ov, jnp.nan, f + df)
    return f, ev + dev, ec + dec, ov


def block_pair_forces(ncfg: NeighborConfig, nlist: NeighborList, x, q,
                      type_idx, tables: PairTables, exclusions, *,
                      g_ewald, qqr2e):
    """LJ + real-space Coulomb from the BLOCK form of the list — same
    returns (and the same pair set, hence roundoff-level identical physics)
    as nlist_pair_forces.  The hot gather is (NB, U) union rows instead of
    (N, K) per-atom rows: ~3.5x fewer gathered rows at B=8; the masked
    pair chain runs on (NB, B, U) = N*U slots.  Each pair still appears in
    both atoms' blocks, so energies carry the full-list 0.5.  Reference
    analogue: the same half/full neighbor-list sweeps
    (fix_conp.cpp:1242-1276) — blocking is the gather-friendly replacement
    for LAMMPS's per-atom jlist walk."""
    n = x.shape[0]
    f_slots, selj, secoul = _block_sweep(
        ncfg, x, q, nlist.bun, nlist.brows, nlist.bcr, nlist.btu, n,
        g_ewald=g_ewald, qqr2e=qqr2e)
    f = f_slots[nlist.binv]
    ev = 0.5 * selj
    ec = 0.5 * secoul
    df, dev, dec = exclusion_correction(
        x, q, type_idx, tables, exclusions, box=ncfg.grid.box,
        periodic=ncfg.grid.periodic, cutsq=ncfg.cutoff ** 2, qqr2e=qqr2e)
    ov = nlist.overflow
    f = jnp.where(ov, jnp.nan, f + df)
    ev = jnp.where(ov, jnp.nan, ev + dev)
    ec = jnp.where(ov, jnp.nan, ec + dec)
    return f, ev, ec, ov


def _block_sweep(ncfg: NeighborConfig, x, q, un, rows, bcr, btu, n, *,
                 g_ewald, qqr2e):
    """Core of the block sweep on the GIVEN block rows: returns
    (f_slots (NB*B, 3) in slot order, sum_elj, sum_ecoul) — the caller
    applies binv, the full-list 0.5, and the exclusion correction.  Shared
    by block_pair_forces (all blocks) and block_pair_rows (a device's
    contiguous block slice in the sharded engine)."""
    dtype = x.dtype
    nt1 = bcr.shape[-1]
    xqp = jnp.concatenate(
        [jnp.concatenate([x, q[:, None].astype(dtype)], axis=1),
         jnp.asarray([[1e6, 1e6, 1e6, 0.0]], dtype)], axis=0)
    xqu = xqp[un]                                        # (NB, U, 4) THE gather
    xqi = xqp[rows]                                      # (NB, B, 4)
    boxj = jnp.asarray(ncfg.grid.box, dtype)
    d = min_image(xqi[:, :, None, :3] - xqu[:, None, :, :3], boxj,
                  ncfg.grid.periodic)
    rsq = jnp.sum(d * d, axis=-1)                        # (NB, B, U)
    mask = ((un[:, None, :] != rows[:, :, None])
            & (un[:, None, :] < n) & (rows[:, :, None] < n)
            & (rsq < ncfg.cutoff ** 2))
    rsq_safe = jnp.where(mask, rsq, 1.0)
    r2inv = 1.0 / rsq_safe
    r6inv = r2inv * r2inv * r2inv
    # expand the pre-typed LJ planes on the fly: 4*nt masked FMAs
    blj = jnp.zeros((4,) + rsq.shape, dtype)
    for t in range(nt1):
        mask_t = (btu == t).astype(dtype)[None, :, None, :]
        blj = blj + mask_t * bcr[:4, :, :, t][:, :, :, None]
    l1, l2, l3, l4 = blj
    flj = jnp.where(mask, r6inv * (l1 * r6inv - l2) * r2inv, 0.0)
    elj = jnp.where(mask, r6inv * (l3 * r6inv - l4), 0.0)
    r = jnp.sqrt(rsq_safe)
    grij = g_ewald * r
    expm2 = jnp.exp(-grij * grij)
    tt = 1.0 / (1.0 + EWALD_P * grij)
    erfc = tt * (A1 + tt * (A2 + tt * (A3 + tt * (A4 + tt * A5)))) * expm2
    pref = qqr2e * xqi[:, :, None, 3] * xqu[:, None, :, 3] / r
    fcoul = jnp.where(mask, pref * (erfc + EWALD_F * grij * expm2), 0.0)
    ecoul = jnp.where(mask, pref * erfc, 0.0)
    fpair = flj + fcoul * r2inv
    f_slots = jnp.sum(fpair[..., None] * d, axis=2).reshape(-1, 3)
    return f_slots, jnp.sum(elj), jnp.sum(ecoul)


def block_pair_rows(ncfg: NeighborConfig, nlist: NeighborList, x, q, b0,
                    nb_l, *, g_ewald, qqr2e):
    """Block sweep over the contiguous block slice [b0, b0 + nb_l) — the
    sharded engine's per-device share of block_pair_forces (the same pair
    set and math; km_ewald_split.cpp shares ALL of km_ewald's optimized
    math, differently distributed).  The caller pads the block axis to a
    device multiple first (pad_block_list), all_gathers the returned slot
    forces, applies nlist.binv and the replicated exclusion correction,
    and psums the energy partials (which carry the full-list 0.5
    already)."""
    def sl(a, axis=0):
        return jax.lax.dynamic_slice_in_dim(a, b0, nb_l, axis=axis)

    f_slots, selj, sec = _block_sweep(
        ncfg, x, q, sl(nlist.bun), sl(nlist.brows), sl(nlist.bcr, axis=1),
        sl(nlist.btu), x.shape[0], g_ewald=g_ewald, qqr2e=qqr2e)
    return f_slots, 0.5 * selj, 0.5 * sec


def pad_block_list(nlist: NeighborList, n: int, d: int) -> NeighborList:
    """Pad the block axis to a multiple of d with EMPTY blocks (ids n,
    zero LJ rows, type 0): padded blocks contribute exactly nothing to the
    sweep (both the id masks and the sentinel positions kill every pair),
    so each device can take an equal contiguous slice."""
    nb_ = nlist.bun.shape[0]
    padb = (-nb_) % d
    if padb == 0:
        return nlist
    return nlist._replace(
        bun=jnp.pad(nlist.bun, ((0, padb), (0, 0)), constant_values=n),
        brows=jnp.pad(nlist.brows, ((0, padb), (0, 0)), constant_values=n),
        bcr=jnp.pad(nlist.bcr, ((0, 0), (0, padb), (0, 0), (0, 0))),
        btu=jnp.pad(nlist.btu, ((0, padb), (0, 0))))


def ele_rows_from_list(nlist: NeighborList, ele_idx):
    """Electrode rows of the neighbor list: (Ne, K) ids plus geometry-free
    slices shared by the b-vector real block and the correction force."""
    return nlist.idx[ele_idx]


def b_realspace_from_list(ncfg: NeighborConfig, nlist: NeighborList, x,
                          q_elyte, ele_idx, elyte_mask, type_idx,
                          pair_potential_fn, *, g_ewald, cut_coulsq):
    """b real-space rows from the electrode rows of the Verlet list:
    b_i = -sum_j (erfc(g r)/r g + pot(r)) q_j over in-range electrolyte
    neighbors (fix_conp.cpp:1281-1365) — O(Ne*K) instead of O(Ne*N)."""
    from .erfc import erfcr_sqrt

    n = x.shape[0]
    dtype = x.dtype
    idx_e = nlist.idx[ele_idx]                           # (Ne, K)
    sentinel = jnp.asarray([[1e6, 1e6, 1e6]], dtype)
    xp = jnp.concatenate([x, sentinel], axis=0)
    qep = jnp.pad(q_elyte, (0, 1))
    elyp = jnp.pad(jnp.asarray(elyte_mask), (0, 1))
    tp = jnp.pad(type_idx, (0, 1))
    xe = x[ele_idx]
    d = min_image(xe[:, None, :] - xp[idx_e], jnp.asarray(ncfg.grid.box, dtype),
                  ncfg.grid.periodic)
    rsq = jnp.sum(d * d, axis=-1)
    mask = (idx_e < n) & elyp[idx_e] & (rsq < cut_coulsq)
    rsq_safe = jnp.where(mask, rsq, 1.0)
    te = type_idx[ele_idx]
    dudq = erfcr_sqrt(g_ewald * g_ewald * rsq_safe) * g_ewald \
        + pair_potential_fn(rsq_safe, te[:, None], tp[idx_e])
    b = -jnp.sum(jnp.where(mask, dudq, 0.0) * qep[idx_e], axis=1)
    return jnp.where(nlist.overflow, jnp.nan, b)


def b_realspace_rows_from_list(ncfg: NeighborConfig, nlist: NeighborList, x,
                               q_elyte, eidx_rows, evalid, elyte_mask,
                               type_idx, pair_potential_fn, *, g_ewald,
                               cut_coulsq):
    """Device-local electrode-row block of b_realspace_from_list: the caller
    holds an (Ne/D,) slice of electrode ids (``eidx_rows``, padded rows
    masked by ``evalid``) and all_gathers the result — the multi-chip path
    inherits the single-chip O(Ne*K) asymptotics instead of a dense
    (Ne/D, N) sweep (fix_conp.cpp:1281-1444 is one neighbor sweep, never an
    all-atoms scan)."""
    from .erfc import erfcr_sqrt

    n = x.shape[0]
    dtype = x.dtype
    idx_e = nlist.idx[eidx_rows]                         # (Ne/D, K)
    sentinel = jnp.asarray([[1e6, 1e6, 1e6]], dtype)
    xp = jnp.concatenate([x, sentinel], axis=0)
    qep = jnp.pad(q_elyte, (0, 1))
    elyp = jnp.pad(jnp.asarray(elyte_mask), (0, 1))
    tp = jnp.pad(type_idx, (0, 1))
    xe = x[eidx_rows]
    d = min_image(xe[:, None, :] - xp[idx_e], jnp.asarray(ncfg.grid.box, dtype),
                  ncfg.grid.periodic)
    rsq = jnp.sum(d * d, axis=-1)
    mask = (idx_e < n) & elyp[idx_e] & (rsq < cut_coulsq) & evalid[:, None]
    rsq_safe = jnp.where(mask, rsq, 1.0)
    te = type_idx[eidx_rows]
    dudq = erfcr_sqrt(g_ewald * g_ewald * rsq_safe) * g_ewald \
        + pair_potential_fn(rsq_safe, te[:, None], tp[idx_e])
    b = -jnp.sum(jnp.where(mask, dudq, 0.0) * qep[idx_e], axis=1)
    return jnp.where(nlist.overflow, jnp.nan, b)


def conp_correction_rows_from_list(ncfg: NeighborConfig, nlist: NeighborList,
                                   x, q, eidx_rows, evalid, elyte_mask,
                                   type_idx, pair_force_fn, pair_potential_fn,
                                   *, cutoff, qqr2e):
    """Device-local electrode-row block of conp_correction_from_list: forces
    for MY electrode rows plus their Newton reactions scattered into a local
    (N, 3) array — the caller psums over devices.  Returns
    (f_partial (N, 3), ecorr_partial)."""
    n = x.shape[0]
    dtype = x.dtype
    idx_e = nlist.idx[eidx_rows]                         # (Ne/D, K)
    sentinel = jnp.asarray([[1e6, 1e6, 1e6]], dtype)
    xp = jnp.concatenate([x, sentinel], axis=0)
    qp = jnp.pad(q, (0, 1))
    elyp = jnp.pad(jnp.asarray(elyte_mask), (0, 1))
    tp = jnp.pad(type_idx, (0, 1))
    xe = x[eidx_rows]
    qe = q[eidx_rows]
    te = type_idx[eidx_rows]
    d = min_image(xe[:, None, :] - xp[idx_e], jnp.asarray(ncfg.grid.box, dtype),
                  ncfg.grid.periodic)
    rsq = jnp.sum(d * d, axis=-1)
    mask = (idx_e < n) & elyp[idx_e] & (rsq < cutoff ** 2) & evalid[:, None]
    rsq_safe = jnp.where(mask, rsq, 1.0)
    pref = qqr2e * qe[:, None] * qp[idx_e]
    fk = pair_force_fn(rsq_safe, te[:, None], tp[idx_e])
    ek = pair_potential_fn(rsq_safe, te[:, None], tp[idx_e])
    forcecoul = jnp.where(mask, pref * fk, 0.0)
    epair = jnp.where(mask, pref * ek, 0.0)
    fpair = forcecoul / rsq_safe
    fvec = fpair[:, :, None] * d                         # (Ne/D, K, 3)
    f = jnp.zeros((n + 1, 3), dtype).at[idx_e.reshape(-1)].add(
        -fvec.reshape(-1, 3))[:n]
    f = f.at[eidx_rows].add(jnp.sum(fvec, axis=1))
    f = jnp.where(nlist.overflow, jnp.nan, f)
    return f, jnp.sum(epair)


def conp_correction_from_list(ncfg: NeighborConfig, nlist: NeighborList, x,
                              q, ele_idx, elyte_mask, type_idx,
                              pair_force_fn, pair_potential_fn, *,
                              cutoff, qqr2e):
    """Gaussian correction force from the electrode rows of the Verlet list
    (blist_coul_cal_post_force, fix_conp.cpp:1368-1444): forces on the
    electrode rows plus Newton reactions scattered to the electrolyte
    neighbors.  Returns (f (N, 3), ecorr)."""
    n = x.shape[0]
    dtype = x.dtype
    idx_e = nlist.idx[ele_idx]                           # (Ne, K)
    sentinel = jnp.asarray([[1e6, 1e6, 1e6]], dtype)
    xp = jnp.concatenate([x, sentinel], axis=0)
    qp = jnp.pad(q, (0, 1))
    elyp = jnp.pad(jnp.asarray(elyte_mask), (0, 1))
    tp = jnp.pad(type_idx, (0, 1))
    xe = x[ele_idx]
    qe = q[ele_idx]
    te = type_idx[ele_idx]
    d = min_image(xe[:, None, :] - xp[idx_e], jnp.asarray(ncfg.grid.box, dtype),
                  ncfg.grid.periodic)
    rsq = jnp.sum(d * d, axis=-1)
    mask = (idx_e < n) & elyp[idx_e] & (rsq < cutoff ** 2)
    rsq_safe = jnp.where(mask, rsq, 1.0)
    pref = qqr2e * qe[:, None] * qp[idx_e]
    fk = pair_force_fn(rsq_safe, te[:, None], tp[idx_e])
    ek = pair_potential_fn(rsq_safe, te[:, None], tp[idx_e])
    forcecoul = jnp.where(mask, pref * fk, 0.0)
    epair = jnp.where(mask, pref * ek, 0.0)
    fpair = forcecoul / rsq_safe
    fvec = fpair[:, :, None] * d                         # (Ne, K, 3)
    f = jnp.zeros((n + 1, 3), dtype).at[idx_e.reshape(-1)].add(
        -fvec.reshape(-1, 3))[:n]
    f = f.at[jnp.asarray(ele_idx)].add(jnp.sum(fvec, axis=1))
    f = jnp.where(nlist.overflow, jnp.nan, f)
    return f, jnp.sum(epair)
