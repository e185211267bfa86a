"""Per-phase timing — the equivalent of the reference's hand-rolled
Btime/Ctime/Ktime accounting (fix_conp.cpp:139-141, 549-567, 698-714).

Inside one fused jit step the phases aren't separable at runtime, so the
breakdown is measured by timing each phase's jitted function in isolation
(identical code paths), plus the fused step for the true per-step cost.
Also exposes jax.profiler hooks for full XLA traces.
"""

from __future__ import annotations

import contextlib
import json
import time

import jax


def _time_it(fn, args, iters=10):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def profile_step(engine, state, *, iters: int = 10, log_path: str | None = None):
    """Returns {phase: seconds}: b-vector (Btime+Ktime analogue), charge
    solve, pair forces, k-space phases, neighbor rebuild, full step.

    Each phase is timed on the engine's ACTUAL configured path (Verlet list /
    cell / dense; mesh or factored k-space) so the breakdown is
    meaningful at production scale — the dense pair sweep alone would be
    O(N^2) at 100k atoms."""
    sys = engine.system
    u = sys.units()
    x, q, nbr = state.x, state.q, state.nbr
    res = {}
    if engine.conp is not None:
        res["b_vector"] = _time_it(
            jax.jit(lambda x, q: engine.conp.b_vector_full(
                x, q, nbr, engine.ncfg)[0]), (x, q), iters)
        res["charge_solve"] = _time_it(
            jax.jit(lambda x, q: engine.conp.solve_full(
                x, q, 0, nbr, engine.ncfg)[:2]), (x, q), iters)
    if engine.ncfg is not None and nbr is not None:
        from ..ops.neighbors import build_neighbor_list, nlist_pair_forces
        res["pair_forces"] = _time_it(
            jax.jit(lambda x, q: nlist_pair_forces(
                engine.ncfg, nbr, x, q, engine.type_idx, engine.tables,
                engine.exclusions, g_ewald=engine.ksp_force.g_ewald,
                qqr2e=u.qqr2e)), (x, q), iters)
        res["nbr_rebuild"] = _time_it(
            jax.jit(lambda x: build_neighbor_list(
                engine.ncfg, x, engine.tables, engine.type_idx)), (x,), iters)
    elif engine.cell_grid is not None:
        from ..ops.cells import cell_pair_forces
        res["pair_forces"] = _time_it(
            jax.jit(lambda x, q: cell_pair_forces(
                engine.cell_grid, x, q, engine.type_idx, engine.tables,
                engine.exclusions, g_ewald=engine.ksp_force.g_ewald,
                qqr2e=u.qqr2e)), (x, q), iters)
    else:
        from ..ops.pairs import dense_pair_forces
        res["pair_forces"] = _time_it(
            jax.jit(lambda x, q: dense_pair_forces(
                x, q, engine.type_idx, engine.tables, engine.exclusions,
                box=engine.ksp_force.box, periodic=sys.periodic,
                cutoff=engine.md.cutoff, g_ewald=engine.ksp_force.g_ewald,
                qqr2e=u.qqr2e)), (x, q), iters)
    if engine.pppm_grid is not None:
        from ..ops import pppm as pppm_ops
        grid = engine.pppm_grid
        spread_j = jax.jit(lambda x, q: pppm_ops.spread(grid, x, q))
        rho = spread_j(x, q)
        rhok = jax.jit(jax.numpy.fft.rfftn)(rho)
        res["pppm_spread"] = _time_it(spread_j, (x, q), iters)
        tiled = not pppm_ops._use_dense(grid, x.shape[0])
        if engine.md.pppm_diff == "ad" or (
                engine.md.pppm_diff == "auto" and tiled):
            # production ad path: 1 fwd + 1 inv FFT, one-mesh gather
            u_from_k_j = jax.jit(
                lambda r: pppm_ops.pppm_energy_u_from_k(grid, r))
            res["pppm_fft"] = _time_it(u_from_k_j, (rhok,), iters)
            um = u_from_k_j(rhok)[1]
            res["pppm_gather"] = _time_it(
                jax.jit(lambda e, x: pppm_ops.gather3_ad(grid, e, x)),
                (um, x), iters)
        else:
            efield_j = jax.jit(lambda r: pppm_ops.pppm_energy_efield(grid, r))
            res["pppm_fft"] = _time_it(efield_j, (rho,), iters)
            ef = efield_j(rho)[1]
            res["pppm_gather"] = _time_it(
                jax.jit(lambda e, x: pppm_ops.gather3(grid, e, x)),
                (ef, x), iters)
    if engine.fksp is not None:
        from ..ops import ewald_factored as ewf
        res["kspace_forces"] = _time_it(
            jax.jit(lambda x, q: ewf.energy_forces_f(engine.fksp, x, q)),
            (x, q), iters)
    res["full_step"] = _time_it(jax.jit(engine.step), (state,), iters)
    if log_path:
        with open(log_path, "w") as f:
            json.dump({k: round(v * 1e3, 4) for k, v in res.items()}, f)
    return res


@contextlib.contextmanager
def xla_trace(logdir: str):
    """Capture a full XLA device profile viewable in xprof/tensorboard."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
