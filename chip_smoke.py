#!/usr/bin/env python
"""Run the constant-potential MD step on a GPU and check what comes out.

    python chip_smoke.py          # one card: cells A and B, SHAKE phase
    python chip_smoke.py --four   # four cards: sharded cell B vs one card

Cell A is the synthetic capacitor at il-deck size (3.7k atoms: dense pair
sweep, factorised Ewald, INV solve); cell B is the same capacitor at
production size (100k atoms: PPPM, Verlet list, tiled mesh, INV).  Each
cell goes through the library path a user calls (workloads -> setup_conp
-> build_engine -> Engine.run) in float32 on the card, and its step-0
electrode charges and forces are held against the float64 path at the
same positions: on the host CPU for cell A, on the card for cell B.  The
SHAKE phase compares the Triton SHAKE/RATTLE kernel with the plain path
on the card and times both.

Every phase raises on failure; the last line of standard output, printed
only when all phases passed, is one JSON object naming the device.
Without a GPU the script exits non-zero before any phase runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

#: step-0 agreement of the float32 card step with the float64 path,
#: relative to the largest value: catches a TF32 contraction (~1e-3)
STEP0_RTOL = 1e-4
#: cell A's 100-step electrode-charge trajectory against float64
TRAJ_RTOL = 1e-3
#: SHAKE kernel against the plain path, relative to the largest box edge
#: (12 float32 Gauss-Seidel sweeps in another operation order)
SHAKE_RTOL = 2e-6
#: sharded (4 cards) against one card after FOUR_STEPS steps
FOUR_STEPS = 20
FOUR_RTOL = 1e-3


def require_gpu(devices=None):
    """The first device, which must be a GPU; raises otherwise."""
    import jax

    devices = jax.devices() if devices is None else devices
    dev = devices[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX found {dev.platform} "
                           f"({dev.device_kind})")
    return dev


def card_line():
    """nvidia-smi's name and power limit of every card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().replace("\n", "; ")


def _build(system, md, cfg, dtype):
    from lammps_user_conp2_tpu.models.conp import setup_conp
    from lammps_user_conp2_tpu.models.md import build_engine

    solver = setup_conp(system, md, cfg, solve_dtype=dtype)
    return build_engine(system, md, solver, dtype=dtype)


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _step0_f64(system, md, cfg, device):
    """(q_ele, f, engine, state) of the float64 path's step 0 on
    ``device``."""
    import jax
    import jax.numpy as jnp

    with jax.enable_x64(True), jax.default_device(device):
        eng = _build(system, md, cfg, jnp.float64)
        st = jax.block_until_ready(eng.init_state())
        return np.asarray(st.q)[eng.conp.ele_idx], np.asarray(st.f), eng, st


def run_cell(name, system, md, cfg, *, device, steps, check_engine):
    """Set up, compile and run ``steps`` float32 steps on ``device``;
    returns (report dict, engine, initial state, final state, thermo)."""
    import jax
    import jax.numpy as jnp

    rep = {"cell": name, "natoms": system.natoms, "steps": steps}
    with jax.default_device(device):
        t0 = time.perf_counter()
        eng = _build(system, md, cfg, jnp.float32)
        check_engine(eng)
        st0 = jax.block_until_ready(eng.init_state())
        rep["setup_s"] = time.perf_counter() - t0
        caps = _capacities(eng)
        t0 = time.perf_counter()
        compiled = eng.compile_run(st0, steps, thermo_every=1)
        rep["compile_s"] = time.perf_counter() - t0
        mem = compiled.memory_analysis()
        rep["step_temp_bytes"] = int(mem.temp_size_in_bytes)
        rep["step_arg_bytes"] = int(mem.argument_size_in_bytes)
        t0 = time.perf_counter()
        final, th = eng.run(st0, steps, thermo_every=1)
        jax.block_until_ready(final)
        rep["run_s"] = time.perf_counter() - t0
        rep["steps_per_s"] = steps / rep["run_s"]
        stats = device.memory_stats() or {}
        rep["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    if _capacities(eng) != caps:
        raise RuntimeError(f"{name}: a capacity overflowed and was regrown "
                           f"({caps} -> {_capacities(eng)})")
    energy = float(final.energy)
    if not (np.isfinite(energy) and np.all(np.isfinite(np.asarray(final.f)))
            and np.all(np.isfinite(np.asarray(final.q)))):
        raise RuntimeError(f"{name}: non-finite energy, forces or charges")
    if final.nbr is not None and bool(final.nbr.overflow):
        raise RuntimeError(f"{name}: neighbor-list overflow")
    if final.tasg is not None and bool(final.tasg.overflow):
        raise RuntimeError(f"{name}: mesh tile overflow")
    rep["energy"] = energy
    return rep, eng, st0, final, th


def _capacities(eng):
    return (None if eng.ncfg is None else (eng.ncfg.k_max, eng.ncfg.u_max),
            None if eng.pppm_grid is None else eng.pppm_grid.tile_cap)


def _check_step0(rep, eng, st0, q64, f64):
    rep["step0_dq_rel"] = _rel_err(np.asarray(st0.q)[eng.conp.ele_idx], q64)
    rep["step0_df_rel"] = _rel_err(st0.f, f64)
    if rep["step0_dq_rel"] > STEP0_RTOL or rep["step0_df_rel"] > STEP0_RTOL:
        raise RuntimeError(
            f"{rep['cell']}: float32 step 0 differs from float64 by "
            f"{rep['step0_dq_rel']:.3e} (charges), {rep['step0_df_rel']:.3e}"
            f" (forces); bound {STEP0_RTOL}")


def cell_a(device, ref_device, steps=100, **size):
    """Il-sized capacitor: dense pairs + factorised Ewald, f64 reference on
    ``ref_device`` (the host CPU) including a ``steps``-step charge
    trajectory."""
    import jax

    from lammps_user_conp2_tpu import workloads

    system, md, cfg = workloads.capacitor_il(**size)

    def check(eng):
        if eng.fksp is None or eng.ncfg is not None or eng.pppm_grid is not None:
            raise RuntimeError("cell A: expected dense pairs + factorised "
                               "Ewald")

    rep, eng, st0, final, th = run_cell("A", system, md, cfg, device=device,
                                        steps=steps, check_engine=check)
    q64, f64, eng64, st64 = _step0_f64(system, md, cfg, ref_device)
    _check_step0(rep, eng, st0, q64, f64)
    with jax.enable_x64(True), jax.default_device(ref_device):
        fin64, th64 = eng64.run(st64, steps, thermo_every=1)
        ql64 = np.asarray(th64["qleft"])
        qe64 = np.asarray(fin64.q)[eng64.conp.ele_idx]
    rep["traj_dqleft_rel"] = _rel_err(th["qleft"], ql64)
    rep["traj_dq_final_rel"] = _rel_err(np.asarray(final.q)[eng.conp.ele_idx],
                                        qe64)
    if max(rep["traj_dqleft_rel"], rep["traj_dq_final_rel"]) > TRAJ_RTOL:
        raise RuntimeError(
            f"cell A: {steps}-step charge trajectory differs from float64 by "
            f"{rep['traj_dqleft_rel']:.3e} (qleft), "
            f"{rep['traj_dq_final_rel']:.3e} (final q); bound {TRAJ_RTOL}")
    return rep


def cell_b(device, ref_device, steps=100, **size):
    """100k capacitor: PPPM + Verlet list + tiled mesh, f64 step 0 on
    ``ref_device`` (the card); needs at least one neighbor rebuild."""
    from lammps_user_conp2_tpu import workloads
    from lammps_user_conp2_tpu.ops import pppm as pppm_ops

    system, md, cfg = workloads.capacitor_100k(**size)

    def check(eng):
        if (eng.pppm_grid is None or eng.ncfg is None or not eng.mesh_persist
                or pppm_ops._use_dense(eng.pppm_grid, system.natoms)):
            raise RuntimeError("cell B: expected PPPM on the tiled mesh and "
                               "the Verlet list")

    rep, eng, st0, final, _ = run_cell("B", system, md, cfg, device=device,
                                       steps=steps, check_engine=check)
    if np.array_equal(np.asarray(final.nbr.x_ref), np.asarray(st0.nbr.x_ref)):
        raise RuntimeError(f"cell B: no neighbor rebuild in {steps} steps")
    q64, f64, _, _ = _step0_f64(system, md, cfg, ref_device)
    _check_step0(rep, eng, st0, q64, f64)
    return rep


def _time_chain(fn, arg, n=50):
    """Seconds per call of ``fn`` chained n times inside one program."""
    import jax

    run = jax.jit(lambda a: jax.lax.fori_loop(0, n, lambda i, b: fn(b), a))
    jax.block_until_ready(run(arg))
    t0 = time.perf_counter()
    jax.block_until_ready(run(arg))
    return (time.perf_counter() - t0) / n


def shake_phase(device, sizes=(320, 10240), *, interpret=False):
    """Triton SHAKE/RATTLE kernel against the plain path at each cluster
    count, compared and timed on ``device``."""
    import jax
    import jax.numpy as jnp

    from lammps_user_conp2_tpu import workloads
    from lammps_user_conp2_tpu.models import shake
    from lammps_user_conp2_tpu.ops import shake_kernel as sk

    reps = []
    for m in sizes:
        system, scfg = workloads.rotors(m)
        cons = shake.build_constraints(system, scfg)
        box, per = system.box, system.periodic
        rng = np.random.default_rng(m)
        with jax.default_device(device):
            x0 = jnp.asarray(system.x0, jnp.float32)
            xn = x0 + jnp.asarray(rng.normal(0, 0.05, x0.shape), jnp.float32)
            v = jnp.asarray(rng.normal(0, 0.01, x0.shape), jnp.float32)

            def shk_k(a):
                return sk.shake_positions_triton(
                    cons, a, x0, 1.0, box=box, periodic=per,
                    interpret=interpret)[0]

            def shk_x(a):
                return shake.shake_positions_xla(cons, a, x0, 1.0, box=box,
                                                 periodic=per)[0]

            def rat_k(b):
                return sk.rattle_velocities_triton(
                    cons, x0, b, box=box, periodic=per, interpret=interpret)

            def rat_x(b):
                return shake.rattle_velocities_xla(cons, x0, b, box=box,
                                                   periodic=per)

            scale = max(box)
            x_x = jax.jit(shk_x)(xn)
            dx = float(jnp.abs(jax.jit(shk_k)(xn) - x_x).max())
            dv = float(jnp.abs(jax.jit(rat_k)(v) - jax.jit(rat_x)(v)).max())
            rep = {"phase": "shake", "clusters": m,
                   "moved": float(jnp.abs(x_x - xn).max()),
                   "dx_rel": dx / scale,
                   "dv_rel": dv / float(jnp.abs(v).max()),
                   "kernel_us": 1e6 * (_time_chain(shk_k, xn)
                                       + _time_chain(rat_k, v)),
                   "xla_us": 1e6 * (_time_chain(shk_x, xn)
                                    + _time_chain(rat_x, v))}
        if rep["dx_rel"] > SHAKE_RTOL or rep["dv_rel"] > SHAKE_RTOL:
            raise RuntimeError(f"SHAKE kernel differs from the plain path: "
                               f"{rep}")
        reps.append(rep)
    return reps


def four_phase(devices, steps=FOUR_STEPS, **size):
    """Cell B (INV + block Verlet list + PPPM) sharded over ``devices``
    against the same engine on devices[0]."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from lammps_user_conp2_tpu import workloads
    from lammps_user_conp2_tpu.parallel.sharded import build_sharded_engine

    system, md, cfg = workloads.capacitor_100k(**size)
    md = dataclasses.replace(md, pair_path="block")
    rep = {"phase": "four", "natoms": system.natoms, "steps": steps,
           "devices": len(devices)}
    with jax.default_device(devices[0]):
        t0 = time.perf_counter()
        eng = _build(system, md, cfg, jnp.float32)
        st0 = jax.block_until_ready(eng.init_state())
        one, _ = eng.run(st0, steps, thermo_every=0)
        jax.block_until_ready(one)
        rep["one_card_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sheng = build_sharded_engine(eng, Mesh(np.asarray(devices), ("s",)))
        many = jax.block_until_ready(sheng.run(st0, steps))
        rep["sharded_s"] = time.perf_counter() - t0
    ele = eng.conp.ele_idx
    rep["dq_rel"] = _rel_err(np.asarray(many.q)[ele], np.asarray(one.q)[ele])
    rep["dx_max"] = float(np.abs(np.asarray(many.x) - np.asarray(one.x)).max())
    if not np.isfinite(float(many.energy)):
        raise RuntimeError("four: non-finite sharded energy")
    if rep["dq_rel"] > FOUR_RTOL or rep["dx_max"] > FOUR_RTOL:
        raise RuntimeError(f"four: sharded differs from one card: {rep}")
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card sharded phase")
    args = ap.parse_args(argv)

    import jax

    dev = require_gpu()
    from lammps_user_conp2_tpu import enable_compile_cache

    enable_compile_cache()
    card = card_line()

    def emit(rep):
        rep["card"] = card
        print(json.dumps(rep), flush=True)

    if args.four:
        devices = jax.devices()[:4]
        if len(devices) < 4:
            raise RuntimeError(f"--four needs 4 GPUs, found {len(devices)}")
        emit(four_phase(devices))
    else:
        cpu = jax.devices("cpu")[0]
        emit(cell_a(dev, cpu))
        emit(cell_b(dev, dev))
        for rep in shake_phase(dev):
            emit(rep)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    sys.exit(main())
