#!/usr/bin/env python
"""Steps per second of the synthetic capacitor cells on one GPU.

    python bench.py

Runs in one process on the first GPU (and fails without one): for cell A
(il-sized, 3.7k atoms) and cell B (100k atoms) it builds the float32
engine, compiles one thermo-free chain of ``steps`` steps, runs it once to
warm up and once timed, and prints one JSON line with steps/s, simulated
ns/day and the device the numbers were taken on.  Set-up and compilation
are reported apart from the timed window.
"""

import json
import time

from chip_smoke import card_line, require_gpu

CELLS = {"A": ("capacitor_il", 1000), "B": ("capacitor_100k", 200)}


def bench_cell(builder, steps):
    import jax
    import jax.numpy as jnp

    from lammps_user_conp2_tpu import workloads
    from lammps_user_conp2_tpu.models.conp import setup_conp
    from lammps_user_conp2_tpu.models.md import build_engine

    t0 = time.perf_counter()
    system, md, cfg = getattr(workloads, builder)()
    solver = setup_conp(system, md, cfg, solve_dtype=jnp.float32)
    eng = build_engine(system, md, solver, dtype=jnp.float32)
    st = jax.block_until_ready(eng.init_state())
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.compile_run(st, steps, thermo_every=0)
    compile_s = time.perf_counter() - t0
    st = jax.block_until_ready(eng.run(st, steps, thermo_every=0)[0])
    t0 = time.perf_counter()
    st = jax.block_until_ready(eng.run(st, steps, thermo_every=0)[0])
    sps = steps / (time.perf_counter() - t0)
    if not bool(jnp.isfinite(st.energy)):
        raise RuntimeError(f"{builder}: non-finite energy")
    return {"natoms": system.natoms, "steps": steps, "setup_s": setup_s,
            "compile_s": compile_s, "steps_per_s": sps,
            "ns_per_day": sps * md.dt * 86400e-6}


def main():
    dev = require_gpu()
    from lammps_user_conp2_tpu import enable_compile_cache

    enable_compile_cache()
    import jax

    result = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                         "count": len(jax.devices())},
              "card": card_line(), "cells": {}}
    for name, (builder, steps) in CELLS.items():
        with jax.default_device(dev):
            result["cells"][name] = bench_cell(builder, steps)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
