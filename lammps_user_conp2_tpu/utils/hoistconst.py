"""Hoist large device-array constants out of the compiled HLO.

Why this exists: every trace-time ``jnp.asarray(big_numpy_table)`` embeds
the table as a ``stablehlo.constant`` literal.  At the 100k-atom
configuration (workloads.capacitor_100k) the PPPM influence function alone
is a (144, 144, 376) f32 tensor appearing twice (62 MB), and the whole
module serializes to ~150 MB of mostly-literal text that the compiler
must ingest per program.  On an H100 (400 W limit) hoisting cuts that
cell's cold set-up plus compile from 50.7 s to 37.4 s, one run each.

The fix is JAX's transitional ``jax_use_simplified_jaxpr_constants``
machinery (jax-ml/jax#29679): closed-over **jax.Array** constants become
*hoisted executable arguments* — device buffers uploaded once and bound at
execution — instead of HLO literals.  Three pieces of it are evaluated at
``import jax`` time, so :func:`enable` re-applies them post-import:

  1. the config flag itself (read dynamically by ``core.jaxpr_const_args``
     and the mlir lowering);
  2. ``core.literalable_types.add(ArrayImpl)`` (jax/_src/array.py does this
     only at import when the flag is already on);
  3. the ``LoweringParameters.hoist_constants_as_args`` dataclass default,
     snapshotted into ``__init__.__defaults__`` at class definition.

We additionally RESTRICT literal-hoisting to ``ArrayImpl``: under the raw
flag, non-scalar *numpy* constants also become literals and jax 0.9.0's
lowering crashes on them (``'TypedNdArray' object has no attribute
'sharding'``).  With the restriction, every existing in-trace
``jnp.asarray(numpy)`` keeps the old embedded-constant behavior bit-for-bit,
and ONLY tables explicitly converted through :func:`devconst` are hoisted —
surgical, and gracefully degrading: if :func:`enable` fails (future jax
versions), ``devconst`` arrays simply embed as before.

SIZE THRESHOLD: hoisting is further restricted to arrays of at least
``CONP2_TPU_HOIST_MIN_BYTES`` (default 1 MiB).  Hoisted args are opaque
runtime inputs, so XLA cannot constant-fold them; small tables embed as
before (folded, fused) and only the multi-MB PPPM/Ewald tables are
hoisted.  ``CONP2_TPU_NO_CONST_HOIST=1`` turns hoisting off.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

_state = {"enabled": None}

#: arrays smaller than this stay embedded HLO literals (XLA can fold them);
#: only bigger ones become hoisted executable args.  See module docstring.
MIN_HOIST_BYTES = int(os.environ.get("CONP2_TPU_HOIST_MIN_BYTES", 1 << 20))


def enable() -> bool:
    """Idempotently enable jax.Array constant hoisting; True on success."""
    if _state["enabled"] is not None:
        return _state["enabled"]
    if os.environ.get("CONP2_TPU_NO_CONST_HOIST"):
        _state["enabled"] = False
        return False
    try:
        import jax
        from jax._src import core as jcore
        from jax._src.array import ArrayImpl
        from jax._src.interpreters import mlir

        # The fragile step FIRST (snapshotted dataclass defaults — most
        # likely to break on a future jax): if it raises, jax is untouched.
        names = [f.name for f in dataclasses.fields(mlir.LoweringParameters)]
        idx = names.index("hoist_constants_as_args")
        dflt = list(mlir.LoweringParameters.__init__.__defaults__)
        dflt[idx] = True
        mlir.LoweringParameters.__init__.__defaults__ = tuple(dflt)

        jax.config.update("jax_use_simplified_jaxpr_constants", True)
        jcore.literalable_types.add(ArrayImpl)

        orig = jcore.is_literalable

        def _is_literalable(x):
            if np.shape(x):
                # numpy (and any other non-jax.Array) non-scalars keep the
                # old embedded-constant path — see module docstring
                if not isinstance(x, ArrayImpl):
                    return False
                # small jax.Arrays embed too: hoisted args are opaque to
                # XLA's constant folder
                if x.nbytes < MIN_HOIST_BYTES:
                    return False
            return orig(x)

        jcore.is_literalable = _is_literalable
        _state["enabled"] = True
    except Exception:  # noqa: BLE001 — an optimization only; never fatal
        _state["enabled"] = False
    return _state["enabled"]


def devconst(obj, key, build):
    """Memoized device-resident constant attached to a host dataclass.

    ``key`` is any hashable; ``build()`` must return host data (numpy) and
    runs once per (obj, key).
    The result is a committed-to-default-device jax.Array cached in a
    ``_devcache`` dict set on ``obj`` via ``object.__setattr__`` (works on
    frozen dataclasses; cache lifetime == object lifetime, so no id-reuse
    hazards).  Safe to call inside a trace: creation runs under
    ``jax.ensure_compile_time_eval`` so the array is concrete, and with
    :func:`enable` active it lowers as a hoisted executable argument.
    """
    cache = getattr(obj, "_devcache", None)
    if cache is None:
        cache = {}
        object.__setattr__(obj, "_devcache", cache)
    arr = cache.get(key)
    if arr is None:
        import jax
        import jax.numpy as jnp

        with jax.ensure_compile_time_eval():
            arr = jnp.asarray(build())
        cache[key] = arr
    return arr
