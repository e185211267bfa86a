"""Constant-potential molecular dynamics in JAX.

A from-scratch re-design of the capabilities of srtee/lammps-USER-CONP2
(constant-potential/charge/displacement electrodes for electrochemical MD):
JAX/XLA compute, dense-linear-algebra Ewald, jit-compiled MD loop,
shard_map multi-device scaling.
"""

import os as _os

__version__ = "0.1.0"

#: ``<checkout>/.jax_cache``: a fixed path, since the path is part of the
#: cache key and a directory that moves never hits
DEFAULT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def compile_cache_dir():
    """The cache directory the entry points set, or None when
    ``JAX_COMPILATION_CACHE_DIR`` is set (JAX then reads it itself and the
    program sets no other)."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return DEFAULT_CACHE_DIR


def enable_compile_cache():
    """Point JAX's persistent compilation cache at compile_cache_dir().
    Called by the entry points (chip_smoke.py, bench.py, the CLI), never
    at import.  Returns the directory set, or None."""
    path = compile_cache_dir()
    if path is not None:
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path


# Hoist large device-array constants (PPPM influence function, A^-1, cell
# tables) out of the HLO into executable arguments — cuts the 100k-atom
# program from ~150 MB of literal text to a few MB.  Graceful no-op if the
# jax internals move (utils/hoistconst).
from .utils import hoistconst as _hoistconst

_hoistconst.enable()
del _hoistconst
