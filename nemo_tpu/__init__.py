"""nemo_tpu: a JAX rebuild of the Nemo SZ cluster / compact-source
detection framework (reference: borisbolliet/nemo-1).

The compute path (matched filtering, noise estimation, signal modelling,
map simulation, selection-function math) runs on the GPU via JAX/XLA, with
tiles as a batched, shardable axis over a ``jax.sharding.Mesh``.  Host code
handles FITS/WCS/catalog I/O and configuration, with no dependencies beyond
numpy/scipy.
"""

__version__ = "0.1.0"

import os as _os

# Escape hatches for environments whose interpreter startup pre-selects a
# jax platform before user code runs (e.g. CI harnesses): NEMO_TPU_PLATFORM
# and NEMO_TPU_X64 apply via jax.config at package import. Deliberately NOT
# keyed on JAX_PLATFORMS, which such environments set globally.
if _os.environ.get("NEMO_TPU_PLATFORM") or _os.environ.get("NEMO_TPU_X64"):
    import jax as _jax
    try:
        if _os.environ.get("NEMO_TPU_X64"):
            _jax.config.update("jax_enable_x64", True)
        if _os.environ.get("NEMO_TPU_PLATFORM"):
            _jax.config.update("jax_platforms",
                               _os.environ["NEMO_TPU_PLATFORM"])
    except RuntimeError:
        pass
