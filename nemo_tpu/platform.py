"""Per-backend choices and the persistent compilation cache.

Every place where the program picks an implementation by the machine it
runs on reads :func:`choices`: one row per JAX backend.  The ``cpu`` row
serves the test suite and laptop runs; the ``gpu`` row keeps the work on
the card (see ``docs/configuration.md`` for the measurements behind it).
A backend without a row is an error, never a silent fallback.
"""

import dataclasses
import os

import jax


@dataclasses.dataclass(frozen=True)
class BackendChoices:
    # Batched engine: segment, measure and read objects on the device
    # instead of downloading the filtered maps (useDeviceDetection: auto).
    device_detection: bool
    # Batched engine: paint a filter bank's templates in one vmapped
    # dispatch per geometry (bankPaintBatch: auto).
    bank_paint: bool
    # fitQ: apply each geometry's model stack to many tiles per dispatch
    # (qfitTileBatch unset).
    qfit_tile_batch: bool
    # fitQ serial route: models painted and filtered per dispatch
    # (qfitBatchSize unset).
    qfit_model_batch: int
    # ops.detect segment statistics: "compact" or "scatter".
    segment_stats: str
    # ops.noise grid sigma-clip RMS: "xla" gathers or the "triton" kernel.
    rms_impl: str


_TABLE = {
    "cpu": BackendChoices(device_detection=False, bank_paint=False,
                          qfit_tile_batch=False, qfit_model_batch=1,
                          segment_stats="scatter", rms_impl="xla"),
    "gpu": BackendChoices(device_detection=True, bank_paint=True,
                          qfit_tile_batch=True, qfit_model_batch=16,
                          segment_stats="compact", rms_impl="triton"),
}


def choices(backend=None):
    """The decision row for ``backend`` (default: JAX's default backend)."""
    backend = backend or jax.default_backend()
    try:
        return _TABLE[backend]
    except KeyError:
        raise RuntimeError(
            "nemo_tpu has no decision row for the %r backend (rows: %s); "
            "run on a GPU or with JAX_PLATFORMS=cpu"
            % (backend, ", ".join(sorted(_TABLE)))) from None


CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".jax_cache")


def enable_compilation_cache():
    """Keep compiled programs across processes.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is honoured by JAX itself and
    nothing is changed here.  Otherwise the cache lives in ``.jax_cache``
    at the root of the checkout.  ``NEMO_TPU_COMPILE_CACHE=0`` turns it
    off.  Returns the directory in use, or None."""
    if os.environ.get("NEMO_TPU_COMPILE_CACHE") == "0":
        return None
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return os.environ["JAX_COMPILATION_CACHE_DIR"]
    os.makedirs(CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
