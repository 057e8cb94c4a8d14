"""Tests that need an NVIDIA GPU (marker ``gpu``).

They skip on other backends; ``python chip_smoke.py`` runs them on the
card.  Each checks a numerical property the CPU suite cannot see:
float32 products on the GPU may run in TF32 unless they ask for more.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from nemo_tpu.ops import fourier
from nemo_tpu.ops import noise as noise_ops

pytestmark = pytest.mark.gpu


def _need_gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (python chip_smoke.py runs it)")


def test_rms_cell_painting_is_exact_on_card():
    """Painting cell RMS values back to pixels copies each value: a TF32
    product would keep only 10 of its 23 mantissa bits."""
    _need_gpu()
    rng = np.random.default_rng(0)
    shape, g = (403, 517), 40
    meta = noise_ops.cell_meta_batch([shape], shape, g)
    nCy, nCx = noise_ops.n_cells(shape[0], g), noise_ops.n_cells(shape[1], g)
    cells = rng.uniform(1.0, 2.0, (nCy, nCx)).astype(np.float32)
    out = np.asarray(noise_ops._assemble_rms_meta(
        jnp.asarray(cells), *(jnp.asarray(meta[k][0])
                              for k in ("c0y", "c1y", "c0x", "c1x"))))
    ref = noise_ops.assemble_rms_host(cells, shape[0], shape[1], g)
    np.testing.assert_array_equal(out, ref)


def test_windowed_irfft2_on_card():
    """The calibration read's DFT matmuls agree with the CPU backend's
    float32 result.  Summed in TF32, the ~5e4 products per window value
    would be off by ~1e-3."""
    _need_gpu()
    rng = np.random.default_rng(1)
    ny, nx = 256, 384
    m = rng.normal(0, 1, (ny, nx)).astype(np.float32)

    def window(device):
        with jax.default_device(device):
            G = jnp.fft.rfft2(jnp.asarray(m))
            return np.asarray(fourier.windowed_irfft2(
                G, jnp.int32(100), jnp.int32(200), ny, nx, 33))

    np.testing.assert_allclose(window(jax.devices()[0]),
                               window(jax.devices("cpu")[0]), atol=1e-5)


def test_triton_rms_kernel_on_card():
    """The compiled Pallas Triton RMS kernel against the XLA estimator."""
    _need_gpu()
    rng = np.random.default_rng(2)
    shapes, padShape, g = [(400, 700), (377, 655)], (448, 720), 80
    maps = np.zeros((2,) + padShape, np.float32)
    for i, (ny, nx) in enumerate(shapes):
        maps[i, :ny, :nx] = rng.normal(0, 2.0, (ny, nx))
        maps[i, : ny // 10] = 0
    meta = noise_ops.cell_meta_batch(shapes, padShape, g)
    out = {impl: np.asarray(noise_ops.grid_rms_map_batch(
        jnp.asarray(maps), g, impl=impl, meta=meta, return_cells=True))
        for impl in ("xla", "triton")}
    np.testing.assert_allclose(out["triton"], out["xla"], rtol=1e-5,
                               atol=1e-6)
