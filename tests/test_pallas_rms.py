"""The grid sigma-clip RMS estimators: a numpy port of the reference's
cell loop, the XLA gather path, and the Pallas Triton kernel (interpret
mode here; ``tests/test_gpu.py`` runs it compiled on the card)."""

import numpy as np
import pytest

import jax.numpy as jnp

from nemo_tpu.ops import noise as noise_ops


def reference_rms_map(m, g, n_iter=10):
    """The reference's makeNoiseMap cell loop (``filters.py:416-483``):
    half-cell overlapping windows in row-major order, a 3-sigma clip
    iterated over the window's nonzero pixels, and each cell with a
    nonzero RMS overwriting its window."""
    ny, nx = m.shape
    ov = g // 2
    ye = np.linspace(0, ny, int(ny / g + 1), dtype=int)
    xe = np.linspace(0, nx, int(nx / g + 1), dtype=int)
    out = np.zeros_like(m)
    for i in range(len(ye) - 1):
        for k in range(len(xe) - 1):
            y0, y1 = max(ye[i] - ov, 0), min(ye[i + 1] + ov, ny)
            x0, x1 = max(xe[k] - ov, 0), min(xe[k + 1] + ov, nx)
            good = m[y0:y1, x0:x1]
            good = good[good != 0]
            if good.size == 0:
                continue
            mean, rms = good.mean(), good.std()
            for _ in range(n_iter):
                sel = good[np.abs(good) < abs(mean + 3 * rms)]
                if sel.size:
                    mean, rms = sel.mean(), sel.std()
            if rms > 0:
                out[y0:y1, x0:x1] = rms
    return out


@pytest.mark.parametrize("shape, g", [((200, 240), 64), ((167, 233), 40),
                                      ((96, 96), 80)])
def test_grid_rms_matches_reference_cell_loop(shape, g):
    rng = np.random.default_rng(7)
    m = rng.normal(0, 2.0, shape)
    m[: shape[0] // 8] = 0                      # masked rows
    m[:, -shape[1] // 9:] = 0                   # masked columns
    m[rng.random(shape) < 0.01] = 25.0          # outliers the clip removes
    np.testing.assert_allclose(
        np.asarray(noise_ops.grid_rms_map(jnp.asarray(m), g)),
        reference_rms_map(m, g), rtol=1e-10, atol=1e-12)


def test_triton_rms_matches_xla():
    rng = np.random.default_rng(42)
    nT, ny, nx = 2, 200, 240
    m = rng.normal(0, 2.0, (nT, ny, nx))
    m[:, :20] = 0
    m[:, :, -20:] = 0
    xla = np.asarray(noise_ops.grid_rms_map_batch(jnp.asarray(m), 64,
                                                  impl="xla"))
    triton = np.asarray(noise_ops.grid_rms_map_batch(jnp.asarray(m), 64,
                                                     impl="triton",
                                                     interpret=True))
    np.testing.assert_allclose(triton, xla, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("impl", ["xla", "triton"])
def test_meta_geometry_matches_true_shape_exactly(impl):
    """With per-tile cell_meta, the batched estimator on PADDED maps must
    reproduce grid_rms_map on each tile's TRUE shape - the host-engine
    geometry (filters.py:417-422 lays cell edges out on the tile dims, not
    the padded dims)."""
    rng = np.random.default_rng(3)
    g = 64
    shapes = [(200, 240), (167, 233), (256, 256)]
    padShape = (256, 256)
    padded = np.zeros((len(shapes),) + padShape)
    tiles = []
    for i, (ny, nx) in enumerate(shapes):
        t = rng.normal(0, 2.0, (ny, nx))
        t[: ny // 10] = 0          # masked border rows
        tiles.append(t)
        padded[i, :ny, :nx] = t

    meta = noise_ops.cell_meta_batch(shapes, padShape, g)
    kw = {"interpret": True} if impl == "triton" else {}
    out = np.asarray(noise_ops.grid_rms_map_batch(
        jnp.asarray(padded), g, impl=impl, meta=meta, **kw))
    for i, (ny, nx) in enumerate(shapes):
        ref = np.asarray(noise_ops.grid_rms_map(jnp.asarray(tiles[i]), g))
        np.testing.assert_allclose(out[i, :ny, :nx], ref,
                                   rtol=1e-12, atol=1e-14,
                                   err_msg="impl=%s tile=%d" % (impl, i))
        # padding region must come back zero
        assert np.all(out[i, ny:] == 0)
        assert np.all(out[i, :, nx:] == 0)


def test_unknown_rms_impl_raises():
    with pytest.raises(ValueError, match="unknown RMS implementation"):
        noise_ops.grid_rms_map_batch(jnp.ones((1, 64, 64)), 32,
                                     impl="pallas")


def test_meta_cells_match_true_shape_cells():
    """return_cells with meta gives the true-shape cell grid in the
    leading slots and zeros in the unused padded slots."""
    rng = np.random.default_rng(5)
    g = 64
    shape, padShape = (150, 170), (192, 256)
    t = rng.normal(0, 1.0, shape)
    padded = np.zeros((1,) + padShape)
    padded[0, : shape[0], : shape[1]] = t

    meta = noise_ops.cell_meta_batch([shape], padShape, g)
    cells = np.asarray(noise_ops.grid_rms_map_batch(
        jnp.asarray(padded), g, impl="xla", meta=meta,
        return_cells=True))[0]
    refCells = np.asarray(noise_ops.grid_rms_map(
        jnp.asarray(t), g, return_cells=True))
    nCy, nCx = refCells.shape
    np.testing.assert_allclose(cells[:nCy, :nCx], refCells,
                               rtol=1e-12, atol=1e-14)
    assert np.all(cells[nCy:] == 0)
    assert np.all(cells[:, nCx:] == 0)
    # host expansion of the sliced grid reproduces the true-shape map
    full = noise_ops.assemble_rms_host(cells[:nCy, :nCx], shape[0],
                                       shape[1], g)
    ref = np.asarray(noise_ops.grid_rms_map(jnp.asarray(t), g))
    np.testing.assert_allclose(full, ref, rtol=1e-12, atol=1e-14)
