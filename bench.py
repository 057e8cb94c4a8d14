"""Benchmark: production matched-filter step throughput on one GPU.

Metric: PRODUCTION tile-scale MMF pipeline steps per second on one card,
on ACT DR5-like tiles (2 frequencies, ~7 x 12 deg tile at 0.5 arcmin
pixels, padded to FFT-friendly 896 x 1536).  One step = the batched
engine's per-tile-per-scale device work
(``make_sharded_matched_filter_step``, the same compiled program
``useDeviceBatching`` runs in production): noise covariance from tile
FFTs + 3-pixel Gaussian smoothing, closed-form per-pixel N^-1 w|s| solve,
signal-norm calibration against a known-amplitude template (reference
``filters.py:635-690``), filter application, grid sigma-clipped RMS map,
S/N map, edge trim and masking.  Excluded (host-side in both this
framework and the reference): per-tile preprocessing/IO, template
painting, detection and catalog work - those are timed end-to-end by
``chip_smoke.py`` and ``examples/dr5_scale_benchmark.py`` instead.

Exits non-zero when JAX finds no GPU.  Prints the card's name and power
limit, then ONE JSON line.
"""

import json
import subprocess
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit("bench.py: JAX found no GPU (platform %r)" % dev.platform)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)

    from __graft_entry__ import _example_inputs
    from nemo_tpu.ops import noise as noise_ops
    from nemo_tpu.parallel import distribute
    from nemo_tpu.parallel.mesh import get_mesh, tile_sharding

    nf = 2
    ny, nx = 896, 1536          # DR5-like tile (7 x 12 deg at 0.5')
    gridSize = 80               # 40 arcmin noise cells at 0.5' pixels
    trimPix = 240               # reference default: 3 x gridSize
    nTiles = 16                 # tiles resident per step

    mesh = get_mesh(n_devices=1)
    data, noise, fsignal, w, apodM, psMask, surveyMask = _example_inputs(
        nTiles, nf, ny, nx, np.float32, seed=1)
    sh = tile_sharding(mesh)
    apodB = np.broadcast_to(np.asarray(apodM), (nTiles, ny, nx))
    calib = np.asarray(fsignal) * 2e-4   # known-amplitude templates
    peakYX = np.full((nTiles, 2), ny // 2, dtype=np.int32)
    peakYX[:, 1] = nx // 2
    fgPower = np.full((nTiles, ny, nx // 2 + 1), -np.inf,
                      dtype=np.float32)  # no CMB covariance floor
    meta = noise_ops.cell_meta_batch([(ny, nx)] * nTiles, (ny, nx),
                                     gridSize)
    stepArgs = (jax.device_put(data, sh), jax.device_put(noise, sh),
                jax.device_put(fsignal, sh),
                jax.device_put(jnp.asarray(calib), sh), w,
                jax.device_put(jnp.asarray(apodB), sh),
                jax.device_put(psMask, sh), jax.device_put(surveyMask, sh),
                jax.device_put(jnp.asarray(fgPower), sh),
                jax.device_put(jnp.asarray(peakYX), sh),
                {k: jax.device_put(jnp.asarray(v), sh)
                 for k, v in meta.items()})
    step = distribute.make_sharded_matched_filter_step(mesh, gridSize,
                                                       trimPix)
    jax.block_until_ready(step(*stepArgs))      # compile + warm up

    # Median of batches with the dispersion beside it: each timed batch
    # is nIter steps.
    nIter, nBatches = 5, 7
    batchSeconds = []
    for _ in range(nBatches):
        t0 = time.perf_counter()
        for _ in range(nIter):
            jax.block_until_ready(step(*stepArgs))
        batchSeconds.append(time.perf_counter() - t0)
    rates = np.array([nIter * nTiles / s for s in batchSeconds])
    q1, q3 = np.percentile(rates, 25), np.percentile(rates, 75)
    print(json.dumps({
        "metric": "DR5-like 2-freq MMF production tile-scale steps/sec",
        "value": float(np.median(rates)),
        "unit": "tile_scale_steps/sec",
        "value_iqr": [float(q1), float(q3)],
        "value_batches": [float(r) for r in rates],
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
