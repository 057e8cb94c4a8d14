"""Multi-device scaling measurement for the sharded production step.

Measures how the SAME sharded production program (detect-mode
``make_sharded_matched_filter_step``) executed over 1/2/4/8 virtual XLA
host devices (``--xla_force_host_platform_device_count``) behaves, the
mechanism
the test suite uses for sharding validation (mirroring the reference's
single-host ``mpiexec -np 4``, ``tests/lib/NemoTests.py:177``).

What this DOES measure: the sharding itself - that the tile axis
partitions with no cross-device collectives in the hot path (the step is
embarrassingly tile-parallel by design, like the reference's
tile-per-MPI-rank loop), and how per-device throughput changes as the
mesh grows on fixed silicon.

What this does NOT measure: interconnect bandwidth or device compute
(virtual devices share one host's cores); the 4-card path runs on the
GPUs with ``python chip_smoke.py --four-cards``.

Each mesh size runs in a fresh subprocess (host device count is fixed at
backend init).  Writes JSON to --out.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

_WORKER = r"""
import json, os, sys, time
import numpy as np
sys.path.insert(0, %(repo)r)
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from __graft_entry__ import _example_inputs
from nemo_tpu.ops import noise as noise_ops
from nemo_tpu.parallel import distribute
from nemo_tpu.parallel.mesh import get_mesh, tile_sharding

nDev = %(nDev)d
tilesPerDev = %(tilesPerDev)d
nT = nDev * tilesPerDev
nf, ny, nx = 2, %(ny)d, %(nx)d
gridSize = %(gridSize)d

mesh = get_mesh(n_devices=nDev)
sh = tile_sharding(mesh)
host = _example_inputs(nT, nf, ny, nx, np.float32, seed=1)
data, noiseA, fsignal, w, apodM, psMask, surveyMask = host
apodB = np.broadcast_to(np.asarray(apodM), (nT, ny, nx))
calib = np.asarray(fsignal) * 2e-4
peakYX = np.full((nT, 2), ny // 2, dtype=np.int32); peakYX[:, 1] = nx // 2
fgPower = np.full((nT, ny, nx // 2 + 1), -np.inf, dtype=np.float32)
meta = noise_ops.cell_meta_batch([(ny, nx)] * nT, (ny, nx), gridSize)
metaDev = {k: jax.device_put(jnp.asarray(v), sh) for k, v in meta.items()}
args = (jax.device_put(data, sh), jax.device_put(noiseA, sh),
        jax.device_put(fsignal, sh), jax.device_put(jnp.asarray(calib), sh),
        w, jax.device_put(jnp.asarray(apodB), sh),
        jax.device_put(psMask, sh), jax.device_put(surveyMask, sh),
        jax.device_put(jnp.asarray(fgPower), sh),
        jax.device_put(jnp.asarray(peakYX), sh), metaDev)
step = distribute.make_sharded_matched_filter_step(
    mesh, gridSize, 0, rms_impl="auto",
    detect_params=(4.0, 128, 128, False, 16))

# Collective census: count inter-device communication ops in the
# compiled HLO.  Zero collectives = the tile axis partitions with no
# cross-device traffic, so throughput scales with device count by
# construction (each chip runs the identical per-shard program on its
# own tiles) - the compile-level fact behind "tiles shard linearly".
def _census(lowered):
    hlo = lowered.compile().as_text()
    return {op: hlo.count(op + "(") for op in
            ("all-reduce", "all-gather", "all-to-all", "reduce-scatter",
             "collective-permute", "collective-broadcast")}

census = _census(step.lower(*args))

# The SURVEY-STATS step (make_sharded_tile_step with_survey_stats=True,
# the program dryrun_multichip also validates) DOES carry collectives:
# a pmax for globally-consistent histogram bins and psums for the
# candidate count + noise histogram - the reference's MPI gathers.
# Census it separately so the story names which program has which
# traffic: the production detect path has none; the survey-stat
# reductions move O(histogram) bytes once per chunk.
statsStep = distribute.make_sharded_tile_step(
    mesh, gridSize, 0, topK=64, threshold=4.0, with_survey_stats=True)
statsCensus = _census(statsStep.lower(
    args[0], args[1], args[2], w, jnp.asarray(np.asarray(apodM)),
    args[6], args[7]))

jax.block_until_ready(step(*args))       # warm
ts = []
for _ in range(%(iters)d):
    t0 = time.time()
    jax.block_until_ready(step(*args))
    ts.append(time.time() - t0)
t = float(np.median(ts))
print(json.dumps({"nDev": nDev, "nTiles": nT, "step_s": t,
                  "tile_scale_steps_per_s": nT / t,
                  "hlo_collectives_production_detect_step": census,
                  "hlo_collectives_survey_stats_step": statsCensus}))
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ny", type=int, default=900)
    ap.add_argument("--nx", type=int, default=1728)
    ap.add_argument("--gridSize", type=int, default=80)
    ap.add_argument("--tilesPerDev", type=int, default=1)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--meshes", default="1,2,4,8")
    args = ap.parse_args()

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rows = []
    for nDev in [int(s) for s in args.meshes.split(",")]:
        code = _WORKER % {"repo": repo, "nDev": nDev,
                          "tilesPerDev": args.tilesPerDev,
                          "ny": args.ny, "nx": args.nx,
                          "gridSize": args.gridSize, "iters": args.iters}
        env = dict(os.environ)
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                            + " --xla_force_host_platform_device_count=%d"
                            % nDev).strip()
        env["JAX_PLATFORMS"] = "cpu"
        env["NEMO_TPU_PLATFORM"] = "cpu"
        r = subprocess.run([sys.executable, "-c", code], env=env,
                           capture_output=True, text=True)
        line = [l for l in r.stdout.strip().splitlines()
                if l.startswith("{")]
        if not line:
            print("mesh %d FAILED:\n%s" % (nDev, r.stderr[-2000:]))
            continue
        row = json.loads(line[-1])
        rows.append(row)
        print("mesh %d: %.2f steps/s (%.2f per device)"
              % (nDev, row["tile_scale_steps_per_s"],
                 row["tile_scale_steps_per_s"] / nDev), flush=True)

    base = rows[0]["tile_scale_steps_per_s"] if rows else float("nan")
    try:
        nCores = len(os.sched_getaffinity(0))
    except AttributeError:
        nCores = os.cpu_count()
    doc = {
        "what": "detect-mode sharded production step, weak scaling "
                "(tiles = %d per device) over virtual XLA host devices"
                % args.tilesPerDev,
        "shape": [2, args.ny, args.nx], "gridSize": args.gridSize,
        "host_cores": nCores,
        "rows": rows,
        "weak_scaling_efficiency": [
            {"nDev": r["nDev"],
             "efficiency": (r["tile_scale_steps_per_s"] / r["nDev"])
             / base} for r in rows],
        "caveats": "virtual devices time-share %d host core(s), so the "
                   "wall-clock rows measure CORE CONTENTION, not chip "
                   "scaling (on 1 core, expect efficiency ~ 1/nDev). "
                   "The scaling claim rests on the HLO censuses, one "
                   "per PROGRAM: the PRODUCTION detect-mode step (what "
                   "the DR5 record runs per chunk x scale) compiles "
                   "with ZERO inter-device communication at every mesh "
                   "size, so each added chip adds its full bench.py "
                   "rate; the survey-stats step (the dryrun's psum/"
                   "pmax reductions, the reference's MPI gathers) "
                   "carries its all-reduces explicitly and moves "
                   "O(histogram) bytes once per chunk - not a "
                   "bandwidth term.  The serial remainder is the host "
                   "staging/catalog work (Amdahl terms measured per-"
                   "stage in the DR5 benchmark's timings.json)."
                   % nCores,
    }
    print(json.dumps(doc, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(doc, indent=2) + "\n")


if __name__ == "__main__":
    main()
