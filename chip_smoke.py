#!/usr/bin/env python
"""End-to-end check of the nemo cluster search on one NVIDIA GPU.

Runs the main path (``nemo config.yml``: filter -> detect -> catalog ->
fitQ -> RMS tables -> selection function) through the CLI entry point on
skies simulated from fixed seeds, checks the results against the
repository's references, and times the device kernels.  Phases:

  device   JAX must find a GPU; prints its kind, name and power limit
  golden   the tests/golden.py sky through the per-tile and the batched
           engine, against tests/data/golden_fixed_y_c.csv
  dr5      one device chunk of the DR5 search at DR5's shapes: 16 ragged
           10 x 5 deg tiles, 2 bands, 16 Arnaud scales, fitQ, selFn
  step     the production step at the DR5 tile shape on the GPU and on
           the CPU backend of the same process
  kernels  the RMS estimator (XLA vs the Pallas Triton kernel) and the
           segment statistics (compact vs scatter), alone and in the step
  tests    the tests marked ``gpu`` in tests/test_gpu.py

Usage:
  python chip_smoke.py                 all phases on one card
  python chip_smoke.py --four-cards    the dr5 phase on a 4-card mesh and
                                       on a 1-card mesh, compared row by row
  python chip_smoke.py --time-choices  also time each backend-table choice
                                       against its alternative (dr5 phase)

Every check that fails raises, so the script exits non-zero.  The last
line of standard output is one JSON object naming the device.
"""

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "examples"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import dr5_scale_benchmark as dr5  # noqa: E402
from nemo_tpu import catalogs, platform  # noqa: E402
from nemo_tpu.ops import noise as noise_ops  # noqa: E402
from nemo_tpu.parallel import distribute  # noqa: E402
from nemo_tpu.parallel.mesh import get_mesh, tile_sharding  # noqa: E402
from nemo_tpu.utils import yamlio  # noqa: E402
from nemo_tpu.utils.tables import Table  # noqa: E402

# DR5 chunk: 21 x 60 deg at 0.5' autotiles into 16 tiles of 10 x 5 deg.
DR5_SHAPE = (2520, 7200)
DR5_CLUSTERS = 100
# Production step at the DR5 tile shape (bench.py's cell).
STEP_TILES, NF, NY, NX = 16, 2, 896, 1536
GRID, TRIM = 80, 240
DETECT = (4.0, 512, 128, True, 16)   # pipelines.py's device detection
STEP_CPU_TILES = 4                    # tiles the CPU reference recomputes

_compile = {"s": 0.0}


def repo_module(relPath):
    """Import a file of this checkout by path (the name ``tests`` may be
    taken by an installed package)."""
    import importlib.util

    name = os.path.splitext(os.path.basename(relPath))[0]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, relPath))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _on_duration(event, duration, **_):
    # wraps compile_or_get_cached: real compiles plus persistent-cache reads
    if event == "/jax/core/compile/backend_compile_duration":
        _compile["s"] += duration


def say(*parts):
    # to the real stdout even while a CLI run's output goes to its log
    print("SMOKE", *parts, file=sys.__stdout__, flush=True)


@contextlib.contextmanager
def timed(name):
    c0, t0 = _compile["s"], time.perf_counter()
    yield
    say("%s wall_s=%.3f compile_s=%.3f"
        % (name, time.perf_counter() - t0, _compile["s"] - c0))


def check(ok, what):
    if not ok:
        raise AssertionError(what)
    say("check ok:", what)


# -----------------------------------------------------------------------------
# device

def phase_device(nCards):
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit("chip_smoke: JAX found no GPU (platform %r)"
                         % devs[0].platform)
    if len(devs) < nCards:
        raise SystemExit("chip_smoke: %d GPUs needed, %d found"
                         % (nCards, len(devs)))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    say("device kind=%s count=%d" % (devs[0].device_kind, len(devs)))
    for line in smi.stdout.strip().splitlines():
        print(line.strip(), flush=True)
    return devs


# -----------------------------------------------------------------------------
# the nemo CLI

def run_nemo(configDict, path, logPath):
    """Write the config and run ``nemo <config>`` in this process, its
    output going to ``logPath``.  Returns (wall_s, compile_s)."""
    from nemo_tpu.cli import nemo_main

    with open(path, "w") as f:
        f.write(yamlio.dump(configDict))
    c0, t0 = _compile["s"], time.perf_counter()
    argv = sys.argv
    try:
        sys.argv = ["nemo", path]
        with open(logPath, "w") as log, contextlib.redirect_stdout(log):
            nemo_main.main()
    except BaseException:
        with open(logPath) as log:
            sys.stderr.write(log.read()[-8000:])
        raise
    finally:
        sys.argv = argv
    return time.perf_counter() - t0, _compile["s"] - c0


def optimal_catalog(outDir):
    return Table.read(os.path.join(
        outDir, "%s_optimalCatalog.fits" % os.path.basename(outDir)))


def stage_times(outDir):
    with open(os.path.join(outDir, "diagnostics", "timings.json")) as f:
        return json.load(f)


# -----------------------------------------------------------------------------
# golden

def phase_golden(work):
    golden = repo_module("tests/golden.py")
    gdir = os.path.join(work, "golden")
    # The CMB draw depends on the dtype: the golden sky is the float64 CPU
    # one, so a CPU-only child process writes it and never opens the card.
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="",
               JAX_ENABLE_X64="1", NEMO_TPU_COMPILE_CACHE="0")
    with timed("golden sky (CPU subprocess)"):
        subprocess.run(
            [sys.executable, "-c",
             "import sys; sys.path.insert(0, %r); import chip_smoke;"
             " chip_smoke.repo_module('tests/golden.py').write_inputs(%r)"
             % (REPO, gdir)],
            env=env, check=True, timeout=900)
    with open(os.path.join(gdir, "golden.yml")) as f:
        base = yamlio.load(f)
    gold = golden.load_golden()
    inputTab = golden.input_table()
    for name, batched in (("per-tile", False), ("batched", True)):
        cfg = dict(base, useDeviceBatching=batched, meshDevices=1,
                   outputDir=os.path.join(gdir, "out_" + name))
        wall, comp = run_nemo(cfg, os.path.join(gdir, name + ".yml"),
                              os.path.join(gdir, name + ".log"))
        say("golden %s nemo wall_s=%.3f compile_s=%.3f" % (name, wall, comp))
        cat = optimal_catalog(cfg["outputDir"])
        refM, _, _ = catalogs.crossMatch(inputTab, cat, radiusArcmin=1.5)
        check(len(refM) == len(gold),
              "golden %s: %d/%d clusters recovered" % (name, len(refM),
                                                      len(gold)))
        idx, sep = catalogs.nearestNeighbours(
            np.asarray(gold["RADeg"], float), np.asarray(gold["decDeg"],
                                                         float),
            np.asarray(cat["RADeg"]), np.asarray(cat["decDeg"]))
        check(np.all(sep * 60 < 1.0), "golden %s: max position offset "
              "%.3f' < 1'" % (name, np.max(sep * 60)))
        ratio = np.asarray(cat["fixed_y_c"])[idx] / np.asarray(
            gold["fixed_y_c"], float)
        # rtol of tests/test_golden_regression.py: a float32 card run must
        # stay within the float64 CPU run's calibration to 0.5%
        check(np.all(np.abs(ratio - 1) < 5e-3),
              "golden %s: max |fixed_y_c/golden - 1| = %.2e < 5e-3"
              % (name, np.max(np.abs(ratio - 1))))


# -----------------------------------------------------------------------------
# dr5

def dr5_inputs(work):
    ddir = os.path.join(work, "dr5")
    if not os.path.exists(os.path.join(ddir, "surveyMask.fits")):
        with timed("dr5 sky"):
            dr5.makeSurvey(ddir, shape=DR5_SHAPE, nClusters=DR5_CLUSTERS)
    mapEntries = [{"mapFileName": os.path.join(ddir, "sim_%s.fits" % b),
                   "obsFreqGHz": freq, "units": "uK",
                   "beamFileName": os.path.join(ddir, "beam_%s.txt" % b)}
                  for b, freq, _, _ in dr5.BANDS]
    return ddir, dr5.makeConfig(ddir, mapEntries,
                                os.path.join(ddir, "surveyMask.fits"))


def run_dr5(ddir, cfg, name):
    cfg = dict(cfg, outputDir=os.path.join(ddir, "out_" + name))
    wall, comp = run_nemo(cfg, os.path.join(ddir, name + ".yml"),
                          os.path.join(ddir, name + ".log"))
    stages = stage_times(cfg["outputDir"])
    say("dr5 %s nemo wall_s=%.3f compile_s=%.3f" % (name, wall, comp))
    for stage, secs in sorted(stages["stages"].items(), key=lambda kv:
                              -kv[1]):
        say("dr5 %s stage %s wall_s=%.3f" % (name, stage, secs))
    return cfg["outputDir"], wall, comp


def phase_dr5(work, timeChoices):
    ddir, cfg = dr5_inputs(work)
    cfg["meshDevices"] = 1
    outDir, _, _ = run_dr5(ddir, cfg, "batched")
    with open(os.path.join(outDir, "selFn", "tileDefinitions.yml")) as f:
        tiles = [t["tileName"] for t in yamlio.load(f)]
    say("dr5 tiles=%d" % len(tiles))
    check(14 <= len(tiles) <= 20, "dr5: %d autotiles in 14-20" % len(tiles))
    check(os.path.exists(os.path.join(outDir, "selFn", "QFit.fits")),
          "dr5: fitQ wrote QFit.fits")

    cat = optimal_catalog(outDir)
    inputTab = Table.read(os.path.join(ddir, "inputCatalog.fits"))
    refM, _, seps = catalogs.crossMatch(inputTab, cat, radiusArcmin=1.5)
    frac = len(refM) / len(inputTab)
    check(frac >= 0.98, "dr5: %d/%d injected clusters recovered within "
          "1.5' (>= 98%%)" % (len(refM), len(inputTab)))
    check(np.median(seps) * 60 <= 12.0, "dr5: median offset %.2f\" <= 12\""
          % (np.median(seps) * 60))

    # Per-tile engine on two tiles: the same objects, and fixed_y_c within
    # 2% in the median (the batched-engine parity rule).
    two = tiles[:2]
    host, _, _ = run_dr5(ddir, dict(cfg, useDeviceBatching=False,
                                    tileNameList=two, fitQ=False,
                                    calcSelFn=False), "per-tile")
    hostCat = optimal_catalog(host)
    mine = cat[np.isin(np.asarray(cat["tileName"]), two)]
    a, b, _ = catalogs.crossMatch(mine, hostCat, radiusArcmin=0.5)
    check(len(a) >= 0.98 * max(len(mine), len(hostCat)) and len(mine) > 0,
          "dr5 per-tile engine on %s: %d of %d/%d objects shared"
          % (two, len(a), len(mine), len(hostCat)))
    medRatio = np.median(np.asarray(b["fixed_y_c"])
                         / np.asarray(a["fixed_y_c"]))
    check(abs(medRatio - 1) <= 0.02, "dr5 per-tile engine: median "
          "fixed_y_c ratio %.5f within 2%%" % medRatio)
    if timeChoices:
        time_choices(ddir, cfg, outDir)


def time_choices(ddir, cfg, outDir):
    """Each backend-table choice of the gpu row against its alternative,
    warm, on the same chunk."""
    from nemo_tpu import startup
    from nemo_tpu.models import qfit

    filterOnly = dict(cfg, fitQ=False, calcSelFn=False)
    for name, extra in (("table", {}),
                        ("no-device-detection", {"useDeviceDetection":
                                                 False}),
                        ("no-bank-paint", {"bankPaintBatch": False})):
        run_dr5(ddir, dict(filterOnly, **extra), "choice-" + name)
    for name, extra in (("tile-batched", {}),
                        ("serial-batch16", {"qfitTileBatch": False}),
                        ("serial-batch1", {"qfitTileBatch": False,
                                           "qfitBatchSize": 1})):
        with open(os.path.join(ddir, "fitq-%s.log" % name), "w") as log, \
                contextlib.redirect_stdout(log):
            config = startup.NemoConfig(os.path.join(ddir, "batched.yml"),
                                        writeTileInfo=False)
            config.parDict.update(extra)
            with timed("dr5 choice fitQ %s" % name):
                qfit.fitQ(config)


def phase_four_cards(work):
    """The dr5 chunk's catalog from a 4-card mesh and from a 1-card mesh,
    in one process.  fitQ and the selection function use one device
    either way, so only the filter and detection stages run."""
    ddir, cfg = dr5_inputs(work)
    cfg = dict(cfg, fitQ=False, calcSelFn=False)
    cats = {}
    for n in (4, 1):
        outDir, _, _ = run_dr5(ddir, dict(cfg, meshDevices=n),
                               "mesh%d" % n)
        cats[n] = optimal_catalog(outDir)
    c4, c1 = cats[4], cats[1]
    check(len(c4) == len(c1) and len(c1) > 0,
          "four-cards: %d rows on 4 cards, %d on 1" % (len(c4), len(c1)))
    idx, sep = catalogs.nearestNeighbours(
        np.asarray(c1["RADeg"]), np.asarray(c1["decDeg"]),
        np.asarray(c4["RADeg"]), np.asarray(c4["decDeg"]))
    check(len(set(idx)) == len(c1) and np.all(sep * 3600 < 0.1),
          "four-cards: rows pair up, max offset %.4f\"" % (np.max(sep)
                                                          * 3600))
    # float32 tolerance: the same per-tile program, compiled for another
    # per-device batch, may round differently in the last bits
    worst, worstCol = 0.0, None
    for col in c1.keys():
        x, y = np.asarray(c1[col]), np.asarray(c4[col])[idx]
        if x.dtype.kind != "f":
            check(np.array_equal(x, y), "four-cards: column %s identical"
                  % col)
            continue
        rel = np.max(np.abs(x - y) / np.maximum(np.abs(x), 1e-30))
        if rel >= worst:
            worst, worstCol = rel, col
    check(worst <= 1e-4, "four-cards: numeric columns agree, worst %s max "
          "rel diff %.2e <= 1e-4" % (worstCol, worst))


# -----------------------------------------------------------------------------
# step and kernels

def step_host_inputs(nTiles):
    """Host arrays for the production step at the DR5 tile shape."""
    from __graft_entry__ import _example_inputs

    data, noise, tmpl, w, apodM, psMask, surveyMask = (
        np.asarray(a) for a in _example_inputs(nTiles, NF, NY, NX,
                                               np.float32, seed=1))
    peakYX = np.tile(np.array([[NY // 2, NX // 2]], np.int32), (nTiles, 1))
    meta = noise_ops.cell_meta_batch([(NY, NX)] * nTiles, (NY, NX), GRID)
    return (data, noise, tmpl, tmpl * np.float32(2e-4), w,
            np.broadcast_to(apodM, (nTiles, NY, NX)), psMask, surveyMask,
            np.full((nTiles, NY, NX // 2 + 1), -np.inf, np.float32),
            peakYX, meta)


def place(host, mesh):
    sh = tile_sharding(mesh)
    rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    *tiles, meta = host
    out = [jax.device_put(a, rep if i == 4 else sh)
           for i, a in enumerate(tiles)]
    return out + [{k: jax.device_put(v, sh) for k, v in meta.items()}]


def best_of(fn, args, n=5):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def valid_peaks(det, t):
    ok = np.asarray(det["valid"][t])
    return set(zip(np.asarray(det["peakY"][t])[ok].astype(int),
                   np.asarray(det["peakX"][t])[ok].astype(int)))


def phase_step():
    host = step_host_inputs(STEP_TILES)
    meshG = get_mesh(n_devices=1)
    step = distribute.make_sharded_matched_filter_step(
        meshG, GRID, TRIM, detect_params=DETECT)
    argsG = place(host, meshG)
    with timed("step gpu"):
        outG = jax.device_get(step(*argsG))
    with jax.default_matmul_precision("default"):
        outD = jax.device_get(step(*argsG))
    with jax.default_matmul_precision("highest"):
        outH = jax.device_get(step(*argsG))
    # Every float32 product sets its own precision, so the global setting
    # leaves the program unchanged: allow only last-bit noise, far below
    # TF32's 1e-3 relative rounding.
    for key in ("SNMap", "signalNorm", "RMSCells"):
        d = np.max(np.abs(outD[key] - outH[key]))
        scale = np.max(np.abs(outH[key]))
        check(d <= 1e-6 * scale, "step: %s independent of "
              "default_matmul_precision (max diff %.2e of %.2e)"
              % (key, d, scale))

    cpu = jax.devices("cpu")[0]
    meshC = get_mesh(devices=[cpu])
    n = STEP_CPU_TILES
    hostC = [a[:n] if i != 4 else a for i, a in enumerate(host[:-1])]
    hostC.append({k: v[:n] for k, v in host[-1].items()})
    stepC = distribute.make_sharded_matched_filter_step(
        meshC, GRID, TRIM, detect_params=DETECT)
    with timed("step cpu reference (%d tiles)" % n):
        outC = jax.device_get(stepC(*place(hostC, meshC)))
    # Tolerances, float32 on both sides: cuFFT and the CPU FFT round
    # differently (~1e-6 of a map's norm per transform), and the matched
    # filter's per-pixel solve amplifies that a little.
    sn = np.max(np.abs(outG["SNMap"][:n] - outC["SNMap"]))
    check(sn <= 1e-3, "step: SNMap max |gpu - cpu| %.2e <= 1e-3 (S/N "
          "units; the threshold is 4)" % sn)
    rel = np.max(np.abs(outG["signalNorm"][:n] / outC["signalNorm"] - 1))
    check(rel <= 1e-4, "step: signalNorm max rel diff %.2e <= 1e-4" % rel)
    # A pixel at the 3-sigma clip edge can fall on either side, moving a
    # cell's RMS by ~1/(pixels in the window) ~ 2e-5.
    cg, cc = outG["RMSCells"][:n], outC["RMSCells"]
    rel = np.max(np.abs(cg - cc) / np.maximum(np.abs(cc), 1e-30))
    check(rel <= 1e-3, "step: RMS cells max rel diff %.2e <= 1e-3" % rel)
    # Detections: S/N pixels within 1e-3 of the threshold may flip, so
    # ask that 98% of the peaks of each tile are shared.
    for t in range(n):
        pg, pc = valid_peaks(outG["det"], t), valid_peaks(outC["det"], t)
        shared = len(pg & pc) / max(len(pg), len(pc)) if pg or pc else 1.0
        check(shared >= 0.98, "step: tile %d detections %d gpu / %d cpu, "
              "%.3f shared" % (t, len(pg), len(pc), shared))


def phase_kernels():
    host = step_host_inputs(STEP_TILES)
    mesh = get_mesh(n_devices=1)
    args = place(host, mesh)
    filtered = jnp.asarray(host[0][:, 0] * host[6])
    meta = args[-1]
    times = {}
    outs = {}
    for impl in ("xla", "triton", "triton", "xla"):
        rms = jax.jit(lambda m, meta, impl=impl: noise_ops.grid_rms_map_batch(
            m, GRID, impl=impl, return_cells=True, meta=meta))
        times.setdefault(impl, []).append(best_of(rms, (filtered, meta)))
        outs[impl] = np.asarray(rms(filtered, meta))
    rel = np.max(np.abs(outs["triton"] - outs["xla"])
                 / np.maximum(np.abs(outs["xla"]), 1e-30))
    # same sums in another order: float32 rounding only
    check(rel <= 1e-5, "kernels: Triton RMS cells vs XLA max rel diff "
          "%.2e <= 1e-5 (%d tiles x %d x %d, gridSize %d)"
          % (rel, STEP_TILES, NY, NX, GRID))
    for impl, ts in times.items():
        say("kernels rms_cells impl=%s ms=%.3f" % (impl, 1e3 * min(ts)))

    row = platform.choices()
    steps = {}
    for name in ("xla", "triton", "scatter", "scatter", "triton", "xla"):
        impl = "xla" if name == "scatter" else name
        seg = "scatter" if name == "scatter" else "compact"
        platform._TABLE["gpu"] = dataclasses.replace(row, segment_stats=seg)
        distribute.make_sharded_matched_filter_step.cache_clear()
        step = distribute.make_sharded_matched_filter_step(
            mesh, GRID, TRIM, rms_impl=impl, detect_params=DETECT)
        steps.setdefault(name, []).append(best_of(step, args))
    platform._TABLE["gpu"] = row
    distribute.make_sharded_matched_filter_step.cache_clear()
    for name, ts in steps.items():
        say("kernels step rms=%s segment_stats=%s ms=%.3f"
            % ("xla" if name == "scatter" else name,
               "scatter" if name == "scatter" else "compact",
               1e3 * min(ts)))


def phase_tests():
    test_gpu = repo_module("tests/test_gpu.py")
    for name in sorted(dir(test_gpu)):
        if name.startswith("test_"):
            getattr(test_gpu, name)()
            say("test ok:", name)


# -----------------------------------------------------------------------------

def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the dr5 phase, on 4 cards and on 1")
    ap.add_argument("--time-choices", action="store_true",
                    help="time every backend-table choice in the dr5 phase")
    args = ap.parse_args()
    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    say("compilation cache:", platform.enable_compilation_cache())
    nCards = 4 if args.four_cards else 1
    devs = phase_device(nCards)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        if args.four_cards:
            with timed("phase four-cards"):
                phase_four_cards(work)
        else:
            for name, phase in (("golden", lambda: phase_golden(work)),
                                ("dr5", lambda: phase_dr5(
                                    work, args.time_choices)),
                                ("step", phase_step),
                                ("kernels", phase_kernels),
                                ("tests", phase_tests)):
                with timed("phase " + name):
                    phase()
    say("total wall_s=%.3f compile_s=%.3f"
        % (time.perf_counter() - t0, _compile["s"]))
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
