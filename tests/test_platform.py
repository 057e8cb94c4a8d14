"""The backend decision table, the compilation cache's location, and the
precision of the float32 products that must not run in TF32."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from nemo_tpu import platform
from nemo_tpu.ops import detect as detect_ops
from nemo_tpu.ops import fourier, imageops
from nemo_tpu.ops import noise as noise_ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("backend, row", [
    ("cpu", dict(device_detection=False, bank_paint=False,
                 qfit_tile_batch=False, qfit_model_batch=1,
                 segment_stats="scatter", rms_impl="xla")),
    ("gpu", dict(device_detection=True, bank_paint=True,
                 qfit_tile_batch=True, qfit_model_batch=16,
                 segment_stats="compact", rms_impl="triton")),
])
def test_decision_rows(backend, row):
    got = platform.choices(backend)
    for key, value in row.items():
        assert getattr(got, key) == value, key


def test_default_row_is_this_backend():
    assert platform.choices() is platform.choices(jax.default_backend())


@pytest.mark.parametrize("backend", ["rocm", "METAL", "neuron"])
def test_unknown_backend_raises(backend):
    with pytest.raises(RuntimeError, match="no decision row"):
        platform.choices(backend)


def test_detect_auto_follows_the_table(monkeypatch):
    """impl="auto" takes the row's segment statistics: both rows give the
    same objects."""
    rng = np.random.default_rng(4)
    sn = rng.normal(0, 1, (64, 80))
    sn[20:24, 30:35] = 9.0
    ref = {k: np.asarray(v) for k, v in detect_ops.detect_objects(
        jnp.asarray(sn), 4.0, max_objects=16, impl="scatter").items()}
    row = platform.choices("cpu")
    monkeypatch.setitem(platform._TABLE, jax.default_backend(),
                        platform.BackendChoices(
                            **dict(row.__dict__, segment_stats="compact")))
    detect_ops.detect_objects.clear_cache()
    got = {k: np.asarray(v) for k, v in detect_ops.detect_objects(
        jnp.asarray(sn), 4.0, max_objects=16, impl="auto").items()}
    detect_ops.detect_objects.clear_cache()
    for k in ("valid", "numPix", "comY", "comX", "peak"):
        np.testing.assert_allclose(got[k][ref["valid"]],
                                   ref[k][ref["valid"]], err_msg=k)


def _cache_dir_in_child(env):
    code = ("import sys; sys.path.insert(0, %r); import jax; "
            "from nemo_tpu import platform; "
            "print(platform.enable_compilation_cache()); "
            "print(jax.config.jax_compilation_cache_dir)" % REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    return out[-2:]


def _clean_env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR",
                        "NEMO_TPU_COMPILE_CACHE")}
    env["JAX_PLATFORMS"] = "cpu"
    return env


def test_cache_defaults_to_the_checkout():
    returned, configured = _cache_dir_in_child(_clean_env())
    assert returned == configured == os.path.join(REPO, ".jax_cache")


def test_cache_honours_jax_compilation_cache_dir(tmp_path):
    env = dict(_clean_env(), JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    returned, configured = _cache_dir_in_child(env)
    assert returned == configured == str(tmp_path)


def test_cache_off_switch():
    env = dict(_clean_env(), NEMO_TPU_COMPILE_CACHE="0")
    returned, _ = _cache_dir_in_child(env)
    assert returned == "None"


def _precisions(fn, *args):
    """Precision configs of every dot_general/conv in fn's jaxpr."""
    out = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name in ("dot_general",
                                      "conv_general_dilated"):
                out.append(eqn.params["precision"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return out


def _all_highest(precs):
    hi = jax.lax.Precision.HIGHEST
    return len(precs) > 0 and all(
        p is not None and all(q == hi for q in
                              (p if isinstance(p, tuple) else (p,)))
        for p in precs)


def test_precision_rms_painting():
    meta = noise_ops.cell_meta_batch([(50, 60)], (50, 60), 16)
    args = [jnp.ones((noise_ops.n_cells(50, 16), noise_ops.n_cells(60, 16)),
                     jnp.float32)]
    args += [jnp.asarray(meta[k][0]) for k in ("c0y", "c1y", "c0x", "c1x")]
    assert _all_highest(_precisions(noise_ops._assemble_rms_meta, *args))


def test_precision_windowed_dft():
    G = jnp.ones((32, 17), jnp.complex64)
    precs = _precisions(lambda g: fourier.windowed_irfft2(
        g, jnp.int32(1), jnp.int32(2), 32, 32, 9), G)
    assert len(precs) == 2 and _all_highest(precs)


def test_precision_spline_reads():
    maps3d = jnp.ones((2, 40, 40), jnp.float32)
    ys = jnp.array([20.3, 17.8], jnp.float32)
    precs = _precisions(lambda m, y: detect_ops.spline_values(
        m, y, y, window=8), maps3d, ys)
    assert len(precs) >= 2 and _all_highest(precs)


def test_precision_convolutions():
    m = jnp.ones((2, 30, 30), jnp.float32)
    k = jnp.ones((2, 5, 5), jnp.float32)
    assert _all_highest(_precisions(
        lambda a: imageops.gaussian_filter(a, 2.0), m))
    assert _all_highest(_precisions(imageops.convolve2d_reflect_sum, m, k))
