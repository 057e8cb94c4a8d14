"""Multi-host runtime skeleton.

The reference spans 15-18 nodes with MPI (``DR5ClusterSearch.slurm:1-9``
in Nemo's ``examples/ACT-DR5-clusters``, ``mpiexec`` over ~300 ranks).
The JAX equivalent is NOT a message-passing port: JAX's multi-controller
runtime (``jax.distributed.initialize``) gives every host process the same
global view of the device mesh, and the existing sharded steps
(``distribute.make_sharded_*``) run unchanged - ``jax.sharding.Mesh``
over ``jax.devices()`` spans hosts transparently, with XLA routing
tile-axis collectives over NVLink within a host and the network across
hosts.

What changes per layer when spanning hosts:

* **Mesh** (``mesh.get_mesh``): already built from ``jax.devices()``,
  which is the GLOBAL device list after ``initialize()`` - no change.
* **Collectives**: the survey reductions (psum/pmax in
  ``make_sharded_tile_step``) are mesh-axis collectives; across hosts
  XLA lowers them to network all-reduces automatically.  The tile axis
  is embarrassingly parallel outside those reductions, so cross-host
  traffic is O(histogram), not O(maps).
* **Data feeding** (the real work): each host process must stage only
  ITS addressable shard of a tile batch.
  ``jax.make_array_from_process_local_data`` replaces the plain
  ``device_put`` in ``engine._stage_bucket_uploads``; the tile -> rank
  assignment follows ``parallel.distribute_work`` exactly as the
  reference's startUp assigns tiles to MPI ranks
  (``nemo/startUp.py:389-404``).
* **Filesystem outputs**: per-tile FITS writes already go to
  per-tile paths (share-nothing); only the final merge/stitch steps
  are rank-0 work, gated on ``process_index() == 0``.

This module ships the runtime-init + gating primitives (exercised
single-process in the test suite; see ``tests/test_parallel.py``) so a
multi-host launch is a flag, not a rewrite.  One process drives all the
cards of one host, so the single-host production path never calls
``initialize()``.

Launch contract (one process per host, all hosts):

    NEMO_TPU_MULTIHOST=1 \
    JAX_COORDINATOR_ADDRESS=host0:8476 \
    JAX_NUM_PROCESSES=N JAX_PROCESS_ID=i \
        nemo config.yml
"""

import os

import jax


def multihost_requested():
    """True when the launch environment asked for the multi-host
    runtime (NEMO_TPU_MULTIHOST=1)."""
    return os.environ.get("NEMO_TPU_MULTIHOST", "") not in ("", "0")


def initialize_from_env():
    """Bring up the JAX multi-controller runtime if requested.

    Must run before first device use.  Arguments come from the
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID
    variables, which the launch must set.  No-op (returns False)
    when multi-host was not requested, so single-host runs never touch
    the distributed service."""
    if not multihost_requested():
        return False
    kwargs = {}
    if os.environ.get("JAX_COORDINATOR_ADDRESS"):
        kwargs["coordinator_address"] = os.environ[
            "JAX_COORDINATOR_ADDRESS"]
    if os.environ.get("JAX_NUM_PROCESSES"):
        kwargs["num_processes"] = int(os.environ["JAX_NUM_PROCESSES"])
    if os.environ.get("JAX_PROCESS_ID"):
        kwargs["process_id"] = int(os.environ["JAX_PROCESS_ID"])
    jax.distributed.initialize(**kwargs)
    return True


def process_index():
    return jax.process_index()


def is_coordinator():
    """Rank-0 gate for merge/stitch/summary outputs - the reference's
    rank-0 coordinator role (``nemo/startUp.py:389-404``)."""
    return jax.process_index() == 0


def local_tile_slice(names, mesh):
    """The subset of a tile chunk THIS process must stage: tiles whose
    mesh position lands on one of this process's addressable devices.
    Single-process (the production single-host path): everything."""
    devs = list(mesh.devices.flat)
    local = {d.id for d in jax.local_devices()}
    n = len(devs)
    out = []
    for i, name in enumerate(names):
        if devs[i % n].id in local:
            out.append(name)
    return out
