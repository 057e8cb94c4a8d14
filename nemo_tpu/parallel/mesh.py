"""Device mesh construction.

The reference distributes map tiles over MPI ranks with a rank-0
coordinator (``nemo/startUp.py:389-404``).  Here tiles are a batch axis
sharded over a 1-d ``jax.sharding.Mesh``; survey-level reductions
(RMS-table histograms, candidate counts - the reference's MPI gathers at
``pipelines.py:291-331``) become ``psum``/``all_gather`` collectives
inside the compiled step, which XLA hands to NCCL on GPUs.
"""

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec


TILE_AXIS = "tiles"


def get_mesh(n_devices=None, devices=None):
    """1-d mesh over the tile axis.

    Raises if fewer devices exist than requested instead of silently
    truncating - a silently smaller mesh would shard-check fine but run a
    different parallel decomposition than the caller asked for.
    """
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            if len(devices) < n_devices:
                raise RuntimeError(
                    "get_mesh: %d devices requested but only %d available "
                    "on platform %r (for a virtual CPU mesh set "
                    "XLA_FLAGS=--xla_force_host_platform_device_count=N "
                    "and pin jax_platforms to cpu before backend init)"
                    % (n_devices, len(devices), devices[0].platform
                       if devices else "?"))
            devices = devices[:n_devices]
    return Mesh(np.array(devices), (TILE_AXIS,))


def tile_sharding(mesh):
    """Shard the leading (tile) axis, replicate the rest."""
    return NamedSharding(mesh, PartitionSpec(TILE_AXIS))


def replicated(mesh):
    return NamedSharding(mesh, PartitionSpec())
