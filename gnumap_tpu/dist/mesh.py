"""Device mesh for the mapper: axes ("reads", "index").

Device-mesh equivalent of the reference's two MPI decompositions (SURVEY.md
§2 parallelism table, §3.5):

  * axis "reads"  — data parallelism: read batches sharded across devices /
    hosts (the reference's read-partitioned MPI mode + pthreads).
  * axis "index"  — model parallelism: the CSR k-mer index sharded by k-mer
    range (the reference's genome-partitioned MPI mode for RAM-bound
    genomes, BASELINE.json config 5).

Multi-host: call jax.distributed.initialize() before make_mesh(); the same
code then runs with DCN between hosts and ICI within a slice — collectives
are compiler-emitted (no NCCL/MPI).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np

READS_AXIS = "reads"
INDEX_AXIS = "index"


def make_mesh(read_shards: Optional[int] = None, index_shards: int = 1,
              devices=None) -> jax.sharding.Mesh:
    devices = list(devices) if devices is not None else jax.devices()
    n = len(devices)
    if read_shards is None:
        if n % index_shards:
            raise ValueError(f"{n} devices not divisible by "
                             f"index_shards={index_shards}")
        read_shards = n // index_shards
    need = read_shards * index_shards
    if need > n:
        raise ValueError(f"need {need} devices, have {n}")
    dev = np.asarray(devices[:need]).reshape(read_shards, index_shards)
    return jax.sharding.Mesh(dev, (READS_AXIS, INDEX_AXIS))


def reads_sharding(mesh: jax.sharding.Mesh, *, batch_axis: int = 0,
                   ndim: int = 2) -> jax.sharding.NamedSharding:
    """Shard the batch axis over "reads"; everything else replicated."""
    spec = [None] * ndim
    spec[batch_axis] = READS_AXIS
    return jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(*spec))


def replicated(mesh: jax.sharding.Mesh) -> jax.sharding.NamedSharding:
    return jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
