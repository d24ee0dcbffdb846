"""Data parallelism over ``torch.distributed`` (counterpart of
facl_tpu/parallel): the mesh, its collectives, process-group set-up and a
launcher for tests and measurement scripts."""
from facl_tpu_torch.parallel.mesh import (Mesh, batch_slice, distributed,
                                          make_mesh, shard_train_state)
from facl_tpu_torch.parallel.collectives import (
    COLLECTIVES, all_gather, barrier, broadcast, cross_replica_mean, gather_negatives,
    global_moments, psum, psum_grads, psum_packed)
from facl_tpu_torch.parallel.distributed import (finalize, initialize,
                                                 rank_device)
from facl_tpu_torch.parallel.launch import spawn

__all__ = ["Mesh", "batch_slice", "distributed", "make_mesh",
           "shard_train_state", "COLLECTIVES", "all_gather", "barrier",
           "broadcast",
           "cross_replica_mean", "gather_negatives", "global_moments",
           "psum", "psum_grads", "psum_packed", "finalize", "initialize",
           "rank_device", "spawn"]
