"""Data and tensor parallelism over ``torch.distributed`` (counterpart of
facl_tpu/parallel): the ``dp x mp`` mesh, its collectives, process-group
set-up and a launcher for tests and measurement scripts."""
from facl_tpu_torch.parallel.mesh import (Mesh, batch_slice, distributed,
                                          joined, make_mesh, mp_sharded,
                                          shard_train_state,
                                          tensor_parallel)
from facl_tpu_torch.parallel.collectives import (
    COLLECTIVES, MP_COLLECTIVES, all_gather, barrier, broadcast,
    cross_replica_mean, gather_negatives, global_gram, global_moments,
    mp_enter, mp_full, mp_gather_cols, psum, psum_grads, psum_packed)
from facl_tpu_torch.parallel.distributed import (finalize, initialize,
                                                 rank_device)
from facl_tpu_torch.parallel.launch import spawn

__all__ = ["Mesh", "batch_slice", "distributed", "joined", "make_mesh",
           "mp_sharded", "shard_train_state", "tensor_parallel",
           "COLLECTIVES", "MP_COLLECTIVES", "all_gather", "barrier",
           "broadcast", "cross_replica_mean", "gather_negatives",
           "global_gram", "global_moments", "mp_enter", "mp_full",
           "mp_gather_cols", "psum", "psum_grads", "psum_packed",
           "finalize", "initialize", "rank_device", "spawn"]
