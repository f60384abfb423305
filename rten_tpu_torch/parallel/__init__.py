"""Multi-rank execution on ``torch.distributed``: the device mesh and the
decoder's weight sharding (``mesh``), explicit tensor parallelism and
sequence-parallel prefill (``tp``), pipeline parallelism (``pp``), the
overlapped collective matmuls (``overlap``), the multi-host runtime
(``multihost``) and spawning a world of ranks on one host (``launch``).

Counterpart of ``rten_tpu/parallel/``. Where the JAX package shards one
process's arrays over a ``jax.sharding.Mesh``, the port runs one process a
rank (SPMD) and each rank holds its own shard: ``shard_decoder_params``
returns this rank's tree and ``init_cache`` this rank's cache, in place of
the JAX package's ``shard_cache`` and its ``PartitionSpec`` trees
(``decoder_param_specs``, ``cache_specs``), which have no counterpart.
"""

from rten_tpu_torch.parallel.launch import RankResults, World, run_ranks
from rten_tpu_torch.parallel.mesh import Mesh, init_cache, local_config, make_mesh, shard_decoder_params

__all__ = [
    "make_mesh",
    "Mesh",
    "shard_decoder_params",
    "init_cache",
    "local_config",
    "World",
    "run_ranks",
    "RankResults",
]
