"""Multi-rank sampling and training on ``torch.distributed``: data
parallelism over the batch, sequence parallelism over the query rows of the
pair stack, and tensor parallelism over attention heads and FFN hidden units.

Counterpart of ``se3diff_tpu/parallel/`` for its sampling paths and its
``data x model`` training mesh. Each rank is a process with one device;
:func:`~.launch.run_ranks` spawns them.
"""

from se3diff_torch.parallel.launch import run_ranks
from se3diff_torch.parallel.mesh import (
    MeshContext,
    RankContext,
    copy_in,
    gather_rows,
    good_batch_size,
    init_group,
    init_mesh,
    largest_pow2_leq,
    pick_model_parallel,
    reduce_out,
    round_up_batch,
    row_slabs,
)

__all__ = [
    "MeshContext",
    "RankContext",
    "copy_in",
    "gather_rows",
    "good_batch_size",
    "init_group",
    "init_mesh",
    "largest_pow2_leq",
    "pick_model_parallel",
    "reduce_out",
    "round_up_batch",
    "row_slabs",
    "run_ranks",
]
