"""Multi-rank sampling on ``torch.distributed``: data parallelism over the
batch and sequence parallelism over the query rows of the pair stack.

Counterpart of ``se3diff_tpu/parallel/`` for its sampling paths. Each rank
is a process with one device; :func:`~.launch.run_ranks` spawns them.
"""

from se3diff_torch.parallel.launch import run_ranks
from se3diff_torch.parallel.mesh import (
    RankContext,
    gather_rows,
    good_batch_size,
    init_group,
    largest_pow2_leq,
    pick_model_parallel,
    round_up_batch,
    row_slabs,
)

__all__ = [
    "RankContext",
    "gather_rows",
    "good_batch_size",
    "init_group",
    "largest_pow2_leq",
    "pick_model_parallel",
    "round_up_batch",
    "row_slabs",
    "run_ranks",
]
