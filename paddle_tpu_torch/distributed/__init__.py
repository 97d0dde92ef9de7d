"""paddle_tpu_torch.distributed — the part of ``paddle_tpu.distributed``
that context-parallel training needs, over ``torch.distributed``.

The bootstrap (:func:`init_parallel_env`, :func:`spawn`), the named mesh
of ranks (:class:`ProcessMesh`, :func:`set_mesh`), :func:`shard_layer`,
the collectives of the ring and of the MoE dispatch (:func:`ppermute`,
:func:`all_gather`, :func:`barrier`, :func:`all_to_all`,
:func:`ragged_all_to_all`) and the ring itself (:func:`ring_attention`,
the zig-zag layout over the segment-causal flash kernels). Ulysses,
placements and resharding, data parallel, sharding and the pipeline are
ROADMAP.md A.10 and raise or are absent.
"""

from paddle_tpu_torch.distributed.api import shard_layer  # noqa: F401
from paddle_tpu_torch.distributed.collective import (  # noqa: F401
    all_gather, all_to_all, barrier, ppermute, ragged_all_to_all,
)
from paddle_tpu_torch.distributed.env import (  # noqa: F401
    ParallelEnv, get_rank, get_world_size, init_parallel_env, is_initialized,
)
from paddle_tpu_torch.distributed.process_mesh import (  # noqa: F401
    ProcessMesh, get_mesh, set_mesh,
)
from paddle_tpu_torch.distributed.sequence_parallel import (  # noqa: F401
    ring_attention, ring_attention_flops, sequence_gather, sequence_scatter,
    ulysses_attention, zigzag_gather, zigzag_order, zigzag_ring_attention,
    zigzag_scatter,
)
from paddle_tpu_torch.distributed.spawn import spawn  # noqa: F401
