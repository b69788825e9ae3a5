"""The parallel layout of a run (counterpart of ``vgqa_tpu/parallel/mesh.py``).

The JAX package runs one program over a (dp, sp, tp) device mesh. The port
has its data axis only: ``dp`` processes, one card each, every one holding
the whole model and its slice of each global batch, joined by
``torch.distributed`` (``parallel/distributed.py``). Sequence (frame) and
tensor parallelism, and with them the JAX module's ``param_shardings``,
``batch_sharding``, ``sp_batch_shardings`` and ``replicated``, wait for
ROADMAP Queue 1 item 9; until then ``build_mesh`` refuses ``sp`` or ``tp``
above 1 rather than run the model unsharded.
"""

from __future__ import annotations

from dataclasses import dataclass

from .distributed import get_world_size


@dataclass(frozen=True)
class Mesh:
    dp: int
    sp: int = 1
    tp: int = 1


def build_mesh(dp: int = 0, tp: int = 1, sp: int = 1) -> Mesh:
    """The layout of ``TPU.MESH_DP`` / ``MESH_TP`` / ``MESH_SP``: ``dp = 0``
    means every process of the group (one without a group); any other
    ``dp`` must equal that number."""
    if tp > 1 or sp > 1:
        raise NotImplementedError(
            f"TPU.MESH_TP {tp} / TPU.MESH_SP {sp}: the port has data parallelism only; "
            "tensor and sequence parallelism wait for ROADMAP Queue 1 item 9")
    world = get_world_size()
    if dp <= 0:
        dp = world
    if dp != world:
        raise ValueError(f"TPU.MESH_DP {dp} needs {dp} processes, one per card; this run "
                         f"has {world}")
    return Mesh(dp=dp, sp=sp, tp=tp)
