"""Data parallelism over processes (counterpart of ``vgqa_tpu/parallel``)."""

from .distributed import (  # noqa: F401
    all_gather_objects,
    get_rank,
    get_world_size,
    initialize_multihost,
    is_main_process,
    synchronize,
)
from .mesh import Mesh, build_mesh  # noqa: F401
