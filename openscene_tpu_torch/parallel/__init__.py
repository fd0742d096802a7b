"""Multi-GPU execution on ``torch.distributed`` (one process per GPU)."""

from .mesh import (Mesh, get_mesh, maybe_initialize_distributed,
                   model_axis_size)

__all__ = ["Mesh", "get_mesh", "maybe_initialize_distributed",
           "model_axis_size"]
