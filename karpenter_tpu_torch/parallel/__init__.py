"""Mesh sharding for the solver (data = node slots, model = config catalog)."""

from karpenter_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    assemble_feasibility,
    make_mesh,
    mesh_pack_fn,
    sharded_solve_step,
)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "Mesh", "assemble_feasibility", "make_mesh",
    "mesh_pack_fn", "sharded_solve_step",
]
