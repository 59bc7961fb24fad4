"""Parallel execution layers: chain parallelism (parallel/chains.py), PT
replica and ChEES chain sharding (inference/tempering.py, inference/chees.py)
and within-posterior time-grid sharding (parallel/grid.py), over the ranks
of a torch.distributed process group (parallel/mesh.py)."""

from .chains import make_chain_mesh, run_chains
from .grid import make_grid_mesh, make_grid_sharded_data, make_grid_value_and_grad
from .mesh import CHAIN_AXIS, GRID_AXIS, Mesh

__all__ = [
    "CHAIN_AXIS",
    "GRID_AXIS",
    "Mesh",
    "make_chain_mesh",
    "make_grid_mesh",
    "make_grid_sharded_data",
    "make_grid_value_and_grad",
    "run_chains",
]
