"""L0/L5: device mesh, sharding policy, Monte-Carlo campaign driver.

SURVEY.md §2 #24-25: the reference is single-process; scale-out here is
jax.distributed + Mesh + NamedSharding + jit (GSPMD inserts all
collectives, which XLA lowers to NCCL on GPUs; no MPI layer is needed).
"""

from .mesh import ShardingPolicy, make_mesh  # noqa: F401
from .campaign import run_campaign  # noqa: F401
