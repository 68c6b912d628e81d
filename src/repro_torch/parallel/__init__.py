"""Meshes, collectives, gradient compression and parameter specs — port
of ``src/repro/parallel`` (single-controller: a mesh is a grid of
devices; pipelines are ``ROADMAP.md`` A, item 4)."""

from . import collectives, compress, sharding
from .sharding import (ElemSharding, ElemShards, GridSharding, Mesh,
                       ParamSpec, SlabSharding, data_mesh,
                       disjoint_data_meshes, init_params,
                       lm_params_from_numpy, slab_sharding, space_mesh)

__all__ = ["collectives", "compress", "sharding", "Mesh", "SlabSharding",
           "ElemSharding", "GridSharding", "ElemShards", "data_mesh",
           "space_mesh", "disjoint_data_meshes", "slab_sharding",
           "ParamSpec", "init_params", "lm_params_from_numpy"]
