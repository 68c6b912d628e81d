"""Meshes, collectives and parameter specs — port of
``src/repro/parallel`` (single-controller: a mesh is a list of devices;
pipelines and compression are ``ROADMAP.md`` A5)."""

from . import collectives, sharding
from .sharding import (ElemSharding, ElemShards, Mesh, ParamSpec,
                       SlabSharding, data_mesh, init_params,
                       lm_params_from_numpy, slab_sharding, space_mesh)

__all__ = ["collectives", "sharding", "Mesh", "SlabSharding",
           "ElemSharding", "ElemShards", "data_mesh", "space_mesh",
           "slab_sharding", "ParamSpec", "init_params",
           "lm_params_from_numpy"]
