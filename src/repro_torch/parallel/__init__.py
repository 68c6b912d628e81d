"""Parameter specs on one device — port of the single-device part of
``src/repro/parallel`` (meshes, pipelines and compression are
``ROADMAP.md`` A5)."""

from . import sharding
from .sharding import ParamSpec, init_params, lm_params_from_numpy

__all__ = ["sharding", "ParamSpec", "init_params", "lm_params_from_numpy"]
