"""Core in-situ coupling layer — port of ``src/repro/core``: the store,
server, client, driver, telemetry and fault taxonomy, and the deployments
(``deployment``: co-located, clustered and the 2-D clustered db grid,
``make_clustered_2d``), with the reference's names."""

from . import store
from .client import Client
from .deployment import (Clustered, Colocated, Deployment,
                         make_clustered_1d, make_clustered_2d,
                         make_colocated_1d, split_devices)
from .faults import (FaultEvent, FaultPlan, InjectedCrash, RetryPolicy,
                     StoreError, StoreTimeout, StoreUnavailable,
                     TransferDropped, WatermarkTimeout)
from .orchestrator import InSituDriver, RunResult, StragglerPolicy
from .server import StoreServer
from .store import TableSpec, TableState, make_key, name_key
from .telemetry import Timers

__all__ = [
    "store", "Client", "Clustered", "Colocated", "Deployment",
    "make_clustered_1d", "make_clustered_2d", "make_colocated_1d",
    "split_devices", "FaultEvent", "FaultPlan", "InjectedCrash",
    "RetryPolicy", "StoreError", "StoreTimeout", "StoreUnavailable",
    "TransferDropped", "WatermarkTimeout", "InSituDriver", "RunResult",
    "StragglerPolicy", "StoreServer", "TableSpec", "TableState", "make_key",
    "name_key", "Timers",
]
