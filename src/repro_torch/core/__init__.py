"""Core in-situ coupling layer — port of ``src/repro/core`` (the serving
slice: local store, server, client, driver, telemetry, fault taxonomy)."""

from . import store
from .client import Client
from .faults import (FaultEvent, FaultPlan, InjectedCrash, RetryPolicy,
                     StoreError, StoreTimeout, StoreUnavailable,
                     TransferDropped, WatermarkTimeout)
from .orchestrator import InSituDriver, RunResult, StragglerPolicy
from .server import StoreServer
from .store import TableSpec, TableState, make_key, name_key
from .telemetry import Timers

__all__ = [
    "store", "Client", "FaultEvent", "FaultPlan", "InjectedCrash",
    "RetryPolicy", "StoreError", "StoreTimeout", "StoreUnavailable",
    "TransferDropped", "WatermarkTimeout", "InSituDriver", "RunResult",
    "StragglerPolicy", "StoreServer", "TableSpec", "TableState", "make_key",
    "name_key", "Timers",
]
