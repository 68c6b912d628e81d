"""Declarative in-situ coupling sessions — port of ``src/repro/insitu``
(the serving plane; producer/trainer/inference components are the
training slice, ``ROADMAP.md`` A2)."""

from .components import (InferenceConsumer, Producer, ServingClients,
                         ServingClientsOutput, ServingConsumer,
                         ServingOutput, TrainerConsumer)
from .plan import ComponentPlan, Plan, serving_tier
from .session import InSituSession, SessionResult

__all__ = [
    "InSituSession", "SessionResult", "Producer", "TrainerConsumer",
    "InferenceConsumer", "ServingClients", "ServingConsumer",
    "ServingClientsOutput", "ServingOutput", "Plan", "ComponentPlan",
    "serving_tier",
]
