"""Declarative in-situ coupling sessions — port of ``src/repro/insitu``
on one device: the producer, trainer and inference components of the
paper's workflow and the serving plane, their plan and the session."""

from .components import (InferenceConsumer, InferenceOutput, Producer,
                         ProducerOutput, ServingClients,
                         ServingClientsOutput, ServingConsumer,
                         ServingOutput, TrainerConsumer, TrainerOutput)
from .plan import (ComponentPlan, Plan, inference_tier, producer_tier,
                   serving_tier, trainer_tier)
from .session import InSituSession, SessionResult

__all__ = [
    "InSituSession", "SessionResult", "Producer", "TrainerConsumer",
    "InferenceConsumer", "ServingClients", "ServingConsumer",
    "ProducerOutput", "TrainerOutput", "InferenceOutput",
    "ServingClientsOutput", "ServingOutput", "Plan", "ComponentPlan",
    "producer_tier", "trainer_tier", "inference_tier", "serving_tier",
]
