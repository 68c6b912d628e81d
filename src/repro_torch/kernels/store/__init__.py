"""TensorStore access kernels (probe / sample / gather) — port of
``src/repro/kernels/store``.

``csrc/store.cu`` holds the Hopper kernels, ``ref.py`` their plain PyTorch
versions, ``ops.py`` the device-dispatching wrappers.
"""

from .ops import gather_rows, gather_rows_sharded, probe_slots, sample_slots
from .ref import gather_rows_ref, probe_slots_ref, sample_slots_ref

__all__ = ["probe_slots", "gather_rows", "sample_slots",
           "gather_rows_sharded", "probe_slots_ref", "sample_slots_ref",
           "gather_rows_ref"]
