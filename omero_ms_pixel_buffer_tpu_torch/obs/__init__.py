"""Observability plane (counterpart of ``omero_ms_pixel_buffer_tpu/obs/``):
the flight recorder, tail sampler, wide-event ring, and SLO SLI layer."""

from .recorder import (
    STAGES,
    FlightRecord,
    FlightRecorder,
    ambient_stage,
    current_record,
    defer_exemplar,
    note_fault,
    record_scope,
    stage_all,
    stage_of,
)
from .sli import SliLayer

__all__ = [
    "STAGES",
    "FlightRecord",
    "FlightRecorder",
    "SliLayer",
    "ambient_stage",
    "current_record",
    "defer_exemplar",
    "note_fault",
    "record_scope",
    "stage_all",
    "stage_of",
]
