"""Collective-phase training schedules (see ``phases.schedule``)."""
from .schedule import (CompiledPhases, Phase, PhaseSchedule,
                       phases_from_dict)

__all__ = ["CompiledPhases", "Phase", "PhaseSchedule", "phases_from_dict"]
