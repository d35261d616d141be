"""Dynamic fault injection: declarative link down/up schedules that compile
to epoch-indexed ``LinkState`` stacks both engines consume as time-varying
operands (see :mod:`repro_torch.faults.schedule`)."""
from .schedule import NEVER, CompiledFaults, FaultSchedule, LinkEvent

__all__ = ["NEVER", "CompiledFaults", "FaultSchedule", "LinkEvent"]
