"""Collective schedule planning (see ``collectives.planner``)."""
from .planner import FabricModel, Plan, plan_all_reduce, plan_all_to_all

__all__ = ["FabricModel", "Plan", "plan_all_reduce", "plan_all_to_all"]
