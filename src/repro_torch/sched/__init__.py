"""The early-release schedule of a training step (the port of
``repro.sched``)."""
from .suprema import StepAccessPlan, release_points, step_suprema

__all__ = ["StepAccessPlan", "release_points", "step_suprema"]
