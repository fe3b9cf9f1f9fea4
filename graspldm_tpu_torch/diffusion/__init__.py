from .gaussian import GaussianDiffusion1D
from .schedules import DiffusionSchedule

__all__ = ["DiffusionSchedule", "GaussianDiffusion1D"]
