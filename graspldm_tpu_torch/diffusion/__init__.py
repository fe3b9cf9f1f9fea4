from .elucidated import ElucidatedDiffusion
from .gaussian import GaussianDiffusion1D
from .schedules import DiffusionSchedule

__all__ = ["DiffusionSchedule", "ElucidatedDiffusion", "GaussianDiffusion1D"]
