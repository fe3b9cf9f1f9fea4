from .elucidated import ElucidatedDiffusion
from .gaussian import GaussianDiffusion1D
from .guidance import make_success_guidance
from .schedules import DiffusionSchedule

__all__ = ["DiffusionSchedule", "ElucidatedDiffusion", "GaussianDiffusion1D",
           "make_success_guidance"]
