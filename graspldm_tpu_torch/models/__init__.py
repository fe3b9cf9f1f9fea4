from .grasp_ldm import GraspLatentDDM
from .grasp_vae import GraspCVAE
from .pvcnn import PVCNNEncoder
from .resnet1d import ResNet1D, TimeConditionedResNet1D

__all__ = [
    "GraspCVAE",
    "GraspLatentDDM",
    "PVCNNEncoder",
    "ResNet1D",
    "TimeConditionedResNet1D",
]
