from .conditioning import ClassConditionedGraspLatentDDM, RegionConditionedGraspLatentDDM
from .grasp_ldm import GraspLatentDDM
from .grasp_vae import GraspCVAE
from .pvcnn import PVCNNEncoder
from .pvcnn2 import PVCNN2, PointNet2, PointNet2MSG, PointNet2SSG, PVCNN2Encoder
from .resnet1d import ResNet1D, TimeConditionedResNet1D

__all__ = [
    "ClassConditionedGraspLatentDDM",
    "GraspCVAE",
    "GraspLatentDDM",
    "PVCNNEncoder",
    "PVCNN2",
    "PVCNN2Encoder",
    "PointNet2",
    "PointNet2MSG",
    "PointNet2SSG",
    "RegionConditionedGraspLatentDDM",
    "ResNet1D",
    "TimeConditionedResNet1D",
]
