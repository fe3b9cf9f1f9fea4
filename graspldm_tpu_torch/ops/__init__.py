from .voxel import avg_voxelize, normalize_coords_for_voxelization, trilinear_devoxelize

__all__ = ["avg_voxelize", "normalize_coords_for_voxelization", "trilinear_devoxelize"]
