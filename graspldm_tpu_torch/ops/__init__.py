from .neighborhood import ball_query, group_points, pairwise_sq_dists, three_nn_interpolate
from .sampling import furthest_point_sample, gather_points
from .voxel import avg_voxelize, normalize_coords_for_voxelization, trilinear_devoxelize

__all__ = [
    "avg_voxelize",
    "ball_query",
    "furthest_point_sample",
    "gather_points",
    "group_points",
    "normalize_coords_for_voxelization",
    "pairwise_sq_dists",
    "three_nn_interpolate",
    "trilinear_devoxelize",
]
