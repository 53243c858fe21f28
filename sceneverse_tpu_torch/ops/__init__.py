"""Point-cloud ops in plain PyTorch (the kernels' wrappers live in the
modules beside them): what ``sceneverse_tpu/ops/__init__.py`` exports."""

from sceneverse_tpu_torch.ops.geometry import (calc_pairwise_locs,
                                               calc_pairwise_locs_mv)
from sceneverse_tpu_torch.ops.pointops import (ball_query,
                                               furthest_point_sample,
                                               gather_points, group_points,
                                               three_interpolate, three_nn)

__all__ = [
    "furthest_point_sample",
    "gather_points",
    "group_points",
    "ball_query",
    "three_nn",
    "three_interpolate",
    "calc_pairwise_locs",
    "calc_pairwise_locs_mv",
]
