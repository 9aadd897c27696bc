from .projective import (  # noqa: F401
    act_sim3,
    backproject,
    constrain_points_to_ray,
    decompose_K,
    get_pixel_coords,
    point_to_dist,
    point_to_ray_dist,
    project_calib,
    skew,
    tau_jacobian,
)
