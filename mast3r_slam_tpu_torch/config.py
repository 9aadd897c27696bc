"""Engine configs with ``inherit`` chains and recursive merge.

Port of ``mast3r_slam_tpu/config.py``.  The six packaged configs are kept
here as Python dicts, so loading them needs no YAML parser (the GPU machine
has none).  They hold the same keys and values as the JAX package's
``configs/*.yaml``; ``tests/test_torch_rules.py`` holds them equal.  The
comments on each knob live in those YAML files.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

CONFIGS: Dict[str, Dict[str, Any]] = {
    "base": {
        "use_calib": False,
        "single_thread": False,
        "dataset": {
            "subsample": 1,
            "img_downsample": 1,
            "center_principle_point": True,
        },
        "matching": {
            "max_iter": 10,
            "lambda_init": 1e-08,
            "convergence_thresh": 1e-06,
            "dist_thresh": 0.1,
            "radius": 3,
            "dilation_max": 5,
            "refine_gate": "none",
            "refine_budget_frac": 0.125,
            "proj_gate": "none",
            "proj_init": "warm",
            "proj_pre_iters": 2,
            "proj_budget_frac": 0.125,
        },
        "tracking": {
            "min_match_frac": 0.05,
            "max_iters": 50,
            "C_conf": 0.0,
            "Q_conf": 1.5,
            "rel_error": 0.001,
            "delta_norm": 0.001,
            "huber": 1.345,
            "match_frac_thresh": 0.333,
            "sigma_ray": 0.003,
            "sigma_dist": 10.0,
            "sigma_pixel": 1.0,
            "sigma_depth": 10.0,
            "sigma_point": 0.05,
            "pixel_border": -10,
            "depth_eps": 1e-06,
            "filtering_mode": "weighted_pointmap",
            "filtering_score": "median",
        },
        "local_opt": {
            "pin": 1,
            "window_size": 1000000.0,
            "C_conf": 0.0,
            "Q_conf": 1.5,
            "min_match_frac": 0.1,
            "pixel_border": -10,
            "depth_eps": 1e-06,
            "max_iters": 10,
            "sigma_ray": 0.003,
            "sigma_dist": 10.0,
            "sigma_pixel": 1.0,
            "sigma_depth": 10.0,
            "sigma_point": 0.05,
            "delta_norm": 1e-08,
            "solver": "auto",
            "dense_max_poses": 1024,
            "pcg_iters": 96,
            "pcg_tol": 1e-07,
            "pcg_damping": 0.0001,
            "pcg_precond": "block",
            "hg_impl": "auto",
            "gather_cache": True,
            "gather_cache_max_edges": 256,
            "edge_bucket_floor": 16,
            "pose_bucket_floor": 16,
            "reuse_tracker_match": False,
            "oneway_nonconsec": False,
            "pixel_stride": 1,
            "speculative_gate": False,
        },
        "retrieval": {"k": 3, "min_thresh": 0.005},
        "reloc": {"min_match_frac": 0.3, "strict": True},
        "engine": {
            "keyframe_buffer": 512,
            "device_keyframes": 0,
            "edge_buffer": 1024,
            "dtype": "bfloat16",
            "head_dtype": "float32",
            "attn_impl": "xla",
            "ln_stats": "twopass",
            "mesh": 0,
            "pipeline": 0,
            "viz_point_stride": 0,
        },
    },
    "calib": {
        "inherit": "base",
        "use_calib": True,
        "dataset": {"subsample": 2},
    },
    "eth3d": {
        "inherit": "eval_calib",
        "dataset": {"subsample": 1, "center_principle_point": False},
        "reloc": {"strict": False},
    },
    "eval_calib": {
        "inherit": "base",
        "use_calib": True,
        "single_thread": True,
        "dataset": {"subsample": 2},
    },
    "eval_no_calib": {
        "inherit": "base",
        "use_calib": False,
        "single_thread": True,
        "dataset": {"subsample": 2},
    },
    "speed": {
        "inherit": "base",
        "matching": {
            "refine_gate": "converged",
            "refine_subset_dilations": [5, 2],
            "refine_final_radius": 1,
            "proj_gate": "converged",
            "proj_init": "best",
            "proj_pre_iters": 0,
            "proj_budget_frac": 0.0625,
            "refine_budget_frac": 0.0625,
        },
        "local_opt": {
            "oneway_nonconsec": True,
            "reuse_tracker_match": True,
            "speculative_gate": True,
        },
        "engine": {"pipeline": 1, "head_dtype": "bfloat16"},
    },
}


def merge_config(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively merge ``override`` into a copy of ``base``."""
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_config(out[k], v)
        else:
            out[k] = v
    return out


def load_config(name: str = "base") -> Dict[str, Any]:
    """One of the packaged configs by name (``"base"`` or ``"base.yaml"``),
    with its ``inherit`` chain resolved.  Returns a fresh deep copy."""
    key = name[:-5] if name.endswith(".yaml") else name
    if key not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; have {sorted(CONFIGS)}")
    cfg = copy.deepcopy(CONFIGS[key])
    parent = cfg.pop("inherit", None)
    if parent is not None:
        cfg = merge_config(load_config(parent), cfg)
    return cfg
