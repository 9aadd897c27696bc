"""PyTorch/CUDA port of the MASt3R-SLAM engine for one NVIDIA H100.

The package mirrors ``mast3r_slam_tpu``'s module layout; each module names
its JAX counterpart.  It imports ``torch`` and never ``jax`` or anything of
the JAX package.  Entry points (``MASt3RModel``, ``FrameTracker``, ``SLAM``)
run on the CUDA card unless the caller passes ``device="cpu"``.
"""

from .device import resolve_device  # noqa: F401
