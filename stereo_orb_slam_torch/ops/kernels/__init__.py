"""Hand-written CUDA kernels for Hopper and their Python wrappers.

Each wrapper module beside this file holds the kernel's launch through
`ctypes`, the plain PyTorch version of the same function (taken for CPU
tensors; the detector's stays in `ops/detect.py`) and a launch counter per
kernel (`LAUNCHES`; `describe` also has `ORIENTED_LAUNCHES`). The kernels
are built from `stereo_orb_slam_torch/csrc` by `_build` at first use.
"""
