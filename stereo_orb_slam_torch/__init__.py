"""stereo_orb_slam_torch: the stereo ORB front end and windowed bundle
adjustment in PyTorch, with hand-written CUDA kernels for Hopper.

The PyTorch port of the repository's JAX package, which stays the
reference. It keeps that package's layer map and the layouts of its public
functions ([N,2] xy as (x, y), [N,8] descriptor words, [4,4] transforms with
X_prev = T @ X_curr):

  geometry/ io/ config  SE(3), camera models, loaders, calibration, export
  worldmap/             SoA map state on the host (NumPy)
  ops/ frontend/        detection, ORB, matching, RANSAC odometry
  ops/kernels/ csrc/    the CUDA kernels and their wrappers
  backend/              bundle adjustment (LM, dense/banded Schur, PCG)
  apps/                 the visual_odometry and refine CLIs

Entry points run on the CUDA device unless the caller asks for the CPU.
Nothing here imports JAX or the JAX package.
"""

__version__ = "0.1.0"

from stereo_orb_slam_torch.config import BAConfig, FrontendConfig, RansacConfig

__all__ = ["BAConfig", "FrontendConfig", "RansacConfig"]
