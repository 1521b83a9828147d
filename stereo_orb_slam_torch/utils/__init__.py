from stereo_orb_slam_torch.utils import evaluate, logging

__all__ = ["evaluate", "logging"]
