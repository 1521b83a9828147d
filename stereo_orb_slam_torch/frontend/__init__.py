from stereo_orb_slam_torch.frontend import ransac

__all__ = ["ransac"]
