from stereo_orb_slam_torch.geometry import camera, se3

__all__ = ["camera", "se3"]
