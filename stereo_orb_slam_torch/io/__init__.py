from stereo_orb_slam_torch.io import calib, datasets, export

__all__ = ["calib", "datasets", "export"]
