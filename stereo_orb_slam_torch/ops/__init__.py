from stereo_orb_slam_torch.ops import detect, match, orb

__all__ = ["detect", "match", "orb"]
