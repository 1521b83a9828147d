from stereo_orb_slam_torch.worldmap.world import WorldMap

__all__ = ["WorldMap"]
