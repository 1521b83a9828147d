from stereo_orb_slam_torch.backend import ba, residuals, schur_dense

__all__ = ["ba", "residuals", "schur_dense"]
