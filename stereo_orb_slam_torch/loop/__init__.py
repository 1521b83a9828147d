"""BoW place recognition and the Bayesian loop filter."""

from stereo_orb_slam_torch.loop.detector import LoopDetector
from stereo_orb_slam_torch.loop.vocab import OrbVocabulary

__all__ = ["LoopDetector", "OrbVocabulary"]
