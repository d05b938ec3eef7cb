"""Image metrics ported so far: FID (InceptionV3 trunk) and LPIPS."""

from torchmetrics_tpu_torch.image.fid import FrechetInceptionDistance
from torchmetrics_tpu_torch.image.lpip import LearnedPerceptualImagePatchSimilarity

__all__ = ["FrechetInceptionDistance", "LearnedPerceptualImagePatchSimilarity"]
