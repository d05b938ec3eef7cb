"""Functional image metrics ported so far: LPIPS."""

from torchmetrics_tpu_torch.functional.image.lpips import learned_perceptual_image_patch_similarity

__all__ = ["learned_perceptual_image_patch_similarity"]
