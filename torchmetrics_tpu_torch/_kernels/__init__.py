"""Hand-written Hopper kernels of the model-based metrics' trunks, with their plain versions.

- :func:`conv_bias_act`: ``relu(conv + bias)`` for the BN-folded InceptionV3
  (kernel B2a for pointwise convs, B2b after the library's spatial convs);
- :func:`lpips_head`: one LPIPS ``lin`` head (kernel B3);
- :func:`attention`: BERT's masked self-attention core (kernel B4);
- :func:`layernorm_residual`: ``LayerNorm(x + h)`` after each BERT block (kernel B5);
- :func:`biquad_bank`: SRMR's IIR filterbanks (kernel S1, which replaces a
  ``lax.scan`` of the JAX package, not a Pallas kernel).

CPU tensors take the plain PyTorch versions; CUDA tensors launch the kernels,
built at first use from ``torchmetrics_tpu_torch/csrc/``. There is no switch
between the two and no fallback.
"""

from torchmetrics_tpu_torch._kernels.attention import (
    attention,
    attention_cost,
    layernorm_residual,
    layernorm_residual_cost,
)
from torchmetrics_tpu_torch._kernels.biquad import biquad_bank, biquad_bank_cost
from torchmetrics_tpu_torch._kernels.conv_epilogue import (
    KernelCost,
    bias_relu_cost,
    conv_bias_act,
    conv_bias_act_cost,
)
from torchmetrics_tpu_torch._kernels.lpips_head import lpips_head, lpips_head_cost

__all__ = [
    "KernelCost",
    "attention",
    "attention_cost",
    "bias_relu_cost",
    "biquad_bank",
    "biquad_bank_cost",
    "conv_bias_act",
    "conv_bias_act_cost",
    "layernorm_residual",
    "layernorm_residual_cost",
    "lpips_head",
    "lpips_head_cost",
]
