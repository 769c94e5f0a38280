"""bundler_sfm_tpu_torch — the PyTorch/CUDA port of bundler_sfm_tpu.

Same module paths and function names as the JAX package, written as plain
PyTorch functions on tensors with an explicit `device`.  The descriptor
matcher's fused 2-NN runs on a hand-written Hopper kernel
(`csrc/two_nn.cu`); everything else is PyTorch.

TF32 is switched off for matrix products and for cuDNN convolutions: the
JAX package asks for exact f32 matmuls in its estimators
(`ops/ransac.py::exact_matmuls`), and cuDNN's TF32 default would round the
SIFT pyramid's convolutions to ~3 decimal digits.
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
