"""PyTorch/CUDA port of the paged-attention decoder inference framework.

The JAX/Pallas package
``pagedattention_based_transformer_decoder_inference_framework_tpu`` is
the reference; this package computes the same functions with PyTorch
tensors and hand-written CUDA kernels for Hopper (``csrc/``). It imports
``torch`` and never ``jax``, and nothing of the JAX package.

Entry points (``engine.Engine``, ``cli.cli_app``) run on ``cuda`` unless
the caller passes ``device="cpu"``; with no CUDA device and no explicit
device they raise. On CPU tensors every kernel wrapper runs its plain
PyTorch version; on CUDA tensors it launches the kernel or raises.
"""

__version__ = "0.1.0"
