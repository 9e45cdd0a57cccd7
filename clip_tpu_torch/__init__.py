"""clip_tpu_torch: the PyTorch and CUDA port of clip_tpu for NVIDIA Hopper.

The JAX package ``clip_tpu`` stays the reference.  This package loads the same
GGUF checkpoints, tokenizes, preprocesses, encodes both towers and labels
zero-shot, with the TPU's Pallas kernels replaced by CUDA kernels written by
hand for ``sm_90a`` (``csrc/``), built with one ``nvcc`` call at first use.
It imports ``torch`` and numpy, never ``jax``, and nothing of ``clip_tpu``.
"""

__version__ = "0.1.0"

from .engine import ClipEngine, similarity_score, softmax_with_sorting

__all__ = ["ClipEngine", "similarity_score", "softmax_with_sorting", "__version__"]
