"""PyTorch/CUDA port of labelanything_tpu for NVIDIA Hopper GPUs.

Mirrors the JAX package's module paths (``ops/``, ``models/``, ``api.py``)
and the original PyTorch LabelAnything's module and parameter names. The
decomposed rel-pos attention of the SAM ViT encoder runs in hand-written
CUDA kernels (``csrc/``), built by ``nvcc`` at first use.
"""
