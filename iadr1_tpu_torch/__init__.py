"""PyTorch/CUDA port of iadr1_tpu for NVIDIA Hopper (H100).

The JAX package ``iadr1_tpu`` stays the reference; this package imports
nothing from it (nor JAX).  Attention runs through hand-written CUDA
kernels on ``cuda`` tensors (``kernels/``) and through their plain PyTorch
twins on CPU tensors.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""
