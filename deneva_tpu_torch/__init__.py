"""deneva_tpu_torch: the PyTorch / CUDA port of deneva_tpu.

The batched scheduler tick of the JAX package (deneva_tpu/), rebuilt in
PyTorch for an NVIDIA H100, with the package's TPU kernel rewritten by
hand for Hopper (csrc/).  It imports torch, numpy and the standard
library only, never jax or deneva_tpu.
"""
