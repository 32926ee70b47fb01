"""PyTorch + CUDA port of stgcma_tpu for NVIDIA Hopper (H100).

The JAX package `stgcma_tpu` stays the reference; this package imports
neither it nor JAX. Entry points run on the card ("cuda") unless the caller
asks for the CPU, where the kernels' plain PyTorch versions run.
"""
