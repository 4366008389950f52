"""PyTorch/CUDA port of the RIPPLE / Neuralink flash-offloaded inference
system, for an NVIDIA Hopper card.

A second package beside the JAX reference (`repro`), with the same module
names so each counterpart is easy to find. It imports torch, numpy and the
standard library only — never jax, never `repro`. Entry points run on the
GPU unless the caller passes device="cpu".

This slice serves decoder-only dense models end to end through
`serving.server.InferenceServer` in resident and offload modes; the offload
FFN runs through the hand-written Hopper kernel in
`kernels/csrc/sparse_ffn_fused.cu`.
"""
