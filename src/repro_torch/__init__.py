"""PyTorch/CUDA port of the RIPPLE / Neuralink flash-offloaded inference
system, for an NVIDIA Hopper card.

A second package beside the JAX reference (`repro`), with the same module
names so each counterpart is easy to find. It imports torch, numpy and the
standard library only — never jax, never `repro`. Entry points run on the
GPU unless the caller passes device="cpu".

It serves decoder-only dense models end to end through
`serving.server.InferenceServer` in resident and offload modes, from an
in-memory store or a NeuronPack file (`store/`), with the offline stage
that builds the pack (`store.packer.build_pack`, `launch/pack.py`). The
hand-written Hopper kernels are in `kernels/csrc/`: the fused segment FFN,
paged decode attention and the co-activation counts.
"""
