"""PyTorch/CUDA port of the RIPPLE / Neuralink flash-offloaded inference
system, for an NVIDIA Hopper card.

A second package beside the JAX reference (`repro`), with the same module
names so each counterpart is easy to find. It imports torch, numpy and the
standard library only — never jax, never `repro`. Entry points run on the
GPU unless the caller passes device="cpu".

It serves decoder-only models end to end through
`serving.server.InferenceServer` (dense models in resident and offload
modes, from an in-memory store or a NeuronPack file (`store/`), with the
offline stage that builds the pack (`store.packer.build_pack`,
`launch/pack.py`); MoE, SSM and hybrid models resident). The
encoder-decoder and VLM models run through `models.Model`'s entry points,
and every family trains (`training/`, `data/`, `launch/train.py`). The
hand-written Hopper kernels are in `kernels/csrc/`: the fused and unfused
segment FFNs, paged and sliding-window decode attention and the
co-activation counts.
"""
