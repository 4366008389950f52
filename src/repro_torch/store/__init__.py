"""Flash-store tooling of the port. Only the bundle extraction the offload
runtime needs is ported so far; the NeuronPack format, file-backed store,
fault injection and the offline packer come in a later slice."""
