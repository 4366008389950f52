"""Sharding on a `torch.distributed` device mesh (DTensor): the spec rules,
their placements, the sequence-pipelined mLSTM, and the explicit
redistributions the model needs under sharding."""
