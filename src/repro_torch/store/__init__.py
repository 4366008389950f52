"""On-disk NeuronPack artifact + file-backed flash store, in the port.

Offline, `build_pack` runs the paper's whole offline stage (trace on the
device -> co-activation counts through the coact kernel -> linked
placement on the host) and serializes the result as a NeuronPack: per-layer
neuron bundles written in PHYSICAL placement order, so byte offsets in the
file ARE flash positions. Online, `FileNeuronStore` serves the `NeuronStore`
contract from that file with one real positional read per collapsed extent.

The format, the store and the fault injection are copies of the reference
package's (`format`, `file_store`, `faults`): each package reads the packs
and trace shards the other writes, and `write_pack` from identical inputs
writes identical bytes.
"""
from repro_torch.store.faults import (CorruptExtentError, FatalFault,
                                      FaultEvent, FaultInjectingStore,
                                      FaultPlan, RetryPolicy,
                                      TransientIOError, seeded_layer_plans)
from repro_torch.store.file_store import FileNeuronStore, open_layer_stores
from repro_torch.store.format import (MAGIC, READABLE_VERSIONS, VERSION,
                                      NeuronPack, PackFormatError,
                                      dequantize_int8, quantize_int8,
                                      write_pack)
from repro_torch.store.packer import (PackBuildReport, build_pack,
                                      extract_dense_ffn_bundles,
                                      trace_to_shards)

__all__ = [
    "MAGIC", "VERSION", "READABLE_VERSIONS", "NeuronPack", "PackFormatError",
    "FileNeuronStore", "open_layer_stores",
    "write_pack", "quantize_int8", "dequantize_int8",
    "PackBuildReport", "build_pack", "extract_dense_ffn_bundles",
    "trace_to_shards",
    "FaultPlan", "FaultEvent", "FaultInjectingStore", "RetryPolicy",
    "TransientIOError", "CorruptExtentError", "FatalFault",
    "seeded_layer_plans",
]
