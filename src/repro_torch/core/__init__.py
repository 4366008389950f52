"""RIPPLE core, PyTorch port: neuron co-activation linking for
flash-offloaded LLM inference.

Offline stage: `trace` (activation masks, disk shards) -> `coactivation`
(pattern extraction: counts on the device through the coact kernel) ->
`placement` (greedy Hamiltonian-path search). Online stage: `collapse`
(access collapse), `cache` (linking-aligned S3-FIFO), `storage` (UFS
device model + neuron store), `engine` (the batched serving pipeline),
`pipeline` (double-buffered I/O-compute overlap model), `predictor`
(activation and lookahead predictors, trained on the device), `sparse_ffn`
(FFN math over flash bundles, in torch).

`collapse`, `placement`, `cache`, `storage`, `engine` and `pipeline` are
framework-free numpy, kept as copies of the reference package so the two
make identical decisions; `coactivation` gives the reference's bits because
its counts are exact.
"""
from repro_torch.core.cache import (ArrayLinkingAlignedCache, ArrayS3FIFOCache,
                                    CacheStats, FIFOCache, LRUCache,
                                    LinkingAlignedCache, LoopCounters,
                                    S3FIFOCache, make_linking_aligned_cache)
from repro_torch.core.coactivation import (CoActivationStats, expected_io_ops,
                                           stats_from_mask_shards,
                                           stats_from_masks)
from repro_torch.core.collapse import (AdaptiveThreshold, BottleneckDetector,
                                       collapse_extents, collapse_positions,
                                       run_bounds_from_sorted,
                                       runs_from_positions)
from repro_torch.core.engine import (BatchStepResult, EngineConfig,
                                     OffloadEngine, RequestStats, TokenStats)
from repro_torch.core.pipeline import (IOScheduler, Stage, TokenTiming,
                                       overlapped_latency, serial_latency)
from repro_torch.core.placement import (PlacementResult, frequency_placement,
                                        identity_placement, path_length,
                                        search_placement)
from repro_torch.core.predictor import (PredictorConfig, PredictorParams,
                                        init_predictor, predict_mask,
                                        predictor_logits, recall_precision,
                                        train_predictor)
from repro_torch.core.sparse_ffn import (FFNWeights, dense_ffn,
                                         ffn_pre_activation, make_bundles,
                                         sparse_ffn_from_bundles,
                                         sparse_ffn_gather)
from repro_torch.core.storage import (UFS31, UFS40, IOStats, ManagedReader,
                                      NeuronStore, UFSDevice)

__all__ = [k for k in dir() if not k.startswith("_")]
