"""Token batches for training: synthetic Markov corpora and byte files."""
from repro_torch.data.pipeline import (DataConfig, SyntheticCorpus,
                                       byte_batches, make_data_iter,
                                       synthetic_batches)

__all__ = ["DataConfig", "SyntheticCorpus", "byte_batches",
           "make_data_iter", "synthetic_batches"]
