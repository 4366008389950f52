from repro_torch.models.encdec import DecoderCache
from repro_torch.models.model import Model, build_model

__all__ = ["DecoderCache", "Model", "build_model"]
