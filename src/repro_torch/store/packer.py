"""Per-layer flash bundles from model parameters (the part of the
reference's offline packer that `build_offload_runtime` uses)."""
from __future__ import annotations

from typing import List

import numpy as np


def extract_dense_ffn_bundles(cfg, params) -> List[np.ndarray]:
    """Per dense-FFN layer, the [n_neurons, bundle_width] flash bundles (host
    numpy) in LOGICAL neuron order, enumerated in the same (group, sublayer)
    order as `ffn_pre_act` capture."""
    from repro_torch.core.sparse_ffn import FFNWeights, make_bundles
    from repro_torch.models import transformer

    P = transformer.stack_period(cfg)
    ffns = cfg.ffn_kinds()
    bundles = []
    for group in params["stack"]:
        for j in range(P):
            if ffns[j] != "dense":
                continue
            ffn_p = group[f"sub_{j}"]["ffn"]
            w = FFNWeights(
                w_up=ffn_p["w_up"].T, w_down=ffn_p["w_down"],
                w_gate=(ffn_p["w_gate"].T if "w_gate" in ffn_p else None))
            bundles.append(make_bundles(w))
    return bundles
