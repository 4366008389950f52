"""Device resolution shared by every entry point of the port.

The port runs on a CUDA card. An entry point (`build_model`, the weight
loader, `build_offload_runtime`, `InferenceServer`) takes `device=None`,
which means "cuda"; the CPU is used only when the caller passes
`device="cpu"` (the tests do). Without a card, a request for CUDA raises
instead of carrying on quietly on the CPU. `device="meta"` is accepted for
shape-only use: tensors with a shape and a dtype and no values
(`launch.specs` builds its cache stand-ins so); nothing computes there.

float32 matrix products run at full float32 precision on the card: TF32 is
switched off explicitly for matmuls and cuDNN, so logits stay comparable
with the reference's float32 results.
"""
from __future__ import annotations

from typing import Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` -> cuda. Raises RuntimeError when CUDA is asked for (explicitly
    or by default) and no card is visible; raises ValueError for a device
    type the port does not run on ("meta" passes, for shape-only
    stand-ins)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on a GPU by "
                "default — pass device='cpu' to run on the CPU explicitly")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu' "
                         f"('meta' for shape-only stand-ins)")
    return dev


def check_same_device(expected: torch.device, got: torch.device,
                      what: str) -> None:
    """Raise when `what` lives on another device than the entry point was
    asked to run on (no silent cross-device copies on the hot path)."""
    if torch.device(got) != torch.device(expected):
        raise ValueError(f"{what} is on {got}, but this entry point runs on "
                         f"{expected}")
