"""Device selection: CUDA unless the caller asks for the CPU.

There is no "cuda if available" fallback: a run that asked for the card
and has none fails instead of quietly running (and being timed) on the CPU.
"""

from __future__ import annotations

import torch

DEVICES = ("cuda", "cpu")


def resolve_device(name: str = "cuda") -> torch.device:
    """``"cuda"`` (default) or ``"cpu"`` as a :class:`torch.device`.

    Raises ``RuntimeError`` when CUDA is asked for and no card is visible.
    """
    if name not in DEVICES:
        raise ValueError(f"device {name!r}: use one of {DEVICES}")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() "
                           "is False (pass device='cpu' to run on the CPU)")
    return torch.device(name)


def no_tf32(x: torch.Tensor) -> None:
    """float32 convolutions on the card in full float32 (``x`` on cuda):
    cuDNN's default is TF32, unlike matmul's."""
    if x.is_cuda:
        torch.backends.cudnn.allow_tf32 = False
