"""One-device resource manager (counterpart of hugectr_tpu/core/mesh.py:38).

The JAX package builds a device mesh; this slice runs on one device, so the
manager holds one `torch.device`. Entry points default to CUDA and raise
where CUDA is absent unless the caller asks for the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means the card. A CUDA device without CUDA raises; the CPU is
    only taken when asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        # fp32 math stays fp32: the reference runs fp32 GEMMs and the port is
        # compared with it in fp32 (TF32 keeps only ~3 decimal digits)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


class ResourceManager:
    """Holds the device of a single-device run (mesh.py:38 `ResourceManager`,
    :50 `create`)."""

    def __init__(self, device: torch.device):
        self.device = device

    @classmethod
    def create(
        cls, num_devices: int = 1, device: DeviceLike = None
    ) -> "ResourceManager":
        if num_devices not in (0, 1):
            raise NotImplementedError(
                "multi-GPU training is not ported yet (ROADMAP Queue 1)"
            )
        return cls(resolve_device(device))

    @property
    def num_devices(self) -> int:
        return 1

    def generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))
