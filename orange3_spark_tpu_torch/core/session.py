"""TorchSession — the SparkSession equivalent of the PyTorch package.

The JAX package's ``TpuSession`` owns a device mesh and its shardings. This
first slice of the PyTorch port runs on one device, so the session owns a
``torch.device`` and nothing else: the mesh and sharding surface waits for
the multi-device slice.

The session runs on the GPU unless the caller asks for the CPU. With no
argument it selects ``cuda`` and raises when CUDA is absent: it never falls
back to the CPU by itself. Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import threading

import torch


class TorchSession:
    """Owns the device; get-or-create singleton like SparkSession."""

    _lock = threading.Lock()
    _active: "TorchSession | None" = None
    #: what ``cache_dtype='auto'`` resolves to (io/codec.py): full compression
    default_cache_dtype: str = "packed"

    def __init__(self, device: str | torch.device | None = None):
        if device is None:
            device = "cuda"
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchSession: no CUDA device is available; pass "
                "device='cpu' to run the port on the CPU")
        self.device = device

    @classmethod
    def builder_get_or_create(
            cls, device: str | torch.device | None = None) -> "TorchSession":
        """``SparkSession.builder.getOrCreate()`` analogue."""
        with cls._lock:
            if cls._active is None or (
                    device is not None
                    and torch.device(device) != cls._active.device):
                cls._active = cls(device)
            return cls._active

    @classmethod
    def active(cls) -> "TorchSession":
        return cls.builder_get_or_create()

    @property
    def n_devices(self) -> int:
        return 1

    def pad_rows(self, n: int) -> int:
        """Padded row count: with one device there is nothing to even out,
        so it is ``n`` (at least 1), the JAX formula at parallelism 1."""
        return max(1, n)

    def synchronize(self) -> None:
        """Wait for the device's queued work (a no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
