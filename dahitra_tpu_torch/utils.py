"""Logger, timer and device helpers.

Counterpart of dahitra_tpu/utils.py (Logger, Timer), plus the port's device
rule: entry points run on ``cuda`` unless the caller asks for the CPU, and a
request for ``cuda`` on a host without a card raises instead of falling back.
"""
from __future__ import annotations

import os
import sys
import time
from typing import Optional, Union

import torch


class Logger:
    """Tees messages to stdout and, when given a path, to that file."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path), exist_ok=True)

    def write(self, msg: str) -> None:
        sys.stdout.write(msg)
        sys.stdout.flush()
        if self.path:
            with open(self.path, "a") as f:
                f.write(msg)


class Timer:
    """Wall-clock rate since construction (the ``imps`` field)."""

    def __init__(self):
        self.start = time.time()

    def elapsed(self) -> float:
        return time.time() - self.start

    def images_per_sec(self, n_images: int) -> float:
        return n_images / max(self.elapsed(), 1e-9)


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The requested device; raises when ``cuda`` is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass --device cpu (device='cpu') to run on the CPU")
    return dev


def disable_tf32() -> None:
    """The one place that keeps fp32 products in full fp32 on the card.

    cuDNN runs fp32 convolutions in TF32 by default (about three decimal
    digits); fp32 mode must compute what the JAX package computes in fp32.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
