"""Device resolution and capability report for the PyTorch port.

The reference library picks an ISA tier at load time (reference
``c/stringzilla/dispatch.h:34-109``). Here the tier follows the device a
tensor lives on: CUDA tensors run the hand-written Hopper kernels in
``csrc/``, CPU tensors run each kernel's plain PyTorch version. Nothing is
decided at import time, and no device is picked silently.

``force_backend`` is the knob behind ``reset_capabilities`` (the
reference's ``sz.reset_capabilities``): ``force_backend(cpu=True)`` makes
the entry points that are given no device (the default scope among them)
run the plain versions on the CPU, an explicit request like
``DeviceScope(device="cpu")``; ``force_backend(cpu=False)`` gives them the
card again.
"""

from __future__ import annotations

import torch

__all__ = ["cuda_device", "default_device", "resolve_device", "force_backend", "capabilities"]

_CPU_FORCED = False  # set by force_backend


def cuda_device(index: int = 0) -> torch.device:
    """``torch.device("cuda", index)``, or a clear error when there is no
    such card. Never falls back to the CPU: callers that want the plain
    PyTorch versions ask for ``torch.device("cpu")`` themselves."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the kernels of stringzilla_tpu_torch "
            "run on an NVIDIA GPU. Pass DeviceScope(device='cpu') to run the "
            "plain PyTorch versions on the CPU instead.")
    count = torch.cuda.device_count()
    if not 0 <= index < count:
        raise ValueError(f"CUDA device {index} does not exist ({count} visible)")
    return torch.device("cuda", index)


def force_backend(cpu: bool) -> None:
    """Whether entry points given no device run the plain versions on the
    CPU (``cpu=True``) or on the card (``cpu=False``, the default)."""
    global _CPU_FORCED
    _CPU_FORCED = bool(cpu)


def default_device() -> torch.device:
    """The CPU after ``force_backend(cpu=True)``, else ``cuda_device()``,
    which raises when there is no card."""
    return torch.device("cpu") if _CPU_FORCED else cuda_device()


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None is ``default_device()``."""
    return torch.device(device) if device is not None else default_device()


def capabilities() -> tuple[str, ...]:
    """Introspection analog of ``sz_capabilities_to_string`` (reference
    ``stringzilla.h:742-765``)."""
    caps = ["torch-plain", f"torch:{torch.__version__}"]
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count and torch.cuda.get_device_capability(0) == (9, 0):
        caps.append("cuda-sm90a")  # the only target csrc/ is built for
    caps.append(f"devices:{count}")
    return tuple(caps)
