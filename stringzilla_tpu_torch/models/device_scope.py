"""DeviceScope — where an engine runs, the port's analog of the reference's
``szs_device_scope_t`` (reference ``c/stringzillas/stringzillas.cuh:276-331``,
Python type ``python/stringzillas.c:198-199``).

Counterpart of ``stringzilla_tpu/models/device_scope.py``. A scope holds one
``torch.device``, and engines pass it down to every tensor they make:

* ``DeviceScope()`` / ``DeviceScope(device_index=k)`` / ``gpu_device=k`` —
  ``cuda:k`` (``k = 0`` by default);
* ``DeviceScope(device="cpu")`` — the plain PyTorch versions on the CPU,
  reachable only by asking for it (here, or for the default scope with
  ``reset_capabilities('serial')``).

There is no silent CPU fallback: without a card, a CUDA scope raises.
Spreading one call over several cards comes with the port of ``parallel/``.
"""

from __future__ import annotations

import torch

from ..utils import platform

__all__ = ["DeviceScope", "default_device_scope"]

_MULTI_DEVICE = ("a scope over several devices waits for the port of "
                 "parallel/ (ROADMAP.md, queue 1: DeviceScope, multi-GPU and "
                 "serve)")


class DeviceScope:
    def __init__(self, cpu_cores: int | None = None, gpu_device: int | None = None,
                 device_index: int | None = None,
                 device: torch.device | str | None = None):
        if device is not None:
            self.device = torch.device(device)
            if self.device.type == "cuda":
                self.device = platform.cuda_device(self.device.index or 0)
            return
        if device_index is None:
            device_index = gpu_device  # API-parity alias
        if device_index is None:
            # The JAX scope spans every device (or the first cpu_cores of
            # them); the port runs one card, so only a one-card span is valid.
            count = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if min(cpu_cores or count, count) > 1:
                raise NotImplementedError(_MULTI_DEVICE)
            device_index = 0
        self.device = platform.cuda_device(device_index)

    @property
    def device_count(self) -> int:
        """Devices the scope spans: one, until scopes over several cards."""
        return 1

    @property
    def is_single_device(self) -> bool:
        return self.device_count == 1

    def get_capabilities(self) -> tuple[str, ...]:
        """Analog of ``szs_device_scope_get_capabilities``
        (reference ``stringzillas.h:148``)."""
        return platform.capabilities() + (f"scope-device:{self.device}",)

    def __repr__(self) -> str:  # pragma: no cover
        return f"DeviceScope(device={self.device})"


def default_device_scope() -> DeviceScope:
    """``cuda:0``, which raises when there is no card; the CPU after
    ``reset_capabilities('serial')`` (``platform.force_backend(cpu=True)``)."""
    return DeviceScope(device=platform.default_device())
