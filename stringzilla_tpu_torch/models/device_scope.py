"""DeviceScope — where an engine runs, the port's analog of the reference's
``szs_device_scope_t`` (reference ``c/stringzillas/stringzillas.cuh:276-331``,
Python type ``python/stringzillas.c:198-199``).

Counterpart of ``stringzilla_tpu/models/device_scope.py``. A scope holds a
list of ``torch.device``s, as the JAX scope holds a mesh:

* ``DeviceScope()`` — every visible card, as the JAX scope spans
  ``jax.devices()``;
* ``DeviceScope(cpu_cores=n)`` — the first ``min(n, count)`` cards;
* ``DeviceScope(device_index=k)`` / ``gpu_device=k`` — card ``k``;
* ``DeviceScope(device=d)`` — one device: ``"cpu"`` runs the plain PyTorch
  versions, reachable only by asking for it (here, or for the default
  scope with ``reset_capabilities('serial')``);
* ``DeviceScope(devices=[...])`` — a list of devices, the counterpart of
  ``mesh=``. A device may repeat (``["cpu"] * 8``, ``["cuda:0"] * 4``):
  the split routes then run on one device, as the JAX tests run them on
  a virtual 8-device CPU mesh.

``device`` is the first device: the engines gather their results there,
and every entry point that runs on one device (``Str``, ``intersect``, the
hash and SHA-256 functions) runs there. Over several devices the engines
split their candidates and ``Fingerprints`` its documents
(``parallel/cross.py``), and a pair past one device's wavefront is scored
on the ring (``parallel/ring.py``), its rows cut over the devices. There
is no silent CPU fallback: without a card, a CUDA scope raises. Not
ported: scopes over several hosts.
"""

from __future__ import annotations

import torch

from ..utils import platform

__all__ = ["DeviceScope", "default_device_scope"]


def _resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA one checked against the
    visible cards (``cuda`` alone is ``cuda:0``)."""
    device = torch.device(device)
    if device.type == "cuda":
        return platform.cuda_device(device.index or 0)
    return device


class DeviceScope:
    def __init__(self, cpu_cores: int | None = None, gpu_device: int | None = None,
                 device_index: int | None = None,
                 device: torch.device | str | None = None,
                 devices=None):
        if devices is not None:
            devs = [_resolve(d) for d in devices]
            if not devs:
                raise ValueError("devices must name at least one device")
            if len({d.type for d in devs}) > 1:
                raise ValueError(f"a scope's devices must be of one type, got {devs}")
        elif device is not None:
            devs = [_resolve(device)]
        else:
            if device_index is None:
                device_index = gpu_device  # API-parity alias
            if device_index is not None:
                devs = [platform.cuda_device(device_index)]
            else:
                count = torch.cuda.device_count() if torch.cuda.is_available() else 0
                if cpu_cores is not None and cpu_cores > 0:
                    count = min(cpu_cores, count)
                # cuda_device raises when there is no card
                devs = [platform.cuda_device(i) for i in range(max(count, 1))]
        self.devices = tuple(devs)
        self.device = self.devices[0]

    @property
    def device_count(self) -> int:
        return len(self.devices)

    @property
    def is_single_device(self) -> bool:
        return self.device_count == 1

    def get_capabilities(self) -> tuple[str, ...]:
        """Analog of ``szs_device_scope_get_capabilities``
        (reference ``stringzillas.h:148``)."""
        return platform.capabilities() + (f"scope-device:{self.device}",
                                          f"scope-devices:{self.device_count}")

    def __repr__(self) -> str:  # pragma: no cover
        return f"DeviceScope(devices={[str(d) for d in self.devices]})"


def default_device_scope() -> DeviceScope:
    """``cuda:0``, which raises when there is no card; the CPU after
    ``reset_capabilities('serial')`` (``platform.force_backend(cpu=True)``).
    One device, as the JAX package's ``device_index=0``."""
    return DeviceScope(device=platform.default_device())
