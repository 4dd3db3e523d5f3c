"""stringzilla_tpu_torch — the PyTorch/CUDA port of stringzilla_tpu.

Batch string engines in PyTorch, with every kernel on the engines' path
hand-written in CUDA C++ for NVIDIA Hopper (``csrc/``, built with ``nvcc``
for ``sm_90a`` on first use) and a plain PyTorch version beside each kernel
for the CPU. Imports torch and numpy, never jax.

Layout mirrors ``stringzilla_tpu`` so each module has a counterpart:

* ``stringzilla_tpu_torch.ops``    — kernels' wrappers and plain versions,
  tapes and on-device packing
* ``stringzilla_tpu_torch.models`` — engine classes and ``DeviceScope``
* ``stringzilla_tpu_torch.utils``  — device resolution, the CUDA kernel build

Ported so far, on one device: ``LevenshteinDistances`` with any costs
(unit costs on the Myers kernel, others on the column DP),
``NeedlemanWunschScores`` and ``SmithWatermanScores`` (the column DP, with
the byte-LUT kernel mapping bytes to cost classes), pairs with a string
over 4096 chars on the wavefront kernels, ``LevenshteinDistancesUTF8``
(the same engines over runes, the Myers kernel's rune route for unit
costs) and ``Fingerprints`` (the MinHash kernel).
"""

from .models.device_scope import DeviceScope
from .models.fingerprints import Fingerprints
from .models.similarities import (
    LevenshteinDistances,
    LevenshteinDistancesUTF8,
    NeedlemanWunsch,
    NeedlemanWunschScores,
    SmithWaterman,
    SmithWatermanScores,
)
from .ops.tape import Tape
from .utils import platform

__version__ = "0.1.0"


def __capabilities__():
    return platform.capabilities()


__all__ = [
    "DeviceScope",
    "Fingerprints",
    "LevenshteinDistances",
    "LevenshteinDistancesUTF8",
    "NeedlemanWunsch",
    "NeedlemanWunschScores",
    "SmithWaterman",
    "SmithWatermanScores",
    "Tape",
    "__capabilities__",
]
