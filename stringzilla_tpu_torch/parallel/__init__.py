"""Work split over the devices of a ``DeviceScope`` (``cross.py``).

Counterpart of ``stringzilla_tpu/parallel/``. Its ring tier
(``ring.py``, one long pair over several devices) is not ported.
"""
