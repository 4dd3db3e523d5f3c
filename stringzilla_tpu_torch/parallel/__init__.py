"""Work split over the devices of a ``DeviceScope``: ``cross.py`` cuts a
batch into one part a device; ``ring.py`` cuts ONE pair's DP matrix into
bands of rows, one a device, in a systolic pipeline.

Counterpart of ``stringzilla_tpu/parallel/``.
"""
