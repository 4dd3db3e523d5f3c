"""Engine classes (the ``szs.*`` public API) and ``DeviceScope``."""
