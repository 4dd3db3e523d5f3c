"""Arrow C data interface for Tape / Strs — zero-copy export, import.

Counterpart of ``stringzilla_tpu/models/arrow.py``, copied rather than
imported (importing any ``stringzilla_tpu`` module imports jax).

The reference's Python binding speaks the Arrow PyCapsule protocol: ``Strs``
exports itself through ``__arrow_c_array__`` and the constructor accepts any
Arrow producer (reference ``python/stringzilla.c:15`` capsule docs, ``:8537``
consumer call, ``:70-95`` ArrowSchema/ArrowArray struct definitions). Here the
same stable Arrow C ABI is spoken from pure Python via ctypes — no pyarrow
dependency in the library; the tests validate both directions against pyarrow
when it is installed.

Export is **zero-copy**: the capsules point straight at the tape's
``(offsets int64[n+1], data u8[N])`` numpy buffers (large_binary layout "Z"),
which are pinned in a registry until the consumer calls the release callback.
Import copies the two buffers once (a memcpy — the producer's lifetime is then
immediately released) and accepts binary/large_binary/utf8/large_utf8 arrays,
including sliced ones (non-zero ``offset``).
"""

from __future__ import annotations

import ctypes

import numpy as np

__all__ = ["export_tape_capsules", "tape_arrays_from_arrow"]


class ArrowSchema(ctypes.Structure):
    pass


class ArrowArray(ctypes.Structure):
    pass


_RELEASE_SCHEMA = ctypes.CFUNCTYPE(None, ctypes.POINTER(ArrowSchema))
_RELEASE_ARRAY = ctypes.CFUNCTYPE(None, ctypes.POINTER(ArrowArray))

ArrowSchema._fields_ = [
    ("format", ctypes.c_char_p),
    ("name", ctypes.c_char_p),
    ("metadata", ctypes.c_char_p),
    ("flags", ctypes.c_int64),
    ("n_children", ctypes.c_int64),
    ("children", ctypes.POINTER(ctypes.POINTER(ArrowSchema))),
    ("dictionary", ctypes.POINTER(ArrowSchema)),
    ("release", _RELEASE_SCHEMA),
    ("private_data", ctypes.c_void_p),
]

ArrowArray._fields_ = [
    ("length", ctypes.c_int64),
    ("null_count", ctypes.c_int64),
    ("offset", ctypes.c_int64),
    ("n_buffers", ctypes.c_int64),
    ("n_children", ctypes.c_int64),
    ("buffers", ctypes.POINTER(ctypes.c_void_p)),
    ("children", ctypes.POINTER(ctypes.POINTER(ArrowArray))),
    ("dictionary", ctypes.POINTER(ArrowArray)),
    ("release", _RELEASE_ARRAY),
    ("private_data", ctypes.c_void_p),
]

# ctypes.pythonapi.NAME caches ONE function object per name — indexing with
# [] mints independent objects so the two PyCapsule_GetPointer signatures
# (py_object arg for normal calls, void* arg inside capsule destructors)
# don't clobber each other.
_capsule_new = ctypes.pythonapi["PyCapsule_New"]
_capsule_new.restype = ctypes.py_object
_capsule_new.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p]

_capsule_get = ctypes.pythonapi["PyCapsule_GetPointer"]
_capsule_get.restype = ctypes.c_void_p
_capsule_get.argtypes = [ctypes.py_object, ctypes.c_char_p]

_capsule_get_raw = ctypes.pythonapi["PyCapsule_GetPointer"]
_capsule_get_raw.restype = ctypes.c_void_p
_capsule_get_raw.argtypes = [ctypes.c_void_p, ctypes.c_char_p]

_err_clear = ctypes.pythonapi["PyErr_Clear"]
_err_clear.restype = None
_err_clear.argtypes = []

_ARROW_FLAG_NULLABLE = 2

# Pinned exports: token -> tuple of objects that must stay alive until the
# consumer calls release (struct, buffer array, numpy arrays, format bytes).
# Keyed by a token carried in the struct's private_data, NOT the struct
# address: consumers are allowed to MOVE the struct and call release on
# their own copy (Arrow C data interface semantics).
_EXPORTS: dict = {}
_next_token = [1]


def _release_schema_impl(ptr):
    s = ptr.contents
    token = int(s.private_data or 0)
    s.release = ctypes.cast(None, _RELEASE_SCHEMA)
    _EXPORTS.pop(("schema", token), None)


def _release_array_impl(ptr):
    a = ptr.contents
    token = int(a.private_data or 0)
    a.release = ctypes.cast(None, _RELEASE_ARRAY)
    _EXPORTS.pop(("array", token), None)


_release_schema_cb = _RELEASE_SCHEMA(_release_schema_impl)
_release_array_cb = _RELEASE_ARRAY(_release_array_impl)

_CAPSULE_DTOR = ctypes.CFUNCTYPE(None, ctypes.c_void_p)


def _schema_capsule_dtor_impl(capsule_ptr):
    ptr = _capsule_get_raw(capsule_ptr, b"arrow_schema")
    if not ptr:
        _err_clear()  # consumer renamed/consumed the capsule
        return
    s = ctypes.cast(ptr, ctypes.POINTER(ArrowSchema)).contents
    if s.release:
        s.release(ctypes.cast(ptr, ctypes.POINTER(ArrowSchema)))


def _array_capsule_dtor_impl(capsule_ptr):
    ptr = _capsule_get_raw(capsule_ptr, b"arrow_array")
    if not ptr:
        _err_clear()
        return
    a = ctypes.cast(ptr, ctypes.POINTER(ArrowArray)).contents
    if a.release:
        a.release(ctypes.cast(ptr, ctypes.POINTER(ArrowArray)))


_schema_dtor = _CAPSULE_DTOR(_schema_capsule_dtor_impl)
_array_dtor = _CAPSULE_DTOR(_array_capsule_dtor_impl)


def export_tape_capsules(offsets: np.ndarray, data: np.ndarray):
    """``(schema_capsule, array_capsule)`` for a large_binary Arrow array
    aliasing the given int64 offsets and u8 data buffers — zero-copy; the
    numpy arrays are pinned until the consumer releases them."""
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = int(offsets.shape[0]) - 1
    assert n >= 0 and int(offsets[0]) == 0

    schema = ArrowSchema()
    fmt = b"Z"  # large_binary: int64 offsets
    name = b""
    schema.format = fmt
    schema.name = name
    schema.metadata = None
    schema.flags = _ARROW_FLAG_NULLABLE
    schema.n_children = 0
    schema.children = None
    schema.dictionary = None
    token = _next_token[0]
    _next_token[0] += 1
    schema.release = _release_schema_cb
    schema.private_data = token

    bufs = (ctypes.c_void_p * 3)(
        None,  # validity: no nulls
        ctypes.c_void_p(offsets.ctypes.data),
        ctypes.c_void_p(data.ctypes.data if data.size else offsets.ctypes.data),
    )
    array = ArrowArray()
    array.length = n
    array.null_count = 0
    array.offset = 0
    array.n_buffers = 3
    array.n_children = 0
    array.buffers = ctypes.cast(bufs, ctypes.POINTER(ctypes.c_void_p))
    array.children = None
    array.dictionary = None
    array.release = _release_array_cb
    array.private_data = token

    _EXPORTS[("schema", token)] = (schema, fmt, name)
    _EXPORTS[("array", token)] = (array, bufs, offsets, data)

    schema_capsule = _capsule_new(ctypes.addressof(schema), b"arrow_schema",
                                  ctypes.cast(_schema_dtor, ctypes.c_void_p))
    array_capsule = _capsule_new(ctypes.addressof(array), b"arrow_array",
                                 ctypes.cast(_array_dtor, ctypes.c_void_p))
    return schema_capsule, array_capsule


def tape_arrays_from_arrow(obj):
    """``(data u8[N], offsets int64[n+1])`` copied out of any Arrow producer
    (an object exposing ``__arrow_c_array__``, e.g. a pyarrow Array). The
    producer's structures are released immediately after the copy."""
    if not hasattr(obj, "__arrow_c_array__"):
        raise TypeError(f"{type(obj).__name__} is not an Arrow array producer")
    schema_capsule, array_capsule = obj.__arrow_c_array__()

    sptr = _capsule_get(schema_capsule, b"arrow_schema")
    aptr = _capsule_get(array_capsule, b"arrow_array")
    schema = ctypes.cast(sptr, ctypes.POINTER(ArrowSchema)).contents
    array = ctypes.cast(aptr, ctypes.POINTER(ArrowArray)).contents

    fmt = (schema.format or b"").decode()
    if fmt in ("z", "u"):
        off_t, off_size = ctypes.c_int32, 4
    elif fmt in ("Z", "U"):
        off_t, off_size = ctypes.c_int64, 8
    else:
        raise TypeError(
            f"unsupported Arrow format {fmt!r} (want binary/utf8 variants)")
    if array.n_buffers != 3:
        raise ValueError(f"expected 3 buffers, got {array.n_buffers}")
    validity = array.buffers[0]
    if array.null_count > 0 or (array.null_count == -1 and validity):
        raise ValueError("null values are not representable in a string tape")

    length, off0 = int(array.length), int(array.offset)
    offs_ptr = ctypes.cast(array.buffers[1], ctypes.POINTER(off_t))
    offs_all = np.ctypeslib.as_array(offs_ptr, shape=(off0 + length + 1,))
    offsets = offs_all[off0:].astype(np.int64)  # copy
    base, end = int(offsets[0]), int(offsets[-1])
    if end > base:
        data_ptr = ctypes.cast(array.buffers[2], ctypes.POINTER(ctypes.c_uint8))
        data = np.ctypeslib.as_array(data_ptr, shape=(end,))[base:end].copy()
    else:
        data = np.zeros(0, dtype=np.uint8)
    offsets -= base
    del offs_all  # no references into producer memory survive below

    # We copied — release the producer's structures now; the capsule
    # destructors see release == NULL and no-op.
    if array.release:
        array.release(ctypes.cast(aptr, ctypes.POINTER(ArrowArray)))
    if schema.release:
        schema.release(ctypes.cast(sptr, ctypes.POINTER(ArrowSchema)))
    _ = off_size
    return data, offsets
