"""Out-of-process engine serving — the analog of the reference's
engine-level C ABI (``include/stringzillas/stringzillas.h:104-597``).

Counterpart of ``stringzilla_tpu/serve.py``, with the same wire protocol
byte for byte, the same ops and the same bounded engine cache: a JAX client
talks to this server and this client to the JAX server. One worker process
holds the port's engines and their device state and serves them over a
Unix-domain socket (4-byte LE header length, a JSON header, then raw
little-endian array bytes — no Python anywhere in the contract).

Protocol
--------
Request header::

    {"op": "levenshtein" | "levenshtein_utf8" | "needleman_wunsch" |
           "smith_waterman" | "fingerprints" | "hash" | "sha256",
     "queries": <count>, "candidates": <count>,   # tape entry counts
     ...op-specific params...,
     "payload": [[name, dtype, [shape...]], ...]} # order of the raw blocks

Payload blocks follow immediately, each ``prod(shape) * itemsize`` bytes.
String collections travel as Arrow-style tapes: ``<name>_offsets``
(int64, count+1) + ``<name>_data`` (uint8).  The response mirrors the
shape: a JSON header (``{"ok": true, "payload": [...]}`` or
``{"ok": false, "error": ...}``) followed by the result blocks.

Every request runs on the server's scope (``EngineServer(path, device)``,
the default scope when None): the engines, ``hash`` through the hash
kernels (``hash_batch_device``) and ``sha256`` through ``sha256_batch`` on
the scope's first device. An error crosses the wire and the connection
keeps serving.

Two differences from the JAX server, on purpose: it serves one connection
at a time, so a second client waits until the first has closed; this one
serves each connection on a thread of its own and runs one request at a
time under a lock (the device runs one program at a time anyway, and the
engine cache needs no other lock). And ``start_background`` returns once
the socket listens, so a client may connect at once; the JAX server's
returns when the socket file exists, which is at ``bind``, before
``listen``.
"""

from __future__ import annotations

import json
import os
import socket
import socketserver
import struct
import threading
from collections import OrderedDict

import numpy as np

__all__ = ["EngineServer", "EngineClient", "serve", "DEFAULT_PATH"]

_HDR = struct.Struct("<I")

#: The CLI's socket; the JAX server's is ``/tmp/stringzilla_tpu.sock``, so
#: both can run side by side.
DEFAULT_PATH = "/tmp/stringzilla_tpu_torch.sock"


def _send(sock, header: dict, blocks: list[np.ndarray]) -> None:
    header = dict(header)
    header["payload"] = [[f"b{i}", str(b.dtype), list(b.shape)]
                         for i, b in enumerate(blocks)]
    raw = json.dumps(header).encode("utf-8")
    sock.sendall(_HDR.pack(len(raw)) + raw)
    for b in blocks:
        # a view of the array's buffer, not a bytes copy (tapes run to tens of MB)
        sock.sendall(memoryview(np.ascontiguousarray(b)).cast("B"))


def _recv_exact(sock, n: int) -> bytes:
    chunks = []
    while n:
        c = sock.recv(min(n, 1 << 20))
        if not c:
            raise ConnectionError("peer closed mid-message")
        chunks.append(c)
        n -= len(c)
    return b"".join(chunks)


def _recv(sock) -> tuple[dict, dict[str, np.ndarray]]:
    (hlen,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    header = json.loads(_recv_exact(sock, hlen))
    blocks = {}
    for name, dtype, shape in header.get("payload", []):
        dt = np.dtype(dtype)
        count = int(np.prod(shape)) if shape else 1
        blocks[name] = np.frombuffer(
            _recv_exact(sock, count * dt.itemsize), dtype=dt).reshape(shape)
    return header, blocks


def _tape(blocks: dict, name: str):
    """The tape of ``name``: its bytes a view of the received block, its
    offsets a writable copy (the engines hand them to torch)."""
    from .ops.tape import Tape

    return Tape(np.asarray(blocks[f"{name}_data"], dtype=np.uint8),
                np.array(blocks[f"{name}_offsets"], dtype=np.int64))


class EngineServer:
    """Holds the port's engines warm and serves them on a Unix socket."""

    #: Engine-cache capacity. NW/SW cache keys embed the full byte→class +
    #: cost-table bytes, so a client cycling tables could grow the cache
    #: without bound; the LRU bound caps the worker at a few dozen engines.
    MAX_CACHED_ENGINES = 32

    def __init__(self, path: str, device=None):
        """``device``: the ``DeviceScope`` every request runs on; None is
        the default scope (``cuda:0``, which raises here when there is no
        card)."""
        from .models.device_scope import default_device_scope

        self.path = path
        self.scope = device if device is not None else default_device_scope()
        self._engines: OrderedDict[tuple, object] = OrderedDict()
        self._server: socketserver.ThreadingUnixStreamServer | None = None
        self._lock = threading.Lock()  # one request at a time, over every connection

    # --- engine cache (bounded LRU) -----------------------------------------

    def _engine(self, key: tuple, make):
        eng = self._engines.get(key)
        if eng is None:
            eng = self._engines[key] = make()
            while len(self._engines) > self.MAX_CACHED_ENGINES:
                self._engines.popitem(last=False)
        else:
            self._engines.move_to_end(key)
        return eng

    # --- op handlers ------------------------------------------------------

    def _handle(self, header: dict, blocks: dict) -> list[np.ndarray]:
        from . import (Fingerprints, LevenshteinDistances, LevenshteinDistancesUTF8,
                       NeedlemanWunschScores, SmithWatermanScores)

        op = header["op"]
        scope = self.scope
        if op in ("levenshtein", "levenshtein_utf8"):
            cls = (LevenshteinDistancesUTF8 if op.endswith("utf8")
                   else LevenshteinDistances)
            eng = self._engine((op,), cls)
            return [eng(_tape(blocks, "queries"), _tape(blocks, "candidates"), device=scope)]
        if op in ("needleman_wunsch", "smith_waterman"):
            cls = (NeedlemanWunschScores if op == "needleman_wunsch"
                   else SmithWatermanScores)
            b2c = np.asarray(blocks["byte_to_class"], dtype=np.uint8)
            table = np.asarray(blocks["costs"], dtype=np.int32)
            gap_open = int(header.get("open", -1))
            gap_extend = int(header.get("extend", -1))
            key = (op, b2c.tobytes(), table.tobytes(), gap_open, gap_extend)
            eng = self._engine(key, lambda: cls(
                byte_to_class=b2c, class_substitution_costs=table,
                open=gap_open, extend=gap_extend))
            return [eng(_tape(blocks, "queries"), _tape(blocks, "candidates"), device=scope)]
        if op == "fingerprints":
            ndim = int(header.get("ndim", 256))
            eng = self._engine((op, ndim), lambda: Fingerprints(ndim=ndim))
            hashes, counts = eng(_tape(blocks, "texts"), device=scope)
            return [hashes, counts]
        if op == "hash":
            from .ops.hash_kernel import hash_batch_device

            return [hash_batch_device(_tape(blocks, "texts"), seed=int(header.get("seed", 0)),
                                      device=scope.device)]
        if op == "sha256":
            from .ops.sha256 import sha256_batch

            return [sha256_batch(_tape(blocks, "texts"), device=scope.device)]
        raise ValueError(f"unknown op {op!r}")

    # --- lifecycle --------------------------------------------------------

    def _listen(self) -> None:
        """Binds the socket and listens on it."""
        handle, lock = self._handle, self._lock

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                while True:
                    try:
                        header, blocks = _recv(self.request)
                    except (ConnectionError, struct.error):
                        return
                    try:
                        with lock:
                            out = handle(header, blocks)
                    except Exception as exc:  # the error crosses the wire, not the process
                        _send(self.request, {"ok": False, "error": str(exc)}, [])
                    else:
                        _send(self.request, {"ok": True}, out)

        if os.path.exists(self.path):
            os.unlink(self.path)
        self._server = socketserver.ThreadingUnixStreamServer(self.path, Handler)
        # a connection left open does not hold up shutdown
        self._server.daemon_threads = True
        self._server.block_on_close = False

    def serve_forever(self) -> None:
        if self._server is None:
            self._listen()
        self._server.serve_forever()

    def start_background(self) -> threading.Thread:
        """Listens, then serves on a daemon thread; a client may connect as
        soon as this returns."""
        self._listen()
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self) -> None:
        """Stops taking connections and removes the socket; a connection
        still open is served until its client closes it."""
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
            if os.path.exists(self.path):
                os.unlink(self.path)


class EngineClient:
    """Python reference client (any language can speak the same bytes)."""

    def __init__(self, path: str):
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.connect(path)

    def close(self) -> None:
        self._sock.close()

    @staticmethod
    def _pack_tape(name: str, items) -> dict[str, np.ndarray]:
        from .ops.tape import Tape

        if isinstance(items, Tape):  # already the wire layout, no copy
            return {f"{name}_offsets": np.ascontiguousarray(items.offsets, dtype=np.int64),
                    f"{name}_data": np.ascontiguousarray(items.data, dtype=np.uint8)}
        raw = [x.encode("utf-8") if isinstance(x, str) else bytes(x) for x in items]
        offsets = np.zeros(len(raw) + 1, dtype=np.int64)
        np.cumsum([len(x) for x in raw], out=offsets[1:])
        return {f"{name}_offsets": offsets,
                f"{name}_data": np.frombuffer(b"".join(raw), dtype=np.uint8)}

    def call(self, op: str, *, tapes: dict | None = None,
             arrays: dict | None = None, **params) -> list[np.ndarray]:
        blocks: dict[str, np.ndarray] = {}
        for name, items in (tapes or {}).items():
            blocks.update(self._pack_tape(name, items))
        for name, arr in (arrays or {}).items():
            blocks[name] = np.asarray(arr)
        header = {"op": op, **params,
                  "payload": [[n, str(b.dtype), list(b.shape)]
                              for n, b in blocks.items()]}
        raw = json.dumps(header).encode("utf-8")
        self._sock.sendall(_HDR.pack(len(raw)) + raw)
        for b in blocks.values():
            self._sock.sendall(memoryview(np.ascontiguousarray(b)).cast("B"))
        resp, out = _recv(self._sock)
        if not resp.get("ok"):
            raise RuntimeError(resp.get("error", "server error"))
        return [out[n] for n, _, _ in resp["payload"]]


def serve(path: str = DEFAULT_PATH, device=None) -> None:
    """CLI entry: ``python -m stringzilla_tpu_torch.serve [socket-path]``,
    serving on the default scope (``cuda:0``)."""
    EngineServer(path, device).serve_forever()


if __name__ == "__main__":
    import sys

    serve(sys.argv[1] if len(sys.argv) > 1 else DEFAULT_PATH)
