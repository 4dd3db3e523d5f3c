"""The port's engine server (``stringzilla_tpu_torch/serve.py``) on a CPU
scope against the JAX package's (``stringzilla_tpu/serve.py``): the same
bytes on the wire both ways (each client against each server), the same
answer for every op as the port's direct call and as the JAX server's,
errors that leave the connection serving, the bounded engine cache, and a
``start_background`` that a client may connect to at once. Tolerance:
exact equality of every array and its dtype."""

import hashlib
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from stringzilla_tpu.serve import EngineClient as JaxClient  # noqa: E402
from stringzilla_tpu.serve import EngineServer as JaxServer  # noqa: E402

import stringzilla_tpu_torch as tsz  # noqa: E402
from stringzilla_tpu_torch import serve as tserve  # noqa: E402
from stringzilla_tpu_torch.ops.hash_kernel import hash_batch_device  # noqa: E402
from stringzilla_tpu_torch.ops.sha256 import sha256_batch  # noqa: E402
from stringzilla_tpu_torch.serve import EngineClient, EngineServer  # noqa: E402

CPU = tsz.DeviceScope(device="cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _connect(cls, path: str, retry_s: float = 0.0):
    """A client whose every wait for an answer is bounded. A client of the
    JAX server retries connecting for ``retry_s``: its ``start_background``
    can return between ``bind`` and ``listen``."""
    deadline = time.monotonic() + retry_s
    while True:
        try:
            client = cls(path)
            break
        except ConnectionRefusedError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.01)
    client._sock.settimeout(120)
    return client


def _strings(rng, lengths, alphabet=b"acgt"):
    return [bytes(rng.choice(list(alphabet), int(n)).astype(np.uint8)) for n in lengths]


def _requests():
    """One request of each op: ``(op, call keywords, the port's direct
    call)``, on numpy-seeded inputs."""
    rng = np.random.default_rng(21)
    qs, cs = _strings(rng, rng.integers(0, 30, 5)), _strings(rng, rng.integers(0, 30, 9))
    uq = ["héllo wörld", "plain", "数据", ""]
    uc = ["hello world", "hèllo", "数据库", "x", "naïve"]
    b2c = (np.arange(256) % 20).astype(np.uint8)
    table = rng.integers(-4, 6, (32, 32)).astype(np.int32)
    docs = [bytes(rng.integers(32, 127, int(n)).astype(np.uint8))
            for n in rng.integers(0, 200, 6)]
    texts = [b"", b"a", b"hello world", b"x" * 100, bytes(range(256))]
    pair = {"queries": qs, "candidates": cs}
    classes = {"byte_to_class": b2c, "costs": table}
    return {
        "levenshtein": (dict(tapes=pair),
                        lambda s: [tsz.LevenshteinDistances()(qs, cs, device=s)]),
        "levenshtein_utf8": (dict(tapes={"queries": uq, "candidates": uc}),
                             lambda s: [tsz.LevenshteinDistancesUTF8()(uq, uc, device=s)]),
        "needleman_wunsch": (dict(tapes=pair, arrays=classes, open=-4, extend=-1),
                             lambda s: [tsz.NeedlemanWunschScores(b2c, table, open=-4,
                                                                  extend=-1)(qs, cs, device=s)]),
        "smith_waterman": (dict(tapes=pair, arrays=classes, open=-2, extend=-2),
                           lambda s: [tsz.SmithWatermanScores(b2c, table, open=-2,
                                                              extend=-2)(qs, cs, device=s)]),
        "fingerprints": (dict(tapes={"texts": docs}, ndim=64),
                         lambda s: list(tsz.Fingerprints(ndim=64)(docs, device=s))),
        "hash": (dict(tapes={"texts": texts}, seed=7),
                 lambda s: [hash_batch_device(texts, seed=7, device=s.device)]),
        "sha256": (dict(tapes={"texts": texts}),
                   lambda s: [sha256_batch(texts, device=s.device)]),
    }


REQUESTS = _requests()


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """The port's server on the CPU and the JAX server, each with a client
    of its own package and one of the other's."""
    d = tmp_path_factory.mktemp("sock")
    port, jax_srv = EngineServer(str(d / "port.sock"), CPU), JaxServer(str(d / "jax.sock"))
    port.start_background()
    jax_srv.start_background()
    clients = {"port": _connect(EngineClient, port.path),
               "jax client": _connect(JaxClient, port.path),
               "jax server": _connect(EngineClient, jax_srv.path, retry_s=10)}
    yield clients
    for c in clients.values():
        c.close()
    port.shutdown()
    jax_srv.shutdown()


def _same(got, want, what):
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=what)


@pytest.mark.parametrize("op", list(REQUESTS))
def test_every_op_answers_alike(servers, op):
    """The port's server through its own client and the JAX client, and the
    JAX server through the port's client: one answer, the port's direct
    call's."""
    kwargs, direct = REQUESTS[op]
    want = [np.asarray(a) for a in direct(CPU)]
    for name, client in servers.items():
        _same(client.call(op, **kwargs), want, f"{op} via {name}")


def test_sha256_and_hash_against_host(servers):
    texts = REQUESTS["sha256"][0]["tapes"]["texts"]
    (digests,) = servers["port"].call("sha256", tapes={"texts": texts})
    assert [bytes(d) for d in digests] == [hashlib.sha256(t).digest() for t in texts]
    (hashes,) = servers["port"].call("hash", seed=7, tapes={"texts": texts})
    assert list(hashes) == [tsz.hash(t, seed=7) for t in texts]


def test_tape_requests_match_lists(servers):
    """A ``Tape`` travels as it is, with the same answer as its list."""
    qs = REQUESTS["levenshtein"][0]["tapes"]["queries"]
    cs = REQUESTS["levenshtein"][0]["tapes"]["candidates"]
    (a,) = servers["port"].call("levenshtein", tapes={"queries": tsz.Tape.from_strings(qs),
                                                      "candidates": tsz.Tape.from_strings(cs)})
    (b,) = servers["port"].call("levenshtein", tapes={"queries": qs, "candidates": cs})
    _same([a], [b], "tape")


@pytest.mark.parametrize("client", ["port", "jax client"])
def test_error_then_recover(servers, client):
    c = servers[client]
    with pytest.raises(RuntimeError, match="unknown op"):
        c.call("no_such_op", tapes={"texts": [b"x"]})
    with pytest.raises(RuntimeError, match="byte_to_class"):
        c.call("needleman_wunsch", tapes={"queries": [b"a"], "candidates": [b"b"]})
    (hashes,) = c.call("hash", tapes={"texts": [b"y"]})
    assert hashes[0] == tsz.hash(b"y")


def test_engine_cache_bounded():
    """The NW/SW engine cache keys on full table bytes; a client cycling
    tables must not grow the worker without bound (LRU, as the JAX
    server's)."""
    srv = EngineServer("/nonexistent/unused.sock", CPU)
    assert srv.MAX_CACHED_ENGINES == JaxServer.MAX_CACHED_ENGINES == 32
    for i in range(srv.MAX_CACHED_ENGINES + 10):
        srv._engine(("k", i), lambda: object())
    assert len(srv._engines) == srv.MAX_CACHED_ENGINES
    assert ("k", 9) not in srv._engines and ("k", 10) in srv._engines
    srv._engine(("k", srv.MAX_CACHED_ENGINES + 9), lambda: object())
    keep = srv._engines[("k", srv.MAX_CACHED_ENGINES + 9)]
    for i in range(srv.MAX_CACHED_ENGINES - 1):
        srv._engine(("fresh", i), lambda: object())
    assert srv._engines[("k", srv.MAX_CACHED_ENGINES + 9)] is keep


def test_start_background_listens_before_it_returns(tmp_path):
    """A client connects as soon as ``start_background`` returns, with no
    retry, many times in a row on one path; ``shutdown`` removes the
    socket."""
    path = str(tmp_path / "again.sock")
    for i in range(12):
        srv = EngineServer(path, CPU)
        srv.start_background()
        client = _connect(EngineClient, path)
        (h,) = client.call("hash", seed=i, tapes={"texts": [b"abc"]})
        assert h[0] == tsz.hash(b"abc", seed=i)
        client.close()
        srv.shutdown()
        assert not os.path.exists(path)


def test_split_scope_server_answers_as_one_device(tmp_path):
    """A server on a scope that lists the CPU three times splits the
    engines' candidates and fingerprints' documents, with the one-device
    answers."""
    srv = EngineServer(str(tmp_path / "split.sock"), tsz.DeviceScope(devices=["cpu"] * 3))
    srv.start_background()
    client = _connect(EngineClient, srv.path)
    try:
        for op in ("levenshtein", "needleman_wunsch", "fingerprints", "levenshtein_utf8"):
            kwargs, direct = REQUESTS[op]
            _same(client.call(op, **kwargs), [np.asarray(a) for a in direct(CPU)], op)
    finally:
        client.close()
        srv.shutdown()


def test_cli_without_a_card_raises_and_imports_no_jax():
    """``python -m stringzilla_tpu_torch.serve`` serves the default scope,
    which needs a card; the module and ``parallel`` import no JAX."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    code = ("import sys, stringzilla_tpu_torch.serve, stringzilla_tpu_torch.parallel.cross; "
            "assert 'jax' not in sys.modules; "
            "assert not any(m.split('.')[0] == 'stringzilla_tpu' for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)
    proc = subprocess.run([sys.executable, "-m", "stringzilla_tpu_torch.serve",
                           os.path.join(REPO, "build", "cli-test.sock")],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert tserve.DEFAULT_PATH == "/tmp/stringzilla_tpu_torch.sock"
