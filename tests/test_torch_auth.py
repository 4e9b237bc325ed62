"""The port's session layer (``auth/django.py``, ``auth/stores.py``,
``auth/omero_session.py``, ``cache/plane/resp_stub.py``,
``utils/connstate.py``, ``resilience/timeouts.py``) against the JAX
package's on the same inputs: Django payloads (pickled, signed JSON,
compressed or not, bare JSON, garbage) decode to the same OMERO key in
both, and a ``REDUCE`` payload that would call ``os.system`` executes
nothing; the RESP2 wire is cross-checked (the port's ``RedisSessionStore``
against the JAX stub, the JAX store against the port's stub); a closing
or hanging store raises ``ServiceUnavailableError`` once its breaker
opens; ``PostgresSessionStore`` against ``FakePg`` (expired rows absent,
as the query excludes them). Tolerance: zero (keys, statuses, breaker
states)."""

import asyncio
import base64
import json
import pickle
import zlib

import pytest

from omero_ms_pixel_buffer_tpu.auth import django as jdjango
from omero_ms_pixel_buffer_tpu.auth.stores import RedisSessionStore as JaxRedis
from omero_ms_pixel_buffer_tpu.cache.plane.resp_stub import InMemoryRespServer as JaxStub
from omero_ms_pixel_buffer_tpu_torch.auth import django as pdjango
from omero_ms_pixel_buffer_tpu_torch.auth import stores as pstores
from omero_ms_pixel_buffer_tpu_torch.auth.omero_session import AllowListValidator
from omero_ms_pixel_buffer_tpu_torch.cache.plane.resp_stub import InMemoryRespServer
from omero_ms_pixel_buffer_tpu_torch.errors import ServiceUnavailableError
from omero_ms_pixel_buffer_tpu_torch.resilience import breaker as pbreaker
from omero_ms_pixel_buffer_tpu_torch.resilience import timeouts

from test_auth_dispatch import FakeConnector, _django_signed
from test_postgres import FakePg

SESSION = {"connector": {"omero_session_key": "sj-77", "server_id": 1, "is_secure": False},
           "_auth_user_id": "2"}


def _payloads():
    big = dict(SESSION, pad="x" * 200)
    return {
        "raw_pickle": pickle.dumps({"connector": FakeConnector("abc-123")}),
        "b64_hash_pickle": base64.b64encode(
            b"fakehash:" + pickle.dumps({"connector": FakeConnector("k-9")})),
        "pickle_dict_connector": pickle.dumps({"connector": {"omero_session_key": "d-1"}}),
        "signed_compressed": _django_signed(big),
        "signed_plain": _django_signed(SESSION, compress=False),
        "bare_json": json.dumps(SESSION).encode(),
        "no_connector": _django_signed({"_auth_user_id": "3"}),
        "garbage": b"\x00\x01garbage",
        "signed_garbage": b"abc:def:ghi",
        "colons": b"::",
        "zlib_json": b"." + base64.urlsafe_b64encode(
            zlib.compress(json.dumps(SESSION).encode())).rstrip(b"=") + b":ts:sig",
        "empty": b"",
    }


PAYLOADS = _payloads()


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_payloads_decode_like_jax(name):
    raw = PAYLOADS[name]
    jsess = jdjango.decode_session_payload(raw)
    psess = pdjango.decode_session_payload(raw)
    jkey = None if jsess is None else jdjango.extract_omero_session_key(jsess)
    pkey = None if psess is None else pdjango.extract_omero_session_key(psess)
    assert pkey == jkey
    assert (psess is None) == (jsess is None)


def test_reduce_payload_executes_nothing(tmp_path):
    """A pickle whose REDUCE would call ``os.system`` (an attacker-written
    Redis value) decodes without resolving the callable."""
    marker = tmp_path / "pwned"
    evil = (b"cos\nsystem\n(S'touch " + str(marker).encode() + b"'\ntR.")
    for module in (pdjango, jdjango):
        module.decode_session_payload(evil)
        module.decode_session_payload(base64.b64encode(b"h:" + evil))
    assert not marker.exists()


def _seed(data, sessions):
    for sid, value in sessions.items():
        data[f":1:django.contrib.sessions.cache{sid}".encode()] = (value, None)


STORED = {
    "pick": base64.b64encode(b"h:" + pickle.dumps({"connector": FakeConnector("key-p")})),
    "sign": _django_signed(dict(SESSION, pad="y" * 100)),
    "none": _django_signed({"_auth_user_id": "3"}),
}
LOOKUPS = {"pick": "key-p", "sign": "sj-77", "none": None, "unknown": None}


@pytest.fixture(autouse=True)
def _fresh_breakers():
    pbreaker.BOARD.reset()
    yield
    pbreaker.BOARD.reset()
    timeouts.set_io_timeout(timeouts.DEFAULT_IO_TIMEOUT_S)


async def test_port_store_against_jax_stub():
    stub = JaxStub()
    port = await stub.start()
    _seed(stub.data, STORED)
    store = pstores.RedisSessionStore(f"redis://127.0.0.1:{port}/1")
    try:
        for sid, key in LOOKUPS.items():
            assert await store.get_omero_session_key(sid) == key, sid
    finally:
        await store.close()
        await stub.close()


async def test_jax_store_against_port_stub():
    stub = InMemoryRespServer()
    port = await stub.start()
    _seed(stub.data, STORED)
    store = JaxRedis(f"redis://:pw@127.0.0.1:{port}/2")
    try:
        for sid, key in LOOKUPS.items():
            assert await store.get_omero_session_key(sid) == key, sid
        assert stub.commands >= len(LOOKUPS) + 2  # AUTH and SELECT first
    finally:
        await store.close()
        await stub.close()


async def test_both_stores_send_the_same_commands():
    """The RESP2 frames each store writes for one lookup, seen by one stub."""
    seen = {}
    for name, cls in (("port", pstores.RedisSessionStore), ("jax", JaxRedis)):
        stub = InMemoryRespServer()
        port = await stub.start()
        frames = []
        dispatch = stub._dispatch

        def record(parts, frames=frames, dispatch=dispatch):
            frames.append(list(parts))
            return dispatch(parts)

        stub._dispatch = record
        _seed(stub.data, STORED)
        store = cls(f"redis://:secret@127.0.0.1:{port}/3")
        try:
            await store.get_omero_session_key("unknown")
            await store.get_omero_session_key("sign")
        finally:
            await store.close()
            await stub.close()
        seen[name] = frames
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == [b"AUTH", b"secret"] and seen["port"][1] == [b"SELECT", b"3"]


@pytest.mark.parametrize("mode", ["close", "hang"])
async def test_sick_store_is_unavailable_and_opens_its_breaker(mode):
    timeouts.set_io_timeout(0.2)
    stub = InMemoryRespServer()
    port = await stub.start()
    _seed(stub.data, STORED)
    store = pstores.RedisSessionStore(f"redis://127.0.0.1:{port}/1")
    try:
        assert await store.get_omero_session_key("sign") == "sj-77"
        stub.fail_mode = mode
        raised = []
        for _ in range(pbreaker.FAILURE_THRESHOLD):
            with pytest.raises((ConnectionError, OSError, asyncio.TimeoutError)):
                await store.get_omero_session_key("sign")
            raised.append(store.breaker.state)
        assert store.breaker.state == "open"
        with pytest.raises(ServiceUnavailableError) as e:
            await store.get_omero_session_key("sign")
        assert 0 < e.value.retry_after_s <= pbreaker.OPEN_DURATION_S
        # healed and past the open period: the half-open probe closes it
        stub.fail_mode = None
        store.breaker._opened_at -= pbreaker.OPEN_DURATION_S
        assert await store.get_omero_session_key("sign") == "sj-77"
        assert store.breaker.state == "closed"
    finally:
        stub.fail_mode = None
        await store.close()
        await stub.close()


DJANGO_ROW = base64.b64encode(b"hash:" + pickle.dumps(
    {"connector": {"omero_session_key": "omero-key-123"}})).decode()


def _django_rows(sql, params):
    """django_session rows: the query excludes expired rows, as Postgres
    would with ``expire_date > now()``."""
    assert "django_session" in sql and "expire_date > now()" in sql
    rows = {"good-cookie": (DJANGO_ROW, "2999-01-01"), "expired": (DJANGO_ROW, "2000-01-01"),
            "signed": (_django_signed(SESSION).decode(), "2999-01-01"),
            "null": (None, "2999-01-01")}
    row = rows.get(params[0])
    if row is None or row[1] < "2026":
        return []
    return [(row[0],)]


async def test_postgres_store_against_fakepg():
    from omero_ms_pixel_buffer_tpu.auth.stores import PostgresSessionStore as JaxPg

    async with FakePg(rows_for=_django_rows) as pg:
        uri = f"postgresql://omero:pw@127.0.0.1:{pg.port}/omero_web"
        port, jax = pstores.PostgresSessionStore(uri), JaxPg(uri)
        try:
            for sid in ("good-cookie", "expired", "signed", "null", "missing"):
                got = await port.get_omero_session_key(sid)
                assert got == await jax.get_omero_session_key(sid), sid
            assert await port.get_omero_session_key("good-cookie") == "omero-key-123"
            assert await port.get_omero_session_key("expired") is None
            assert pg.queries[-1][0] == pstores.PostgresSessionStore.QUERY
        finally:
            await port.close()
            await jax.close()


async def test_postgres_store_down_is_unavailable():
    async with FakePg() as pg:
        dead = pg.port
    store = pstores.PostgresSessionStore(f"postgresql://omero:pw@127.0.0.1:{dead}/omero_web")
    try:
        for _ in range(pbreaker.FAILURE_THRESHOLD + 1):
            try:
                await store.get_omero_session_key("x")
            except ServiceUnavailableError as e:
                assert e.retry_after_s > 0
                break
            except (ConnectionError, OSError):
                pass
        else:
            pytest.fail("the store never answered 'unavailable'")
    finally:
        await store.close()


async def test_factory_validator_and_echo_match_jax():
    from omero_ms_pixel_buffer_tpu.auth import stores as jstores
    from omero_ms_pixel_buffer_tpu.auth.omero_session import AllowListValidator as JaxAllow

    for kind, uri in (("memory", None), ("redis", "redis://h:1/2"),
                      ("postgres", "jdbc:postgresql://x:5433/db")):
        assert (type(pstores.make_session_store(kind, uri)).__name__
                == type(jstores.make_session_store(kind, uri)).__name__)
    for module in (pstores, jstores):
        with pytest.raises(ValueError, match="session-store.type"):
            module.make_session_store("dynamo", None)
    assert await pstores.EchoSessionStore().get_omero_session_key("s") == "s"
    assert await pstores.EchoSessionStore().get_omero_session_key("") is None
    for key in ("k1", "k2", "", None):
        for allowed in (None, ["k1"]):
            assert (await AllowListValidator(allowed).validate(key)
                    == await JaxAllow(allowed).validate(key))


def test_connstate_matches_jax():
    from omero_ms_pixel_buffer_tpu.utils.connstate import ConnState as JaxState
    from omero_ms_pixel_buffer_tpu_torch.utils.connstate import ConnState

    class W:
        closed = False

        def close(self):
            self.closed = True

    for cls in (ConnState, JaxState):
        s = cls()
        assert not s.connected and not s.closed
        w = W()
        s.attach(object(), w)
        assert s.connected
        s.drop()
        assert w.closed and not s.connected and not s.closed
        s.attach(object(), W())
        s.close()
        assert s.closed and not s.connected


async def test_concurrent_lookups_share_a_bounded_pool():
    """Concurrent lookups run on up to ``REDIS_CONNECTIONS`` connections of
    their own (each opened with SELECT), every one answering right."""
    stub = InMemoryRespServer()
    port = await stub.start()
    selects = []
    dispatch = stub._dispatch

    def record(parts):
        if parts[0] == b"SELECT":
            selects.append(parts)
        return dispatch(parts)

    stub._dispatch = record
    _seed(stub.data, STORED)
    store = pstores.RedisSessionStore(f"redis://127.0.0.1:{port}/1")
    try:
        sids = list(LOOKUPS) * 16
        got = await asyncio.gather(*(store.get_omero_session_key(s) for s in sids))
        assert got == [LOOKUPS[s] for s in sids]
        assert 1 < len(selects) <= pstores.REDIS_CONNECTIONS
        again = await asyncio.gather(*(store.get_omero_session_key(s) for s in sids))
        assert again == got and len(selects) <= pstores.REDIS_CONNECTIONS  # reused
    finally:
        await store.close()
        await stub.close()
    with pytest.raises(ConnectionError):
        await store.get_omero_session_key("sign")  # closed for good
