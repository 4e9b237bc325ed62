"""The port's Glacier2 session join (``auth/ice.py``) against the JAX
package's: the request bytes equal JAX ``build_request`` for the same
ids, identities and payloads, and both clients and validators against
``FakeGlacier2`` from ``tests/test_ice.py``: the join and its denials,
the TTL cache (denials never cached), single flight (one join for many
waiters; a waiter's cancellation does not cancel the join) and TTL 0
(one join a call). Tolerance: zero (bytes, verdicts, join counts)."""

import asyncio

import pytest

from omero_ms_pixel_buffer_tpu.auth import ice as jice
from omero_ms_pixel_buffer_tpu_torch.auth import ice as pice
from omero_ms_pixel_buffer_tpu_torch.auth.validator import SessionValidator
from omero_ms_pixel_buffer_tpu_torch.resilience import breaker as pbreaker

from test_ice import FakeGlacier2


@pytest.fixture(autouse=True)
def _fresh_breakers():
    pbreaker.BOARD.reset()
    yield
    pbreaker.BOARD.reset()


@pytest.mark.parametrize("request_id,identity,op,a,b", [
    (1, ("Glacier2", "router"), "createSession", "k", "k"),
    (7, ("Glacier2", "router"), "createSession", "u" * 300, "p"),
    (2 ** 31 - 1, ("cat", "name"), "destroySession", "", "ü-key"),
])
def test_request_bytes_match_jax(request_id, identity, op, a, b):
    payload = pice.marshal_two_strings(a, b)
    assert payload == jice.marshal_two_strings(a, b)
    assert (pice.build_request(request_id, identity, op, payload)
            == jice.build_request(request_id, identity, op, payload))


@pytest.mark.parametrize("module", [pice, jice], ids=["port", "jax"])
async def test_join_and_denials(module):
    async with FakeGlacier2(valid_keys={"good-key"}) as g:
        client = module.Glacier2Client("127.0.0.1", g.port)
        assert await client.create_session("good-key", "good-key") == (True, None)
        _, category, name, op, mode, user, pw = g.requests[0]
        assert (category, name, op, mode, user, pw) == (
            "Glacier2", "router", "createSession", 0, "good-key", "good-key")
    for exc, reason in (("PermissionDenied", "Permission denied"),
                        ("CannotCreateSession", "Cannot create session")):
        async with FakeGlacier2(exception=exc) as g:
            client = module.Glacier2Client("127.0.0.1", g.port)
            assert await client.create_session("bad", "bad") == (False, reason)


async def test_both_clients_send_the_same_request():
    seen = []
    for module in (pice, jice):
        async with FakeGlacier2(valid_keys={"k"}) as g:
            await module.Glacier2Client("127.0.0.1", g.port).create_session("k", "k")
            seen.append(g.requests[0][1:])
    assert seen[0] == seen[1]


async def test_protocol_error_raises():
    async def bad_server(reader, writer):
        writer.write(b"NOPE" + bytes(10))
        await writer.drain()
        writer.close()

    server = await asyncio.start_server(bad_server, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    try:
        with pytest.raises(pice.IceProtocolError):
            await pice.Glacier2Client("127.0.0.1", port, timeout_s=2).create_session("k", "k")
    finally:
        server.close()
        await server.wait_closed()


async def test_validator_caches_valid_keys_only():
    assert issubclass(pice.IceSessionValidator, SessionValidator)
    async with FakeGlacier2(valid_keys={"k"}) as g:
        v = pice.IceSessionValidator("127.0.0.1", g.port, cache_ttl_s=30)
        assert await v.validate("k")
        joins = len(g.requests)
        assert await v.validate("k")
        assert len(g.requests) == joins
        assert not await v.validate("other")
        assert not await v.validate("other")
        assert len(g.requests) == joins + 2
        assert not await v.validate(None) and not await v.validate("")
        assert len(g.requests) == joins + 2


@pytest.mark.parametrize("module", [pice, jice], ids=["port", "jax"])
async def test_single_flight(module):
    async with FakeGlacier2(valid_keys={"k"}) as g:
        v = module.IceSessionValidator("127.0.0.1", g.port)
        assert all(await asyncio.gather(*[v.validate("k") for _ in range(16)]))
        assert len(g.requests) == 1


async def test_single_flight_survives_waiter_cancellation():
    async with FakeGlacier2(valid_keys={"k"}) as g:
        v = pice.IceSessionValidator("127.0.0.1", g.port)
        first = asyncio.ensure_future(v.validate("k"))
        await asyncio.sleep(0)  # the join task starts
        first.cancel()
        with pytest.raises(asyncio.CancelledError):
            await first
        assert await v.validate("k")
        assert len(g.requests) == 1


@pytest.mark.parametrize("module", [pice, jice], ids=["port", "jax"])
async def test_ttl_zero_joins_every_call(module):
    async with FakeGlacier2(valid_keys={"k"}) as g:
        v = module.IceSessionValidator("127.0.0.1", g.port, cache_ttl_s=0)
        assert await v.validate("k")
        assert await v.validate("k")
        assert len(g.requests) == 2


async def test_unreachable_router_opens_its_breaker():
    """A router that refuses connections fails the join; past the
    threshold the validator answers from the open breaker."""
    async with FakeGlacier2() as g:
        dead = g.port
    v = pice.IceSessionValidator("127.0.0.1", dead, cache_ttl_s=0)
    outcomes = []
    for _ in range(pbreaker.FAILURE_THRESHOLD + 1):
        try:
            outcomes.append(await v.validate("k"))
        except Exception as e:  # noqa: BLE001 - the failure's type is what is checked
            outcomes.append(type(e).__name__)
    assert v.breaker.state == "open"
    assert outcomes[-1] == "ServiceUnavailableError"
