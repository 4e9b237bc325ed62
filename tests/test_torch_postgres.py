"""The port's Postgres wire client (``db/postgres.py``) and the metadata
resolver's sync adapter (``db/metadata.py`` ``_LoopThread``) against the
JAX package's on the same inputs: the SCRAM-SHA-256 vectors of RFC 7677,
the md5 password, DSN cases (the JDBC spelling, defaults, ``sslmode``),
trust / cleartext / md5 / SCRAM against ``FakePg`` from
``tests/test_postgres.py`` (the same rows and the same SQL seen by the
server in both), a bad password, an empty result, a dead server
(``PostgresUnavailableError`` with ``retry_after_s`` once the breaker
opens), and the resolver's sync ``get_pixels`` called many times from
many threads. Tolerance: zero."""

import asyncio
import base64
import concurrent.futures
import dataclasses
import threading

import pytest

from omero_ms_pixel_buffer_tpu.db import metadata as jmeta
from omero_ms_pixel_buffer_tpu.db import postgres as jpg
from omero_ms_pixel_buffer_tpu_torch.db import metadata as pmeta
from omero_ms_pixel_buffer_tpu_torch.db import postgres as ppg
from omero_ms_pixel_buffer_tpu_torch.resilience import breaker as pbreaker

from test_postgres import FakePg, pixels_row


def test_scram_rfc7677_vectors():
    bare = "n=user,r=rOprNGfwEbeRWgbNEkqO"
    server_first = ("r=rOprNGfwEbeRWgbNEkqO%hvYDpWUa2RaTCAfuxFIlj)hNlF$k0,"
                    "s=W22ZaJ0SNY7soEsUEjb6gQ==,i=4096")
    final, sig = ppg.scram_client_final("pencil", bare, server_first)
    assert final == ("c=biws,r=rOprNGfwEbeRWgbNEkqO%hvYDpWUa2RaTCAfuxFIlj)hNlF$k0,"
                     "p=dHzbZapWIk4jUhN+Ute9ytag9zjfMHgsqmmiz7AndVQ=")
    assert base64.b64encode(sig).decode() == "6rriTRBi23WpRR/wtup+mMhUZUn/dB5nLTJRsjl95G4="
    assert (final, sig) == jpg.scram_client_final("pencil", bare, server_first)
    assert ppg.scram_client_first("rOprNGfwEbeRWgbNEkqO") == jpg.scram_client_first(
        "rOprNGfwEbeRWgbNEkqO")


@pytest.mark.parametrize("user,password,salt", [
    ("user", "secret", b"\x01\x02\x03\x04"), ("omero", "", b"\xff\x00\xff\x00"),
    ("ü", "pässwörd", b"abcd")])
def test_md5_password_matches_jax(user, password, salt):
    assert ppg.md5_password(user, password, salt) == jpg.md5_password(user, password, salt)


@pytest.mark.parametrize("dsn", [
    "postgresql://alice:pw@db.example:5433/omero_web",
    "jdbc:postgresql://db:5432/omero",
    "postgresql://localhost",
    "postgres://u@h/d",
    "postgresql://u:p%40ss@h:6000/d?sslmode=disable",
    "postgresql://u:p@db/omero?sslmode=prefer",
    "postgresql://u:p@db/omero?sslmode=require",
    "postgresql://u:p@db/omero?sslmode=verify-full",
    "mysql://db/x",
    "postgresql://[::1]:5432/omero",
])
def test_parse_dsn_matches_jax(dsn):
    def outcome(module):
        try:
            return "ok", module.parse_dsn(dsn)
        except ValueError as e:
            return "error", str(e)

    assert outcome(ppg) == outcome(jpg)


ROWS = [("1", "hello"), ("2", None), ("3", "")]


@pytest.mark.parametrize("auth", ["trust", "cleartext", "md5", "scram"])
async def test_auth_and_query_match_jax(auth):
    seen = {}
    for name, module in (("port", ppg), ("jax", jpg)):
        async with FakePg(auth=auth, user="u1", password="sekret",
                          rows_for=lambda sql, params: list(ROWS)) as pg:
            client = module.PostgresClient(host="127.0.0.1", port=pg.port, user="u1",
                                           password="sekret", database="db")
            rows = await client.query("SELECT a, b FROM t WHERE x=$1", ["42"])
            rows2 = await client.query("SELECT a FROM t", [])
            await client.close()
            seen[name] = (rows, rows2, list(pg.queries))
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == ROWS


async def test_bad_password_raises():
    async with FakePg(auth="cleartext", password="right") as pg:
        client = ppg.PostgresClient(host="127.0.0.1", port=pg.port, password="wrong")
        with pytest.raises(ppg.PostgresError):
            await client.query("SELECT 1")
        await client.close_nowait()


async def test_empty_result():
    async with FakePg() as pg:
        client = ppg.PostgresClient(host="127.0.0.1", port=pg.port)
        assert await client.query("SELECT 1") == []
        await client.close()


async def test_dead_server_is_unavailable_after_the_breaker_opens():
    pbreaker.BOARD.reset()
    async with FakePg() as pg:
        dead = pg.port
    client = ppg.PostgresClient(host="127.0.0.1", port=dead)
    try:
        errors = []
        for _ in range(pbreaker.FAILURE_THRESHOLD + 1):
            with pytest.raises((ppg.PostgresError, OSError)) as e:
                await client.query("SELECT 1")
            errors.append(e.value)
        # refused connections until the breaker opens, then "unavailable"
        assert all(isinstance(e, OSError) for e in errors[:-1])
        assert isinstance(errors[-1], ppg.PostgresUnavailableError)
        assert errors[-1].retry_after_s > 0
    finally:
        await client.close_nowait()
        pbreaker.BOARD.reset()


def test_sync_adapter_survives_many_calls_from_many_threads():
    """``get_pixels`` runs on the batcher's executor threads: the
    resolver's loop thread must serve calls from many threads, many
    times, and its answers equal the JAX resolver's."""
    def rows_for(sql, params):
        return [pixels_row(pid=params[0], sx="64", sy="32", sz="1", sc="1", st="1",
                           ptype="uint8", name="img")]

    started, stop, port = threading.Event(), threading.Event(), {}

    def server():
        loop = asyncio.new_event_loop()

        async def run():
            async with FakePg(rows_for=rows_for) as pg:
                port["n"] = pg.port
                started.set()
                while not stop.is_set():
                    await asyncio.sleep(0.02)

        try:
            loop.run_until_complete(run())
        finally:
            loop.close()

    t = threading.Thread(target=server, daemon=True)
    t.start()
    assert started.wait(5)
    uri = f"postgresql://omero:pw@127.0.0.1:{port['n']}/omero"
    port_r = pmeta.OmeroPostgresMetadataResolver(uri, cache_ttl_s=0)
    jax_r = jmeta.OmeroPostgresMetadataResolver(uri, cache_ttl_s=0)
    try:
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            got = list(pool.map(lambda i: port_r.get_pixels(1 + i % 5), range(40)))
        assert all(m is not None and m.size_x == 64 for m in got)
        for image in (1, 2, 3):
            assert (dataclasses.asdict(port_r.get_pixels(image))
                    == dataclasses.asdict(jax_r.get_pixels(image)))
    finally:
        port_r.close_sync()
        jax_r.close_sync()
        stop.set()
        t.join(5)
