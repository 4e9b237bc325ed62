"""The port's OMERO metadata plane (``db/metadata.py``) against the JAX
package's on the same rows: ``can_read``/``can_write`` over every group
permission long and caller, ``PixelsMeta`` equal field for field, the
per-session ACL outcomes per group permission (``_fake_omero`` from
``tests/test_permissions.py``: owner, member, leader, admin, outsider,
unknown and closed sessions), enforcement off, the unchecked buffer-plane
lookup, the per-image cache, the invalidation listener, and
``omero.db.enforce-permissions`` read from strings as the JAX front reads
it. Tolerance: zero."""

import dataclasses
import itertools

import pytest

from omero_ms_pixel_buffer_tpu.db import metadata as jmeta
from omero_ms_pixel_buffer_tpu_torch.db import metadata as pmeta

from test_permissions import PRIVATE, READ_ANNOTATE, READ_ONLY, READ_WRITE, _fake_omero
from test_postgres import FakePg, pixels_row

PERMS = (PRIVATE, READ_ONLY, READ_ANNOTATE, READ_WRITE, READ_ONLY | jmeta.WORLD_READ,
         READ_WRITE | jmeta.WORLD_WRITE, 0, -1)
CTXS = (None, (2, {3: False}, False), (5, {3: False}, False), (6, {3: True}, False),
        (9, {0: False}, True), (7, {4: False}, False), (2, {}, False))


def test_permission_bits_match_jax():
    for name in ("USER_READ", "GROUP_READ", "WORLD_READ", "USER_WRITE", "GROUP_WRITE",
                 "WORLD_WRITE", "PIXELS_QUERY", "SESSION_USER_QUERY", "USER_GROUPS_QUERY"):
        assert getattr(pmeta, name) == getattr(jmeta, name), name


@pytest.mark.parametrize("perms", PERMS)
def test_can_read_and_write_match_jax(perms):
    for ctx, owner, group in itertools.product(CTXS, (2, 5, None), (3, 4, None)):
        assert pmeta.can_read(ctx, owner, group, perms) == jmeta.can_read(ctx, owner, group, perms)
        assert (pmeta.can_write(ctx, owner, group, perms)
                == jmeta.can_write(ctx, owner, group, perms))


def _resolvers(pg, **kw):
    uri = f"postgresql://omero:pw@127.0.0.1:{pg.port}/omero"
    return pmeta.OmeroPostgresMetadataResolver(uri, **kw), jmeta.OmeroPostgresMetadataResolver(
        uri, **kw)


def _asdict(meta):
    return None if meta is None else dataclasses.asdict(meta)


SESSIONS = ("alice-key", "bob-key", "lead-key", "admin-key", "nobody-key", None, "closed-key")


@pytest.mark.parametrize("perms", [PRIVATE, READ_ONLY, READ_ANNOTATE, READ_WRITE])
@pytest.mark.parametrize("enforce", [True, False])
async def test_acl_outcomes_match_jax(perms, enforce):
    sessions = {"alice-key": 2, "bob-key": 5, "lead-key": 6, "admin-key": 9, "closed-key": 5}
    async with FakePg(rows_for=_fake_omero(perms, sessions, closed=("closed-key",))) as pg:
        port, jax = _resolvers(pg, enforce_permissions=enforce)
        try:
            for key in SESSIONS:
                for image in (1, 2):
                    want = await jax.get_pixels_async(image, session_key=key)
                    got = await port.get_pixels_async(image, session_key=key)
                    assert _asdict(got) == _asdict(want), (key, image)
                assert (await port.can_write_image_async(1, key)
                        == await jax.can_write_image_async(1, key)), key
        finally:
            await port.close()
            await jax.close()


async def test_pixels_meta_fields_match_jax():
    def rows_for(sql, params):
        if params == ["7"]:
            return [pixels_row(fmt="OMETiff", e_type="ome.model.core.Image",
                               e_lsid="urn:lsid:x", e_uuid="u-1")]
        if params == ["8"]:
            return [pixels_row(ptype="float", name="")]
        return []

    async with FakePg(rows_for=rows_for) as pg:
        port, jax = _resolvers(pg)
        try:
            for image in (7, 8, 9):
                got = _asdict(await port.get_pixels_async(image))
                assert got == _asdict(await jax.get_pixels_async(image))
            assert got is None
            meta = await port.get_pixels_async(7)
            assert meta.external_info == {"entityType": "ome.model.core.Image",
                                          "lsid": "urn:lsid:x", "uuid": "u-1"}
        finally:
            await port.close()
            await jax.close()


def test_sync_adapter_unchecked_cache_and_listener():
    """The sync surface the batcher's threads call: the scoped lookup, the
    unchecked one, the per-image cache (one pixels query for two calls)
    and the invalidation listener."""
    import asyncio
    import threading

    counted = {"pixels": 0}
    base = _fake_omero(PRIVATE)

    def rows_for(sql, params):
        if sql == pmeta.PIXELS_QUERY:
            counted["pixels"] += 1
        return base(sql, params)

    started, stop, port_no = threading.Event(), threading.Event(), {}

    def server():
        loop = asyncio.new_event_loop()

        async def run():
            async with FakePg(rows_for=rows_for) as pg:
                port_no["n"] = pg.port
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
    r = pmeta.OmeroPostgresMetadataResolver(
        f"postgresql://omero:pw@127.0.0.1:{port_no['n']}/omero", enforce_permissions=True)
    fired = []
    r.add_invalidation_listener(fired.append)
    try:
        assert r.get_pixels(1, session_key="alice-key") is not None
        assert r.get_pixels(1, session_key="bob-key") is None  # private: 404
        assert r.get_pixels_unchecked(1) is not None
        assert counted["pixels"] == 1  # cached per image
        r.invalidate(1)
        assert fired == [1]
        assert r.get_pixels_unchecked(1) is not None
        assert counted["pixels"] == 2
    finally:
        r.close_sync()
        stop.set()
        t.join(5)


@pytest.mark.parametrize("flag,enforced", [
    (True, True), (False, False), ("false", False), ("0", False), ("no", False),
    ("off", False), (" Off ", False), ("true", True), ("1", True), ("yes", True), (0, False),
])
def test_enforce_permissions_flag_read_as_jax_reads_it(flag, enforced):
    from omero_ms_pixel_buffer_tpu_torch.http.server import _pixels_service
    from omero_ms_pixel_buffer_tpu_torch.utils.config import Config

    config = Config.from_dict({
        "session-store": {"type": "memory"},
        "omero.server": {"omero.db.uri": "postgresql://omero@127.0.0.1:1/omero",
                         "omero.db.enforce-permissions": flag}})
    svc = _pixels_service(config, "cpu")
    try:
        assert svc.metadata_resolver.enforce_permissions is enforced
        # the JAX wiring's rule, spelled as it spells it
        assert (str(flag).strip().lower() not in ("false", "0", "no", "off")) is enforced
    finally:
        svc.metadata_resolver.close_sync()
