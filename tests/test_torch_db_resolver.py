"""The port's OMERO image source (``db/resolver.py`` ``OmeroImageSource``:
image id -> pixels id -> fileset file or the ``Pixels/`` fan-out path
under ``omero.data.dir``, NGFF detection) and the ACL-scoped pixels
service over it, against the JAX package's on the same ``FakePg`` rows
and the same synthesized data directory (``data_dir`` and ``_rows_for``
from ``tests/test_db_resolver.py``): equal registry entries for every
layout, equal fan-out paths, and end to end equal PNG bytes from the
port's pipeline and the JAX one for a caller the ACL admits, 404 (None)
in both for one it does not, and the invalidation hook that drops the
open buffer and its device planes. Tolerance: zero (entries, paths,
bytes)."""

import asyncio
import threading

import numpy as np
import pytest

from omero_ms_pixel_buffer_tpu.db import resolver as jres
from omero_ms_pixel_buffer_tpu.db.metadata import (
    PIXELS_QUERY,
    SESSION_USER_QUERY,
    USER_GROUPS_QUERY,
)
from omero_ms_pixel_buffer_tpu_torch.db import resolver as pres

from test_db_resolver import TIFF_IMG, ZARR_IMG, ROMIO_IMG, _rows_for, data_dir  # noqa: F401
from test_postgres import FakePg
from test_scheduler import _png_pixels


@pytest.mark.parametrize("pixels_id", [0, 7, 999, 1000, 1001, 54321, 1234567, 10 ** 9 + 3])
def test_fanout_paths_match_jax(pixels_id):
    assert (pres.pixels_fanout_path("/OMERO", pixels_id)
            == jres.pixels_fanout_path("/OMERO", pixels_id))


def test_queries_match_jax():
    for name in ("FILESET_FILES_QUERY", "PIXELS_ID_QUERY", "REPO_ROOT_QUERY"):
        assert getattr(pres, name) == getattr(jres, name), name


def _full_rows(data_dir):  # noqa: F811 - the fixture's value
    """Files and fan-out (``_rows_for``), the metadata plane's pixels rows
    (user 2 owns every image in private group 3) and the ACL queries
    (alice is user 2, bob user 5, a member of group 3)."""
    base = _rows_for(data_dir)
    dims = {"1": ("101", "128", "96"), "2": ("201", "80", "64"), "3": ("301", "64", "48")}
    users = {"alice-key": "2", "bob-key": "5"}

    def rows(sql, params):
        if sql == PIXELS_QUERY:
            d = dims.get(params[0])
            if d is None:
                return []
            return [(d[0], d[1], d[2], "1", "1", "1", "uint16", f"img{params[0]}", "2", "3",
                     "-120", None, None, None, None)]
        if sql == SESSION_USER_QUERY:
            return [(users[params[0]],)] if params[0] in users else []
        if sql == USER_GROUPS_QUERY:
            return [("3", "f", "lab")]
        return base(sql, params)

    return rows


class _Db:
    """FakePg on a thread of its own, and both packages' image sources."""

    def __init__(self, data_dir, rows_for):  # noqa: F811
        self.started, self.stop, self.port = threading.Event(), threading.Event(), None
        self.thread = threading.Thread(target=self._serve, args=(rows_for,), daemon=True)
        self.thread.start()
        assert self.started.wait(5)
        uri = f"postgresql://omero:pw@127.0.0.1:{self.port}/omero"
        self.port_src = pres.OmeroImageSource(uri, data_dir)
        self.jax_src = jres.OmeroImageSource(uri, data_dir)

    def _serve(self, rows_for):
        loop = asyncio.new_event_loop()

        async def run():
            async with FakePg(rows_for=rows_for) as pg:
                self.port = pg.port
                self.started.set()
                while not self.stop.is_set():
                    await asyncio.sleep(0.02)

        try:
            loop.run_until_complete(run())
        finally:
            loop.close()

    def close(self):
        self.port_src.close_sync()
        self.jax_src.close_sync()
        self.stop.set()
        self.thread.join(5)


@pytest.fixture
def db(data_dir):  # noqa: F811
    d = _Db(data_dir, _full_rows(data_dir))
    yield d
    d.close()


@pytest.mark.parametrize("image", [1, 2, 3, 4, 5, 6, 7, 8, 99])
def test_entries_match_jax(db, image):
    got = db.port_src.entry(image)
    assert got == db.jax_src.entry(image)
    assert db.port_src.entry(image) == got  # the TTL cache answers alike
    if got is not None:
        assert db.port_src.resolve_path(got) == db.jax_src.resolve_path(got)


def _lanes(key):
    from omero_ms_pixel_buffer_tpu.tile_ctx import RegionDef as JR
    from omero_ms_pixel_buffer_tpu.tile_ctx import TileCtx as JC
    from omero_ms_pixel_buffer_tpu_torch.tile_ctx import RegionDef, TileCtx

    regions = [(1, (0, 0, 64, 64)), (1, (16, 8, 100, 80)), (2, (0, 0, 80, 64)),
               (2, (10, 5, 40, 40)), (3, (0, 0, 64, 48)), (3, (8, 8, 32, 16))]
    port = [TileCtx(i, 0, 0, 0, RegionDef(*r), format="png", omero_session_key=key)
            for i, r in regions]
    jax = [JC(i, 0, 0, 0, JR(*r), format="png", omero_session_key=key) for i, r in regions]
    return port, jax


def test_pipeline_png_from_the_database_matches_jax(db):
    """An image end to end from ``OmeroImageSource``: the PNG bytes of the
    port's pipeline equal the JAX pipeline's for the owner; a group member
    of a private group gets None (404) in both; each tile is the source."""
    from omero_ms_pixel_buffer_tpu.io.pixels_service import PixelsService as JS
    from omero_ms_pixel_buffer_tpu.models.tile_pipeline import TilePipeline as JP
    from omero_ms_pixel_buffer_tpu_torch.io.pixels_service import PixelsService
    from omero_ms_pixel_buffer_tpu_torch.models.tile_pipeline import TilePipeline

    jax = JP(JS(db.jax_src), engine="device", device_deflate=True, buckets=(64, 128))
    jax.mesh = None
    port = TilePipeline(PixelsService(db.port_src, device="cpu"), buckets=(64, 128),
                        device="cpu")
    try:
        assert port.pixels_service.metadata_resolver is db.port_src
        pctx, jctx = _lanes("alice-key")
        got, want = port.handle_batch(pctx), jax.handle_batch(jctx)
        assert got == want
        assert all(isinstance(b, bytes) and b[:4] == b"\x89PNG" for b in got)
        for ctx, body, src in zip(pctx, got, (TIFF_IMG, TIFF_IMG, ZARR_IMG, ZARR_IMG,
                                               ROMIO_IMG, ROMIO_IMG)):
            r = ctx.region
            np.testing.assert_array_equal(
                _png_pixels(body), src[0, 0, 0, r.y:r.y + r.height, r.x:r.x + r.width])
        pctx, jctx = _lanes("bob-key")
        assert port.handle_batch(pctx) == jax.handle_batch(jctx) == [None] * len(pctx)
        # one request of one lane takes the host route: the same bytes too
        pctx, jctx = _lanes("alice-key")
        assert port.handle(pctx[2]) == jax.handle(jctx[2])
    finally:
        port.close()
        jax.close()


def test_invalidation_drops_buffer_and_planes(db):
    from omero_ms_pixel_buffer_tpu_torch.io.pixels_service import PixelsService
    from omero_ms_pixel_buffer_tpu_torch.models.tile_pipeline import TilePipeline

    port = TilePipeline(PixelsService(db.port_src, device="cpu"), buckets=(64, 128),
                        device="cpu")
    try:
        buf = port.pixels_service.get_pixel_buffer(1, session_key="alice-key")
        assert buf is not None
        plane = port.plane_cache.get_plane(buf, 0, 0, 0, 0, read=port._stage_read)
        plane = port.plane_cache.get_plane(buf, 0, 0, 0, 0, read=port._stage_read)
        assert plane is not None and len(port.plane_cache) == 1
        port.pixels_service.block_cache[(buf.cache_ns, "x")] = np.zeros(4, np.uint8)
        fired = []
        db.port_src.metadata.add_invalidation_listener(fired.append)
        db.port_src.metadata.invalidate(1)
        assert fired == [1]
        port.invalidate_image(1)
        assert len(port.plane_cache) == 0
        assert port.pixels_service.block_cache.get((buf.cache_ns, "x")) is None
        assert port.pixels_service.get_pixel_buffer(1) is not buf
    finally:
        port.close()


def test_invalidation_stamps_and_purges_a_zarr_buffer(db):
    """On an NGFF buffer the hook stamps a new epoch on the open buffer
    (reads still holding it miss their next shard-index lookup) and drops
    its memoized shard indexes, then the buffer."""
    from omero_ms_pixel_buffer_tpu_torch.io.pixels_service import PixelsService
    from omero_ms_pixel_buffer_tpu_torch.io.zarr import ZarrPixelBuffer
    from omero_ms_pixel_buffer_tpu_torch.models.tile_pipeline import TilePipeline

    port = TilePipeline(PixelsService(db.port_src, device="cpu"), buckets=(64, 128),
                        device="cpu")
    try:
        buf = port.pixels_service.get_pixel_buffer(2, session_key="alice-key")
        assert isinstance(buf, ZarrPixelBuffer)
        calls = []
        note, purge = buf.note_epoch, buf.purge_shard_indexes
        buf.note_epoch = lambda epoch: calls.append(("epoch", epoch)) or note(epoch)
        buf.purge_shard_indexes = lambda: calls.append(("purge",)) or purge()
        port.invalidate_image(2)
        port.invalidate_image(2)  # nothing open: nothing stamped
        assert calls == [("epoch", 1), ("purge",)]
        assert port.pixels_service.get_pixel_buffer(2) is not buf
    finally:
        port.close()
