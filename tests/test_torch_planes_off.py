"""``cache.enabled: false`` and ``slo.enabled: false`` through the port's
front against the JAX aiohttp app, both built from one config dict, on
the CPU.

- Cache off: 32 sequential repeats of one ``/tile`` PNG request and of one
  ``/render`` request each execute (lanes counted in both pipelines), no
  answer carries ``ETag``, ``Cache-Control`` or ``X-Cache``, an
  ``If-None-Match`` never answers 304, and ``/healthz`` reports the cache
  and the prefetcher as ``{"enabled": false}`` in both.
- SLO off: the binary door gate with ``resilience.admission.max-inflight``
  2 in front of a held pipeline: two requests hold the slots, four more
  answer 503 with the same ``Retry-After``, ``/healthz`` and ``/metrics``
  answer 200 meanwhile (status ``degraded``, two in flight, the sheds
  counted alike), and the held two answer 200 once released;
  ``/healthz`` ``slo`` is ``{"enabled": false}`` in both.

Each case runs with the other plane on and off. Tolerance: zero
(statuses, header values, bodies and counts)."""

import asyncio
import json
import threading

import numpy as np
import pytest

from omero_ms_pixel_buffer_tpu_torch.io.ometiff import write_ome_tiff
from test_torch_host_engine import (  # noqa: F401 - restore_process_state is a fixture
    COOKIE,
    ConfigFronts,
    base_config,
    restore_process_state,
)

SHAPE = (1, 2, 1, 128, 192)
TILE = "/tile/1/0/0/0?x=64&y=0&w=64&h=64&format=png"
RENDER = "/render/1/0/0/0?c=1|0:4000$FF0000,2|0:4000$00FF00&x=0&y=64&w=96&h=64"
PLANES = {
    "cache-off": {"cache": {"enabled": False}},
    "cache-off-slo-off": {"cache": {"enabled": False}, "slo": {"enabled": False}},
    "slo-off": {"slo": {"enabled": False}},
}


@pytest.fixture(scope="module")
def image_path(tmp_path_factory):
    data = np.random.default_rng(31).integers(0, 4096, SHAPE, dtype=np.uint16)
    path = str(tmp_path_factory.mktemp("planes_off") / "img.ome.tiff")
    write_ome_tiff(path, data, tile_size=(64, 64), compression="zlib")
    return path


class LaneCounter:
    """Counts the lanes a pipeline executes (``handle`` and
    ``handle_batch``), optionally holding each call until ``release``."""

    def __init__(self, pipeline, hold: bool = False):
        self.lanes = 0
        self.gate = threading.Event()
        if not hold:
            self.gate.set()
        handle, handle_batch = pipeline.handle, pipeline.handle_batch

        def counted_handle(ctx):
            self.lanes += 1
            self.gate.wait(30)
            return handle(ctx)

        def counted_batch(ctxs, *args, **kwargs):
            self.lanes += len(ctxs)
            self.gate.wait(30)
            return handle_batch(ctxs, *args, **kwargs)

        pipeline.handle, pipeline.handle_batch = counted_handle, counted_batch


@pytest.mark.parametrize("planes", [p for p in PLANES if p.startswith("cache-off")])
async def test_cache_off_executes_every_request_like_jax(image_path, planes,
                                                         restore_process_state):
    f = await ConfigFronts().start(base_config(**PLANES[planes]), {1: image_path})
    try:
        assert f.port.cache is None and f.port.prefetcher is None
        jax_n, port_n = LaneCounter(f.jax_app.pipeline), LaneCounter(f.port.pipeline)
        for url in (TILE, RENDER):
            for _ in range(32):
                status, hdrs, _ = await f.both("GET", url, COOKIE)
                assert status == 200
                assert not {"etag", "cache-control", "x-cache"} & set(hdrs)
            etag = "\"" + "0" * 16 + "\""
            status, _, _ = await f.both("GET", url, {**COOKIE, "If-None-Match": etag})
            assert status == 200
            await f.both("HEAD", url, COOKIE)
        assert port_n.lanes == jax_n.lanes == 2 * 34
        health = f.port.health()
        _, _, jax_body = await f.jax_request("GET", "/healthz")
        jax_health = json.loads(jax_body)
        assert health["result_cache"] == jax_health["cache"] == {"enabled": False}
        assert health["prefetch"] == jax_health["prefetch"] == {"enabled": False}
        if "slo-off" in planes:
            assert health["slo"] == jax_health["slo"] == {"enabled": False}
    finally:
        await f.close()


@pytest.mark.parametrize("planes", [p for p in PLANES if p.endswith("slo-off")])
async def test_slo_off_door_gate_sheds_like_jax(image_path, planes, restore_process_state):
    raw = base_config(**PLANES[planes], resilience={"admission": {"max-inflight": 2}})
    f = await ConfigFronts().start(raw, {1: image_path})
    try:
        assert f.port.scheduler is None and f.port.sweep_detector is None
        answers = {}
        for name, request, admission, pipeline in (
                ("jax", f.jax_request, f.jax_app.admission, f.jax_app.pipeline),
                ("port", f.port_request, f.port.admission, f.port.pipeline)):
            counter = LaneCounter(pipeline, hold=True)
            # raw tiles: the same bytes whether the two run as one batch
            # or one by one
            held = [asyncio.ensure_future(request("GET", f"/tile/1/0/0/0?x={x}&y=0&w=64&h=64",
                                                  COOKIE)) for x in (0, 64)]
            for _ in range(600):
                if admission.snapshot()["inflight"] == 2:
                    break
                await asyncio.sleep(0.01)
            assert admission.snapshot()["inflight"] == 2, name
            shed = await asyncio.gather(*(
                request("GET", f"/tile/1/0/0/0?x={x}&y=64&w=64&h=64&format=png", COOKIE)
                for x in (0, 64, 128, 0)))
            health = await request("GET", "/healthz")
            metrics = await request("GET", "/metrics")
            options = await request("OPTIONS", "/tile/1/0/0/0")
            counter.gate.set()
            done = await asyncio.gather(*held)
            answers[name] = (shed, health, metrics, options, done, counter.lanes,
                             admission.snapshot())
        jshed, jhealth, jmetrics, joptions, jdone, jlanes, jadm = answers["jax"]
        pshed, phealth, pmetrics, poptions, pdone, planes_n, padm = answers["port"]
        for want, got in zip(jshed, pshed):
            f.assert_alike(want, got, "shed")
            assert got[0] == 503 and got[1]["retry-after"] == "1"
            assert got[2] == b"Service overloaded"
        for want, got in zip(jdone, pdone):
            f.assert_alike(want, got, "held")
            assert got[0] == 200
        assert jhealth[0] == phealth[0] == 200 and jmetrics[0] == pmetrics[0] == 200
        assert joptions[0] == poptions[0] == 200
        jh, ph = json.loads(jhealth[2]), json.loads(phealth[2])
        assert jh["status"] == ph["status"] == "degraded"
        assert jh["admission"] == ph["admission"] == {"inflight": 2, "max_inflight": 2,
                                                      "shed_total": 4}
        assert jh["slo"] == ph["slo"] == {"enabled": False}
        assert planes_n == jlanes == 2
        assert padm == jadm
    finally:
        await f.close()
