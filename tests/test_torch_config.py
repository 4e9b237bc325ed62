"""The port's YAML config (``omero_ms_pixel_buffer_tpu_torch/utils/config.py``)
against the JAX package's on the same inputs: the shipped
``conf/config.yaml`` and every case of ``tests/test_config.py`` load to
equal ``dataclasses.asdict``; every leaf key of the shipped file, set to
each of a list of values, either loads to equal dicts in both or raises
``ConfigError`` with the same message in both; the env overrides; the JSON
reading without PyYAML. Then the port's wiring (``http/server.py``
``check_planes``, ``wire``): the default-on planes it lacks start absent,
each opt-in plane it lacks stops start-up with a ``ConfigError`` naming
the key, and a server built from a config with non-default knobs reports
them on ``/healthz``. Tolerance: zero (dicts and messages equal)."""

import copy
import dataclasses
import json

import pytest
import yaml

from omero_ms_pixel_buffer_tpu.utils import config as jconfig
from omero_ms_pixel_buffer_tpu_torch.utils import config as pconfig

SHIPPED = "conf/config.yaml"
with open(SHIPPED) as _f:
    SHIPPED_RAW = yaml.safe_load(_f)


def _outcome(module, raw):
    """("ok", asdict) or ("error", message) of ``Config.from_dict``."""
    try:
        return "ok", dataclasses.asdict(module.Config.from_dict(copy.deepcopy(raw)))
    except module.ConfigError as e:
        return "error", str(e)


def _same(raw):
    jax, port = _outcome(jconfig, raw), _outcome(pconfig, raw)
    assert port == jax
    return port


def test_shipped_config_loads_equal():
    port = dataclasses.asdict(pconfig.Config.load(SHIPPED))
    assert port == dataclasses.asdict(jconfig.Config.load(SHIPPED))
    assert port["session_store"]["type"] == "redis"


# the cases of tests/test_config.py, valid and invalid
CASES = {
    "defaults": {"session-store": {"type": "memory"}},
    "missing_store": {"port": 9000},
    "bad_store_type": {"session-store": {"type": "dynamo"}},
    "full_shape": {
        "port": 9090, "event-bus-send-timeout": 5000, "worker_pool_size": 4,
        "omero": {"host": "omero.example", "port": 4444},
        "session-store": {"type": "redis", "synchronicity": "async", "uri": "redis://h:6379/1"},
        "http-tracing": {"enabled": True, "zipkin-url": "http://z/api/v2"},
        "backend": {"engine": "jax", "batching": {"buckets": [128, 256], "max-batch": 8}},
    },
    "bad_engine": {"session-store": {"type": "memory"}, "backend": {"engine": "hots"}},
    "png_block": {"session-store": {"type": "memory"},
                  "backend": {"png": {"filter": "sub", "level": 3, "strategy": "default"}}},
    "png_queue_mode": {"session-store": {"type": "memory"},
                       "backend": {"png": {"queue-depth": 4, "device-deflate-mode": "rle"}}},
    "queue_depth_0": {"session-store": {"type": "memory"}, "backend": {"png": {"queue-depth": 0}}},
    "queue_depth_word": {"session-store": {"type": "memory"},
                         "backend": {"png": {"queue-depth": "deep"}}},
    "bad_deflate_mode": {"session-store": {"type": "memory"},
                         "backend": {"png": {"device-deflate-mode": "huffman"}}},
    "logging": {"session-store": {"type": "memory"},
                "logging": {"file": "/tmp/svc.log", "level": "debug", "retention-days": 3}},
    "bad_synchronicity": {"session-store": {"type": "memory", "synchronicity": "later"}},
    "ttl_zero": {"session-store": {"type": "memory"}, "omero": {"session-validation-ttl": 0}},
    "ttl_word": {"session-store": {"type": "memory"}, "omero": {"session-validation-ttl": "30s"}},
    "ttl_negative": {"session-store": {"type": "memory"}, "omero": {"session-validation-ttl": -1}},
    "empty_store_block": {"session-store": None},
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_config_cases_match_jax(name):
    _same(CASES[name])


def _leaves(d, prefix=()):
    for k, v in d.items():
        if isinstance(v, dict) and v and k != "omero.server":
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,)


# every leaf of the shipped file, and the keys it leaves commented out
LEAVES = sorted(set(_leaves(SHIPPED_RAW)) | {
    ("worker_pool_size",), ("image-registry",), ("http-tracing", "zipkin-url"),
    ("logging", "file"), ("logging", "level"), ("logging", "retention-days"),
    ("render", "lut-dir"), ("cache", "disk-dir"), ("jax", "compilation-cache-dir"),
    ("resilience", "request-budget-ms"), ("cluster", "members"), ("cluster", "self-url"),
    ("cluster", "virtual-nodes"), ("cluster", "peer-timeout-ms"), ("cluster", "l2", "uri"),
    ("cluster", "l2", "ttl-s"), ("cluster", "hedge", "enabled"), ("cluster", "secret"),
    ("cluster", "drain", "deadline-s"), ("cluster", "gossip", "fanout"),
    ("omero.server", "omero.db.uri"), ("cache", "bogus-key"), ("slo", "bogus-key"),
})
VALUES = ("x", -1, 0, 1, 2.5, True, None, [1, 2], {"a": 1}, "", 300)


def _set(raw, path, value):
    node = raw
    for k in path[:-1]:
        if not isinstance(node.get(k), dict):
            node[k] = {}
        node = node[k]
    node[path[-1]] = value


@pytest.mark.parametrize("path", LEAVES, ids=[".".join(p) for p in LEAVES])
def test_each_key_and_value_matches_jax(path):
    """Each value either loads to equal dicts in both packages or raises
    the same ``ConfigError`` message in both."""
    outcomes = set()
    for value in VALUES:
        raw = copy.deepcopy(SHIPPED_RAW)
        _set(raw, path, value)
        try:
            jax = _outcome(jconfig, raw)
        except Exception as e:  # a crash in the JAX parser: the port must crash alike
            with pytest.raises(type(e)):
                pconfig.Config.from_dict(copy.deepcopy(raw))
            outcomes.add("crash")
            continue
        assert _outcome(pconfig, raw) == jax, value
        outcomes.add(jax[0])
    assert outcomes


@pytest.mark.parametrize("env", [
    {"OMPB_PORT": "9123"},
    {"OMPB_SESSION_STORE": "postgres"},
    {"OMPB_SESSION_STORE": "memory", "OMPB_PORT": "1"},
    {"OMPB_SESSION_STORE": "nosuch"},
])
def test_env_overrides_match_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    def load(module):
        try:
            return "ok", dataclasses.asdict(module.Config.load(SHIPPED))
        except module.ConfigError as e:
            return "error", str(e)

    port = load(pconfig)
    assert port == load(jconfig)
    if "OMPB_PORT" in env and port[0] == "ok":
        assert port[1]["port"] == int(env["OMPB_PORT"])


def test_default_memory_store_and_missing_file_match_jax(tmp_path):
    missing = str(tmp_path / "absent.yaml")
    for kw in ({}, {"default_memory_store": True}):
        def load(module):
            try:
                return "ok", dataclasses.asdict(module.Config.load(missing, **kw))
            except module.ConfigError as e:
                return "error", str(e)

        assert load(pconfig) == load(jconfig)


def test_json_subset_reads_without_pyyaml(monkeypatch, tmp_path):
    """Without PyYAML the port reads a file in YAML's JSON subset with
    ``json``; any other file fails with the JAX message."""
    as_json = tmp_path / "config.json.yaml"
    as_json.write_text(json.dumps(SHIPPED_RAW))
    want = dataclasses.asdict(jconfig.Config.load(str(as_json)))
    monkeypatch.setattr(pconfig, "yaml", None)
    assert dataclasses.asdict(pconfig.Config.load(str(as_json))) == want
    monkeypatch.setattr(jconfig, "yaml", None)
    with pytest.raises(jconfig.ConfigError) as jerr:
        jconfig.Config.load(SHIPPED)
    with pytest.raises(pconfig.ConfigError) as perr:
        pconfig.Config.load(SHIPPED)
    assert str(perr.value) == str(jerr.value)


def test_logging_setup_matches_jax(tmp_path):
    import logging

    from omero_ms_pixel_buffer_tpu_torch.utils.logging_setup import FORMAT, configure_logging
    from omero_ms_pixel_buffer_tpu.utils.logging_setup import FORMAT as JFORMAT

    assert FORMAT == JFORMAT
    cfg = pconfig.Config.from_dict({
        "session-store": {"type": "memory"},
        "logging": {"file": str(tmp_path / "svc.log"), "level": "debug", "retention-days": 3}})
    configure_logging(cfg.logging)
    try:
        logging.getLogger("t").info("hello rolling file")
        handler = logging.getLogger().handlers[0]
        handler.flush()
        assert "hello rolling file" in (tmp_path / "svc.log").read_text()
        assert handler.backupCount == 3
    finally:
        configure_logging(type(cfg.logging)())


# -- the port's wiring ----------------------------------------------------------------

def _raw(**blocks):
    """The shipped config's dict with each ``a__b`` key set."""
    raw = copy.deepcopy(SHIPPED_RAW)
    for key, value in blocks.items():
        _set(raw, tuple(key.split("__")), value)
    return raw


def _config(**blocks):
    return pconfig.Config.from_dict(_raw(**blocks))


def test_shipped_config_starts_with_five_planes_absent():
    from omero_ms_pixel_buffer_tpu_torch.http.server import check_planes

    # every default-on plane is ported (the session plane last): none is
    # left absent
    assert check_planes(pconfig.Config.load(SHIPPED)) == []
    quiet = _config(obs__enabled=False, session__enabled=False, **{
        "jmx-metrics__enabled": False, "cache__tinylfu__enabled": False,
        "cache__prefetch__enabled": False})
    assert check_planes(quiet) == []


@pytest.mark.parametrize("key,value,named", [
    ("backend__engine", "host", "backend.engine"),
    ("backend__batching__device-encode", False, "backend.batching.device-encode"),
    ("cache__enabled", False, "cache.enabled"),
    ("slo__enabled", False, "slo.enabled"),
    ("backend__png__filter", "paeth", "backend.png.filter"),
    ("backend__png__level", 9, "backend.png.level"),
    ("backend__png__strategy", "default", "backend.png.strategy"),
])
def test_opt_in_planes_stop_startup(key, value, named, restore_process_state):
    """The values the port once refused at start-up (the whole-host
    engine, the cache and the scheduler turned off, a PNG policy other
    than ``up``/6/``fast``) now start: ``check_planes`` passes them, and
    ``wire`` builds what the JAX app builds for them (the host engine with
    no device object; no result cache, single-flight or prefetcher; no
    scheduler or sweep detector; the policy in the pipeline and its cache
    key). Serving under each value is held against the JAX app in
    ``test_torch_host_engine.py``, ``test_torch_planes_off.py`` and
    ``test_torch_png_policy.py``."""
    from omero_ms_pixel_buffer_tpu_torch.http.server import check_planes, wire

    config = _config(**{key: value})  # a valid config to both parsers
    assert dataclasses.asdict(config) == dataclasses.asdict(
        jconfig.Config.from_dict(_raw(**{key: value})))
    assert check_planes(config) == []
    server = wire(config, device="cpu")
    try:
        pipe, health = server.pipeline, server.health()
        host = named in ("backend.engine", "backend.batching.device-encode")
        assert pipe.engine == ("host" if host else "device")
        assert (pipe.dispatcher is None) == host and (health["plane_cache"] is None) == host
        assert (server.cache is None) == (named == "cache.enabled")
        assert (server.prefetcher is None) == (named == "cache.enabled")
        assert (health["result_cache"] == {"enabled": False}) == (named == "cache.enabled")
        assert (server.scheduler is None) == (named == "slo.enabled")
        assert (health["slo"] == {"enabled": False}) == (named == "slo.enabled")
        png = config.backend.png
        assert pipe.encode_signature() == f"{png.filter}.{png.level}.{png.strategy}"
        assert health["config"]["png"] == {"filter": png.filter, "level": png.level,
                                           "strategy": png.strategy}
    finally:
        server.pipeline.close()


@pytest.mark.parametrize("key,value", [
    ("backend__png__level", "abc"),
    ("backend__engine", "gpu"),
    ("backend__png__filter", "bogus"),
    ("backend__png__strategy", "bogus"),
], ids=["level-not-an-integer", "unknown-engine", "unknown-filter", "unknown-strategy"])
def test_invalid_png_policy_answers_as_jax(key, value, tmp_path):
    """An invalid value answers as the JAX package does: the parser's
    exception and message where the JAX ``Config`` refuses it (a level
    that is not an integer, an unknown engine); where it accepts it (an
    unknown filter or strategy: the JAX ``Config`` checks neither), the
    same lone PNG request gives the same answer in both pipelines (None,
    a 404, for an unknown filter; zlib's default strategy for an unknown
    one)."""
    raw = _raw(**{key: value})
    try:
        jconfig.Config.from_dict(copy.deepcopy(raw))
    except Exception as e:
        with pytest.raises(Exception) as got:
            pconfig.Config.from_dict(copy.deepcopy(raw))
        assert (type(got.value).__name__, str(got.value)) == (type(e).__name__, str(e))
        return
    import numpy as np

    from omero_ms_pixel_buffer_tpu.io.ometiff import write_ome_tiff
    from omero_ms_pixel_buffer_tpu.io.pixels_service import ImageRegistry as JaxRegistry
    from omero_ms_pixel_buffer_tpu.io.pixels_service import PixelsService as JaxService
    from omero_ms_pixel_buffer_tpu.models.tile_pipeline import TilePipeline as JaxPipeline
    from omero_ms_pixel_buffer_tpu.tile_ctx import RegionDef as JaxRegion
    from omero_ms_pixel_buffer_tpu.tile_ctx import TileCtx as JaxCtx
    from omero_ms_pixel_buffer_tpu_torch.io.pixels_service import ImageRegistry, PixelsService
    from omero_ms_pixel_buffer_tpu_torch.models.tile_pipeline import TilePipeline
    from omero_ms_pixel_buffer_tpu_torch.tile_ctx import RegionDef, TileCtx

    png = pconfig.Config.from_dict(copy.deepcopy(raw)).backend.png
    path = str(tmp_path / "img.ome.tiff")
    write_ome_tiff(path, np.arange(64 * 96, dtype=np.uint16).reshape(1, 1, 1, 64, 96))
    jreg, reg = JaxRegistry(), ImageRegistry()
    jreg.add(1, path)
    reg.add(1, path)
    policy = dict(png_filter=png.filter, png_level=png.level, png_strategy=png.strategy)
    jax_pipe = JaxPipeline(JaxService(jreg), engine="host", **policy)
    port = TilePipeline(PixelsService(reg), device="cpu", **policy)
    try:
        want = jax_pipe.handle(JaxCtx(1, 0, 0, 0, JaxRegion(0, 0, 64, 48), format="png"))
        got = port.handle(TileCtx(1, 0, 0, 0, RegionDef(0, 0, 64, 48), format="png"))
        assert got == want
        assert (got is None) == (key == "backend__png__filter")
    finally:
        jax_pipe.close()
        port.close()


@pytest.mark.parametrize("key,value,named", [
    ("ingest__enabled", True, "ingest.enabled"),
    ("mesh__probe-interval-ms", 500, "mesh.probe-interval-ms"),
])
def test_once_refused_planes_start(key, value, named, restore_process_state):
    """``ingest.enabled`` and ``mesh.probe-interval-ms`` (refused until the
    write and multi-device planes were ported) start from the shipped
    config: ``check_planes`` passes them, and the ingest plane (its routes'
    bounds, ``/healthz`` ``ingest``) or the background mesh prober is
    built."""
    from omero_ms_pixel_buffer_tpu_torch.http.server import check_planes, wire

    config = _config(**{key: value})
    assert check_planes(config) == []
    server = wire(config, device="cpu")
    try:
        health = server.health()
        if named == "ingest.enabled":
            assert server.ingest is not None and health["ingest"]["enabled"] is True
            assert health["ingest"]["staging_bytes"] == 256 << 20
            assert server.max_body == (256 << 20) + 65536
        else:
            assert server.mesh_prober is not None and server.mesh_prober.interval_s == 0.5
            assert health["ingest"] == {"enabled": False}
    finally:
        server.pipeline.close()


@pytest.mark.parametrize("cluster", [
    {"members": ["http://127.0.0.1:8082", "http://127.0.0.1:8083"],
     "self": "http://127.0.0.1:8083", "secret": "s", "replication-factor": 2,
     "repair": {"interval-s": 5}, "hedge": {"enabled": True}},
    {"l2": {"uri": "redis://127.0.0.1:6379/2"}},
], ids=["static-ring", "l2-only"])
def test_static_fleet_config_starts(cluster, restore_process_state):
    """``cluster.members`` and ``cluster.l2.uri`` (once refused) start the
    fleet plane: the ring, the L2 tier, the drain and the knobs reach it."""
    from omero_ms_pixel_buffer_tpu_torch.http.server import check_planes, wire

    config = _config(cluster=cluster)
    assert check_planes(config) == []
    server = wire(config, device="cpu")
    try:
        plane = server.cache_plane
        assert plane is not None and server.drainer is not None
        assert (plane.ring is None) == ("members" not in cluster)
        assert (plane.l2 is None) == ("l2" not in cluster)
        view = server.health()["cluster"]
        assert view["authenticated"] == ("secret" in cluster)
        assert view["drain"]["state"] == "serving"
        if "members" in cluster:
            assert plane.ring.members == cluster["members"]
            assert plane.replicator.replication_factor == 2
            assert plane.repairer.interval_s == 5 and plane.hedge is not None
    finally:
        server.pipeline.close()


@pytest.mark.parametrize("mode", ["lease", "gossip"])
async def test_membership_config_starts_and_serves(mode, restore_process_state):
    """``cluster.lease-ttl-s`` > 0 and ``cluster.gossip.enabled`` (once
    refused) start the plane with its membership manager and the fleet
    brains; the replica serves ``/healthz`` with the membership view, and
    the lease lands in the shared Redis (the port's RESP stub)."""
    import asyncio

    from omero_ms_pixel_buffer_tpu_torch.cache.plane.resp_stub import InMemoryRespServer
    from omero_ms_pixel_buffer_tpu_torch.cluster import (
        FleetBrains, GossipManager, MembershipManager)
    from omero_ms_pixel_buffer_tpu_torch.http.server import check_planes, wire

    stub = InMemoryRespServer()
    await stub.start()
    cluster = {"members": ["http://127.0.0.1:1"], "self": "http://127.0.0.1:1",
               "l2": {"uri": stub.uri}, "secret": "s"}
    cluster.update({"lease-ttl-s": 0.6} if mode == "lease"
                   else {"gossip": {"enabled": True, "interval-s": 0.1}})
    config = _config(cluster=cluster)
    assert check_planes(config) == []
    server = wire(config, device="cpu")
    try:
        port = await server.start("127.0.0.1", 0)
        plane = server.cache_plane
        assert isinstance(plane.membership,
                          MembershipManager if mode == "lease" else GossipManager)
        assert isinstance(plane.brains, FleetBrains)
        key = b"ompb:cluster:member:http://127.0.0.1:1"
        for _ in range(200):
            if key in stub.data:
                break
            await asyncio.sleep(0.01)
        assert key in stub.data
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(b"GET /healthz HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n")
        raw = await reader.read()
        writer.close()
        assert raw.startswith(b"HTTP/1.1 200 OK")
        view = json.loads(raw.partition(b"\r\n\r\n")[2])
        assert view["cluster"]["gossip"] == (mode == "gossip")
        assert view["cluster"]["membership"]["members"] == ["http://127.0.0.1:1"]
        assert set(view["cluster"]["brains"]) >= {"fleet_pressure", "demoted"}
        assert {"fleet_pressure", "fleet_engaged"} <= set(view["slo"])
    finally:
        await server.close()
        server.pipeline.close()
        await stub.close()


@pytest.mark.parametrize("key,value", [
    ("http-tracing__enabled", True),
    ("http-tracing__zipkin-url", "http://127.0.0.1:9/api/v2/spans"),
])
def test_tracing_keys_start_and_configure_the_tracer(key, value, restore_process_state):
    """The two tracing keys once refused: ``http-tracing.enabled`` turns
    live spans on (logged without a URL); ``zipkin-url`` with the recorder
    on builds the Zipkin reporter for the kept records' retro spans."""
    from omero_ms_pixel_buffer_tpu_torch.http.server import check_planes, wire
    from omero_ms_pixel_buffer_tpu_torch.utils import tracing

    config = _config(**{key: value})
    assert check_planes(config) == []
    server = wire(config, device="cpu")
    try:
        if key == "http-tracing__enabled":
            assert tracing.TRACER.enabled and tracing.TRACER.log_spans
            assert tracing.TRACER.reporter is None
        else:
            assert not tracing.TRACER.enabled
            assert tracing.TRACER.reporter.url == value
            assert server.recorder is not None
    finally:
        server.pipeline.close()
        tracing.configure(enabled=False, log_spans=False)


@pytest.mark.parametrize("engine", ["jax", "auto", "device", "tpu"])
def test_engine_names_mean_the_device_engine(engine):
    from omero_ms_pixel_buffer_tpu_torch.http.server import check_planes

    check_planes(_config(backend__engine=engine))


@pytest.fixture
def restore_process_state():
    """``wire`` configures the breaker board, the retry policy, the I/O
    timeout and the read plane process-wide: put the defaults back."""
    from omero_ms_pixel_buffer_tpu_torch.io import fetch
    from omero_ms_pixel_buffer_tpu_torch.resilience import breaker, configure

    yield
    default = pconfig.Config.from_dict({"session-store": {"type": "memory"}})
    configure(default.resilience)
    fetch.configure(default.io)
    breaker.BOARD.reset()


@pytest.mark.parametrize("manifest", [True, False], ids=["manifest", "no-manifest"])
def test_disk_tier_starts_with_the_cache(tmp_path, manifest, restore_process_state):
    """``cache.disk-dir`` (once refused) starts the disk tier: the
    directory, ``disk-mb`` and ``manifest`` reach the tiered cache."""
    from omero_ms_pixel_buffer_tpu_torch.http.server import check_planes, wire

    spill = str(tmp_path / "spill")
    config = _config(**{"cache__disk-dir": spill, "cache__disk-mb": 7,
                        "cache__manifest": manifest})
    assert check_planes(config) == []
    server = wire(config, device="cpu")
    try:
        disk = server.cache.disk
        assert (disk.directory, disk.max_bytes) == (spill, 7 << 20)
        assert (disk.manifest is not None) == manifest
        view = server.health()["result_cache"]["disk"]
        assert view["breaker"] == "closed" and ("manifest" in view) == manifest
    finally:
        server.cache.close()
        server.pipeline.close()


@pytest.mark.parametrize("enabled", [True, False], ids=["on", "off"])
def test_session_keys_reach_the_plane(enabled, restore_process_state):
    """Every ``session:`` key reaches the registry, the annotation store or
    the pump (the JAX ``PixelBufferApp`` wiring); ``enabled: false``
    builds neither."""
    from omero_ms_pixel_buffer_tpu_torch.http.server import wire

    config = _config(**{"session__enabled": enabled, "session__max-channels": 9,
                        "session__max-per-image": 4, "session__queue-size": 5,
                        "session__ping-interval-s": 2.5,
                        "session__max-annotations-per-image": 7,
                        "session__max-annotation-images": 11})
    server = wire(config, device="cpu")
    try:
        reg, store = server.session_channels, server.annotations
        if not enabled:
            assert reg is None and store is None
            assert server.health()["session"] == {"enabled": False}
            return
        assert (reg.max_channels, reg.max_per_image, reg.queue_size) == (9, 4, 5)
        assert reg.recorder is server.recorder and server.ping_interval_s == 2.5
        assert (store.max_per_image, store.max_images) == (7, 11)
        assert server.health()["session"]["max_channels"] == 9
    finally:
        server.pipeline.close()


def test_non_default_knobs_show_on_healthz(restore_process_state):
    from omero_ms_pixel_buffer_tpu_torch.auth.stores import RedisSessionStore
    from omero_ms_pixel_buffer_tpu_torch.http.server import wire

    config = _config(**{
        "slo__queue-size": 128, "resilience__admission__max-inflight": 7,
        "resilience__breaker__failure-threshold": 3,
        "resilience__breaker__open-duration-ms": 2000,
        "resilience__io-timeout-ms": 1234, "resilience__request-budget-ms": 5000,
        "cache__memory-mb": 64, "cache__max-age-s": 30, "cache__etag-precheck": False,
        "backend__batching__max-batch": 8, "backend__batching__coalesce-window-ms": 5.0,
        "backend__batching__buckets": [128, 512], "backend__max-tile-mb": 64,
        "protocols__dzi__tile-size": 512, "protocols__iiif__enabled": False,
        "analysis__max-bins": 1024, "render__jpeg-quality": 75, "io__fetch-workers": 3,
        "supertile__min-lanes": 4, "worker_pool_size": 5,
        "backend__batching__burst-continuation__window-ms": 10.0,
    })
    server = wire(config, device="cpu")
    try:
        h = server.health()
        c = h["config"]
        assert h["slo"]["queue_size"] == 128
        assert h["admission"]["max_inflight"] == 7
        assert h["request_budget_ms"] == 5000.0
        assert c["absent"] == []
        assert c["session_store"] == "RedisSessionStore"
        assert isinstance(server.session_store, RedisSessionStore)
        assert c["breaker"]["failure_threshold"] == 3
        assert c["breaker"]["open_duration_s"] == 2.0
        assert c["io_timeout_ms"] == pytest.approx(1234.0)
        assert c["cache"]["memory_bytes"] == 64 << 20
        assert c["cache"]["max_age_s"] == 30 and c["cache"]["etag_precheck"] is False
        assert c["batching"] == {"buckets": [128, 512], "max_batch": 8,
                                 "coalesce_window_ms": 5.0, "burst_window_ms": 10.0,
                                 "workers": 5}
        assert c["max_tile_bytes"] == 64 << 20
        assert c["tile_sizes"]["dzi"] == 512 and not h["protocols"]["iiif"]
        assert c["analysis_max_bins"] == 1024 and c["jpeg_quality"] == 75
        assert c["supertile"]["limits"][1] == 4
        assert h["io"]["config"]["fetch_workers"] == 3
    finally:
        server.pipeline.close()
