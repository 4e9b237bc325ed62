"""The port's stores, fetch planner and resilience pieces (``io/stores.py``,
``io/fetch.py``, ``resilience/``) against the JAX package's: the same
bytes from ``FileStore``, ``HTTPStore`` (a local ``ThreadingHTTPServer``)
and ``S3Store`` (the SigV4-checking S3 stub of ``tests/test_zarr_stores``,
which verifies with the JAX signer), the same coalescing plans, SigV4
headers for a fixed time, rejected keys, credential resolution, retry
schedules and breaker states under an injected clock. Inputs are made
from a seed with numpy; tolerance zero throughout."""

import datetime
import os
import random

import numpy as np
import pytest

from test_zarr_stores import ACCESS_KEY, SECRET_KEY, _DirHandler, _FakeS3Handler, _serve_dir

from omero_ms_pixel_buffer_tpu.io import fetch as jfetch
from omero_ms_pixel_buffer_tpu.io import stores as jstores
from omero_ms_pixel_buffer_tpu.io.zarr import write_ngff
from omero_ms_pixel_buffer_tpu.resilience import breaker as jbreaker
from omero_ms_pixel_buffer_tpu.resilience import retry as jretry
from omero_ms_pixel_buffer_tpu_torch.io import fetch as pfetch
from omero_ms_pixel_buffer_tpu_torch.io import stores as pstores
from omero_ms_pixel_buffer_tpu_torch.io.zarr import ZarrPixelBuffer
from omero_ms_pixel_buffer_tpu_torch.resilience import breaker as pbreaker
from omero_ms_pixel_buffer_tpu_torch.resilience import retry as pretry

IMG = np.random.default_rng(71).integers(0, 60000, (1, 2, 1, 100, 120), dtype=np.uint16)


@pytest.fixture(autouse=True)
def fresh_breakers():
    """Breakers are process-wide in both packages: each test starts clean."""
    jbreaker.BOARD.reset()
    pbreaker.BOARD.reset()
    yield
    jbreaker.BOARD.reset()
    pbreaker.BOARD.reset()


@pytest.fixture(scope="module")
def hierarchy(tmp_path_factory):
    """One directory with a v2 blosc-lz4 image and a v3 sharded one."""
    root = tmp_path_factory.mktemp("stores")
    write_ngff(str(root / "v2.zarr"), IMG, chunks=(32, 32), levels=2, compressor="blosc-lz4")
    write_ngff(str(root / "v3.zarr"), IMG, chunks=(32, 32), levels=2, compressor="blosc-lz4",
               zarr_format=3, shards=(64, 64))
    return str(root)


@pytest.fixture(scope="module")
def http_root(hierarchy):
    server = _serve_dir(hierarchy, _DirHandler)
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()


@pytest.fixture(scope="module")
def s3_endpoint(hierarchy):
    server = _serve_dir(hierarchy, _FakeS3Handler)
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()


@pytest.fixture
def s3_env(monkeypatch, s3_endpoint, tmp_path):
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", ACCESS_KEY)
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", SECRET_KEY)
    monkeypatch.setenv("AWS_REGION", "us-east-1")
    monkeypatch.setenv("OMPB_S3_ENDPOINT", s3_endpoint)
    monkeypatch.setenv("AWS_SHARED_CREDENTIALS_FILE", str(tmp_path / "none"))
    monkeypatch.setenv("AWS_CONFIG_FILE", str(tmp_path / "none"))
    monkeypatch.delenv("OMPB_S3_403_AS_MISSING", raising=False)
    return s3_endpoint


def _store_pair(kind, hierarchy, http_root, image):
    if kind == "file":
        uri = os.path.join(hierarchy, image)
    elif kind == "http":
        uri = f"{http_root}/{image}"
    else:
        uri = f"s3://{_FakeS3Handler.bucket}/{image}"
    return jstores.make_store(uri), pstores.make_store(uri)


KEYS = [".zattrs", "0/.zarray", "0/0.0.0.0.0", "0/0.1.0.3.3", "1/0.0.0.1.1", "0/9.9.9.9.9",
        "nope/.zarray"]
RANGES = [(0, 16), (5, 100), (-40, 40), (100, None), (0, 1), (3, 10_000)]


@pytest.mark.parametrize("kind", ["file", "http", "s3"])
def test_stores_give_the_jax_bytes(kind, hierarchy, http_root, s3_env):
    jst, pst = _store_pair(kind, hierarchy, http_root, "v2.zarr")
    assert pst.describe() == jst.describe()
    for key in KEYS:
        assert pst.get(key) == jst.get(key), key
    for start, length in RANGES:
        for key in ("0/0.0.0.0.0", "0/.zarray"):
            assert pst.get_range(key, start, length) == jst.get_range(key, start, length)
    reqs = [pfetch.RangeReq(k) for k in KEYS] + [
        pfetch.RangeReq("0/0.0.0.0.0", s, n) for s, n in RANGES]
    jreqs = [jfetch.RangeReq(r.key, r.start, r.length) for r in reqs]
    assert pst.get_many(reqs) == jst.get_many(jreqs)


@pytest.mark.parametrize("kind", ["file", "http", "s3"])
@pytest.mark.parametrize("image", ["v2.zarr", "v3.zarr"])
def test_zarr_over_every_store(kind, image, hierarchy, http_root, s3_env):
    _, pst = _store_pair(kind, hierarchy, http_root, image)
    buf = ZarrPixelBuffer(pst.describe() if kind != "file" else os.path.join(hierarchy, image))
    coords = [(0, 1, 0, 5, 7, 100, 80), (0, 0, 0, 64, 32, 56, 68)]
    for (z, c, t, x, y, w, h), tile in zip(coords, buf.read_tiles(coords)):
        np.testing.assert_array_equal(tile, IMG[t, c, z, y:y + h, x:x + w])
    lv1 = buf.read_tiles([(0, 0, 0, 0, 0, 60, 50)], level=1)[0]
    np.testing.assert_array_equal(lv1, IMG[0, 0, 0, ::2, ::2])


@pytest.mark.parametrize("seed", range(6))
def test_coalesce_plans_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = 40
    starts = rng.integers(0, 1 << 22, n)
    lengths = rng.integers(1, 1 << 17, n)
    reqs = [pfetch.RangeReq("k", int(s), int(n_)) for s, n_ in zip(starts, lengths)]
    jreqs = [jfetch.RangeReq("k", int(s), int(n_)) for s, n_ in zip(starts, lengths)]
    order = list(rng.permutation(n))
    gap = int(rng.choice([0, 4096, 64 << 10, 1 << 20]))
    got = [(p.key, p.start, p.end, p.members) for p in pfetch._coalesce(reqs, order, gap)]
    want = [(p.key, p.start, p.end, p.members) for p in jfetch._coalesce(jreqs, order, gap)]
    assert got == want


def test_fetch_many_counts_match_jax(hierarchy):
    jst, pst = jstores.FileStore(hierarchy), pstores.FileStore(hierarchy)
    key = "v3.zarr/0/c/0/0/0/0/0"
    size = len(pst.get(key))
    spans = [(0, 100), (100, 50), (300, 64), (size - 16, 16), (-16, 16), (0, None), (0, 100)]
    reqs = [pfetch.RangeReq(key, s, n) for s, n in spans] + [pfetch.RangeReq("absent")]
    jreqs = [jfetch.RangeReq(r.key, r.start, r.length) for r in reqs]
    pst_stats, jst_stats = pfetch.FetchStats(), jfetch.FetchStats()
    assert pst.get_many(reqs, stats=pst_stats) == jst.get_many(jreqs, stats=jst_stats)
    want = jst_stats.snapshot()
    got = pst_stats.snapshot()
    assert {k: got[k] for k in want} == want
    assert set(got) - set(want) == {"tiles", "requests_per_tile", "decodes"}


def test_io_snapshot_shape_matches_jax():
    got, want = pfetch.io_snapshot(), jfetch.io_snapshot()
    assert set(want) <= set(got)
    assert got["config"] == want["config"]
    assert set(got["pool"]) == set(want["pool"])


SIGV4_CASES = [
    dict(method="GET", host="bucket.s3.us-east-1.amazonaws.com", canonical_uri="/img.zarr/0/.zarray",
         region="us-east-1", access_key="AKIA1", secret_key="s/ecret"),
    dict(method="GET", host="127.0.0.1:9000", canonical_uri="/b/a%20b/0.0", region="eu-west-1",
         access_key="AKIA2", secret_key="x", session_token="tok",
         extra_headers={"Range": "bytes=-20"}),
    dict(method="PUT", host="h", canonical_uri="/b/k", region="us-east-1", access_key="A",
         secret_key="S", payload_sha256="ab" * 32, query={"partNumber": 2, "uploadId": "u~1"}),
]


@pytest.mark.parametrize("case", range(len(SIGV4_CASES)))
def test_sigv4_headers_match_jax_for_a_fixed_time(case):
    now = datetime.datetime(2026, 3, 14, 15, 9, 26, tzinfo=datetime.timezone.utc)
    kw = SIGV4_CASES[case]
    assert pstores.sigv4_headers(now=now, **kw) == jstores.sigv4_headers(now=now, **kw)


BAD_KEYS = ["/etc/passwd", "\\x", "C:\\win", "x:y", "../up", "a/../../b", "a\\..\\b", ".."]
GOOD_KEYS = ["0/.zarray", "a..b/c", "c/0/0", "...", "ab:c"]


@pytest.mark.parametrize("key", BAD_KEYS + GOOD_KEYS)
def test_validate_key_rejects_the_same_keys(key):
    try:
        jstores.validate_key(key)
        jax_ok = True
    except jstores.StoreError:
        jax_ok = False
    if jax_ok:
        assert pstores.validate_key(key) == key
    else:
        with pytest.raises(pstores.StoreError):
            pstores.validate_key(key)
    assert jax_ok == (key in GOOD_KEYS)


def test_s3_wrong_secret_and_403_as_missing(s3_env, monkeypatch):
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "wrong")
    uri = f"s3://{_FakeS3Handler.bucket}/v2.zarr"
    with pytest.raises(pstores.StoreError, match="403"):
        pstores.S3Store(uri).get("0/.zarray")
    monkeypatch.setenv("OMPB_S3_403_AS_MISSING", "1")
    assert pstores.S3Store(uri).get("0/.zarray") is None
    assert jstores.S3Store(uri).get("0/.zarray") is None


def test_credentials_resolve_as_jax(tmp_path, monkeypatch):
    cred, conf = tmp_path / "credentials", tmp_path / "config"
    cred.write_text("[default]\naws_access_key_id = FILEKEY\naws_secret_access_key = FILE%SECRET\n"
                    "[other]\naws_access_key_id = K2\naws_secret_access_key = S2\n"
                    "aws_session_token = T2\n")
    conf.write_text("[default]\nregion = ap-south-1\n[profile other]\nregion = eu-north-1\n")
    monkeypatch.setenv("AWS_SHARED_CREDENTIALS_FILE", str(cred))
    monkeypatch.setenv("AWS_CONFIG_FILE", str(conf))
    for var in ("AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY", "AWS_SESSION_TOKEN", "AWS_REGION",
                "AWS_DEFAULT_REGION", "AWS_PROFILE", "OMPB_S3_ENDPOINT"):
        monkeypatch.delenv(var, raising=False)
    for profile in (None, "other", "missing"):
        assert (pstores.load_shared_credentials(profile)
                == jstores.load_shared_credentials(profile))
    for kw in ({}, {"read_files_for_region": True}, {"prefer_files": True}):
        assert pstores._resolve_credentials(**kw) == jstores._resolve_credentials(**kw)
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "ENVKEY")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "ENVSECRET")
    monkeypatch.setenv("AWS_SESSION_TOKEN", "ENVTOKEN")
    for kw in ({}, {"read_files_for_region": True}, {"prefer_files": True}):
        assert pstores._resolve_credentials(**kw) == jstores._resolve_credentials(**kw)
    p, j = pstores.S3Store("s3://bkt/pre/fix"), jstores.S3Store("s3://bkt/pre/fix")
    assert (p.region, p._base, p.prefix, p._creds) == (j.region, j._base, j.prefix, j._creds)


def test_make_store_dispatch(tmp_path, monkeypatch):
    monkeypatch.delenv("OMPB_S3_ENDPOINT", raising=False)
    for uri, cls in ((str(tmp_path), "FileStore"), ("http://h/x", "HTTPStore"),
                     ("https://h/x", "HTTPStore"), ("s3://b/p", "S3Store")):
        assert type(pstores.make_store(uri)).__name__ == type(jstores.make_store(uri)).__name__ == cls
    with pytest.raises(ValueError):
        pstores.S3Store("http://not-s3")


def _events(seed, n=200):
    """A seeded event sequence: (op, clock advance)."""
    rng = random.Random(seed)
    ops = ["allow", "ok", "fail", "fail", "fail"]
    return [(rng.choice(ops), rng.choice([0.0, 0.5, 3.0, 31.0])) for _ in range(n)]


def _drive(mod, events):
    now = [0.0]
    b = mod.CircuitBreaker("dep", clock=lambda: now[0])
    trace = []
    for op, dt in events:
        now[0] += dt
        outcome = None
        if op == "allow":
            try:
                b.allow()
                outcome = "admitted"
            except mod.BreakerOpenError as e:
                outcome = ("rejected", round(e.retry_after_s, 6))
        elif op == "ok":
            b.record_success()
        else:
            b.record_failure()
        snap = b.snapshot()
        trace.append((b.state, outcome, snap["consecutive_failures"], snap["window_failures"],
                      snap["window_size"], snap["rejected_total"], snap["opened_total"]))
    return trace


@pytest.mark.parametrize("seed", range(8))
def test_breaker_states_match_jax_under_an_injected_clock(seed):
    events = _events(seed)
    assert _drive(pbreaker, events) == _drive(jbreaker, events)


def test_breaker_board_reuses_and_resets():
    a = pbreaker.for_dependency("store:x")
    assert pbreaker.for_dependency("store:x") is a
    assert pbreaker.BOARD.snapshot()["store:x"]["state"] == "closed"
    for _ in range(pbreaker.FAILURE_THRESHOLD):
        a.record_failure()
    assert pbreaker.BOARD.snapshot()["store:x"]["state"] == "open"
    pbreaker.BOARD.reset()
    assert pbreaker.BOARD.snapshot() == {} and a.state == "closed"
    assert pbreaker.for_dependency("store:x") is not a


@pytest.mark.parametrize("fail_times", [0, 1, 2, 5])
def test_retry_schedule_matches_jax(fail_times):
    def run(mod):
        calls, sleeps = [0], []

        def fn():
            calls[0] += 1
            if calls[0] <= fail_times:
                raise OSError("flaky")
            return "ok"

        try:
            out = mod.retry_call(fn, retryable=(OSError,), rng=random.Random(5),
                                 sleep=sleeps.append, name="dep")
        except OSError:
            out = "raised"
        return out, calls[0], sleeps

    assert run(pretry) == run(jretry)


def test_dead_http_store_opens_its_breaker_as_jax():
    """Connection refused: StoreError (retried, counted) until the fifth
    failure opens the breaker, then StoreUnavailableError without a
    connection, with the same retry-after."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    url = f"http://127.0.0.1:{port}/img.zarr"
    seq = []
    for mod in (pstores, jstores):
        store, kinds = mod.HTTPStore(url, timeout_s=2.0), []
        for _ in range(7):
            try:
                store.get("0/.zarray")
                kinds.append("ok")
            except mod.StoreUnavailableError as e:
                kinds.append(("unavailable", int(e.retry_after_s + 0.999)))
            except mod.StoreError:
                kinds.append("error")
        seq.append(kinds)
    assert seq[0] == seq[1]
    assert seq[0][:5] == ["error"] * 5 and seq[0][5] == ("unavailable", 30)
