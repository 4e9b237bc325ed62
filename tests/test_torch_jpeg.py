"""The port's baseline JPEG decoder (``io/jpeg.py``) against the JAX
package's, and its torch IDCT against the JAX float and islow IDCTs.

- Pillow-made streams (grey; RGB at 4:4:4, 4:2:2 and 4:2:0; odd sizes;
  restart intervals; abbreviated streams seeded with tag-347 tables):
  the port's host decode equals JAX ``decode_jpeg`` with the native scan
  walker and with the Python loop (both packages' ``_native_engine``
  forced to None), and Pillow where the JAX tests require it.
  Tolerance: zero.
- Every hostile stream of the JAX ``tests/test_jpeg.py`` raises
  ``JpegError`` in both, with the same message.
- ``idct_blocks_torch`` on the CPU: within 1 count of JAX
  ``idct_blocks_device`` (run on the CPU) on seeded random blocks, and of
  ``idct_blocks_host`` (islow) on the blocks of real streams (random
  coefficients reach the clamp, where the float and islow IDCTs part by
  more: the JAX test allows 2 there). Device-mode decodes (``DeviceIdct``
  on the CPU) no further from host mode than the JAX device mode is from
  its own host mode on the same stream (1 grey, the JAX test's bound; 3
  RGB: see the test), and within 1 of the JAX device-mode decode. A
  failing device IDCT raises ``DeviceIdctError``, never a host decode.
- ``cuda``: the IDCT on the card within 1 of a float64 numpy IDCT, and
  equal whatever ``torch.backends.cuda.matmul.allow_tf32`` says (no
  TF32 can reach it).
"""

import io

import numpy as np
import pytest
import torch

from omero_ms_pixel_buffer_tpu_torch.io import jpeg as pj

rng = np.random.default_rng(71)
_YY, _XX = np.mgrid[0:208, 0:240].astype(np.float32)
GRAY = (128 + 60 * np.sin(_XX / 13) + 50 * np.cos(_YY / 17)
        + rng.normal(0, 6, (208, 240))).clip(0, 255).astype(np.uint8)
RGB = np.stack([GRAY, np.roll(GRAY, 9, 0), np.roll(GRAY, 5, 1)], -1)


def _jpeg(img, mode, **kw):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil(data):
    from PIL import Image

    return np.array(Image.open(io.BytesIO(data)))


STREAMS = {
    "gray_q75": lambda: _jpeg(GRAY, "L", quality=75),
    "gray_q98": lambda: _jpeg(GRAY, "L", quality=98),
    "rgb444": lambda: _jpeg(RGB, "RGB", quality=92, subsampling=0),
    "rgb422": lambda: _jpeg(RGB, "RGB", quality=90, subsampling=1),
    "rgb420": lambda: _jpeg(RGB, "RGB", quality=85, subsampling=2),
    "rgb420_odd_93x117": lambda: _jpeg(RGB[:93, :117], "RGB", quality=88, subsampling=2),
    "rgb422_odd_31x45": lambda: _jpeg(RGB[:31, :45], "RGB", quality=80, subsampling=1),
    "gray_1x1": lambda: _jpeg(GRAY[:1, :1], "L", quality=95),
    "gray_7x5": lambda: _jpeg(GRAY[:7, :5], "L", quality=95),
    "gray_17x23": lambda: _jpeg(GRAY[:17, :23], "L", quality=95),
    "gray_restarts": lambda: _jpeg(GRAY, "L", quality=85, restart_marker_blocks=3),
    "rgb420_restarts": lambda: _jpeg(RGB, "RGB", quality=85, subsampling=2,
                                     restart_marker_blocks=2),
}


@pytest.fixture(params=["native", "python"])
def walker(request, monkeypatch):
    """Both packages' scan walker: the native engine's, or the Python
    loop (``_native_engine`` forced to None in both)."""
    from omero_ms_pixel_buffer_tpu.io import jpeg as jj

    if request.param == "python":
        monkeypatch.setattr(jj, "_native_engine", lambda: None)
        monkeypatch.setattr(pj, "_native_engine", lambda: None)
    elif pj._native_engine() is None:
        pytest.skip("the native engine does not build here")
    return request.param


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_host_decode_equals_jax_and_pillow(name, walker):
    from omero_ms_pixel_buffer_tpu.io.jpeg import decode_jpeg as jax_decode

    data = STREAMS[name]()
    got = pj.decode_jpeg(data, idct_mode="host")
    want = jax_decode(data, idct_mode="host")
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _pil(data))


@pytest.mark.parametrize("name", ["gray_q75", "rgb444", "rgb420", "gray_restarts"])
def test_abbreviated_stream_with_tables_equals_jax(name, walker):
    from omero_ms_pixel_buffer_tpu.io import jpeg as jj

    data = STREAMS[name]()
    tables_p, stripped_p = pj.split_tables(data)
    tables_j, stripped_j = jj.split_tables(data)
    assert (tables_p, stripped_p) == (tables_j, stripped_j)
    got = pj.decode_jpeg(stripped_p, tables=pj.parse_tables(tables_p), idct_mode="host")
    want = jj.decode_jpeg(stripped_j, tables=jj.parse_tables(tables_j), idct_mode="host")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pj.decode_jpeg(data, idct_mode="host"))


def test_ycbcr_false_keeps_components():
    from omero_ms_pixel_buffer_tpu.io.jpeg import decode_jpeg as jax_decode

    data = STREAMS["rgb422"]()
    np.testing.assert_array_equal(pj.decode_jpeg(data, ycbcr=False, idct_mode="host"),
                                  jax_decode(data, ycbcr=False, idct_mode="host"))


def _patched(data, find, offset, value):
    out = bytearray(data)
    at = out.find(find)
    assert at > 0
    out[at + offset: at + offset + len(value)] = value
    return bytes(out)


def _hostile():
    gray = _jpeg(GRAY, "L", quality=90)
    sos = gray.find(b"\xff\xda")
    dqt = gray.find(b"\xff\xdb")
    stripped = pj.split_tables(_jpeg(RGB, "RGB", quality=88, subsampling=0))[1]
    return {
        "progressive": ("decode", _jpeg(GRAY, "L", quality=90, progressive=True)),
        "not_a_jpeg": ("decode", b"not a jpeg"),
        "half_stream": ("decode", gray[: len(gray) // 2]),
        "sof_65535x65535": ("decode", _patched(gray, b"\xff\xc0", 5, b"\xff\xff\xff\xff")),
        "short_dht_body": ("tables", b"\xff\xd8\xff\xc4\x00\x03\x00\xff\xd9"),
        "short_sof_body": ("decode", b"\xff\xd8\xff\xc0\x00\x04\x08\x00\xff\xd9"),
        "dc_category_63": ("decode", _patched(gray, b"\xff\xc4", 5 + 16, b"\x3f")),
        "scan_cut_mid_entropy": ("decode", gray[: sos + 40]),
        "abbreviated_without_tables": ("decode", stripped),
        "split_length_cut": ("split", gray[: dqt + 3]),
        "split_marker_no_length": ("split", gray[:dqt] + b"\xff\xdb"),
        "split_length_past_end": ("split", gray[: dqt + 10]),
        "frame_over_max_pixels": ("decode_small", gray),
    }


@pytest.mark.parametrize("case", sorted(_hostile()))
def test_hostile_streams_raise_the_same_jpeg_error(case, walker):
    from omero_ms_pixel_buffer_tpu.io import jpeg as jj

    how, data = _hostile()[case]

    def run(mod):
        if how == "tables":
            return mod.parse_tables(data)
        if how == "split":
            return mod.split_tables(data)
        if how == "decode_small":
            return mod.decode_jpeg(data, idct_mode="host", max_pixels=1000)
        return mod.decode_jpeg(data, idct_mode="host")

    with pytest.raises(jj.JpegError) as want:
        run(jj)
    with pytest.raises(pj.JpegError) as got:
        run(pj)
    assert str(got.value) == str(want.value)


def test_idct_torch_within_one_of_jax_float_on_random_blocks():
    from omero_ms_pixel_buffer_tpu.io.jpeg import idct_blocks_device, idct_blocks_float

    r = np.random.default_rng(3)
    coefs = r.integers(-500, 500, (1500, 64)).astype(np.int32)
    q = r.integers(1, 64, 64).astype(np.int32)
    got = pj.idct_blocks_torch(coefs, q, "cpu")
    assert got.dtype == torch.uint8 and tuple(got.shape) == (1500, 8, 8)
    got = got.numpy().astype(int)
    assert np.abs(got - idct_blocks_device(coefs, q).astype(int)).max() <= 1
    assert np.abs(got - idct_blocks_float(coefs, q).astype(int)).max() <= 1


def _real_blocks():
    """(coefs, qtable) of every component of a few Pillow streams, as the
    host decode hands them to its IDCT."""
    caught = []
    orig = pj.idct_blocks_host

    def grab(c, q):
        caught.append((c.copy(), q.copy()))
        return orig(c, q)

    pj.idct_blocks_host = grab
    try:
        for name in ("gray_q75", "rgb420", "rgb444"):
            pj.decode_jpeg(STREAMS[name](), idct_mode="host")
    finally:
        pj.idct_blocks_host = orig
    return caught


def test_idct_torch_within_one_of_islow_on_real_blocks():
    from omero_ms_pixel_buffer_tpu.io.jpeg import idct_blocks_host

    blocks = _real_blocks()
    assert len(blocks) == 7
    for coefs, q in blocks:
        got = pj.idct_blocks_torch(coefs, q, "cpu").numpy().astype(int)
        assert np.abs(got - idct_blocks_host(coefs, q).astype(int)).max() <= 1
        assert np.abs(got - pj.idct_blocks_host(coefs, q).astype(int)).max() <= 1


# A float IDCT is within 1 of islow per component; the JFIF transform
# then adds up to 1.772 x a chroma count (B = Y + 1.772 Cb): 1 + 1.772
# rounds to 3 for RGB. The JAX package's own device mode reads 3 from its
# host mode on every RGB stream here (its docstring says 2; no JAX test
# pins RGB): the test measures that reading and holds the port to no more
# than it, and to the JAX device decode itself.
@pytest.mark.parametrize("name,bound", [("gray_q75", 1), ("gray_restarts", 1),
                                        ("rgb444", 3), ("rgb420", 3), ("rgb422_odd_31x45", 3),
                                        ("rgb422", 3), ("rgb420_odd_93x117", 3)])
def test_device_mode_decode_within_bounds_of_host(name, bound):
    from omero_ms_pixel_buffer_tpu.io.jpeg import decode_jpeg as jax_decode

    data = STREAMS[name]()
    idct = pj.DeviceIdct("cpu")
    dev = pj.decode_jpeg(data, idct_mode="device", device_idct=idct)
    host = pj.decode_jpeg(data, idct_mode="host")
    assert dev.shape == host.shape
    jax_dev = jax_decode(data, idct_mode="device")
    jax_spread = np.abs(jax_dev.astype(int)
                        - jax_decode(data, idct_mode="host").astype(int)).max()
    assert jax_spread <= bound
    assert np.abs(dev.astype(int) - host.astype(int)).max() <= jax_spread
    assert np.abs(dev.astype(int) - jax_dev.astype(int)).max() <= 1
    snap = idct.snapshot()
    assert snap["device_idct_calls"] == (1 if host.ndim == 2 else 3)
    assert snap["device"] == "cpu" and snap["device_idct_failed"] == 0


def test_device_mode_follows_the_environment(monkeypatch):
    data = STREAMS["gray_q75"]()
    idct = pj.DeviceIdct("cpu")
    monkeypatch.setenv("OMPB_JPEG_DEVICE_IDCT", "1")
    pj.decode_jpeg(data, device_idct=idct)
    assert idct.calls == 1 and idct.snapshot()["idct_mode"] == "device"
    monkeypatch.setenv("OMPB_JPEG_DEVICE_IDCT", "0")
    pj.decode_jpeg(data, device_idct=idct)
    assert idct.calls == 1 and idct.snapshot()["idct_mode"] == "host"


def test_device_idct_failure_raises_and_never_decodes_on_the_host(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(pj, "idct_blocks_torch", boom)
    idct = pj.DeviceIdct("cpu")
    with pytest.raises(pj.DeviceIdctError, match="device lost"):
        pj.decode_jpeg(STREAMS["rgb420"](), idct_mode="device", device_idct=idct)
    assert idct.failed == 1 and idct.calls == 0


def test_device_idct_on_a_missing_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(pj.DeviceIdctError, match="CUDA"):
        pj.decode_jpeg(STREAMS["gray_q75"](), idct_mode="device",
                       device_idct=pj.DeviceIdct("cuda"))


def test_decodes_without_an_instance_share_one_device_idct(monkeypatch):
    monkeypatch.setattr(pj, "_shared_idct", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    shared = pj.shared_device_idct()
    assert pj.shared_device_idct() is shared
    for _ in range(2):
        with pytest.raises(pj.DeviceIdctError, match="CUDA"):
            pj.decode_jpeg(STREAMS["gray_q75"](), idct_mode="device")
    assert pj.shared_device_idct() is shared and shared.failed == 2


def _idct_f64(coefs, q):
    deq = (coefs.astype(np.int64) * q[None, :]).astype(np.float64).reshape(-1, 8, 8)
    basis = pj._A.astype(np.float64)
    s = np.einsum("uy,nuv,vx->nyx", basis, deq, basis)
    return np.clip(np.round(s) + 128.0, 0, 255).astype(np.uint8)


@pytest.mark.cuda
def test_idct_on_the_card_within_one_of_float64_and_free_of_tf32():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = np.random.default_rng(11)
    coefs = r.integers(-300, 300, (4096, 64)).astype(np.int32)
    q = r.integers(1, 40, 64).astype(np.int32)
    dev = torch.device("cuda", 0)
    flag = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        off = pj.idct_blocks_torch(coefs, q, dev).cpu().numpy()
        torch.backends.cuda.matmul.allow_tf32 = True
        on = pj.idct_blocks_torch(coefs, q, dev).cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    np.testing.assert_array_equal(on, off)
    assert np.abs(off.astype(int) - _idct_f64(coefs, q).astype(int)).max() <= 1
    cpu = pj.idct_blocks_torch(coefs, q, "cpu").numpy()
    assert np.abs(off.astype(int) - cpu.astype(int)).max() <= 1
    idct = pj.DeviceIdct(dev)
    np.testing.assert_array_equal(idct(coefs, q), off)
    assert idct.timed_calls == 1 and idct.span_ms > 0
