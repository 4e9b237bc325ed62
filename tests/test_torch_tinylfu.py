"""The port's TinyLFU admission gate (``cache/plane/tinylfu.py``) and the
result cache's ``admission=`` hook against the JAX package's: on one key
stream (made from a seed with numpy: a Zipf-like hot set, a one-pass scan
and repeats), the count-min sketch's estimates, the doorkeeper's
membership, the aging resets and every admit verdict are equal; a
``TileResultCache`` with the gate, under one byte budget and one get/put
sequence, holds the same keys in the same segments and order, and turns
away the same candidates. Tolerance: zero."""

import asyncio

import numpy as np
import pytest

from omero_ms_pixel_buffer_tpu.cache import result_cache as jrc
from omero_ms_pixel_buffer_tpu.cache.plane import tinylfu as jt
from omero_ms_pixel_buffer_tpu_torch.cache import result_cache as prc
from omero_ms_pixel_buffer_tpu_torch.cache.plane import tinylfu as pt


def _stream(seed: int, n: int = 3000):
    rng = np.random.default_rng(seed)
    hot = [f"img=1|z=0|hot{i}" for i in range(40)]
    out = []
    for k in range(n):
        r = rng.random()
        if r < 0.6:
            out.append(hot[min(int(rng.zipf(1.3)) - 1, len(hot) - 1)])
        elif r < 0.9:
            out.append(f"img=2|scan{k}")
        else:
            out.append(f"img=3|rep{int(rng.integers(0, 200))}")
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("counters,sample", [(64, 0), (256, 500), (16384, 0)])
def test_sketch_doorkeeper_and_verdicts_equal(seed, counters, sample):
    j, p = jt.TinyLFU(counters=counters, sample_size=sample), pt.TinyLFU(
        counters=counters, sample_size=sample)
    keys = _stream(seed)
    rng = np.random.default_rng(seed + 50)
    for i, key in enumerate(keys):
        j.record(key)
        p.record(key)
        if i % 7 == 0:
            other = keys[int(rng.integers(0, i + 1))]
            assert p.estimate(key) == j.estimate(key)
            assert p.admit(key, other) == j.admit(key, other)
            h = jt._hashes(key)
            assert pt._hashes(key) == h
            assert p.doorkeeper.contains(h) == j.doorkeeper.contains(h)
            assert p.sketch.estimate(h) == j.sketch.estimate(h)
    assert p.snapshot() == j.snapshot()
    assert bytes(p.sketch._table) == bytes(j.sketch._table)
    assert bytes(p.doorkeeper._bytes) == bytes(j.doorkeeper._bytes)


def test_sketch_bounds_match():
    for bad in ((1, 4), (16, 0), (16, 5)):
        with pytest.raises(ValueError):
            jt.CountMinSketch(*bad)
        with pytest.raises(ValueError):
            pt.CountMinSketch(*bad)


def _segments(cache):
    mem = cache.memory
    return list(mem._probation), list(mem._protected)


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("gate", [True, False], ids=["tinylfu", "plain"])
def test_cache_with_admission_evicts_like_jax(seed, gate):
    """One get/put sequence under a budget of ~24 entries of mixed sizes:
    the same entries survive, in the same segments and order."""
    rng = np.random.default_rng(seed)
    budget = 24 * 1000
    jc = jrc.TileResultCache(memory_bytes=budget, admission=jt.TinyLFU(counters=128)
                             if gate else None)
    pc = prc.TileResultCache(memory_bytes=budget, admission=pt.TinyLFU(counters=128)
                             if gate else None)
    rejects = pt.ADMISSION._values[(("decision", "reject"),)]
    loop = asyncio.new_event_loop()
    try:
        for key in _stream(seed, 1500):
            body = bytes(int(rng.integers(600, 1400)))
            jhit = loop.run_until_complete(jc.get(key))
            phit = loop.run_until_complete(pc.get(key))
            assert (phit is None) == (jhit is None), key
            if phit is None:
                loop.run_until_complete(jc.put(key, jrc.CachedTile(body)))
                pc.put(key, prc.CachedTile(body))
            assert _segments(pc) == _segments(jc)
    finally:
        loop.close()
    assert pc.memory.snapshot() == jc.memory.snapshot()
    if gate:
        assert pc.snapshot()["admission"] == jc.snapshot()["admission"]
        assert pt.ADMISSION._values[(("decision", "reject"),)] > rejects
