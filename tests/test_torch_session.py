"""The port's session plane modules against the JAX package's, on the same
operation sequences made from a seed with numpy.

- ``AnnotationStore``: creates, updates, deletes, gets, lists, shapes,
  sub-epochs, LRU image eviction, the full table's refusal and the
  ``BadRequestError`` messages; every record, epoch and snapshot equal
  under one injected clock.
- ``ChannelRegistry``: both caps, drop counting on a full queue, a close
  sentinel that lands in a full queue, revocation, ``drop_session`` from
  other threads, ``subscriptions``, the handoff payloads and snapshots.
- Viewport-true prefetch: the port's ``ViewportPrefetcher`` queues the
  same predictions as JAX's for seeded rectangles and pans, across zoom
  mismatches, the 64-tile budget, nonsense rectangles and invalidation.

Tolerance: zero."""

import asyncio
import threading

import numpy as np
import pytest

from omero_ms_pixel_buffer_tpu.cache import prefetch as jpf
from omero_ms_pixel_buffer_tpu.errors import TileError as JaxTileError
from omero_ms_pixel_buffer_tpu.session import annotations as jann
from omero_ms_pixel_buffer_tpu.session import channels as jch
from omero_ms_pixel_buffer_tpu.tile_ctx import RegionDef as JaxRegion
from omero_ms_pixel_buffer_tpu.tile_ctx import TileCtx as JaxCtx
from omero_ms_pixel_buffer_tpu_torch.cache import prefetch as ppf
from omero_ms_pixel_buffer_tpu_torch.errors import TileError
from omero_ms_pixel_buffer_tpu_torch.session import annotations as pann
from omero_ms_pixel_buffer_tpu_torch.session import channels as pch
from omero_ms_pixel_buffer_tpu_torch.tile_ctx import RegionDef, TileCtx


class _Clock:
    def __init__(self):
        self.t = 1.7e9

    def __call__(self):
        self.t += 0.25
        return self.t


def _shape(rng):
    kind = int(rng.integers(0, 6))
    if kind == 0:
        return {"type": "rect", "x": int(rng.integers(0, 90)), "y": int(rng.integers(0, 90)),
                "w": int(rng.integers(1, 40)), "h": int(rng.integers(1, 40))}
    if kind == 1:
        return {"type": "ellipse", "cx": float(rng.integers(0, 90)),
                "cy": float(rng.integers(0, 90)), "rx": 3.5, "ry": float(rng.integers(1, 9))}
    if kind == 2:
        return {"type": "polygon", "points": rng.integers(0, 90, (3, 2)).tolist()}
    if kind == 3:
        return {"type": "polyline", "points": rng.integers(0, 90, (2, 2)).tolist(), "width": 2}
    if kind == 4:
        return {"type": ("star", "rect", "ellipse")[int(rng.integers(0, 3))],
                "w": -1, "rx": 0, "zz": 1}  # a grammar refusal
    return [1, 2]  # not an object


def _body(rng):
    pick = rng.random()
    if pick < 0.1:
        return "not an object"
    shape = _shape(rng)
    if pick < 0.4:
        return shape  # the body is the shape itself
    body = {"shape": shape}
    if rng.random() < 0.5:
        body["label"] = ("x" * int(rng.integers(0, 300))) if rng.random() < 0.9 else 7
    return body


def _call(store, op, *args, err=(TileError, JaxTileError)):
    try:
        return ("ok", getattr(store, op)(*args))
    except err as e:
        return ("error", e.code, e.message)


@pytest.mark.parametrize("seed", range(6))
def test_annotation_store_sequence_matches_jax(seed):
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(1, 3)) * 2
    stores = [mod.AnnotationStore(max_images=3, max_per_image=cap, clock=_Clock())
              for mod in (jann, pann)]
    for _ in range(400):
        op = ("create", "create", "update", "delete", "get", "list", "shapes",
              "sub_epoch")[int(rng.integers(0, 8))]
        image = int(rng.integers(1, 5))
        ann = f"a{int(rng.integers(1, 30))}"
        args = {"create": (image, _body(rng)), "update": (image, ann, _body(rng)),
                "delete": (image, ann), "get": (image, ann)}.get(op, (image,))
        got = [_call(s, op, *args) for s in stores]
        if op == "shapes" and got[0][0] == "ok":
            got = [("ok", [sh.to_json() for sh in g[1]]) for g in got]
        assert got[1] == got[0], (op, args)
        assert stores[1].snapshot() == stores[0].snapshot()
    snap = stores[1].snapshot()
    assert snap["created"] > 0 and snap["evicted_images"] > 0 and snap["rejected_full"] > 0


def test_annotation_cap_never_exceeds_max_shapes():
    for mod in (jann, pann):
        assert mod.AnnotationStore(max_per_image=500).max_per_image == 64


# -- the channel registry -----------------------------------------------------------

def _regs(**kw):
    return [jch.ChannelRegistry(**kw), pch.ChannelRegistry(**kw)]


def _drain(channel):
    out = []
    while not channel.queue.empty():
        out.append(channel.queue.get_nowait())
    return out


@pytest.mark.parametrize("seed", range(4))
async def test_registry_sequence_matches_jax(seed):
    """Registrations against both caps, pushes into small queues (drops
    counted), revocations, unregisters, subscriptions and the handoff
    payloads: the same channels, frames and snapshots."""
    rng = np.random.default_rng(seed)
    loop = asyncio.get_running_loop()
    regs = _regs(max_channels=6, max_per_image=3, queue_size=3)
    for reg in regs:
        reg.start(loop)
    live = [[], []]
    for step in range(120):
        op = int(rng.integers(0, 6))
        image = int(rng.integers(1, 4))
        if op <= 1:
            got = [reg.register(image, f"s{image % 2}", "k", ("ws", "sse")[op]) for reg in regs]
            assert (got[0] is None) == (got[1] is None)
            if got[0] is not None:
                assert got[1].channel_id == got[0].channel_id
                for i in range(2):
                    live[i].append(got[i])
        elif op == 2:
            kind = ("invalidate", "annotations")[int(rng.integers(0, 2))]
            for reg in regs:
                reg.push_delta(image, epoch=step, tiles=("t",),
                               kind=kind, annotation_epoch=step if kind == "annotations" else None)
        elif op == 3 and live[0]:
            i = int(rng.integers(0, len(live[0])))
            for k, reg in enumerate(regs):
                reg.revoke(live[k][i])
        elif op == 4 and live[0]:
            i = int(rng.integers(0, len(live[0])))
            for k, reg in enumerate(regs):
                reg.unregister(live[k].pop(i))
        else:
            got = [reg.subscriptions() for reg in regs]
            assert got[1] == got[0]
        await asyncio.sleep(0)  # the fan-outs run
        assert regs[1].snapshot() == regs[0].snapshot()
        if step % 17 == 0:
            for jc, pc in zip(*live):
                assert _drain(pc) == _drain(jc)
                assert (pc.pushed, pc.dropped, pc.closing) == (jc.pushed, jc.dropped, jc.closing)
    payloads = [reg.begin_handoff("http://next:8082") for reg in regs]
    assert payloads[1] == payloads[0]
    for jc, pc in zip(*live):
        assert _drain(pc) == _drain(jc)
    moved = sum(sub["channels"] for sub in payloads[0]["subscriptions"])
    assert [reg.absorb_handoff(payloads[0]) for reg in regs] == [moved] * 2
    assert regs[1].snapshot() == regs[0].snapshot()
    assert regs[1].snapshot()["rejected_full"] > 0


def test_full_queue_drops_and_the_sentinel_lands():
    for mod in (jch, pch):
        ch = mod.SessionChannel(1, 1, "s", "k", "ws", queue_size=2)
        assert ch.push({"type": "a"}) and ch.push({"type": "b"})
        assert not ch.push({"type": "c"}) and ch.dropped == 1
        assert ch.push(None)  # displaces a queued frame
        assert _drain(ch)[-1] is None
        ch.closing = True
        assert not ch.push({"type": "late"})


@pytest.mark.parametrize("payload", [
    {"subscriptions": [{"image": 1, "channels": 3}, {"image": 2, "channels": "x"},
                       "junk", {"channels": 2}]},
    {"subscriptions": "nope"}, {}, {"subscriptions": [{"image": i, "channels": 1}
                                                      for i in range(40)]},
])
def test_absorb_handoff_matches_jax(payload):
    regs = _regs(max_channels=8)
    assert regs[1].absorb_handoff(payload) == regs[0].absorb_handoff(payload)
    assert regs[1].snapshot() == regs[0].snapshot()


async def test_drop_session_from_other_threads():
    """``drop_session`` and ``push_delta`` from worker threads land on the
    loop: the session's channels get the revocation close, the others the
    delta, in both packages."""
    loop = asyncio.get_running_loop()
    regs = _regs()
    chans = []
    for reg in regs:
        reg.start(loop)
        chans.append([reg.register(1, sid, "k", "sse") for sid in ("a", "b", "a")])

    def other_thread():
        for reg in regs:
            assert reg.drop_session("a") == 1
            reg.push_delta(1, epoch=3)

    t = threading.Thread(target=other_thread)
    t.start()
    t.join()
    for _ in range(3):
        await asyncio.sleep(0)
    got = [[_drain(c) for c in cs] for cs in chans]
    assert got[1] == got[0]
    assert got[1][0] == [{"type": "close", "reason": "revoked"}, None]
    assert got[1][1] == [{"type": "invalidate", "image": 1, "tiles": [], "epoch": 3}]
    assert regs[1].snapshot() == regs[0].snapshot()
    assert regs[1].snapshot()["revoked"] == 2


def test_push_without_a_loop_is_a_no_op():
    for reg in _regs():
        reg.push_delta(1)
        assert reg.drop_session("a") == 0
        assert reg.snapshot()["delta_pushes"] == 0


async def test_close_ends_every_channel():
    loop = asyncio.get_running_loop()
    for reg in _regs(queue_size=1):
        reg.start(loop)
        chans = [reg.register(i, "s", "k", "ws") for i in range(3)]
        chans[0].push({"type": "x"})
        await reg.close()
        assert all(_drain(c)[-1] is None and c.closing for c in chans)


# -- viewport-true prefetch ---------------------------------------------------------

EXTENTS = {(1, None): (2048, 1024), (1, 0): (2048, 1024), (1, 1): (1024, 512)}


class _Cache:
    @staticmethod
    def contains(key):
        return False


class _Admission:
    @staticmethod
    def has_headroom(fraction=0.5):
        return True


def _prefetchers(lookahead):
    out = []
    for mod, ctx_cls, region_cls in ((jpf, JaxCtx, JaxRegion), (ppf, TileCtx, RegionDef)):
        pf = mod.ViewportPrefetcher(fetch=None, cache=_Cache(), admission=_Admission(),
                                    quality="q", queue_size=4096, lookahead=lookahead,
                                    viewport_span=1, max_streams=4,
                                    extent_fn=lambda image, res: EXTENTS.get((image, res)))

        def ctx(session, x, y, w, h, res, ctx_cls=ctx_cls, region_cls=region_cls):
            return ctx_cls(image_id=1, z=0, c=0, t=0, region=region_cls(x, y, w, h),
                           resolution=res, format="png", omero_session_key=session)
        out.append((pf, ctx))
    return out


def _queued(pf):
    out = []
    while not pf._queue.empty():
        c, key = pf._queue.get_nowait()
        r = c.region
        out.append(((r.x, r.y, r.width, r.height), c.resolution, key))
    return out


def _rect(rng):
    pick = rng.random()
    if pick < 0.1:  # nonsense: refused
        return ({"x": -4, "y": 0, "w": 10, "h": 10}, {"x": 0, "y": 0, "w": 0, "h": 3},
                {"x": 0, "y": 0, "w": 8, "h": 8, "zoom": "in"}, {"y": 1},
                {"x": "a", "y": 0, "w": 1, "h": 1})[int(rng.integers(0, 5))]
    rect = {"x": int(rng.integers(0, 1500)), "y": int(rng.integers(0, 800)),
            "w": int(rng.integers(1, 1200)), "h": int(rng.integers(1, 700))}
    if pick < 0.2:  # a whole-plane rectangle: the 64-tile budget
        rect.update(x=0, y=0, w=2048, h=1024)
    if rng.random() < 0.4:
        rect["zoom"] = int(rng.integers(0, 2))
    return rect


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("lookahead", [1, 2])
def test_viewport_true_predictions_in_lockstep(seed, lookahead):
    """Sessions report seeded rectangles (some nonsense, some at another
    zoom, some the whole plane) and pan: the same queued predictions,
    ``note_viewport`` verdicts and counts; an invalidation drops the
    image's rectangles in both."""
    rng = np.random.default_rng(seed)
    made = _prefetchers(lookahead)
    for step in range(160):
        session = f"s{int(rng.integers(0, 6))}"
        op = rng.random()
        if op < 0.25:
            rect = _rect(rng)
            assert len({pf.note_viewport(session, 1, rect) for pf, _ in made}) == 1
        elif op < 0.3:
            for pf, _ in made:
                pf.invalidate_image(1)
        else:
            size = (64, 128, 256)[int(rng.integers(0, 3))]
            res = (None, 0, 1)[int(rng.integers(0, 3))]
            x, y = int(rng.integers(0, 12)) * size, int(rng.integers(0, 6)) * size
            for pf, ctx in made:
                pf.observe(ctx(session, x, y, size, size, res))
        (jq, pq) = [_queued(pf) for pf, _ in made]
        assert pq == jq, step
        assert made[1][0]._viewports == made[0][0]._viewports
    snaps = [pf.snapshot() for pf, _ in made]
    assert snaps[1] == snaps[0] and snaps[1]["viewport_true"] > 0


def test_a_whole_plane_rectangle_is_cut_at_64_tiles():
    for pf, ctx in _prefetchers(1):
        assert pf.note_viewport("s", 1, {"x": 0, "y": 0, "w": 2048, "h": 1024})
        pf.observe(ctx("s", 0, 0, 64, 64, 0))
        pf.observe(ctx("s", 64, 0, 64, 64, 0))
        regions = [q[0] for q in _queued(pf)]  # two rows of 32; column 32 is off the plane
        assert len(regions) + pf.snapshot()["pruned_off_image"] == 64
        assert regions[0] == (64, 0, 64, 64) and regions[-1] == (1984, 64, 64, 64)
        pf.invalidate_image(1)
        assert pf._viewports == {}
