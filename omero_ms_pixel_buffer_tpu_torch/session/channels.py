"""Live push channels: the bounded registry and its delta fan-out (copy of
``omero_ms_pixel_buffer_tpu/session/channels.py``).

One ``SessionChannel`` per open viewer connection, subscribed to one
image. The registry is the hook the purge path calls: ``push_delta`` may
be called from any thread (the metadata resolver's refresh thread fires
invalidation listeners) and schedules the fan-out onto the serving loop
captured at ``start`` with ``call_soon_threadsafe``.

Backpressure: every per-channel queue is bounded and drops when full (a
slow viewer never parks the purge path or grows memory), with the drop
counted; the close sentinel always lands. Registration beyond the
channel caps is refused (503 upstream), never answered by evicting
someone else's channel.

Drain: ``begin_handoff`` snapshots the subscription state for a
successor and pushes every client a ``{"reconnect": url}`` frame before
closing it; ``absorb_handoff`` is the successor's half. (Their callers,
the drain coordinator and ``/internal/handoff``, belong to the fleet
plane.)

Every fan-out stamps one ``/session/push`` flight record (tagged with
the subscriber and drop counts), so a slow or dropped push is a kept
trace.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional

from ..utils.metrics import REGISTRY

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.session")

SESSION_PUSHES = REGISTRY.counter(
    "session_pushes_total",
    "Live-channel push frames by kind and outcome",
)
SESSION_CHANNEL_EVENTS = REGISTRY.counter(
    "session_channel_events_total",
    "Channel lifecycle events (open, close, rejected_full, revoked, "
    "reconnect, handoff)",
)

# the process-wide live-channel gauge follows the most recent registry
# (several servers may be built in one process)
_ACTIVE: Optional["weakref.ref[ChannelRegistry]"] = None
_gauge_registered = False
_gauge_lock = threading.Lock()


def _channel_gauge_values():
    ref = _ACTIVE
    reg = ref() if ref is not None else None
    if reg is None:
        return {}
    return {(("transport", "all"),): float(len(reg._channels))}


def _register_gauge() -> None:
    global _gauge_registered
    with _gauge_lock:
        if not _gauge_registered:
            REGISTRY.gauge_fn("session_channels_live",
                              "Live session-plane channels on this replica",
                              _channel_gauge_values)
            _gauge_registered = True


class SessionChannel:
    """One live viewer connection: a bounded outbound frame queue the
    transport drains, and the identity to authorize, revoke and hand off.
    Frames are dicts; ``None`` is the close sentinel."""

    __slots__ = ("channel_id", "image_id", "session_id", "omero_session_key",
                 "transport", "queue", "pushed", "dropped", "closing")

    def __init__(self, channel_id: int, image_id: int, session_id: str,
                 omero_session_key: str, transport: str, queue_size: int):
        self.channel_id = channel_id
        self.image_id = image_id
        self.session_id = session_id
        self.omero_session_key = omero_session_key
        self.transport = transport  # "ws" | "sse"
        self.queue: "asyncio.Queue[Optional[dict]]" = asyncio.Queue(
            maxsize=max(1, int(queue_size)))
        self.pushed = 0
        self.dropped = 0
        self.closing = False

    def push(self, frame: Optional[dict]) -> bool:
        """Enqueue one frame; drop it (counted) when the viewer is slow.
        The close sentinel always lands, displacing queued frames."""
        if frame is None:
            while True:
                try:
                    self.queue.put_nowait(None)
                    return True
                except asyncio.QueueFull:
                    try:
                        self.queue.get_nowait()
                    except asyncio.QueueEmpty:  # pragma: no cover - race
                        continue
        if self.closing:
            return False
        try:
            self.queue.put_nowait(frame)
        except asyncio.QueueFull:
            self.dropped += 1
            SESSION_PUSHES.inc(kind=str(frame.get("type", "?")), outcome="dropped_slow")
            return False
        self.pushed += 1
        SESSION_PUSHES.inc(kind=str(frame.get("type", "?")), outcome="queued")
        return True


class ChannelRegistry:
    """The bounded channel table and its cross-thread push entry.

    Loop-affine but for ``push_delta`` and ``drop_session`` (any thread:
    they schedule onto the captured loop). Bounds: ``max_channels`` in
    all, ``max_per_image`` per image; a registration beyond either is
    refused, never met by evicting a live channel."""

    def __init__(self, max_channels: int = 256, max_per_image: int = 64,
                 queue_size: int = 64, recorder=None):
        self.max_channels = max(1, int(max_channels))
        self.max_per_image = max(1, int(max_per_image))
        self.queue_size = max(1, int(queue_size))
        self.recorder = recorder
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._next_id = 0
        self._channels: "OrderedDict[int, SessionChannel]" = OrderedDict()
        # image_id -> channel ids; an emptied set is deleted
        self._by_image: Dict[int, set] = {}
        self._stats = {"opened": 0, "closed": 0, "rejected_full": 0,
                       "delta_pushes": 0, "annotation_pushes": 0,
                       "dropped_slow": 0, "revoked": 0, "reconnects": 0,
                       "handoff_out": 0, "handoff_in": 0}
        global _ACTIVE
        _ACTIVE = weakref.ref(self)
        _register_gauge()

    # -- lifecycle -----------------------------------------------------

    def start(self, loop: asyncio.AbstractEventLoop) -> None:
        """Capture the serving loop the cross-thread entries schedule on."""
        self._loop = loop

    async def close(self) -> None:
        """Shutdown: the close sentinel to every channel; the transports
        drain and exit."""
        for channel in list(self._channels.values()):
            channel.closing = True
            channel.push(None)

    # -- registration --------------------------------------------------

    def register(self, image_id: int, session_id: str, omero_session_key: str,
                 transport: str) -> Optional[SessionChannel]:
        """A new live channel, or None when either bound is hit (the
        caller answers 503 with ``Retry-After``)."""
        if len(self._channels) >= self.max_channels or (
                len(self._by_image.get(image_id, ())) >= self.max_per_image):
            self._stats["rejected_full"] += 1
            SESSION_CHANNEL_EVENTS.inc(event="rejected_full")
            return None
        self._next_id += 1
        channel = SessionChannel(self._next_id, image_id, session_id, omero_session_key,
                                 transport, self.queue_size)
        self._channels[channel.channel_id] = channel
        self._by_image.setdefault(image_id, set()).add(channel.channel_id)
        self._stats["opened"] += 1
        SESSION_CHANNEL_EVENTS.inc(event="open")
        return channel

    def unregister(self, channel: SessionChannel) -> None:
        if self._channels.pop(channel.channel_id, None) is None:
            return
        ids = self._by_image.get(channel.image_id)
        if ids is not None:
            ids.discard(channel.channel_id)
            if not ids:
                del self._by_image[channel.image_id]
        self._stats["closed"] += 1
        self._stats["dropped_slow"] += channel.dropped
        SESSION_CHANNEL_EVENTS.inc(event="close")

    def channels_for(self, image_id: int) -> List[SessionChannel]:
        return [self._channels[cid] for cid in self._by_image.get(image_id, ())
                if cid in self._channels]

    # -- the push entry (any thread) -----------------------------------

    def push_delta(self, image_id: int, epoch: Optional[int] = None, tiles: tuple = (),
                   kind: str = "invalidate", annotation_epoch: Optional[int] = None) -> None:
        """Schedule one delta frame to every channel subscribed to
        ``image_id``. Any thread; never blocks, never raises."""
        loop = self._loop
        if loop is None or loop.is_closed():
            return
        frame = {"type": kind, "image": int(image_id), "tiles": list(tiles), "epoch": epoch}
        if annotation_epoch is not None:
            frame["annotations"] = int(annotation_epoch)
        try:
            loop.call_soon_threadsafe(self._fan_out, image_id, frame)
        except RuntimeError:
            pass  # the loop is shutting down: no channels left to tell

    def _fan_out(self, image_id: int, frame: dict) -> None:
        """The loop's half of ``push_delta``: enqueue onto every subscribed
        channel and stamp one flight record for the delta."""
        channels = self.channels_for(image_id)
        delivered = dropped = 0
        for channel in channels:
            if channel.push(dict(frame)):
                delivered += 1
            else:
                dropped += 1
        if frame.get("type") == "annotations":
            self._stats["annotation_pushes"] += 1
        else:
            self._stats["delta_pushes"] += 1
        if self.recorder is not None and channels:
            rec = self.recorder.start("/session/push", method="PUSH")
            if rec is not None:
                rec.tag("push.kind", str(frame.get("type")))
                rec.tag("push.image", int(image_id))
                rec.tag("push.channels", delivered)
                if dropped:
                    rec.tag("push.dropped", dropped)
                    rec.note_fault("session.push.dropped")
                self.recorder.complete(rec, 200)

    def drop_session(self, session_id: str) -> int:
        """Revocation: close every channel opened under a browser session
        (any thread). The client gets an explicit close frame."""
        loop = self._loop
        if loop is None or loop.is_closed():
            return 0
        try:
            loop.call_soon_threadsafe(self._drop_session, session_id)
        except RuntimeError:
            return 0
        return 1

    def _drop_session(self, session_id: str) -> None:
        for channel in list(self._channels.values()):
            if channel.session_id == session_id:
                self.revoke(channel)

    def revoke(self, channel: SessionChannel) -> None:
        """Close one channel for auth reasons: an explicit frame, then the
        close sentinel."""
        channel.push({"type": "close", "reason": "revoked"})
        channel.closing = True
        channel.push(None)
        self._stats["revoked"] += 1
        SESSION_CHANNEL_EVENTS.inc(event="revoked")

    # -- drain handoff -------------------------------------------------

    def subscriptions(self) -> List[dict]:
        """Per image, how many channels watch it (identity stays with the
        client: the reconnect re-authenticates)."""
        return [{"image": image_id, "channels": len(ids)}
                for image_id, ids in sorted(self._by_image.items())]

    def begin_handoff(self, reconnect_url: str) -> dict:
        """Drain side: snapshot the subscriptions, then tell every client
        where to reconnect and close it. Returns the handoff payload."""
        subs = self.subscriptions()
        moved = 0
        for channel in list(self._channels.values()):
            channel.push({"type": "reconnect", "reconnect": reconnect_url})
            channel.closing = True
            channel.push(None)
            moved += 1
        self._stats["reconnects"] += moved
        self._stats["handoff_out"] += moved
        SESSION_CHANNEL_EVENTS.inc(event="handoff")
        return {"kind": "session_handoff", "subscriptions": subs, "channels": moved}

    def absorb_handoff(self, payload: dict) -> int:
        """Successor side: count the incoming subscriptions (nothing here
        grants access; at most ``max_channels`` items are read)."""
        subs = payload.get("subscriptions")
        count = 0
        if isinstance(subs, list):
            for item in subs[: self.max_channels]:
                if isinstance(item, dict):
                    try:
                        count += int(item.get("channels", 0))
                    except (TypeError, ValueError):
                        continue
        self._stats["handoff_in"] += count
        return count

    # -- observability -------------------------------------------------

    def snapshot(self) -> dict:
        return {"enabled": True, "live": len(self._channels), "images": len(self._by_image),
                "max_channels": self.max_channels, "max_per_image": self.max_per_image,
                **self._stats}
