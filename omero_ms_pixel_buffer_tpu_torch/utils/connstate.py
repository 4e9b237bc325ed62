"""Teardown-safe connection state for the hand-rolled wire clients (a
copy of ``omero_ms_pixel_buffer_tpu/utils/connstate.py``, the PyTorch
port's own: it imports nothing of the JAX package).

The RESP2/Postgres stream clients (auth/stores, db/postgres) guard
their exchanges with an asyncio op lock, but their CLOSE paths cannot
take it: ``close_nowait`` runs precisely when the lock may belong to
a closed event loop (the loop-affinity reset in ``query``), and a
terminal ``close`` parked behind a wedged exchange would hang
shutdown. The old shape left the reader/writer attributes lock-
guarded on the exchange side and bare on the teardown side — real
enough races only because a foreign thread or loop could observe a
half-torn pair.

``ConnState`` removes the split instead of suppressing it: all
transport state lives in ONE holder that is created in ``__init__``
and never reassigned. Teardown is two GIL-atomic operations — set the
lock-free terminal ``closed`` flag, then ``drop()`` (which swaps the
(reader, writer) pair out in one tuple assignment before closing) —
so no observer anywhere can see a closed writer next to a live
reader, and no lock is ever needed on the teardown path. Exchange
paths check ``closed`` before (re)connecting, so a post-close caller
gets a clean ``ConnectionError`` instead of silently resurrecting a
transport the owner is tearing down (the manifest-close precedent).
"""

from __future__ import annotations

from typing import Optional


class ConnState:
    """One client connection's mutable state. Fields are only ever
    replaced whole (tuple swap in ``drop``), so readers — any thread,
    any loop — see a coherent pair or (None, None), never a torn
    mix."""

    __slots__ = ("reader", "writer", "loop", "closed")

    def __init__(self):
        self.reader = None
        self.writer = None
        self.loop = None
        self.closed = False

    @property
    def connected(self) -> bool:
        return self.writer is not None

    def attach(self, reader, writer, loop=None) -> None:
        if self.closed:
            # the owner closed while we were connecting: do not leak
            # the transport into a client nobody will close again
            try:
                writer.close()
            except RuntimeError:
                pass
            raise ConnectionError("client closed")
        self.reader, self.writer = reader, writer
        self.loop = loop

    def drop(self) -> Optional[object]:
        """Close + forget the transport (one atomic swap first, so no
        concurrent reader sees half a connection). Reconnecting later
        is allowed unless ``closed`` was set. Returns the old writer
        for callers that want to await ``wait_closed``."""
        writer, self.reader, self.writer, self.loop = (
            self.writer, None, None, None
        )
        if writer is not None:
            try:
                writer.close()
            except RuntimeError:
                pass  # transport's event loop already closed
        return writer

    def close(self) -> Optional[object]:
        """Terminal teardown: the lock-free ``closed`` flag FIRST (an
        exchange mid-reconnect observes it and aborts), then the
        drop."""
        self.closed = True
        return self.drop()
