"""The cache plane (counterpart of ``omero_ms_pixel_buffer_tpu/cache/plane/``):
the TinyLFU admission gate (``tinylfu.py``), the disk tier's
crash-consistent manifest (``manifest.py``), the shared Redis L2 tier
(``l2.py``), the consistent-hash ring (``ring.py``) and the bounded owner
fetch (``peer.py``) under ``coordinator.CachePlane``, the object the HTTP
front wires in; ``resp_stub.py`` is the dev/bench/test RESP server."""
