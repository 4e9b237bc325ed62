"""The cache plane's in-process RESP2 stub (``resp_stub.py``, copied from
``omero_ms_pixel_buffer_tpu/cache/plane/``); the plane itself is
``ROADMAP.md`` §1 items 6 and 8."""
