"""Process utilities of the port (counterpart of
``omero_ms_pixel_buffer_tpu/utils/``): the config, the event-loop
watchdog, the metrics registry (``metrics.py``), the process collector
(``process_metrics.py``) and tracing (``tracing.py``)."""
