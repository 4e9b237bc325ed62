"""Process utilities of the port (counterpart of
``omero_ms_pixel_buffer_tpu/utils/``): the event-loop watchdog."""
