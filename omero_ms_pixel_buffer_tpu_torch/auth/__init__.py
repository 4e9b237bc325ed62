"""OMERO.web sessions and OMERO session joins (copied from
``omero_ms_pixel_buffer_tpu/auth/``)."""
