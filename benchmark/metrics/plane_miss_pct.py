"""Plane cache: the share of plane lookups in the window that found the
plane not resident on the device (``/healthz`` ``plane_cache.misses``
over ``hits`` plus ``misses``); a miss reads the region on the host or
stages the whole plane."""


def read(ctx):
    hits = ctx.healthz_delta("plane_cache.hits")
    misses = ctx.healthz_delta("plane_cache.misses")
    if hits is None or misses is None or hits + misses <= 0:
        return None
    return 100.0 * misses / (hits + misses)
