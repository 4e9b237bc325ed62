"""Process-level metrics, the JMX/hotspot collector analog (copy of
``omero_ms_pixel_buffer_tpu/utils/process_metrics.py``; the
``jmx-metrics`` plane).

The reference's ``/metrics`` exposes JVM internals when
``jmx-metrics.enabled`` is set: the JMX collector, hotspot
``DefaultExports`` (CPU, memory, GC, threads, fds), and a
``BuildInfoCollector`` (PixelBufferMicroserviceVerticle.java:202-218).
The CPython equivalents come from ``/proc/self`` and the ``gc``
module, sampled lazily at scrape time so idle processes cost nothing.
"""

from __future__ import annotations

import gc
import os
import resource
import time
from typing import Iterable

from .metrics import REGISTRY, Registry, _om_family

_CLK_TCK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100
_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096
_START = time.time()


class ProcessCollector:
    """Samples /proc/self at scrape time; registry-compatible
    (exposes ``collect()``)."""

    name = "process"

    def __init__(self, version: str):
        self.version = version

    def _stat(self):
        try:
            with open("/proc/self/stat") as f:
                parts = f.read().rsplit(")", 1)[1].split()
            # 0-based indices into the fields after ") ": 11 utime,
            # 12 stime, 17 num_threads, 20 vsize, 21 rss (pages)
            utime = int(parts[11]) / _CLK_TCK
            stime = int(parts[12]) / _CLK_TCK
            threads = int(parts[17])
            vsize = int(parts[20])
            rss = int(parts[21]) * _PAGE
            return utime, stime, threads, vsize, rss
        except (OSError, IndexError, ValueError):
            return None

    def _fds(self):
        try:
            return len(os.listdir("/proc/self/fd"))
        except OSError:
            return None

    def collect(self, openmetrics: bool = False) -> Iterable[str]:
        # OpenMetrics counter metadata drops the _total sample suffix
        # — the ONE naming rule lives in utils/metrics._om_family
        def fam(name: str) -> str:
            return _om_family(name, "counter") if openmetrics else name

        cpu_fam = fam("process_cpu_seconds_total")
        gc_coll_fam = fam("python_gc_collections_total")
        gc_obj_fam = fam("python_gc_objects_collected_total")
        stat = self._stat()
        if stat:
            utime, stime, threads, vsize, rss = stat
            yield (f"# HELP {cpu_fam} Total user+system "
                   "CPU time")
            yield f"# TYPE {cpu_fam} counter"
            yield f"process_cpu_seconds_total {utime + stime}"
            yield "# HELP process_threads Current thread count"
            yield "# TYPE process_threads gauge"
            yield f"process_threads {threads}"
            yield "# HELP process_virtual_memory_bytes Virtual memory size"
            yield "# TYPE process_virtual_memory_bytes gauge"
            yield f"process_virtual_memory_bytes {vsize}"
            yield "# HELP process_resident_memory_bytes Resident set size"
            yield "# TYPE process_resident_memory_bytes gauge"
            yield f"process_resident_memory_bytes {rss}"
        fds = self._fds()
        if fds is not None:
            yield "# HELP process_open_fds Open file descriptors"
            yield "# TYPE process_open_fds gauge"
            yield f"process_open_fds {fds}"
            soft, _hard = resource.getrlimit(resource.RLIMIT_NOFILE)
            yield "# HELP process_max_fds Soft limit on open fds"
            yield "# TYPE process_max_fds gauge"
            yield f"process_max_fds {soft}"
        yield "# HELP process_start_time_seconds Unix process start time"
        yield "# TYPE process_start_time_seconds gauge"
        yield f"process_start_time_seconds {_START}"
        # GC — the hotspot GC-collector analog for CPython
        counts = gc.get_stats()
        yield (f"# HELP {gc_coll_fam} Collections per "
               "generation")
        yield f"# TYPE {gc_coll_fam} counter"
        for gen, st in enumerate(counts):
            yield (f'python_gc_collections_total{{generation="{gen}"}} '
                   f'{st.get("collections", 0)}')
        yield f"# HELP {gc_obj_fam} Collected objects"
        yield f"# TYPE {gc_obj_fam} counter"
        for gen, st in enumerate(counts):
            yield (f'python_gc_objects_collected_total{{generation="{gen}"}} '
                   f'{st.get("collected", 0)}')
        # BuildInfoCollector analog
        yield "# HELP build_info Service build information"
        yield "# TYPE build_info gauge"
        yield f'build_info{{version="{self.version}"}} 1'


def install(registry: Registry = REGISTRY) -> ProcessCollector:
    """Register the process collector (idempotent per registry)."""
    from .. import __version__

    for m in getattr(registry, "_metrics", []):
        if isinstance(m, ProcessCollector):
            return m
    return registry.register(ProcessCollector(__version__))
