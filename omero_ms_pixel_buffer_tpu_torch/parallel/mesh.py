"""Device meshes for multi-GPU tile serving (counterpart of
``omero_ms_pixel_buffer_tpu/parallel/mesh.py``).

A mesh is an ordered list of slots, each an ``(index, torch.device)``.
Its one axis is the JAX mesh's ``data`` axis: a coalesced tile batch
shards its lanes over the slots in contiguous blocks (request
parallelism), and one plane larger than every bucket shards its rows
over them with a one-row halo (``sharding.py``). Serving builds a mesh
over the visible ``cuda:i`` when there is more than one; the tests build
one over ``cpu``, and a mesh may hold two slots on one card (each slot
then runs its chain on that card in turn).

``MeshManager`` owns the mesh's health, as the JAX manager does: a
circuit breaker per slot (``device:<index>``, failure threshold 1, on
the shared breaker board), a probe per slot (a small copy and an add,
synchronized, under the fault point ``device.chip:<index>``; a success
heals the breaker at once), and ``dispatch``, which runs a sharded
program on the healthy slots under the fault point
``device.mesh-dispatch`` and, when it fails, probes every slot and
retries once on the survivors. Width listeners hear every change of the
healthy width; ``MeshProber`` probes the open slots on a cadence
(``mesh.probe-interval-ms``), so a recovered slot rejoins before a
dispatch has to fail.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import List, Optional, Sequence, Union

import torch

from ..resilience.breaker import for_dependency
from ..resilience.faultinject import INJECTOR

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.mesh")

__all__ = ["Mesh", "MeshHealthError", "MeshManager", "MeshProber", "Slot", "lane_counts",
           "make_mesh"]


@dataclasses.dataclass(frozen=True)
class Slot:
    """One place of the mesh: its index (the breaker's and the fault
    point's name) and the device its chain runs on."""

    index: int
    device: torch.device


class Mesh:
    """An ordered list of slots over one ``data`` axis."""

    axis = "data"

    def __init__(self, slots: Sequence[Slot]):
        if not slots:
            raise ValueError("a mesh needs at least one slot")
        self.slots = tuple(slots)

    @property
    def size(self) -> int:
        return len(self.slots)

    @property
    def shape(self) -> dict:
        """{axis: width}, as ``dict(jax_mesh.shape)`` reads."""
        return {self.axis: len(self.slots)}

    @property
    def devices(self) -> List[torch.device]:
        return [s.device for s in self.slots]

    def __repr__(self) -> str:
        return f"Mesh({[(s.index, str(s.device)) for s in self.slots]})"


def make_mesh(devices: Optional[Sequence[Union[str, torch.device]]] = None) -> Mesh:
    """A mesh with one slot per entry of ``devices`` (an entry may repeat:
    two slots on one card), indexed in order; by default one slot per
    visible CUDA device."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return Mesh([Slot(i, torch.device(d)) for i, d in enumerate(devices)])


def lane_counts(real: int, n_devices: int) -> List[int]:
    """How many real lanes each slot serves when ``real`` lanes pad to a
    multiple of ``n_devices`` and shard in contiguous blocks."""
    if n_devices <= 0:
        return []
    per = (max(real, 0) + n_devices - 1) // n_devices
    return [max(0, min(real, (d + 1) * per) - d * per) for d in range(n_devices)]


class MeshHealthError(RuntimeError):
    """Every slot of the serving mesh is breaker-open."""


class MeshManager:
    """The serving mesh and its health: per-slot breakers, probes, the
    managed dispatch with one retry on the shrunken mesh, width
    listeners, ``last_dispatch`` and ``snapshot``."""

    def __init__(self, mesh: Union[Mesh, Sequence[Slot]]):
        slots = mesh.slots if isinstance(mesh, Mesh) else tuple(mesh)
        self._slots = list(slots)
        self._lock = threading.Lock()
        self._breakers: dict = {}
        self._mesh_cache: Optional[tuple] = None
        #: the last successful dispatch: {"executed", "n_devices",
        #: "device_ids", "lanes_per_device", "tag"}
        self.last_dispatch: Optional[dict] = None
        self._width_listeners: list = []
        self._last_width: Optional[int] = None

    @property
    def slots(self) -> List[Slot]:
        return list(self._slots)

    def add_width_listener(self, fn) -> None:
        """``fn(new_width)`` runs whenever the healthy width changes (a
        failed probe shrinks it, a heal grows it), on the probing
        thread: it must be quick and hand real work to a thread."""
        with self._lock:
            self._width_listeners.append(fn)

    def _notify_width(self) -> None:
        # the width reads the breakers (which take the lock); the
        # compare-and-set of _last_width is what must be atomic, so two
        # probing threads cannot swallow a transition
        n = len(self.healthy_slots())
        fire = []
        with self._lock:
            prev = self._last_width
            if n:
                self._last_width = n
            if n and prev is not None and n != prev:
                fire = list(self._width_listeners)
        for fn in fire:
            try:
                fn(n)
            except Exception:
                log.exception("mesh width listener failed")

    def _breaker(self, slot: Slot):
        key = f"device:{slot.index}"
        with self._lock:
            br = self._breakers.get(key)
            if br is None:
                # probes run only after a dispatch failed, so one failed
                # probe is definitive; the half-open window readmits
                br = self._breakers[key] = for_dependency(key, failure_threshold=1)
        return br

    def healthy_slots(self) -> List[Slot]:
        out = []
        for slot in self._slots:
            try:
                self._breaker(slot).allow()
            except Exception:
                continue  # open: out until its half-open window
            out.append(slot)
        return out

    def mesh(self) -> Mesh:
        """The mesh of the healthy slots (``MeshHealthError`` when none is)."""
        slots = self.healthy_slots()
        if not slots:
            raise MeshHealthError("all mesh devices are breaker-open")
        key = tuple(s.index for s in slots)
        with self._lock:
            if self._last_width is None:
                self._last_width = len(slots)
            if self._mesh_cache is not None and self._mesh_cache[0] == key:
                return self._mesh_cache[1]
            mesh = Mesh(slots)
            self._mesh_cache = (key, mesh)
            return mesh

    def probe_device(self, slot: Slot) -> bool:
        """One slot's liveness: a small copy to its device and an add,
        synchronized and checked. The outcome goes to the slot's breaker;
        a success heals an open breaker at once."""
        br = self._breaker(slot)
        try:
            INJECTOR.fire(f"device.chip:{slot.index}")
            x = torch.arange(8, dtype=torch.int32).to(slot.device)
            y = (x + 1).cpu()
            if slot.device.type == "cuda":
                torch.cuda.synchronize(slot.device)
            if int(y.sum()) != 36:
                raise RuntimeError(f"device {slot.device} computed {y.tolist()}")
        except Exception:
            log.warning("mesh device %s failed its probe; excluding it", slot.index)
            br.record_failure()
            self._notify_width()
            return False
        br.record_success()
        br.heal()
        self._notify_width()
        return True

    def probe_all(self) -> List[Slot]:
        return [s for s in self._slots if self.probe_device(s)]

    def probe_open(self) -> int:
        """Probe only the slots whose breaker is not closed; returns how
        many rejoined. Free while the mesh is whole."""
        healed = 0
        for slot in self._slots:
            if self._breaker(slot).state == "closed":
                continue
            if self.probe_device(slot):
                healed += 1
                log.info("mesh device %s recovered; rejoining the mesh", slot.index)
        return healed

    def dispatch(self, fn, real_lanes: Optional[int] = None, tag: Optional[str] = None):
        """``fn(mesh)`` on the healthy mesh; when it fails, probe every
        slot, shrink to the survivors and retry once. A success records a
        success on every slot's breaker and ``last_dispatch`` (``tag``
        names the program family: tiles, dynamic, render, supertile)."""
        mesh = self.mesh()
        try:
            INJECTOR.fire("device.mesh-dispatch")
            out = fn(mesh)
        except Exception:
            log.exception("sharded dispatch failed on %d devices; probing them", mesh.size)
            self.probe_all()
            mesh = self.mesh()  # the survivors (raises when none is left)
            INJECTOR.fire("device.mesh-dispatch")
            out = fn(mesh)
        for slot in mesh.slots:
            self._breaker(slot).record_success()
        self.last_dispatch = {
            "executed": True,
            "n_devices": mesh.size,
            "device_ids": [s.index for s in mesh.slots],
            "lanes_per_device": (lane_counts(real_lanes, mesh.size)
                                 if real_lanes is not None else None),
            "tag": tag,
        }
        return out

    def snapshot(self) -> dict:
        return {"devices": len(self._slots), "healthy": len(self.healthy_slots()),
                "last_dispatch": self.last_dispatch}


class MeshProber:
    """The background probe (``mesh.probe-interval-ms``): a daemon thread
    that runs ``probe_open`` on a cadence. ``manager_fn`` is asked each
    tick, since the pipeline builds its manager at its first batch."""

    def __init__(self, manager_fn, interval_s: float):
        self._manager_fn = manager_fn
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, name="mesh-prober", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                mgr = self._manager_fn()
                if mgr is not None:
                    mgr.probe_open()
            except Exception:
                log.exception("background mesh probe failed")
