"""The one generator of traffic. A mix (``traffic/<name>.json``) fixes:

- ``kind``: the request kind (``kinds/<kind>.py``);
- ``clients``: closed-loop clients, each on keep-alive connections of
  its own; a client sends one step, waits for every answer of it, then
  sends the next;
- ``tile``, ``cols``, ``rows``: a step asks for ``cols`` x ``rows``
  tiles of ``tile`` pixels at once, side by side (a viewport);
- ``align``: step origins lie on this grid; ``clip``: whether a step may
  run over the image's edge (its last tiles clipped) or lies inside it;
- ``sample_share``: the share of answers whose pixels are compared with
  the reference after the window;
- ``warm_touches``, ``warm_rounds``: the warm-up (touches of each plane,
  one after another, then rounds of steps at all clients);
- kind-specific parameters (``windows``, ``colors``).

A kind may define ``level(rng, config, traffic)``, which draws the
pyramid level of a step (``spec["level"]``): its origins then lie on
that level's grid and its tiles are clipped to that level's extent. A
kind without it asks for level 0, and no draw is added to its streams,
in its steps or in its warm-up touches.

Every draw comes from a stream of ``numpy.random.default_rng`` seeded by
the run's seed, the client and the stream's purpose, so one seed gives
the same sequence of steps to each client whatever the timing. The
clients' own parameters (a viewer's windows and colours) are the same
set for every seed, handed to the clients in an order drawn from the
seed: a seed changes where the clients look, not how much work a tile
is."""

from __future__ import annotations

import numpy as np

from harness.fixture import level_size

STREAM_TIMED, STREAM_WARM, STREAM_TOUCH = 0, 1, 2


def origins(config: dict, traffic: dict, level: int = 0) -> tuple:
    """The largest grid index of a step's origin along x and y, at a
    pyramid level."""
    t, a = traffic["tile"], traffic["align"]
    size_x, size_y = level_size(config["image"], level)

    def top(size: int, n: int) -> int:
        if traffic["clip"]:
            return (size - 1 - (n - 1) * t) // a  # the last tile starts inside
        return (size - n * t) // a  # the whole step lies inside

    return top(size_x, traffic["cols"]), top(size_y, traffic["rows"])


class Client:
    """The steps of one client, drawn on demand from its own streams."""

    def __init__(self, kind, config: dict, traffic: dict, seed: int, client: int,
                 stream: int = STREAM_TIMED):
        self.kind, self.config, self.traffic = kind, config, traffic
        self.rng = np.random.default_rng([seed, client, stream])
        order = np.random.default_rng([seed, 98]).permutation(traffic["clients"])
        self.session = kind.session(np.random.default_rng([int(order[client]), 99]),
                                    config, traffic)
        self.client, self.n = client, 0

    def step(self) -> list:
        """The next step: a list of request specs (dicts) with their paths."""
        t, a, rng = self.traffic["tile"], self.traffic["align"], self.rng
        draw_level = getattr(self.kind, "level", None)
        level = int(draw_level(rng, self.config, self.traffic)) if draw_level else 0
        top = origins(self.config, self.traffic, level)
        size_x, size_y = level_size(self.config["image"], level)
        x0 = int(rng.integers(top[0] + 1)) * a
        y0 = int(rng.integers(top[1] + 1)) * a
        base = self.kind.place(rng, self.config, dict(self.session))
        specs = []
        for r in range(self.traffic["rows"]):
            for c in range(self.traffic["cols"]):
                x, y = x0 + c * t, y0 + r * t
                spec = dict(base, x=x, y=y, w=min(t, size_x - x),
                            h=min(t, size_y - y), client=self.client, index=self.n,
                            sample=bool(rng.random() < self.traffic["sample_share"]))
                if draw_level:
                    spec["level"] = level
                spec["path"] = self.kind.path(self.config, spec)
                specs.append(spec)
                self.n += 1
        return specs


def touches(kind, config: dict, traffic: dict, seed: int) -> list:
    """Warm-up: for each group of planes one request touches, the
    requests (one after another) that touch it ``warm_touches`` times."""
    rng = np.random.default_rng([seed, 0, STREAM_TOUCH])
    t, draw_level = traffic["tile"], getattr(kind, "level", None)
    out = []
    for group in kind.planes(config):
        c, z = group[0]
        session = kind.session(rng, config, traffic)
        seq = []
        for _ in range(traffic["warm_touches"]):
            level = int(draw_level(rng, config, traffic)) if draw_level else 0
            size_x, size_y = level_size(config["image"], level)
            x = int(rng.integers(max(1, (size_x - t) // t + 1))) * t
            y = int(rng.integers(max(1, (size_y - t) // t + 1))) * t
            spec = dict(session, c=c, z=z, x=x, y=y, w=min(t, size_x - x),
                        h=min(t, size_y - y), sample=False)
            if draw_level:
                spec["level"] = level
            spec["path"] = kind.path(config, spec)
            seq.append(spec)
        out.append(seq)
    return out
