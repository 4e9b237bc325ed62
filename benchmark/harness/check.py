"""``correct``: every answer of the window is judged after the window
has closed, and a sample of them, drawn from the seed, is decoded and
compared pixel for pixel with the plain reference: the seed's source
pixels at the request's pyramid level (``spec["level"]``, 0 when the
kind draws none), or, of a JPEG source, the tiles its file holds as
Pillow decodes them (``fixture.JpegPixels``).

The request kind owns its answers' format: ``kinds/<kind>.py`` may
define ``answer_problem(config, spec, body)`` (why the body is not a
sound answer of the requested size and format, or None; a ValueError
for a body it cannot read) and ``answer_pixels(config, spec, body)``
(the body decoded). A kind without them answers PNGs of
``png_format(config)``, read by the plain PNG decoder.

The numbers compared, each with its limit (exact comparisons, so 0):

- ``bad_answers``: answers that never came (no status, a timeout, an
  error status) or are not a sound answer of the requested size and
  format;
- ``wrong_pixels``: pixels of the compared answers that differ from the
  reference (an RGB pixel counts once)."""

from __future__ import annotations

import functools
from typing import Callable, Iterable

import numpy as np

from reference import png

LIMITS = {"bad_answers": 0, "wrong_pixels": 0}


def wrong_pixels(got: np.ndarray, want: np.ndarray) -> int:
    if got.shape != want.shape:
        return int(np.prod(want.shape[:2]))
    if np.array_equal(got, want):
        return 0
    diff = got != want
    if diff.ndim == 3:
        diff = diff.any(axis=2)
    return int(diff.sum())


def _png_problem(kind, config: dict, spec: dict, body: bytes):
    w, h, depth, color = png.header(body)
    if (w, h) != (spec["w"], spec["h"]) or (depth, color) != kind.png_format(config):
        return f"a {w}x{h} PNG of depth {depth}, colour {color}"
    return None


def _png_pixels(config: dict, spec: dict, body: bytes) -> np.ndarray:
    return png.decode(body)


def expected(kind, source, spec: dict):
    """The reference's pixels of one request (``source``: ``fixture.Pixels``)."""
    return kind.expected(source.level(spec.get("level", 0)), spec)


def judge(answers: Iterable, kind, config: dict, source) -> dict:
    """The program's answers (``client.Answer``) against the reference
    (``source``: ``fixture.Pixels``); ``examples`` names the first few
    answers judged wrong."""
    what = "answer" if hasattr(kind, "answer_problem") else "PNG"
    problem = getattr(kind, "answer_problem", functools.partial(_png_problem, kind))
    pixels = getattr(kind, "answer_pixels", _png_pixels)
    bad = wrong = compared = 0
    examples = []
    for a in answers:
        spec, why = a.spec, None
        if a.status != 200 or a.body is None:
            why = f"status {a.status} {a.error} {(a.body or b'')[:120]!r}"
        else:
            try:
                why = problem(config, spec, a.body)
                if why is None and spec["sample"]:
                    n = wrong_pixels(pixels(config, spec, a.body), expected(kind, source, spec))
                    compared += 1
                    wrong += n
                    if n:
                        why = f"{n} wrong pixels"
            except ValueError as e:
                why = f"not a sound {what}: {e}"
        if why is not None:
            bad += not why.endswith("wrong pixels")
            if len(examples) < 5:
                examples.append(f"{spec['path']}: {why}")
    return {"bad_answers": bad, "wrong_pixels": wrong, "compared": compared,
            "examples": examples}


def judge_arrays(specs: Iterable[dict], answer: Callable, kind, source) -> dict:
    """Answers given as pixel arrays (``answer(level, spec)`` of the
    request's level, such as the control's) against the reference, for
    the sampled specs."""
    wrong = compared = 0
    for spec in specs:
        if spec["sample"]:
            got = answer(source.level(spec.get("level", 0)), spec)
            wrong += wrong_pixels(got, expected(kind, source, spec))
            compared += 1
    return {"bad_answers": 0, "wrong_pixels": wrong, "compared": compared}


def verdict(numbers: dict) -> bool:
    return all(numbers[k] <= limit for k, limit in LIMITS.items())


def report(numbers: dict) -> dict:
    """{name: {"value", "limit"}} of the numbers compared."""
    return {k: {"value": numbers[k], "limit": limit} for k, limit in LIMITS.items()}
