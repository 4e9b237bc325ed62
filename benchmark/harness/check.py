"""``correct``: every answer of the window is judged after the window
has closed, and a sample of them, drawn from the seed, is decoded by the
plain PNG decoder and compared pixel for pixel with the plain reference
computed from the seed's source array.

The numbers compared, each with its limit (exact comparisons, so 0):

- ``bad_answers``: answers that never came (no status, a timeout, an
  error status) or are not a sound PNG of the requested size and format;
- ``wrong_pixels``: pixels of the compared answers that differ from the
  reference (an RGB pixel counts once)."""

from __future__ import annotations

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


def judge(answers: Iterable, kind, config: dict, data: np.ndarray) -> dict:
    """The program's answers (``client.Answer``) against the reference;
    ``examples`` names the first few answers judged wrong."""
    fmt = kind.png_format(config)
    bad = wrong = compared = 0
    examples = []
    for a in answers:
        spec, why = a.spec, None
        if a.status != 200 or a.body is None:
            why = f"status {a.status} {a.error} {(a.body or b'')[:120]!r}"
        else:
            try:
                w, h, depth, color = png.header(a.body)
                if (w, h) != (spec["w"], spec["h"]) or (depth, color) != fmt:
                    why = f"a {w}x{h} PNG of depth {depth}, colour {color}"
                elif spec["sample"]:
                    n = wrong_pixels(png.decode(a.body), kind.expected(data, spec))
                    compared += 1
                    wrong += n
                    if n:
                        why = f"{n} wrong pixels"
            except png.PngError as e:
                why = f"not a sound PNG: {e}"
        if why is not None:
            bad += not why.endswith("wrong pixels")
            if len(examples) < 5:
                examples.append(f"{spec['path']}: {why}")
    return {"bad_answers": bad, "wrong_pixels": wrong, "compared": compared,
            "examples": examples}


def judge_arrays(specs: Iterable[dict], answer: Callable, kind, data: np.ndarray) -> dict:
    """Answers given as pixel arrays (``answer(data, spec)``, such as the
    control's) against the reference, for the sampled specs."""
    wrong = compared = 0
    for spec in specs:
        if spec["sample"]:
            wrong += wrong_pixels(answer(data, spec), kind.expected(data, spec))
            compared += 1
    return {"bad_answers": 0, "wrong_pixels": wrong, "compared": compared}


def verdict(numbers: dict) -> bool:
    return all(numbers[k] <= limit for k, limit in LIMITS.items())


def report(numbers: dict) -> dict:
    """{name: {"value", "limit"}} of the numbers compared."""
    return {k: {"value": numbers[k], "limit": limit} for k, limit in LIMITS.items()}
