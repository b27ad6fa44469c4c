"""Whether the timed path's answers are correct: every answer the window
gave for the sampled pool images against the plain reference's answer for
that image, exactly (the pipeline is integer to its last step, and its
float32 tails are fixed operations, so the detections are bit for bit).

Numbers compared, each with its limit:
  answers_wrong    answers whose det rows or n_det differ   at most 0
  answers_missing  answers that never came or failed        at most 0
  answers_compared answers held against the reference       at least 1
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

LIMITS = {"answers_wrong": ("max", 0), "answers_missing": ("max", 0),
          "answers_compared": ("min", 1)}


def compare(answers: Dict[int, list], reference: Dict[int, Tuple]) -> Dict:
    """answers: pool image -> [(det, n_det) or None, ...] from the window;
    reference: pool image -> (det, n_det). Returns the checks, each
    ``{"value": v, "max"|"min": limit}``."""
    wrong = missing = compared = 0
    for i, got in answers.items():
        want_det, want_n = reference[i]
        for a in got:
            if a is None:
                missing += 1
                continue
            compared += 1
            det, n = a
            if (int(n) != int(want_n)
                    or np.asarray(det).shape != want_det.shape
                    or not np.array_equal(np.asarray(det), want_det)):
                wrong += 1
    values = {"answers_wrong": wrong, "answers_missing": missing,
              "answers_compared": compared}
    return {k: {"value": v, LIMITS[k][0]: LIMITS[k][1]}
            for k, v in values.items()}


def passed(checks: Dict) -> bool:
    return all(c["value"] <= c["max"] if "max" in c else c["value"] >= c["min"]
               for c in checks.values())


def lines(checks: Dict) -> List[str]:
    return [f"check {k}: {c['value']} "
            f"({'at most' if 'max' in c else 'at least'} "
            f"{c.get('max', c.get('min'))})" for k, c in checks.items()]
