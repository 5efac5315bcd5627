"""Whether what the timed path returned is correct.

The clients kept a seeded sample of the answers to requests sent inside
the window (``k`` a client, at seeded moments of it).  Once the window has
closed and the front end is gone, the configuration's plain
reference (``bench/reference/<name>.py``, which imports nothing of the
port) works each sampled request out again from the same frame, and every
pixel is compared: integer grids match exactly, so each number compared
has the limit 0.  A request that was never answered fails the check too.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from benchlib.spec import load_module


def check(config: dict, pools, samples: List[tuple], mix_keys, unanswered: int,
          device: str, min_checked: int) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit: ``{name: {"value", "limit"}}``.
    ``samples``: ``(key, hw, frame, output)``; the reference runs once a
    distinct ``(key, hw, frame)``, on ``device``, one frame at a time.
    ``mix_keys``: every app or chain of the traffic, each of which has to
    be among the answers checked."""
    import torch

    ref = load_module("reference", config["reference"])
    by_input: Dict[Tuple[str, Tuple[int, int], int], list] = {}
    for key, hw, frame, out in samples:
        by_input.setdefault((key, hw, frame), []).append(out)
    wrong = shape_errors = 0
    worst = 0
    keys = set()
    for (key, hw, frame), outs in by_input.items():
        want = ref.run(key.split("+"), torch.as_tensor(pools[hw][frame], device=device))
        want = want.cpu().numpy()
        keys.add(key)
        for got in outs:
            if got.shape != want.shape:
                shape_errors += 1
                wrong += want.size
                continue
            diff = np.abs(got.astype(np.int64) - want)
            wrong += int(np.count_nonzero(diff))
            worst = max(worst, int(diff.max()) if diff.size else 0)
    checked = sum(len(v) for v in by_input.values())
    return {
        "wrong_pixels": {"value": wrong, "limit": 0},
        "max_abs_diff": {"value": worst, "limit": 0},
        "wrong_shapes": {"value": shape_errors, "limit": 0},
        "unanswered": {"value": unanswered, "limit": 0},
        # A floor, not a ceiling: fewer checked answers than this is a fault.
        "checked_min": {"value": checked, "limit": min_checked},
        "works_unchecked": {"value": len(set(mix_keys) - keys), "limit": 0},
    }


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    """Every number at or under its limit; a name ending in ``_min`` is a
    floor, at or over it."""
    return all(v["value"] >= v["limit"] if k.endswith("_min") else v["value"] <= v["limit"]
               for k, v in checks.items())
