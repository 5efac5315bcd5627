"""Whether what a served model's timed path produced is correct.

Once the window has closed, the memory peak has been read and the server
is freed, the benchmark makes the weights again from the seed (it never
reads the program's copy) and runs the configuration's plain reference
(``bench/reference/<name>.py``, which imports nothing of the port) over
the token histories of a sample of the served requests: every request one
of the ``check_rows`` kept logits rows belongs to, and the longest request
finished in the window.  A history is the request's prompt (made again
from the seed) and every token the port served it.

Numbers compared, each against the limit the configuration's ``check``
states (``PERF.md`` gives the readings each was set from):

* ``token_gap_max``: over every served token of those requests, the gap by
  which the reference's float32 logit of the served token lies below its
  best logit at that position.  Greedy decoding serves the port's best
  token; where the port computes the reference's function, a served token
  is the reference's best up to rounding, so the gap is small.
* ``row_err_ratio``: the port's error in units of a plain bf16
  computation's.  A kept row's error is its widest difference from the
  float32 reference's row at the same position; the number is the median
  of the port's row errors over the median of the reference's own, run in
  the served dtype on the same histories.  Medians, as the widest row
  errors of a sound port and of the bf16 reference both come from router
  near-ties that bf16 rounding tips, and swing with them.
* ``failed_requests``: requests that raised, and a load that did not stop.
* ``rows_checked_min``, ``tokens_checked_min``: floors, at least
  ``clients`` rows and ``check_tokens_min`` served tokens judged.
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np

from benchlib import traffic as tr
from benchlib import weights as wts
from benchlib.spec import load_module

#: A router margin (bf16 spacings between the k-th and (k+1)-th router
#: probabilities) at or under which a position counts as a near-tie.
NEAR_TIE = 2.0


def check(sut, run) -> Dict[str, Dict[str, float]]:
    import torch

    config, traffic = run.config, run.traffic
    limits = config["check"]
    ref = load_module("reference", config["reference"])
    model = config["model"]
    kept = [(s, i) for s, i in sut.kept if s.ok and i < len(s.tokens)]
    chosen: List = []
    for stream, _ in kept:
        if stream not in chosen:
            chosen.append(stream)
    done = [s for s in run.completed() if s.tokens]
    if done:
        longest = max(done, key=lambda s: len(s.tokens))
        if longest not in chosen:
            chosen.append(longest)
    device = sut.device
    prompts = {id(s): torch.as_tensor(tr.prompt_ids(sut.seed, s.client, s.index, s.prompt_len,
                                                    sut.vocab), device=device) for s in chosen}

    def history(s, n):
        """The prompt and the first ``n`` served tokens."""
        return torch.cat([prompts[id(s)],
                          torch.as_tensor(s.tokens[:n], dtype=torch.int64, device=device)])

    weights = wts.make(sut.layout, sut.seed, device, float(config["init_std"]))
    hs, margins = ref.hidden(weights, model, [history(s, len(s.tokens) - 1) for s in chosen],
                             [torch.arange(s.prompt_len - 1, s.prompt_len - 1 + len(s.tokens))
                              for s in chosen])
    gap_max, n_tokens, n_best, ref_rows = 0.0, 0, 0, {}
    rows_of = {}
    for j, (s, i) in enumerate(kept):
        rows_of.setdefault(id(s), []).append((j, i))
    for s, h in zip(chosen, hs):
        lg = ref.logits(weights, h)
        served = torch.as_tensor(s.tokens, dtype=torch.int64, device=lg.device)
        gap = lg.max(dim=-1).values - lg.gather(1, served[:, None])[:, 0]
        gap_max = max(gap_max, float(gap.max()))
        n_best += int((gap == 0).sum())
        n_tokens += len(s.tokens)
        for j, i in rows_of.get(id(s), ()):
            ref_rows[j] = lg[i]
    near = [float(m[i]) <= NEAR_TIE
            for s, m in zip(chosen, margins) for _, i in rows_of.get(id(s), ())]
    del hs
    # the reference's own bf16 error at the kept rows' positions
    with_rows = [s for s in chosen if id(s) in rows_of]
    h16, _ = ref.hidden(weights, model,
                        [history(s, max(i for _, i in rows_of[id(s)])) for s in with_rows],
                        [torch.as_tensor([s.prompt_len - 1 + i for _, i in rows_of[id(s)]])
                         for s in with_rows], dtype=getattr(torch, config["dtype"]))
    port_errs, ref_errs = [], []
    for s, h in zip(with_rows, h16):
        lg16 = ref.logits(weights, h)
        for (j, _), row16 in zip(rows_of[id(s)], lg16):
            want = ref_rows[j]
            port_errs.append(float((sut.rows[j] - want).abs().max()))
            ref_errs.append(float((row16 - want).abs().max()))
    del weights
    sut.counters["check_notes"] = "check readings: " + json.dumps({
        "rows": len(kept), "requests": len(chosen), "near_tie_rows": sum(near),
        "tokens_not_best": n_tokens - n_best,
        "port_row_err": [round(e, 5) for e in port_errs],
        "ref_row_err": [round(e, 5) for e in ref_errs]})
    ratio = float(np.median(port_errs)) / max(float(np.median(ref_errs)), 1e-30) \
        if port_errs else 0.0
    failed = len(run.failed()) + int(bool(sut.counters.get("stuck")))
    return {
        "token_gap_max": {"value": gap_max, "limit": limits["token_gap_max"]},
        "row_err_ratio": {"value": ratio, "limit": limits["row_err_ratio"]},
        "failed_requests": {"value": failed, "limit": 0},
        # floors, not ceilings: fewer judged than this is a fault
        "rows_checked_min": {"value": len(kept), "limit": int(traffic["clients"])},
        "tokens_checked_min": {"value": n_tokens, "limit": int(traffic["check_tokens_min"])},
    }
