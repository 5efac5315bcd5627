"""The general traffic generator: every mix is a data file it reads.

A traffic file (``bench/workloads/<traffic>.json``) holds:

* ``loop``: ``"closed"`` -- each of ``clients`` clients sends its next
  request only once its last one has returned (``benchlib.load``);
* ``frames``: ``[[H, W, weight], ...]``, the frame sizes and their shares;
* ``sample_bits``: samples are uniform over ``[0, 2**sample_bits)``;
* ``pool``: distinct frames made per size at set-up (host arrays, as users
  upload them); a client's requests of one size cycle through the pool;
* ``mix``: the requests' work, each entry an app name or a list of stages
  (a chain); every entry is equally likely, so a repeated name weighs
  twice;
* ``warm_rounds``: rounds of one request a client served at set-up, then
  each mix entry once a size;
* ``ramp_s``: seconds the clients run before the measured window opens;
* ``request_timeout_s``: how long a client waits for one answer.

Everything is drawn from ``--seed``: the frames, each client's order of
work and sizes, and the moments at which it keeps an answer for the check.  Orders are balanced blocks -- each block holds every
mix entry (and every size, by weight) once, in a seeded order -- so every
seed gives the same set of work in another order.

A served language model's traffic file (``"loop": "closed"``, one client
a serving slot) holds instead:

* ``prompt_tokens``, ``output_tokens``: ``{"low", "high"}``, each length
  log-uniform over ``[low, high]``, drawn as the midpoints of ``block``
  equal-probability strata (:func:`strata`): a client's requests go
  through blocks that hold every prompt length and every output length
  once, each in its own seeded order, so every seed serves the same
  lengths in another pairing and order;
* each client's first request is what is left of a request in flight
  when the server runs steadily: its output length is drawn from the
  stationary law of a request's remaining tokens (density proportional to
  the chance that an output is longer), as the midpoints of ``clients``
  equal strata in a seeded order (:func:`first_outputs`); so the window
  opens on a steady server, and every seed sees the same completions in
  it;
* ``warm_ticks``, ``ramp_s``; ``check_rows`` (logits rows kept for the
  check, at seeded moments of the window, from ``check_clients`` seeded
  clients) and ``check_tokens_min`` (the fewest served tokens the check
  has to judge).

Prompt token ids are uniform over the configuration's vocabulary, one
seeded stream a request.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple, Union

import numpy as np

Work = Union[str, List[str]]

#: Streams of the seed: frames, client orders, output samples; a served
#: model's prompt tokens, request lengths, first-request shares and the
#: check's choice of rows.
FRAMES, ORDER, SAMPLE, TOKENS, LENGTHS, SHARES, ROWS = 0, 1, 2, 3, 4, 5, 6


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of ``seed`` (any whole number)."""
    return np.random.default_rng(np.random.SeedSequence([abs(int(seed)), int(seed < 0), *stream]))


def work_key(work: Work) -> str:
    """A request's work as one name: an app, or a chain's stages joined
    by ``+`` (the front end's own job name)."""
    return work if isinstance(work, str) else "+".join(work)


def sizes(traffic: dict) -> List[Tuple[int, int]]:
    return [(int(h), int(w)) for h, w, _ in traffic["frames"]]


def frame_pool(traffic: dict, seed: int) -> Dict[Tuple[int, int], np.ndarray]:
    """``pool`` frames a size, ``[pool, H, W]`` int32, uniform samples."""
    gen = rng(seed, FRAMES)
    high = 1 << int(traffic["sample_bits"])
    return {hw: gen.integers(0, high, (int(traffic["pool"]), *hw), dtype=np.int32)
            for hw in sizes(traffic)}


def client_requests(traffic: dict, seed: int, client: int
                    ) -> Iterator[Tuple[Work, Tuple[int, int], int]]:
    """Client ``client``'s requests in order, without end: ``(work, size,
    frame index)``.  Its j-th frame of a size is ``(client + clients * j) %
    pool``, so at most one request in flight holds a frame while
    ``clients <= pool``."""
    gen = rng(seed, ORDER, client)
    mix = traffic["mix"]
    size_block = [hw for (h, w, weight) in traffic["frames"]
                  for hw in [(int(h), int(w))] * int(weight)]
    clients, pool = int(traffic["clients"]), int(traffic["pool"])
    used = {hw: 0 for hw in sizes(traffic)}
    while True:
        works = [mix[i] for i in gen.permutation(len(mix))]
        hws = [size_block[i] for i in gen.permutation(len(size_block))]
        for k, work in enumerate(works):
            hw = hws[k % len(hws)]
            yield work, hw, (client + clients * used[hw]) % pool
            used[hw] += 1


def sample_times(seed: int, client: int, k: int, seconds: float) -> List[float]:
    """When client ``client`` marks its next request for the check: ``k``
    seeded offsets into the window, in order.  A sample by time covers the
    whole window whatever the rate, and keeps the same number of answers in
    every run."""
    return sorted(rng(seed, SAMPLE, client).uniform(0.0, seconds, k).tolist())


def strata(spec: dict, block: int) -> List[int]:
    """``block`` lengths log-uniform over ``[low, high]``: the midpoint of
    each of ``block`` equal-probability strata, rounded."""
    lo, hi = float(spec["low"]), float(spec["high"])
    return [int(round(lo * (hi / lo) ** ((i + 0.5) / block))) for i in range(block)]


def first_outputs(traffic: dict, seed: int) -> List[int]:
    """Each client's first output length: the midpoints of ``clients``
    equal strata of a steady server's remaining-token law over the output
    strata, in a seeded order."""
    n = int(traffic["clients"])
    outs = np.array(strata(traffic["output_tokens"], int(traffic["block"])), dtype=np.float64)
    grid = np.arange(0.0, outs.max() + 1.0)
    cdf = np.minimum(grid[:, None], outs[None, :]).sum(axis=1) / outs.sum()
    left = np.interp((np.arange(n) + 0.5) / n, cdf, grid)
    return [max(1, int(np.ceil(left[k]))) for k in rng(seed, SHARES).permutation(n)]


def chat_requests(traffic: dict, seed: int, client: int) -> Iterator[Tuple[int, int]]:
    """Client ``client``'s requests in order, without end: ``(prompt
    tokens, output tokens)``."""
    gen = rng(seed, LENGTHS, client)
    block = int(traffic["block"])
    prompts = strata(traffic["prompt_tokens"], block)
    outputs = strata(traffic["output_tokens"], block)
    first = first_outputs(traffic, seed)[client]
    while True:
        for a, b in zip(gen.permutation(block), gen.permutation(block)):
            out, first = (first or outputs[b]), None
            yield prompts[a], out


def prompt_ids(seed: int, client: int, index: int, length: int, vocab: int) -> np.ndarray:
    """The token ids of client ``client``'s request ``index``: ``length``
    ids uniform over ``[0, vocab)``."""
    return rng(seed, TOKENS, client, index).integers(0, vocab, length, dtype=np.int64)
