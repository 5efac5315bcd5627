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
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple, Union

import numpy as np

Work = Union[str, List[str]]

#: Streams of the seed: frames, client orders, output samples.
FRAMES, ORDER, SAMPLE = 0, 1, 2


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
