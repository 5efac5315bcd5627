"""A served language model as the system under test (a configuration with
``"system": "lm"``).

The configuration names the port's architecture (``arch``, from
``repro_torch.configs.ARCHS``) with its ``overrides`` (nested groups by
their field names, e.g. ``{"moe": {"capacity_factor": 10.67}}``), the
served ``dtype``, the serving slots and cache rows (``serve``:
``max_batch``, ``max_seq``), the standard deviation of the seeded
weights (``init_std``), the plain reference's module (``reference``),
``model`` (the numbers the reference and the yardstick read, checked here
against the architecture the port builds) and ``check`` (the limits of
:mod:`benchlib.lmcheck`).  ``"reduce": true`` builds the port's reduced
twin of the architecture (``configs.reduced``): the tests' small size.

Set-up makes the weights from the seed on the device
(``benchlib.weights``) and serves them through the port's continuous-
batching entry, ``SlotServer(LM(arch), weights, ServeConfig(max_batch,
max_seq))``; warm-up admits every client's first request.  The load is a
closed loop with one client a slot, on one thread: each free slot takes
its client's next request through ``add_request`` (a prefill), then one
``tick`` decodes every active slot;
a request ends at its drawn output length (random weights have no end of
sequence), and its client sends the next at once.  Every request's token
times, every tick and every prefill is recorded.

For the check the instance's ``lm.decode_step`` and ``lm.prefill`` are
wrapped to keep their last logits; at each of ``check_rows`` seeded
moments of the window the next call's row of one of ``check_clients``
seeded clients is copied into a device buffer made at set-up, with the
request and the token it predicts.  With ``control`` (an
8-bit float dtype name) the port serves the weights rounded through it
(``weights.round_through``): the lower-precision control, whose answers
have to fail the check.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from benchlib import lmcheck
from benchlib import traffic as tr
from benchlib import weights as wts
from benchlib.record import LMRun, Prefill, Stream, Tick

IN_TICK = "host in SlotServer.tick"
IN_PREFILL = "host in add_request"
BETWEEN_TICKS = "host between ticks"

DTYPES = ("bfloat16", "float32")
#: ``model`` keys and the ``ArchConfig`` fields (or functions of it) they
#: have to equal.
ARCH_KEYS = {
    "vocab_size": lambda a: a.vocab_size,
    "hidden_size": lambda a: a.d_model,
    "num_hidden_layers": lambda a: a.num_layers,
    "num_attention_heads": lambda a: a.num_heads,
    "num_key_value_heads": lambda a: a.num_kv_heads,
    "head_dim": lambda a: a.head_dim,
    "moe_intermediate_size": lambda a: a.d_ff,
    "dense_intermediate_size": lambda a: a.d_ff,
    "first_k_dense_replace": lambda a: len(a.prefix_pattern),
    "n_routed_experts": lambda a: a.moe.num_experts if a.moe else 0,
    "num_experts_per_tok": lambda a: a.moe.top_k if a.moe else 0,
    "n_shared_experts": lambda a: a.moe.num_shared if a.moe else 0,
    "rope_theta": lambda a: a.rope_theta,
    "tie_word_embeddings": lambda a: a.tie_embeddings,
}


def build_arch(config: dict):
    """The port's ``ArchConfig`` as the configuration states it; raises
    where it differs from the configuration's ``model``."""
    from repro_torch.configs import get_arch, reduced

    arch = get_arch(config["arch"])
    if config.get("reduce"):
        arch = reduced(arch)
    fields = {}
    for key, value in config.get("overrides", {}).items():
        current = getattr(arch, key)
        fields[key] = (dataclasses.replace(current, **value) if isinstance(value, dict)
                       else value)
    arch = dataclasses.replace(arch, **fields)
    model = config["model"]
    wrong = {k: (model[k], get(arch)) for k, get in ARCH_KEYS.items()
             if k in model and model[k] != get(arch)}
    if arch.pattern not in (("moe",), ("dense",)) or set(arch.prefix_pattern) - {"dense"}:
        wrong["pattern"] = (arch.prefix_pattern, arch.pattern)
    if wrong:
        raise ValueError(f"{config['name']}: the port's {arch.name} differs from the "
                         f"configuration's model (stated, built): {wrong}")
    return arch


class ChatLoop(threading.Thread):
    """The closed loop: client ``c`` owns slot ``c``.  One thread makes
    every call into the server, so the load adds no thread that contends
    with it."""

    def __init__(self, sut: "System", stop: threading.Event):
        super().__init__(name="bench-chat-loop", daemon=True)
        self.sut, self.stop = sut, stop
        traffic, seed = sut.traffic, sut.seed
        self.orders = [tr.chat_requests(traffic, seed, c) for c in range(sut.clients)]
        self.sent = [0] * sut.clients
        self.marks = collections.deque(tr.sample_times(seed, 0, sut.check_rows, sut.seconds))
        self.picks = tr.rng(seed, tr.ROWS)
        self.watched = {int(c) for c in self.picks.choice(sut.clients,
                                                          int(traffic["check_clients"]),
                                                          replace=False)}
        self.t_start = None                       # set when the window opens
        self.streams: List[Stream] = []
        self.ticks: List[Tick] = []
        self.prefills: List[Prefill] = []
        self.slots: Dict[int, Stream] = {}
        self.rows: List[tuple] = []               # (stream, token index) a kept row

    def admit(self, client: int) -> None:
        sut = self.sut
        prompt_len, target = next(self.orders[client])
        stream = Stream(client, self.sent[client], prompt_len, target, time.perf_counter())
        self.sent[client] += 1
        self.streams.append(stream)
        ids = tr.prompt_ids(sut.seed, client, stream.index, prompt_len, sut.vocab)
        t0 = time.perf_counter()
        sut.server.add_request(client, ids)
        t1 = time.perf_counter()
        self.prefills.append(Prefill(t0, t1, prompt_len))
        stream.token_times.append(t1)
        self.slots[client] = stream
        self.keep_row(t1, [client])
        if target <= 1:
            self.finish(client, t1)

    def finish(self, client: int, t: float) -> None:
        stream = self.slots.pop(client)
        stream.tokens = self.sut.server.finish(client)
        stream.t_done = t
        if not self.stop.is_set():
            self.admit(client)

    def keep_row(self, t: float, slots: List[int]) -> None:
        """Copy one last logits row for each seeded moment passed, from the
        watched clients among ``slots`` (each at most once a call)."""
        marks, watched = self.marks, [s for s in slots if s in self.watched]
        if self.t_start is None or not watched:
            return
        due = 0
        while marks and t - self.t_start >= marks[0]:
            marks.popleft()
            due += 1
        if not due:
            return
        sut = self.sut
        kind, last = sut.last
        for slot in self.picks.choice(watched, size=min(due, len(watched)), replace=False):
            slot = int(slot)
            sut.rows[len(self.rows)].copy_(last[0 if kind == "prefill" else slot])
            self.rows.append((self.slots[slot], len(sut.server.outputs[slot]) - 1))

    def step(self) -> None:
        server = self.sut.server
        active = sorted(self.slots)
        rows = sum(self.slots[s].prompt_len + len(server.outputs[s]) for s in active)
        t0 = time.perf_counter()
        server.tick()
        t1 = time.perf_counter()
        self.ticks.append(Tick(t0, t1, len(active), rows))
        for s in active:
            self.slots[s].token_times.append(t1)
        self.keep_row(t1, active)
        for s in active:
            if len(server.outputs[s]) >= self.slots[s].target:
                self.finish(s, t1)

    def run(self) -> None:
        try:
            while not self.stop.is_set():
                self.step()
        except Exception as exc:  # noqa: BLE001 -- a raise fails the requests it held
            now = time.perf_counter()
            for stream in self.slots.values():
                stream.error, stream.t_done = type(exc).__name__, now
            self.error = repr(exc)
        finally:
            for slot, stream in self.slots.items():
                stream.tokens = list(self.sut.server.outputs.get(slot, ()))


class System:
    """One run's served model: the weights, the server and the clients."""

    between = BETWEEN_TICKS

    def __init__(self, cell, seed: int, seconds: float, device: str, marks: list,
                 control: Optional[str] = None, traffic_overrides: Optional[dict] = None):
        import torch
        from repro_torch.models import LM
        from repro_torch.serve import ServeConfig, SlotServer

        marks.append(("port import", time.perf_counter()))
        config = cell.config
        self.seed, self.seconds = seed, seconds
        self.traffic = {**cell.traffic, **(traffic_overrides or {})}
        serve = config["serve"]
        self.clients = int(self.traffic["clients"])
        if self.clients != int(serve["max_batch"]):
            raise ValueError(f"{self.clients} clients for {serve['max_batch']} slots")
        longest = (int(self.traffic["prompt_tokens"]["high"])
                   + int(self.traffic["output_tokens"]["high"]))
        if longest > int(serve["max_seq"]):
            raise ValueError(f"requests of up to {longest} tokens; the cache holds "
                             f"{serve['max_seq']}")
        self.check_rows = int(self.traffic["check_rows"])
        if config["dtype"] not in DTYPES:
            raise ValueError(f"dtype {config['dtype']!r}; served dtypes: {DTYPES}")
        compute = getattr(torch, config["dtype"])
        arch = build_arch(config)
        self.vocab = arch.vocab_size
        lm = LM(arch, compute_dtype=compute)
        self.layout = wts.template(lm.abstract_params(), compute)
        dev = torch.device(device)
        params = wts.make(self.layout, seed, dev, float(config["init_std"]))
        if control:
            wts.round_through(params, getattr(torch, control))
        marks.append(("weights", time.perf_counter()))
        self.server = SlotServer(lm, params, ServeConfig(int(serve["max_batch"]),
                                                         int(serve["max_seq"])), device=dev)
        self.device = self.server.device
        del params
        self.last = (None, None)
        self._wrap(lm)
        self.rows = torch.zeros((self.check_rows, self.vocab), dtype=torch.float32,
                                device=self.device)
        marks.append(("server", time.perf_counter()))
        self.load = None

    def _wrap(self, lm) -> None:
        """Keep a reference to the last logits of each call, on the instance."""
        real_prefill, real_decode = lm.prefill, lm.decode_step

        def prefill(*args, **kwargs):
            out = real_prefill(*args, **kwargs)
            self.last = ("prefill", out[0])
            return out

        def decode_step(*args, **kwargs):
            out = real_decode(*args, **kwargs)
            self.last = ("decode", out[0])
            return out

        object.__setattr__(lm, "prefill", prefill)
        object.__setattr__(lm, "decode_step", decode_step)

    def warm(self, stop) -> None:
        """Prefill each of the traffic's prompt lengths once, longest first,
        freeing the slot each time (every prefill shape is met, and the
        allocator holds the largest prefill's buffers), then admit every
        client's first request and decode ``warm_ticks`` ticks: the kernel
        libraries are built or loaded, and every slot serves a request
        before the clients start."""
        server = self.server
        lengths = sorted(set(tr.strata(self.traffic["prompt_tokens"],
                                       int(self.traffic["block"]))), reverse=True)
        for n in lengths:
            server.add_request(0, tr.prompt_ids(self.seed, self.clients, n, n, self.vocab))
            server.finish(0)
        self.load = ChatLoop(self, stop)
        for client in range(self.clients):
            self.load.admit(client)
        for _ in range(int(self.traffic["warm_ticks"])):
            self.load.step()

    def start(self) -> None:
        self.load.start()

    def host_spans(self):
        return _LoadSpans(self.load)

    def open_window(self, t_start: float) -> None:
        self.load.t_start = t_start
        self.window_cpu = [time.process_time(), sum(g["collections"] for g in gc.get_stats())]

    def close_window(self) -> None:
        self.window_cpu = [time.process_time() - self.window_cpu[0],
                           sum(g["collections"] for g in gc.get_stats()) - self.window_cpu[1]]

    def drain(self, timeout: float) -> None:
        self.load.join(timeout)
        self.stuck = self.load.is_alive()

    def close(self, timeout: float) -> None:
        pass

    def record(self, **common) -> LMRun:
        """The run's records; the server and its weights are let go."""
        load = self.load
        run = LMRun(streams=load.streams, ticks=load.ticks, prefills=load.prefills, **common)
        self.kept = load.rows
        self.counters = {"ticks": len(run.window_ticks()),
                         "prefills": len(run.window_prefills()),
                         "load_error": getattr(load, "error", None), "stuck": self.stuck,
                         "process_cpu_s": self.window_cpu[0], "gc_runs": self.window_cpu[1]}
        self.last = (None, None)
        del self.server, self.load
        return run

    def check(self, run: LMRun):
        return lmcheck.check(self, run)


class _LoadSpans:
    """The load's ticks and prefills as the trace's host spans."""

    def __init__(self, load: ChatLoop):
        self.load = load

    @property
    def spans(self):
        return ([(IN_TICK, k.t0, k.t1) for k in self.load.ticks]
                + [(IN_PREFILL, p.t0, p.t1) for p in self.load.prefills])

    def close(self) -> None:
        pass


def tally(run: LMRun, counters: dict):
    """``(attempted, failed)``: requests finished in the window, and those
    that raised (a load left running counts every request it held)."""
    failed = len(run.failed())
    if counters.get("stuck"):
        failed += sum(1 for s in run.streams if s.t_done is None)
    return len(run.completed()) + failed, failed


def report(run: LMRun, counters: dict) -> List[str]:
    """Standard error's lines about the window."""
    ticks, prefills = run.window_ticks(), run.window_prefills()
    step_ms = sorted(1e3 * (k.t1 - k.t0) for k in ticks)
    pre_ms = sorted(1e3 * (p.t1 - p.t0) for p in prefills)
    tokens = sum(run.inside(t) for s in run.streams for t in s.token_times)
    lines = [f"host CPUs in the window: {run.host_cpu}; this process "
             f"{counters['process_cpu_s'] / run.window_s:.2f} CPUs, "
             f"{counters['gc_runs']} garbage collections",
             f"window: ticks={len(ticks)} prefills={len(prefills)} tokens={tokens} "
             f"finished={len(run.completed())} failed={len(run.failed())}"]
    if step_ms:
        lines.append(f"tick ms p50 {step_ms[len(step_ms) // 2]:.2f} max {step_ms[-1]:.2f}; "
                     f"active slots mean {np.mean([k.active for k in ticks]):.2f}")
    if pre_ms:
        lines.append(f"prefill ms p50 {pre_ms[len(pre_ms) // 2]:.2f} max {pre_ms[-1]:.2f}; "
                     f"prompt tokens {sum(p.tokens for p in prefills)}")
    if counters.get("check_notes"):
        lines.append(counters["check_notes"])
    if counters.get("load_error"):
        lines.append(f"load stopped on {counters['load_error']}")
    return lines
