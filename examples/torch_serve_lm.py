"""Batched serving example on the card: prefill + decode with continuous
batching.

Twin of ``examples/serve_lm.py``.  Runs a reduced gemma-family model
through the ServeEngine (one-shot batch generation) and the SlotServer
(requests joining mid-stream), and cross-checks that both produce
identical greedy continuations.  On the card every attention layer of a
decode step runs the flash decode kernel (B7).

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.core.interpreter import check_device
from repro_torch.models import LM
from repro_torch.serve import ServeConfig, ServeEngine, SlotServer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    cfg = reduced(ARCHS["gemma-2b"])
    lm = LM(cfg, remat="none", chunk_q=64, loss_chunk=64)
    params = lm.init(torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(0)

    prompts = rng.integers(0, cfg.vocab_size, (4, 12))
    engine = ServeEngine(lm, params, ServeConfig(max_batch=4, max_seq=96), device=device)

    t0 = time.perf_counter()
    out = engine.generate(prompts, 16)
    dt = time.perf_counter() - t0
    print(f"batch generate: {out.shape[0]}x{out.shape[1]} tokens "
          f"in {dt:.2f}s (incl. the kernel build) on {device}")
    for i, row in enumerate(out):
        print(f"  seq{i}: {row[:10].tolist()}...")

    # continuous batching: second request joins two ticks late
    srv = SlotServer(lm, params, ServeConfig(max_batch=2, max_seq=96), device=device)
    srv.add_request(0, prompts[0])
    srv.tick(); srv.tick()
    srv.add_request(1, prompts[1])
    for _ in range(6):
        srv.tick()
    out0, out1 = srv.finish(0), srv.finish(1)
    np.testing.assert_array_equal(out0[:16], out[0][:len(out0)][:16])
    print("slot-server continuations match batch engine  [ok]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
