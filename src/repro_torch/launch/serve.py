"""Serving CLI: batched prefill + decode with the slot engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --reduced \
        --batch 4 --prompt-len 32 --gen 16

Twin of the reference's ``launch/serve.py`` with the same flags, plus
``--device`` (``cuda`` unless asked for ``cpu``).  Parameters come from a
``torch.Generator`` seeded with ``--seed`` on that device, drawn in the
served dtype (``LM.init(..., cast=True)``: a 16 B model's float32 copy
would not fit the card beside its bf16 one).  The cache holds
``--max-seq`` tokens after the config's modality-stub and meta positions;
paligemma's stub patch embeddings are drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_arch, reduced
from repro_torch.core.interpreter import check_device
from repro_torch.models.lm import LM
from repro_torch.serve import ServeConfig, ServeEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = check_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    lm = LM(cfg, chunk_q=64)
    params = lm.init(torch.Generator(device=device).manual_seed(args.seed), cast=True)

    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    pe = None
    if cfg.modality == "vision_stub":
        pe = (rng.standard_normal((args.batch, cfg.prefix_tokens, cfg.d_model))
              .astype(np.float32) * 0.02)
    engine = ServeEngine(
        lm, params,
        ServeConfig(max_batch=args.batch,
                    max_seq=args.max_seq + cfg.prefix_tokens + cfg.meta_tokens,
                    temperature=args.temperature, seed=args.seed),
        device=device,
    )
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.gen, prefix_embeds=pe)
    dt = time.perf_counter() - t0
    print(f"generated [{out.shape[0]} x {out.shape[1]}] tokens on {device} in {dt:.2f}s "
          f"({out.shape[0] * out.shape[1] / dt:.1f} tok/s, first call: on the card "
          "that includes the kernels' build)")
    print("first sequence:", out[0].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
