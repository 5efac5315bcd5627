"""Training CLI.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --steps 200 --batch 8 --seq 256 --reduced --ckpt-dir /tmp/ckpt

Twin of the reference's ``launch/train.py`` with the same flags, plus
``--device`` (``cuda`` unless asked for ``cpu``).  Without ``--reduced``
it trains the full config on one card: float32 master weights and AdamW
moments (gemma-2b: 2.5 B parameters, ~45 GB with the grads and the bf16
copy).  paligemma's stub patch embeddings are drawn with numpy's
``default_rng(step)``, as the reference draws them.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import ARCHS, get_arch, reduced
from repro_torch.core.interpreter import check_device
from repro_torch.data import TokenPipeline
from repro_torch.models.lm import LM
from repro_torch.optim import AdamWConfig
from repro_torch.train import LoopConfig, train_loop


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=None,
                    help="override d_model (e.g. ~100M demo)")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = check_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        over = {}
        if args.d_model:
            over.update(
                d_model=args.d_model, head_dim=max(args.d_model // 8, 16),
                num_heads=4, num_kv_heads=2,
                d_ff=4 * args.d_model if cfg.d_ff else 0,
            )
        if args.layers:
            pat = len(cfg.pattern)
            over["num_layers"] = len(cfg.prefix_pattern) + pat * max(
                1, args.layers // pat
            )
        cfg = reduced(cfg, **over)

    lm = LM(cfg, remat="none", chunk_q=min(512, args.seq),
            loss_chunk=min(512, args.seq))
    pipeline = TokenPipeline(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed,
    )
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(100, args.steps // 10 + 1),
                          total_steps=args.steps)
    loop_cfg = LoopConfig(
        steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, seed=args.seed,
    )
    pe_fn = None
    if cfg.modality == "vision_stub":
        def pe_fn(step):
            rng = np.random.default_rng(step)
            return rng.standard_normal(
                (args.batch, cfg.prefix_tokens, cfg.d_model)
            ).astype(np.float32) * 0.02

    hist = train_loop(lm, loop_cfg, opt_cfg, pipeline, prefix_embed_fn=pe_fn, device=device)
    print(
        f"final loss {hist['_final'][0]:.4f}  "
        f"median throughput {hist['throughput_tok_s'][0]:,.0f} tok/s"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
