"""End-to-end training driver on the card: a ~100M-parameter gemma-family
model for a few hundred steps, with checkpoint/restart fault tolerance.

Twin of ``examples/train_lm.py``, plus the restart the reference's loop
implies: after training, ``resume_or_init`` reads the last checkpoint back
from the same directory.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--device cpu]

``--small`` trains a narrow two-layer model of the same family instead
(a CPU-sized smoke run).  The same ``repro_torch.train`` stack drives
full-size archs (``python -m repro_torch.launch.train``).
"""

import argparse
import dataclasses
import shutil
import tempfile

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_arch
from repro_torch.core.interpreter import check_device
from repro_torch.data import TokenPipeline
from repro_torch.models import LM
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.runtime import resume_or_init
from repro_torch.train import LoopConfig, train_loop
from repro_torch.tree import leaves


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="2 layers, d=64, vocab 512 instead of ~100M parameters")
    args = ap.parse_args(argv)
    device = check_device(args.device)

    # ~100M params: gemma-family, 8 layers, d=768, vocab 32768
    base = get_arch("gemma-2b")
    size = (dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
                 d_ff=256, vocab_size=512) if args.small else
            dict(num_layers=8, d_model=768, num_heads=8, num_kv_heads=1, head_dim=96,
                 d_ff=3072, vocab_size=32_768))
    cfg = dataclasses.replace(base, name="gemma-small" if args.small else "gemma-100m",
                              **size)
    lm = LM(cfg, remat="none", chunk_q=128, loss_chunk=128)
    with FakeTensorMode():   # shapes only, like the reference's eval_shape
        n_params = sum(x.numel() for x in leaves(lm.init(torch.Generator().manual_seed(0))))
    print(f"model: {cfg.name}  params={n_params/1e6:.1f}M  on {device}")

    cycle = max(1, min(16, args.steps // 4))

    class CyclingPipeline(TokenPipeline):
        """Cycle over a fixed batch set so the demo has learnable signal
        (the raw hash stream is uniform => CE would flatline at ln V)."""

        def batch_at(self, step):
            return super().batch_at(step % cycle)

    pipeline = CyclingPipeline(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch
    )
    ckpt_dir = tempfile.mkdtemp(prefix="pixie_train_")
    loop_cfg = LoopConfig(steps=args.steps, ckpt_every=100, ckpt_dir=ckpt_dir, log_every=20)
    try:
        hist = train_loop(
            lm, loop_cfg,
            AdamWConfig(lr=3e-4, warmup_steps=30, total_steps=args.steps),
            pipeline, device=device,
        )
        first, last = hist["loss"][0], hist["loss"][-1]
        print(f"\nloss: {first:.3f} -> {last:.3f} over {args.steps} steps "
              f"({hist['throughput_tok_s'][0]:,.0f} tok/s median)")
        assert last < first, "training did not reduce the loss"
        print("training reduced the loss  [ok]")

        # restart: a new process would find the checkpoint and resume there
        def init_fn():
            params = lm.init(torch.Generator(device=device).manual_seed(loop_cfg.seed))
            return {"params": params, "opt": init_opt_state(params)}

        state = resume_or_init(Checkpointer(ckpt_dir), init_fn)
        assert state.resumed and state.step == args.steps, (state.resumed, state.step)
        print(f"restart: resume_or_init read back step {state.step} from {ckpt_dir}  [ok]")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
