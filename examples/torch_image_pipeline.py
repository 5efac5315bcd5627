"""The Pixie overlay as a first-class data-pipeline feature, on the card.

Twin of ``examples/image_pipeline.py``.  A VLM preprocessing pipeline
where the image filter bank runs on the VCGRA overlay (B1, and B2 for
named channels, on the card): switching augmentation/filter policy is a
settings swap (never a rebuild), exactly the overlay's value proposition
transplanted into a production data path.  The filtered images feed the
SigLIP-stub patch embedder used by the paligemma-3b config.

    PYTHONPATH=src python examples/torch_image_pipeline.py [--device cpu]
"""

import argparse
import time

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.core.interpreter import check_device
from repro_torch.data import PixiePreprocessor, patch_embed_stub, synthetic_images
from repro_torch.kernels import build
from repro_torch.kernels.vcgra import specialized


def built() -> int:
    """Kernel libraries and NVRTC modules loaded so far in this process."""
    return len(build._libs) + len(specialized._MODULES)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    cfg = get_arch("paligemma-3b")
    pre = PixiePreprocessor(filters=("sobel_mag", "gauss3", "sharpen", "laplace"),
                            device=device)
    print(f"overlay grid: {pre.grid}")

    images = synthetic_images(8, (64, 64))
    t0 = time.perf_counter()
    feats = {}
    loaded = []
    for name in pre.filters:
        pre.reconfigure(name)           # settings swap, no rebuild
        feats[name] = pre.batch(images).cpu().numpy()
        loaded.append(built())
    dt = time.perf_counter() - t0
    assert loaded == [loaded[0]] * len(loaded), f"a settings swap loaded a kernel: {loaded}"
    print(f"4 filter policies x 8 images through one overlay executable "
          f"in {dt:.2f}s ({loaded[0]} kernel libraries loaded after the first policy, "
          f"none after the swaps)")

    # stub patch embeddings for the VLM (dry-run feeds these shapes)
    emb = patch_embed_stub(feats["sobel_mag"], cfg.prefix_tokens, cfg.d_model)
    print(f"patch embeddings for {cfg.name}: {emb.shape} "
          f"(prefix_tokens={cfg.prefix_tokens}, d_model={cfg.d_model})")
    assert emb.shape == (8, cfg.prefix_tokens, cfg.d_model)
    print("pipeline complete  [ok]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
