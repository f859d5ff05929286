"""Batched serving on the PyTorch + CUDA port: prefill + greedy decode
with KV/SSM caches, for an attention arch (ring-buffer SWA cache), an
attention-free one (O(1) state) and the VLM (cross-attention image
cache) — the port of ``examples/serve_lm.py``.

  PYTHONPATH=src python examples/torch_serve_lm.py              # the card
  PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.launch.serve import generate
from repro_torch.models.model import Model


def demo(arch: str, batch=4, prompt_len=24, gen=12, device=None):
    cfg = reduced(get_config(arch))
    model = Model(cfg)
    params = model.init(device=device)
    dev = next(iter(params.values())).device
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        2, cfg.vocab_size, size=(batch, prompt_len)).astype(np.int32)).to(dev)
    img = None
    if cfg.family == "vlm":
        img = torch.from_numpy((rng.standard_normal(
            (batch, cfg.num_image_tokens, cfg.d_model)) * 0.02).astype(
                np.float32)).to(dev)
    t0 = time.time()
    out = generate(model, params, prompts, gen_len=gen,
                   cache_len=prompt_len + gen + 1, image_embeds=img,
                   device=device)
    out.cpu()
    dt = time.time() - t0
    assert out.shape == (batch, prompt_len + gen)
    print(f"[serve_lm] {arch:24s} {batch}x({prompt_len}+{gen}) tokens "
          f"in {dt:5.2f}s -> {batch*gen/dt:6.1f} tok/s; "
          f"sample tail: {out[0, -6:].cpu().numpy()}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' runs on the CPU; default the CUDA card")
    ap.add_argument("--gen", type=int, default=12)
    args = ap.parse_args(argv)
    return {arch: demo(arch, gen=args.gen, device=args.device)
            for arch in ("mixtral-8x7b",           # SWA ring-buffer cache
                         "rwkv6-1.6b",             # O(1) recurrent state
                         "llama-3.2-vision-11b")}  # cross-attn image cache


if __name__ == "__main__":
    main()
