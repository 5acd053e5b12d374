"""Serving example on the PyTorch/CUDA port: batched prefill and
autoregressive decode with preallocated caches (the serve step the
``decode_*`` dry-run cells run), at a reduced config.

The counterpart of `examples/lm_serve.py`, with its flags and defaults,
plus ``--device`` (default ``cuda``; ``--device cpu`` runs the kernels'
plain versions). The reduced config's head dim is 64, a head dim of the
attention kernel (`kernels.flash_attn.HEAD_DIMS`), so every arch serves
on the card; the prompt is drawn from a seeded `torch.Generator`:

    PYTHONPATH=src python examples/torch_lm_serve.py --arch mamba2-1.3b \
        --tokens 24
"""
import argparse
import time

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.runtime import lm_serve as serve

HEAD_DIM = 64


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = reduced_config(get_config(args.arch), head_dim=HEAD_DIM)
    params = transformer.init_params(0, cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    n_text = args.prompt_len - cfg.prefix_len
    prompt = {"tokens": torch.randint(0, cfg.vocab_size,
                                      (args.batch, n_text), generator=gen,
                                      device=dev, dtype=torch.int32)}
    if cfg.prefix_len:
        prompt["prefix_embed"] = torch.randn(
            (args.batch, cfg.prefix_len, cfg.d_model), generator=gen,
            device=dev)

    s_max = args.prompt_len + args.tokens + 8
    t0 = time.time()
    out = serve.generate(params, cfg, prompt, n_tokens=args.tokens,
                         s_max=s_max)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    print(f"arch={args.arch} (reduced) batch={args.batch} "
          f"prompt={args.prompt_len} generated={args.tokens} device={dev}")
    print(f"throughput: {args.batch * args.tokens / dt:.1f} tok/s "
          f"(includes the first call's kernel build)")
    print("first sequences:", out[:2].cpu().tolist())


if __name__ == "__main__":
    main()
