"""The paper's technique carried to the LM zoo, on the PyTorch/CUDA port:
NSGA-II mixed-precision search over per-tensor (bits, snap-margin) genes,
the comparator chromosome applied to matmul weights
(`repro_torch.quantize`).

Trains a tiny LM briefly, then searches the (loss increase, hardware cost)
space. Cost = bytes + CSD multiplier cost of the snapped codes. The
counterpart of `examples/lm_quant_search.py`, with its flags and
defaults, plus ``--device`` (default ``cuda``; ``--device cpu`` runs the
kernels' plain versions); its head dim is 64, a head dim of the attention
kernel; the GA draws from a seeded `torch.Generator`:

    PYTHONPATH=src python examples/torch_lm_quant_search.py --arch gemma-2b
"""
import argparse

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core import nsga2
from repro_torch.data import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.models import lm, transformer
from repro_torch.optim import adamw
from repro_torch.quantize import make_lm_quant_problem, quantizable_tensors
from repro_torch.runtime import train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--train-steps", type=int, default=30)
    ap.add_argument("--pop", type=int, default=16)
    ap.add_argument("--gens", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = reduced_config(get_config(args.arch), d_model=128, n_layers=3,
                         d_ff=512, vocab_size=2048, prefix_len=0,
                         loss_chunk=2048, head_dim=64)
    params = transformer.init_params(0, cfg, device=dev)

    # brief training so quantization has real structure to preserve
    opt = adamw(lr=3e-3)
    step_fn = train.make_train_step(cfg, optimizer=opt)
    state = train.init_train_state(params, opt)
    data = SyntheticLMData(cfg.vocab_size, 128, 16, seed=1)
    metrics = None
    for s in range(args.train_steps):
        state, metrics = step_fn(state, {"tokens": torch.as_tensor(
            data.batch(s)["tokens"], device=dev)})
    params = state.params
    if metrics is not None:
        print(f"trained tiny {args.arch}: loss {float(metrics['loss']):.3f} "
              f"device={dev}")

    eval_batch = {"tokens": torch.as_tensor(data.batch(10_000)["tokens"],
                                            device=dev)}
    fitness, n_genes, base = make_lm_quant_problem(
        params, cfg, eval_batch, lambda p, b: lm.lm_loss(p, cfg, b)[0])
    n_tensors = len(quantizable_tensors(params))
    print(f"searching {n_tensors} tensors ({n_genes} genes), "
          f"float loss {base:.3f}")

    ga = nsga2.NSGA2Config(pop_size=args.pop, n_generations=args.gens)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = nsga2.run(gen, lambda g: torch.as_tensor(
        fitness(g.cpu().numpy()), device=g.device), n_genes, ga)
    objs, _ = nsga2.pareto_front(state.objs, state.genes)
    print("\npareto (loss increase, cost vs bf16):")
    for o in objs:
        print(f"  dloss={o[0]:+.4f}  cost={o[1]:.3f} "
              f"({1 / max(o[1], 1e-9):.2f}x smaller than bf16)")
    ok = objs[objs[:, 0] <= 0.02]
    if len(ok):
        best = ok[ok[:, 1].argmin()]
        print(f"\n@<=0.02 loss increase: {1 / best[1]:.2f}x cost reduction "
              f"— the paper's area-accuracy trade carried to the LM zoo")


if __name__ == "__main__":
    main()
