"""Hand-written Hopper kernels of the port and their wrappers.

Each kernel module (`fitness`, `domination`, `tree_infer`, `qmatmul`,
`flash_attn`) holds the CUDA wrapper, its plain PyTorch version, and a
launch counter on the wrapper; `ops` holds the operand preparation and the call sites the
search and the server use. `launch_counts` / `reset_launch_counts` read and
clear the counters, so a run can show that it went through the kernels.
"""
from repro_torch.kernels import (domination, fitness, flash_attn, qmatmul,
                                 tree_infer)

KERNEL_WRAPPERS = {
    "fitness_errors": fitness.fitness_correct_counts,
    "domination_block": domination.domination_block,
    "tree_infer_scores": tree_infer.tree_infer_scores,
    "qmatmul": qmatmul.qmatmul,
    "flash_attention": flash_attn.flash_attention,
}


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last reset, by TPU kernel name."""
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
