"""Hand-written Hopper kernels of the port and their wrappers.

Each kernel module (`fitness`, `domination`, `tree_infer`, `qmatmul`,
`flash_attn`) holds the CUDA wrapper, its plain PyTorch version, and a
launch counter on the wrapper (`flash_attn` two: the forward and
`flash_attention_backward`, its gradient, which replaces no TPU kernel);
`ops` holds the operand preparation and the call sites the search and the
server use. `launch_counts` / `reset_launch_counts` read and
clear the counters, so a run can show that it went through the kernels;
a launch captured in a CUDA graph counts at each replay of the graph
(`rewind_launches`, `add_launches`).
The non-dominated sort's two wrappers (`domination.domination_bits` and the
peel, `domination.non_dominated_rank`) count under `domination_block`, the
TPU kernel they replace together with the slab: that count is two per sort
plus one per slab.
"""
from repro_torch.kernels import (domination, fitness, flash_attn, qmatmul,
                                 tree_infer)

KERNEL_WRAPPERS = {
    "fitness_errors": fitness.fitness_correct_counts,
    "domination_block": domination.domination_block,
    "tree_infer_scores": tree_infer.tree_infer_scores,
    "qmatmul": qmatmul.qmatmul,
    "flash_attention": flash_attn.flash_attention,
    "flash_attention_backward": flash_attn.flash_attention_backward,
}


SORT_WRAPPERS = (domination.domination_bits, domination.non_dominated_rank)


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last reset, by TPU kernel name."""
    counts = {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}
    counts["domination_block"] += sum(fn.launches for fn in SORT_WRAPPERS)
    return counts


def reset_launch_counts() -> None:
    for fn in (*KERNEL_WRAPPERS.values(), *SORT_WRAPPERS):
        fn.launches = 0


def launch_snapshot() -> tuple[int, ...]:
    """Every wrapper's launch counter, for `rewind_launches`."""
    return tuple(fn.launches for fn in (*KERNEL_WRAPPERS.values(),
                                        *SORT_WRAPPERS))


def rewind_launches(before: tuple[int, ...]) -> tuple[int, ...]:
    """Set the counters back to ``before`` and return what was added since:
    the launches a CUDA graph captured, which run only when it is replayed
    (`add_launches` counts them then)."""
    fns = (*KERNEL_WRAPPERS.values(), *SORT_WRAPPERS)
    added = tuple(fn.launches - b for fn, b in zip(fns, before))
    for fn, b in zip(fns, before):
        fn.launches = b
    return added


def add_launches(added: tuple[int, ...]) -> None:
    """Count one replay of a graph that captured ``added`` launches."""
    for fn, n in zip((*KERNEL_WRAPPERS.values(), *SORT_WRAPPERS), added):
        fn.launches += n
