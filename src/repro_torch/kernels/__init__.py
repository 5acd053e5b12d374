"""Hand-written Hopper kernels of the port and their wrappers.

Each kernel module (`fitness`, `domination`, `tree_infer`, `qmatmul`,
`flash_attn`, `fault_sim`) holds the CUDA wrapper, its plain PyTorch
version, and a launch counter for the wrapper (`flash_attn` two: the
forward and `flash_attention_backward`, its gradient). Two replace no TPU
kernel: `flash_attention_backward`, and `fault_sim.fault_lanes`, the
stuck-at simulator's level chain, which the JAX package runs as jnp;
`ops` holds the operand preparation and the call sites the search and the
server use. `launch_counts` / `reset_launch_counts` read and
clear the counters, so a run can show that it went through the kernels.
A wrapper counts a launch in the counter ``launches.<wrapper>`` of
`runtime.trace` (`launched` reads one), so a launch captured in a CUDA
graph counts at each replay of the graph, not at the capture
(`runtime.graphs.record`).
The non-dominated sort's two wrappers (`domination.domination_bits` and the
peel, `domination.non_dominated_rank`) count under `domination_block`, the
TPU kernel they replace together with the slab: that count is two per sort
plus one per slab.
"""
from repro_torch.kernels import (domination, fault_sim, fitness, flash_attn,
                                 qmatmul, tree_infer)
from repro_torch.runtime import trace

KERNEL_WRAPPERS = {
    "fitness_errors": fitness.fitness_correct_counts,
    "domination_block": domination.domination_block,
    "tree_infer_scores": tree_infer.tree_infer_scores,
    "qmatmul": qmatmul.qmatmul,
    "flash_attention": flash_attn.flash_attention,
    "flash_attention_backward": flash_attn.flash_attention_backward,
    "fault_lanes": fault_sim.fault_lanes,
}


SORT_WRAPPERS = (domination.domination_bits, domination.non_dominated_rank)


def launched(wrapper) -> int:
    """Launches that ``wrapper`` counted since the last reset."""
    return trace.counters().get(f"launches.{wrapper.__name__}", 0)


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last reset, by TPU kernel name."""
    counts = {name: launched(fn) for name, fn in KERNEL_WRAPPERS.items()}
    counts["domination_block"] += sum(launched(fn) for fn in SORT_WRAPPERS)
    return counts


def reset_launch_counts() -> None:
    for fn in (*KERNEL_WRAPPERS.values(), *SORT_WRAPPERS):
        trace.count(f"launches.{fn.__name__}", -launched(fn))
