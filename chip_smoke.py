#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; one CUDA card

Phases, each of which stops the script with a non-zero exit on failure:

1. Build the seven Hopper kernel sources from `src/repro_torch/csrc/` (one
   nvcc per source, all started together, `sm_90a`) and report nvcc's
   register and spill summary, for `fitness`, `qmatmul`, `flash_attn` and
   `flash_attn_bwd` by kernel.
2. Hold each kernel to its plain PyTorch version on the card at the main
   paths' shapes (the `har` dataset: a tree of N=588 comparators and L=589
   leaves, and a printed MLP of F=561 features, H=16 hidden and C=6 output
   neurons, over B=3090 test rows): exact equality for the tree kernels
   and for `qmatmul` on the MLP's uint8 codes (the integer tensor-core
   kernel), a stated tolerance for `qmatmul` at a random scale and on
   float inputs (the CUDA-core kernel); report the fitness kernel's rows
   per block and the L2 bytes its path feed reads; hold the non-dominated
   sort (`domination_bits` and the front peel: two launches, checked to
   make no host sync under `torch.cuda.set_sync_debug_mode("error")`) to
   its plain version, the host loop, at pools 256, 1024 and 4096, and
   `tree_infer_scores` at every serving bucket and at N=2048; check that
   each kernel backend scores the exact design
   (0, 1); and time both on the device (a `torch.profiler` trace of
   back-to-back calls) beside the kernel's bound: the larger of its bytes
   over 3.35 TB/s and its operations over the peak rate of their type
   (1979 TOP/s int8 for the tree dataflow and for `qmatmul` on uint8
   codes, 67 TFLOP/s float32 outside the tensor cores for the domination
   compares and `qmatmul` on float32 x, 989 TFLOP/s bf16), and,
   for `qmatmul`, beside the one PyTorch call that computes the same
   function (`torch.mm` on the same values as float32, TF32 off).
3. The tree main path through the user's entry points: train the `har`
   tree, `run_search(backend="kernel", pop_size=512, verify_rtl=True)` into
   a temporary `pareto.json`, then `ClassifyServer.from_artifact` serving
   requests of 1, 37, 1024 and 3090 rows, each checked against the
   gate-level netlist simulation.
4. The printed-MLP main path the same way: `har` at hidden 16, pop 512,
   then `pendigits` at pop 128 (its exact design is far from chance), each
   served request checked against the netlist and the integer predict;
   `qmatmul`'s float kernel must not run on this path.
   Before each path the kernels' launch counters are set to 0 and just
   after they are read; every kernel of the path must have launched, and
   the sort's two kernels (counted under `domination_block`) twice per
   generation.
5. `[forest]`: `--trees 5` on `har` (N=2227 comparators over five trees,
   L=2232, B=3090, C=6; the script fails unless N > 2048): the trees'
   training time; both widened kernels (`fitness_errors` at P=512,
   `tree_infer_scores` at P=1) held to their plain versions, exactly, at
   the forest's block-diagonal super-tree and at a synthetic single tree of
   N=4096, each timed beside its bound with the path product counted tree
   by tree; then the forest path through the user's entry points, counted
   like the others: `run_search(backend="kernel", pop_size=512,
   verify_rtl=True)` and serving at the 1 / 37 / 1024 / 3090-row buckets,
   each request checked against the gate-level netlist.
6. `[flash]`: hold `flash_attention` to its plain version (float32 within
   2e-5; bfloat16 by `row_error`, a row's largest difference over its root
   mean square, within 2^-4) at the LM prefill's shape (llama3.2-3b at
   B=4, S=4096: H=96, Hkv=32, hd=128, bf16) in the model's (B, S, H, hd)
   layout through `flash_attention_bshd`, and the same way at zamba2-7b's
   (B=4, S=4096, H=Hkv=32, hd=112, bf16), grok-1-314b's (48 query / 8 kv
   heads, softcap 30) and kimi-k2-1t-a32b's (64 / 8); in the (H, S, hd)
   layout in float32 (hd 64 and 112), with grok's softcap 30 at S=1024, at
   gemma's MQA with head dim 256 and at a ragged S=1000; time it at the
   four model shapes beside its plain version, its bound (the bf16
   tensor-core rate) and, without a softcap, `scaled_dot_product_attention`
   (causal, GQA); and check that the model's prefill attention runs
   nothing on the card but the kernel (no layout copies). Then the
   gradient, `flash_attention_backward` (two kernels of `flash_attn_bwd.cu`
   from the forward's kept log-sum-exp; no TPU kernel: the JAX package
   differentiates its jnp attention), against its plain version by
   `grad_error` (float32 within 2^-12, bf16 within 2^-4), two calls
   bit-equal and autograd through both wrappers giving the kernel's bits,
   at llama3.2-3b's training shape (B=2, S=4096, 24 / 8 heads), zamba2-7b's
   hd 112, grok-1-314b's softcap 30 and kimi-k2-1t-a32b's heads (B=1), MQA
   at hd 256, ragged S, Sq != Skv, one query, and softcap 5 on scores that
   reach the cap in bf16 and float32, where two planted faults (D dropped,
   the cap's derivative dropped) must read 1.5 limits or more, and the
   edges of the bf16 kernels' tiles, keys that no query sees getting zero
   rows (`flash_bwd_cases`); the model shapes timed beside the plain
   backward, the bound (5/2 of the forward's causal FLOPs at the bf16 rate)
   and SDPA's backward where there is no cap, and split by kernel (the dQ
   and the dK/dV kernel, each with its issued TFLOP/s).
7. `[lm]`: the LM serving path at llama3.2-3b's full width (28 layers,
   random bf16 weights from the seed): `generate` of 32 greedy tokens after
   a B=4 x 4096-token prompt (the repo's `train_4k` length; `prefill_32k`
   would need 120 GB of cache on one card), counted: `flash_attention`
   must launch once per layer of the prefill. Decode at position 4096 is
   held to a fresh prefill over the same 4097 tokens, a second `generate`
   must give the same tokens, and prefill and decode times, peak memory and
   the device time of one prefill split into the attention kernel,
   matmuls and the rest are printed.
8. `[train]`: LM training through `launch.train`'s loop
   (`python -m repro_torch.launch.train`'s code path): llama3.2-3b at full
   width and depth, random bf16 weights from the seed, B=2 x 4096 tokens of
   `SyntheticLMData` (`train_4k`'s length; its global batch of 256 cut to
   2), AdamW on the launcher's warmup-cosine schedule, 4 steps, counted
   (`flash_attention` twice a layer a step under remat, its backward once),
   then 3 steps on one fixed batch whose loss must fall; step time,
   tokens/s, peak memory and one step's device time split into matmuls,
   the attention forward and backward, the CE loss, the optimizer and the
   elementwise rest, with the idle share. A float32 reduced llama (head dim
   64, so both attention kernels run) takes one step on the card equal to
   the CPU's (loss and grad norm within 1e-5, every gradient within 1e-4
   of its leaf's scale, every parameter moved, and AdamW given the CPU's
   gradients within 8 ulps of the CPU's update), and a reduced run resumed
   from its checkpoint equals the uninterrupted run bit for bit. Then grok-1-314b cut to 1 of 64 layers (9.8 GB of bf16
   weights with the untied embeddings), B=4 x 4096 in its grad_accum 4
   microbatches summed in bf16, Adafactor, 2 steps, counted and timed the
   same way (its attention softcapped).
9. `[ssm]`: the SSM and hybrid serving paths at mamba2-1.3b's and
   zamba2-7b's full width (48 and 81 mamba2 layers, zamba2's 13 shared
   attention invocations at head dim 112; random bf16 weights from the
   seed), each as `[lm]`: `generate` of 32 greedy tokens after the B=4 x
   4096 prompt, counted (zamba2: `flash_attention` once per super-block of
   the prefill, 13; mamba2 runs no TPU kernel: its SSD scan is plain
   PyTorch, as it is jnp in the JAX package); decode held to a fresh
   prefill within a quarter of the largest logit (the SSD takes only whole
   chunks of 256 past the first, so decode at position 255 and 3840 after
   a prefill of as many tokens is held to that position of one causal
   forward over the prompt); a second `generate` identical; prefill and
   decode times, peak memory and one prefill's device time split.
10. `[moe]`: the MoE serving path at grok-1-314b's and kimi-k2-1t-a32b's
   published width, cut to 8 of 64 and 1 of 61 layers (56.2 and 38.8 GB
   of random bf16 weights from the seed), each as `[lm]`: `generate` of 32
   greedy tokens after the B=4 x 4096 prompt, counted (`flash_attention`
   once per layer of the prefill, grok's with its softcap 30); a second
   `generate` identical; one `moe_block` call at the prefill's and at
   decode's shape under sync debug mode "error"; decode at position 4096
   against a fresh prefill of 4097 tokens, (a) as served and (b) with the
   last tokens' MoE run as one decode batch (in (a) a row's last token is
   last in its experts' queues, so the prefill drops it where an expert
   overflows), each layer's routing recorded on both sides: rows that
   picked and kept the same experts in every layer are held to the
   `[lm]` tolerance and argmax, the others logged with the first flipped
   pick's router-logit gap (a near-tie) or dropped pick, at least one row
   held in (b); prefill and decode times, peak memory, one prefill's
   device time split and one MoE layer's route, dispatch, expert products
   and combine timed alone.
11. Print where one generation's time goes on each search path (its
   survivor selection run once under sync debug mode "error", its ranks
   held to the host loop's on the same pool).
12. `[chunk]`: on the tree and MLP `har` paths, 8 generations chunked with
   `checkpoint_every=4` (each chunk one captured CUDA graph, its warm-up
   step run under sync debug mode "error") must equal the per-generation
   loop element for element; one generation's host time, device busy time
   and idle share inside a captured chunk beside an eager step's; the
   graphs captured and the dispatches.
13. `[resume]`: 8 tree `har` generations saving every 3; a fresh
   `run_search` resuming from the step-6 save must equal the uninterrupted
   run, the step-8 saves (the CUDA generator's state included) leaf for
   leaf.
14. `[sweep]`: the paper's campaign, `repro_torch.search.sweep.run_sweep`
   over the ten datasets at their real sizes (six buckets, pop 64, 40
   generations, the CLI's defaults): batched with `verify_rtl` and the
   report, then the serial loop, equal array for array; per bucket its
   dims, K, the search's seconds, one generation's host and device busy
   time inside a captured chunk, and its launches (batched: one fitness
   launch and one sort a generation for the bucket, plus the initial
   population's and the capture's warm-up step's; serial: K times that);
   the report's mean area reduction beside the paper's 3.2x; every front
   holds a point no worse than its padded exact design. The batched
   fitness kernel and the batched sort are held to K single launches and
   their plain versions at bucket 0's shape (K=5, pool 128) and timed
   beside their bounds; then a mixed campaign (seeds and vertebral
   two-tree forests in one bucket, seeds and pendigits MLPs in another,
   pop 16, 4 generations), batched == serial.
15. `[faults]`: the stuck-at campaign (`core.faults`, `search.robustness`,
   the fault-lane kernel `fault_sim.fault_lanes` on the card). The har
   tree's best point over all 3090 test rows: its zero-fault lane ==
   `netlist.simulate` == the argmax of `tree_infer_scores`' votes
   (`ops.classify`, the `--verify-rtl` leg); 16 single-fault lanes spread
   over the campaign == the numpy oracle `simulate_faulty_serial`; the
   kernel == its plain version over every single lane, timed beside its
   bound (the kernels line's `fault_lanes` row); the exhaustive single
   stuck-at campaign at the default chunk (one launch) and at `--chunk
   64` (a launch a chunk), equal, each with its launches, wall s and
   device busy s (busy and idle share from a second, traced call). The
   pendigits MLP's best point the same way (its zero-fault lane == the
   `qmatmul` server) at the default chunk and at chunk 256, the har
   forest's at the default chunk; every campaign run holds its rows at
   the 16 spread lanes to the oracle. Point reports on the card == the CPU's,
   floats included, for a seeds tree and a vertebral three-tree forest
   under both vote adders, and their Monte-Carlo draws reproduce under a
   seed. Then `sweep --fault-report` (with `--verify-rtl` and `--report`)
   on the mixed campaign: a robustness row per dataset in the report, and
   each `fault_report.json` == the CPU's but the pendigits MLP's. Its
   launches alone are the phase's count: the checks above launch kernels
   too, outside that window.
16. `[mesh]`: the multi-device search (`core.dist`, `launch.mesh`), two
   ranks spawned on the one card over gloo (NCCL refuses two ranks on one
   GPU; this checks the code and its arithmetic, not NVLink): (a) the har
   tree, kernel backend, pop 512, `mesh="2"`, 8 generations with
   verify_rtl == the single-card run of phase 3 (state and `pareto.json`);
   (b) the same run saved at generation 4 under the mesh and resumed on
   one card with no mesh == it; (c) islands on a 2-ring (256 an island,
   migrate_every 4) == the same islands run one after another in this
   process; (d) the mixed sweep campaign of phase 14 on a 2x1 mesh == its
   batched single-card run. Each rank returns its launch counts (they are
   per process); the bool `domination_block` slab, each rank's (512,
   1024) rows of the sharded sort, must have launched. A sharded
   generation's host ms beside a captured single-card chunk's, the
   collectives a generation, one `all_reduce` alone, spawn and rendezvous
   s; the slab and `fitness_errors` at a rank's shapes timed beside their
   bounds (rows `domination_block[shard]`, `fitness_errors[shard]`).
17. `[lm-mesh]`: sharded LM training (`runtime.train.make_train_step(
   rules=...)`, `sharding/`, `core.comm`) and serving on a (data=2,
   model=2) mesh of 4 ranks (sharing the one card over gloo; a card a
   rank over NCCL with four): (a) llama3.2-3b at full width cut to 2
   layers, B=4 x 1024, AdamW on the launcher's schedule, 3 steps through
   `train_loop`, the
   loss, grad norm and every gathered parameter after each step held to
   the single-card step from the same seed within 4x the spread the
   single-card step shows against the same step in float32 (printed), each
   rank's attention launches (twice and once a layer a step) on its local
   12 of 24 query and 4 of 8 kv heads; step time, tokens/s, peak memory
   and collectives a rank, one traced step's device time split with the
   collectives' share; (b) reduced float32 configs in both head modes
   ("sharded" and "replicated") on the ranks: every gradient within 1e-4
   of its leaf's scale and a step's loss and grad norm within 1e-5 of the
   CPU's single-device step; (c) (a)'s state saved sharded and restored
   onto one card and onto (data=1, model=2), equal to the gathered state
   bit for bit; (d) `compressed_psum` over a 2-rank pod axis equal to the
   CPU's arithmetic. On the same ranks, (a) again for mamba2-1.3b at full
   width, 2 layers, 2 steps (the sharded Mamba2 block), and (b) for the
   other layer kinds: reduced float32 mamba2-1.3b and zamba2-7b (7 layers,
   its head dim 112) against the CPU's single-device step (the SSMs'
   gradients within 2^-7 of their scale, their bf16 SSD block's rounding),
   and the MoE in both expert-parallel modes (kimi's int8 all-to-all,
   grok's gathered d_ff) against the same sharded step on CPU tensors;
   each rank's attention launches counted (the hybrid's feed the kernel
   line's hd-112 backward row). (e) sharded serving on the same ranks
   (`runtime.lm_serve.generate(rules=...)`: a sequence-sharded prefill
   through `flash_attention` at each rank's local heads, then
   context-parallel decode over the caches' slots): the reduced float32
   cases of `tests/test_torch_lm_mesh_serve.py` (both head modes, the
   vlm prefix, mamba2, the hybrid, both MoE modes) at B=4 x 32, s_max 64,
   4 greedy tokens, each rank's tokens == the single-device generate on
   the card (the MoE: == the same sharded serve on CPU tensors), one
   attention launch an attention layer a rank; then llama3.2-3b at full
   width, 2 layers, B=4 x 1024, s_max 1056, 8 greedy tokens against one
   card's generate from the same seed: the agreement of the tokens, the
   first flipped position, the prefill logits within 0.15 of one card's
   (their bf16 row error printed), prefill ms, decode ms a step,
   collectives a decode step by kind, count and bytes, peak memory a
   rank, each rank's attention launches (one a layer at its local 12
   query and 4 kv heads).
18. `[dryrun]`: the dry run (`launch.dryrun`, `launch.step_analysis`)
   in a subprocess on the host, started with the script (a fake process
   group and the script's own groups cannot share a process; it starts
   no CUDA context): (a) `[train]`'s llama3.2-3b step (full depth, B=2 x
   4096, AdamW, no mesh) on meta tensors against the same step analysed
   on the card in `[train]`: FLOPs equal exactly (the attention kernels
   report theirs), the meta peak within DRYRUN_PEAK_RTOL of
   `torch.cuda.max_memory_allocated()` around that step; (b) `[lm-mesh]`
   (a)'s llama3.2-3b cell (2 layers, B=4 x 1024, (data=2, model=2)) on a
   fake group of 4: each rank's collectives by kind (count, result bytes,
   bytes sent) equal to what that gloo rank of (a) counted in every step;
   (c) the production cells `DRYRUN_CELLS` on fake groups of 256 / 512
   ranks, each record's per-rank peak GiB, GFLOP and collective MiB
   printed (predictions, not card measurements).
19. `[examples]`: the five `examples/torch_*.py` on the card at the JAX
   examples' defaults, each in a subprocess, all at once, each timed;
   exit 0; the quickstart's front equal to `python -m repro_torch.search`
   with the same flags, the distributed GA's elastic restart at 48 rows a
   rank.
20. The kernel list, the card's name and power limit, one JSON line of
   per-kernel results (each row names what it times in `what`; the rows
   `fitness_errors[bucket]` and `domination_block[bucket]` are the batched
   launches, the `[shard]` rows a mesh rank's), and last `{"ok": true,
   "device": {...}}`.

The search paths run through `run_search`, whose generations are chunks
of captured CUDA graphs (on one card; a mesh's sharded generations run
one by one); a launch inside a graph counts at every replay.

Without a CUDA device, or without the repository's `src/` beside it, the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import atexit
import dataclasses
import json
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time

from typing import NamedTuple

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

DATASET = "har"
POP = 512
GENS = 8
SEED = 0
MLP_HIDDEN = 16
MLP_RUNS = (("har", 512), ("pendigits", 128))    # (dataset, pop), GENS each
FOREST_TREES = 5       # har --trees 5: N = 2227 comparators, past 2048
WIDE_N, WIDE_POP = 4096, 64   # the synthetic single tree past the old cap
CHUNK = 4              # [chunk]: checkpoint_every, so chunks of 4
RESUME_EVERY = 3       # [resume]: saves at 3, 6 and 8
QMM_RTOL, QMM_ATOL = 1e-5, 1e-3   # qmatmul on float inputs (module doc)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT8_OPS_PER_S = 1979e12       # H100 SXM tensor cores, int8 dense
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM tensor cores, bf16 dense
TPU_KERNELS = {  # kernel -> (port source, the TPU kernel it replaces,
    #                what its row of the kernels line times)
    "fitness_errors": ("src/repro_torch/csrc/fitness.cu",
                       "src/repro/kernels/fitness.py:109",
                       "fitness_correct_counts, tree har: P=512, B=3090, "
                       "N=588, L=589"),
    "domination_block": ("src/repro_torch/csrc/domination.cu",
                         "src/repro/kernels/domination.py:57",
                         "the non-dominated sort of a random pool of 1024, "
                         "M=2: domination_bits + the front peel; launches "
                         "count both, two per sort; the bool slab's own "
                         "times are in the [kernel] domination_block lines"),
    "tree_infer_scores": ("src/repro_torch/csrc/tree_infer.cu",
                          "src/repro/kernels/tree_infer.py:81",
                          "P=1, B=3090 (the tree har verify leg)"),
    "qmatmul": ("src/repro_torch/csrc/qmatmul.cu",
                "src/repro/kernels/qmatmul.py:40",
                "uint8 (3090x561) @ int8 (561x8192), the MLP har fitness"),
    "flash_attention": ("src/repro_torch/csrc/flash_attn.cu",
                        "src/repro/kernels/flash_attn.py:70",
                        "bf16 LM prefill, q (4, 4096, 24, 128), k and v "
                        "(4, 4096, 8, 128), the model's layout; launches "
                        "include [lm-mesh]'s ranks: (a) each on its local "
                        "12 query and 4 kv heads, (b) the reduced float32 "
                        "steps of every layer kind with attention, (e) the "
                        "sharded prefills of the reduced cases and of "
                        "llama3.2-3b at full width (local 12 / 4 heads)"),
    "flash_attention_backward": (
        "src/repro_torch/csrc/flash_attn_bwd.cu",
        "none: no TPU kernel (the Pallas flash_attention has no gradient; "
        "the JAX package differentiates its jnp chunked_prefill_attention, "
        "src/repro/models/attention.py:53)",
        "bf16 llama3.2-3b training, q, o, dout (2, 4096, 24, 128), k and v "
        "(2, 4096, 8, 128), the model's layout; launches include "
        "[lm-mesh]'s ranks: (a) each on its local 12 query and 4 kv heads, "
        "(b) the reduced float32 steps of every layer kind with "
        "attention"),
    "fault_lanes": (
        "src/repro_torch/csrc/fault_sim.cu",
        "none: no TPU kernel (the JAX package's stuck-at simulator is jnp, "
        "src/repro/core/faults.py::FaultSimulator)",
        "every single stuck-at lane of the har tree point's circuit over "
        "its 3090 rows in one launch; the plain version 1024 lanes a call"),
}
# [dryrun] (c): (arch, shape, multi_pod) of the production cells run on
# fake groups; paper-dt-ga is the GA cell
DRYRUN_CELLS = (("llama3.2-3b", "train_4k", False),
                ("llama3.2-3b", "decode_32k", False),
                ("mamba2-1.3b", "long_500k", False),
                ("kimi-k2-1t-a32b", "decode_32k", False),
                ("grok-1-314b", "train_4k", True),
                ("paper-dt-ga", None, False))
# [dryrun] (a): the meta step's peak against the card's
# max_memory_allocated: the caching allocator rounds each block up (512 B;
# 2 MiB segments) and cuBLAS's workspace is allocated outside any op
DRYRUN_PEAK_RTOL = 0.10
DRYRUN_TIMEOUT_S = 600
EXAMPLES_TIMEOUT_S = 400
LM_ARCH = "llama3.2-3b"            # full width; the repo's train_4k length
LM_BATCH, LM_PROMPT, LM_TOKENS = 4, 4096, 32
TRAIN_BATCH, TRAIN_SEQ = 2, 4096   # [train]: train_4k's length, B 256 -> 2
SSM_ARCHS = ("mamba2-1.3b", "zamba2-7b")   # [ssm]: full width, same prompt
SSD_CHUNK = 256                    # ssm_block's default chunk
FLASH_112 = "flash_attention[hd 112]"      # the kernel line's zamba2 row
# [moe]: (arch, layers kept of its published depth), every other field as
# published; 8 of grok's 64 layers are 56.2 GB of bf16 weights, 2 of kimi's
# 61 would be 72.9 GB
MOE_ARCHS = (("grok-1-314b", 8), ("kimi-k2-1t-a32b", 1))
FLASH_SOFTCAP = "flash_attention[softcap 30]"   # the kernel line's grok row
FLASH_F32_TOL = 2e-5               # tests/test_kernels.py:208-209
# bfloat16: `row_error` (a query row's largest difference over the row's
# root mean square) at most two bf16 ulps of a row's largest element at four
# times its rms; the rows' magnitudes fall to ~0.03 at S=4096, so no one
# absolute tolerance fits them (tests/test_torch_flash.py's module doc)
FLASH_BF16_ROW_TOL = 2.0 ** -4
# the backward (`flash_attention_backward`) against its plain version by
# `grad_error` (a row error whose rows of near-zero true gradient are held
# to GRAD_ERROR_FLOOR, 2^-4, of the tensor's scale): float32 within 2^-12.
# dS = P (dP - D) cancels, so dq carries an absolute rounding of about 1e-5
# of the tensor's scale in every row, row 0 (exactly zero) included, where
# the floor turns it into ~1e-4: a second sound float32 computation
# (autograd of the plain forward) reads up to 7.7e-5 against the plain
# backward at the float32 cases below on the CPU, over 1e-4 / FAULT_MARGIN
# (tests/test_torch_flash.py), and the kernel reads at most 5.9e-5 on an
# H100; the planted faults of `flash_backward_ref` read 0.065 and more
# wherever they change the equations. bfloat16 within FLASH_BF16_ROW_TOL:
# the kernel rounds P and dS to bf16 as operands of its products, as the
# forward rounds p, and the plain version keeps them float32 (that rounding
# alone measures 0.019 against float64 on the CPU)
FLASH_BWD_F32_TOL = 2.0 ** -12
FLASH_LSE_TOL = 1e-4   # the kept log-sum-exp against the plain one (float32)
FAULT_MARGIN = 1.5     # a planted fault reads at least this many limits
FLASH_BWD = "flash_attention_backward"
FLASH_BWD_112 = "flash_attention_backward[hd 112]"
FLASH_BWD_SOFTCAP = "flash_attention_backward[softcap 30]"
# decode against a fresh prefill in bfloat16: the two paths round their
# activations at other places (the kernel rounds p to bf16, decode takes a
# float32 softmax; cuBLAS sums a 4-row and a 16k-row product in other
# orders), so logits agree to a few bf16 ulps of their scale, not exactly:
# 0.109 measured on an H100 on logits up to 5.2, against five ulps
# (0.03125 each in [4, 8)) here
LM_LOGIT_ATOL = 0.15
# [ssm]: decode against a fresh prefill, as a share of the prefill's
# largest logit. In bf16 decode runs the exact float32 recurrence and a
# one-step conv einsum where the prefill rounds the SSD weight block and x
# to bf16 and the conv after every tap, and the layers carry that on; the
# JAX package's own decode differs from its fresh prefill as much as the
# port's (tests/test_torch_ssm.py::test_bf16_decode_spread_is_the_jax_
# packages: 2.8% at 12 layers and 16 steps), growing with depth and
# steps: 0.034 and 0.045 of the largest logit measured on an H100 at
# position 255 (mamba2-1.3b, zamba2-7b); a decode that lost its caches
# differs by the logits' own scale
SSM_LOGIT_RTOL = 0.25


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def device_events(fn, reps: int) -> list:
    """(name, us) of every device activity (kernels, copies, fills) in a
    `torch.profiler` trace of ``reps`` back-to-back calls of ``fn`` after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(fn, reps: int, kernel: str | None = None) -> float | None:
    """Device time of one call of ``fn``: the summed time of the device
    activities of `device_events` whose name holds ``kernel`` (every one of
    them when None), over ``reps``. None when the trace holds no such
    activity."""
    us = [t for name, t in device_events(fn, reps)
          if kernel is None or kernel in name]
    return sum(us) / reps / 1e3 if us else None


def device_split_ms(fn, reps: int, names) -> dict:
    """Device time per call of ``fn`` of the kernels whose names hold each
    of ``names``, from one trace of `device_events`."""
    events = device_events(fn, reps)
    return {n: sum(t for name, t in events if n in name) / reps / 1e3
            for n in names}


def stream_ms(fn, reps: int) -> float:
    """Time of one call of ``fn`` on the stream: CUDA events around ``reps``
    back-to-back calls after a warm-up call. It holds whatever host time
    keeps the stream waiting between calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def host_ms(fn, reps: int = 3) -> float:
    """Median host-clock ms of ``fn()`` between two synchronisations."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_or_stream_ms(fn, reps: int) -> tuple[float, str]:
    """(ms, source): `device_ms` of every device activity of ``fn``, or
    `stream_ms` where the trace holds no device activity."""
    ms = device_ms(fn, reps)
    if ms is not None:
        return ms, "device time"
    return stream_ms(fn, reps), "stream time"


def timed(kernel_fn, plain_fn, kernel: str | None, reps: int,
          plain_reps: int):
    """(ms, plain_ms, text): the device time of the CUDA kernel named
    ``kernel`` (of every kernel when None) per call of ``kernel_fn`` and the
    device time of every
    activity of ``plain_fn`` per call, each from a profiler trace, or from
    CUDA events where the trace holds no device activity; the text also
    gives both functions' time per call on the stream."""
    ms, plain_ms = (device_ms(kernel_fn, reps, kernel),
                    device_ms(plain_fn, plain_reps))
    on_stream = stream_ms(kernel_fn, reps), stream_ms(plain_fn, plain_reps)
    how = "device time (profiler)"
    if ms is None or plain_ms is None:
        ms, plain_ms = on_stream
        how = "stream time (CUDA events; the profiler saw no device activity)"
    text = (f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms {how}; per call on "
            f"the stream {on_stream[0]:.4f} / {on_stream[1]:.4f} ms")
    return ms, plain_ms, text


def bound(n_bytes: float, n_ops: float, ops_per_s: float):
    """(bound_ms, bound_by): the least time for the bytes and operations."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tree_ops(p: int, b: int, n: int, l: int, c: int,
             nl: int | None = None) -> int:
    """Integer operations of the tree dataflow for p chromosomes on b rows:
    shift and compare per comparator, the path product (2NL; for a forest
    2 sum_k N_k L_k, ``nl``, since a leaf reads only its own tree's
    comparators) and the vote product (2LC) per (chromosome, row)."""
    return p * b * (2 * n + 2 * (n * l if nl is None else nl) + 2 * l * c)


def peel_ops(rank: torch.Tensor) -> int:
    """Word operations the front peel needs for these ranks: for each front
    but the last, an AND and a popcount per unranked column and non-zero
    word of the front's bit set."""
    r = rank.cpu().numpy()
    ops = 0
    for front in range(int(r.max())):
        members = np.flatnonzero(r == front)
        ops += 2 * int((r > front).sum()) * len(np.unique(members // 32))
    return ops


def sync_free(fn, what: str):
    """``fn()`` under `torch.cuda.set_sync_debug_mode("error")`: fails if it
    makes the host wait for the card."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    except RuntimeError as e:
        fail(f"{what} synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")


def ptxas_summary(name: str) -> str:
    from repro_torch.kernels import _build

    text = _build.build_log(name)
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", text)]
    return (f"{len(regs)} kernels, registers max {max(regs, default=0)}, "
            f"spill stores max {max(spills, default=0)} bytes")


def kernel_label(mangled: str) -> str:
    """'name<template ints>' of a mangled kernel name (bf16 marked), or the
    name as given where no `*_kernel` identifier is found in it."""
    i = 0
    while True:
        m = re.compile(r"\d+").search(mangled, i)
        if m is None:
            return mangled
        ident = mangled[m.end():m.end() + int(m.group())]
        if ident.endswith("_kernel"):
            tail = mangled[m.end() + len(ident):].split("Ev", 1)[0]
            args = re.findall(r"Li(\d+)E", tail)
            args = (["bf16"] if "bfloat16" in tail else ["f32"]
                    if tail.startswith("If") else []) + args
            return f"{ident}<{','.join(args)}>" if args else ident
        i = m.end() + len(ident)


def ptxas_kernels(name: str) -> list[str]:
    """'kernel<args>: N registers, M bytes spilled' for every instantiation
    nvcc compiled into library ``name``."""
    from repro_torch.kernels import _build

    rows, fn, spilled = [], None, "?"
    for line in _build.build_log(name).splitlines():
        hit = re.search(r"Compiling entry function '(\w+)'", line)
        if hit:
            fn, spilled = hit.group(1), "?"
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill and fn:
            spilled = spill.group(1)
        regs = re.search(r"Used (\d+) registers", line)
        if regs and fn:
            rows.append(f"{kernel_label(fn)}: {regs.group(1)} registers, "
                        f"{spilled} bytes spilled")
            fn = None
    return rows


def phase_build() -> float:
    from repro_torch.kernels import _build

    seconds = _build.build()
    log(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: {seconds:.1f} s "
        f"for {', '.join(_build.SOURCES)}")
    for name in _build.SOURCES:
        log(f"[build] {name}: {ptxas_summary(name)}")
    for name in ("fitness", "qmatmul", "flash_attn", "flash_attn_bwd"):
        log(f"[build] {name} by kernel: " + "; ".join(ptxas_kernels(name)))
    return seconds


def phase_kernels(problem, rng) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch import kernels
    from repro_torch.core import quant
    from repro_torch.kernels import domination, fitness, ops, tree_infer
    from repro_torch.search import make_kernel_fitness

    dev = problem.device
    n, l, c = problem.n_comparators, problem.n_leaves, problem.n_classes
    b = int(problem.y.shape[0])
    n_feat = problem.n_features
    results = {}

    def record(name, err, ms, plain_ms, bound_ms, bound_by):
        results[name] = dict(
            name=name, route="cuda", source=TPU_KERNELS[name][0],
            replaces=TPU_KERNELS[name][1], launches=0, max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None)

    # fitness_errors: P random chromosomes (the exact design first), both
    # vote caps, on the problem's own operands
    genes = rng.random((POP, problem.n_genes), dtype=np.float32)
    genes[0] = problem.exact_genes()
    genes[1:, -1] = rng.random(POP - 1) < 0.5     # approximate vote adder
    genes_t = torch.as_tensor(genes, device=dev)
    shift, thr, _, cap = ops.decode_population_full(problem.threshold, genes_t)
    check(sorted(set(cap.tolist())) == [1, quant.NO_VOTE_CAP],
          "fitness chromosomes do not mix both vote caps")
    fit_ops = ops.prepare_fitness_operands(
        problem.x_sel, problem.y, problem.path, problem.path_len,
        problem.n_neg, problem.leaf_class, c)
    got = fitness.fitness_correct_counts(fit_ops, shift, thr, cap)
    torch.cuda.synchronize()
    want = fitness.fitness_correct_counts_plain(fit_ops, shift, thr, cap)
    err = int((got.long() - want.long()).abs().max())
    check(err == 0, f"fitness_errors differs from its plain version by {err}")
    check(int(got[0]) == round(problem.exact_accuracy * b),
          "fitness_errors miscounts the exact design")
    exact_objs = make_kernel_fitness(problem)(genes_t[:1])
    check(exact_objs.tolist() == [[0.0, 1.0]],
          f"the kernel backend scores the exact design "
          f"{exact_objs.tolist()[0]}, not (0, 1)")
    ms, plain_ms, text = timed(
        lambda: fitness.fitness_correct_counts(fit_ops, shift, thr, cap),
        lambda: fitness.fitness_correct_counts_plain(fit_ops, shift, thr, cap),
        "fitness_mma_kernel", reps=10, plain_reps=3)
    k_pad, l_pad = fit_ops.x_sel.shape[1], fit_ops.path.shape[0]
    n_ops = tree_ops(POP, b, n, l, c)
    path_bytes = fit_ops.path.numel() + 2 * l_pad * 4
    n_bytes = (b * k_pad + 2 * POP * n * 4 + path_bytes + b * 4 + POP * 4
               + POP * 4)
    bms, by = bound(n_bytes, n_ops, INT8_OPS_PER_S)
    rows = fitness.BLOCK_ROWS
    blocks = POP * -(-b // rows)
    spans = fit_ops.spans.cpu().numpy()
    span_pairs = int(((spans[:, 1] - spans[:, 0]) * fitness.LEAF_TILE).sum())
    l2_bytes = blocks * (span_pairs + 2 * l_pad * 4)
    log(f"[kernel] fitness_errors P={POP} B={b} N={n} L={l} C={c}: equal; "
        f"{text}; bound {bms:.4f} ms ({by}; {n_ops:.4g} int ops, "
        f"{n_bytes} bytes); {n_ops / ms / 1e9:.1f} TOP/s, {ms / bms:.2f}x "
        f"its bound; {rows} rows a block, {blocks} blocks, each reading its "
        f"tiles' spans of the {tuple(fit_ops.path.shape)} path ({span_pairs} "
        f"bytes, {span_pairs / fit_ops.path.numel():.3f} of it), targets and "
        f"classes from L2: {l2_bytes} bytes ({l2_bytes / ms / 1e6:.0f} GB/s)")
    record("fitness_errors", float(err), ms, plain_ms, bms, by)

    # domination_block: the GA pool (2P rows) against itself, and a slab
    errs = []
    for pi, pj in ((2 * POP, 2 * POP), (POP // 2, 2 * POP)):
        oi = torch.as_tensor((rng.integers(0, 64, (pi, 2)) / 63)
                             .astype(np.float32), device=dev)
        oj = oi if pi == pj else torch.as_tensor(
            (rng.integers(0, 64, (pj, 2)) / 63).astype(np.float32),
            device=dev)
        got = domination.domination_block(oi, oj)
        torch.cuda.synchronize()
        want = domination.domination_block_plain(oi, oj)
        err = int((got.int() - want.int()).abs().max())
        check(err == 0, f"domination_block {pi}x{pj} differs from its plain "
              f"version")
        errs.append(err)
        ms, plain_ms, text = timed(
            lambda: domination.domination_block(oi, oj),
            lambda: domination.domination_block_plain(oi, oj),
            "domination_kernel", reps=50, plain_reps=50)
        n_ops = 3 * 2 * pi * pj
        n_bytes = (pi + pj) * 2 * 4 + pi * pj
        bms, by = bound(n_bytes, n_ops, FP32_OPS_PER_S)
        log(f"[kernel] domination_block {pi}x{pj} M=2: equal; {text}; "
            f"bound {bms:.5f} ms ({by}; {n_ops} compares, {n_bytes} bytes)")

    # the sort on the card (relation bits + front peel, two launches, no host
    # sync) against its plain version, the host loop, at the MLP pendigits
    # pool, the GA pool and a pool whose relation lives in L2
    main = None
    for p in (256, 2 * POP, 4096):
        objs = torch.as_tensor((rng.integers(0, 64, (p, 2)) / 63)
                               .astype(np.float32), device=dev)
        rel, counts = domination.domination_bits(objs)
        torch.cuda.synchronize()
        want_rel, want_counts = domination.domination_bits_plain(objs)
        check(torch.equal(rel, want_rel) and torch.equal(counts, want_counts),
              f"domination_bits at pool {p} differs from its plain version")
        launches = kernels.launch_counts()["domination_block"]
        got = sync_free(lambda: domination.non_dominated_rank(objs),
                        f"the sort at pool {p}")
        torch.cuda.synchronize()
        check(kernels.launch_counts()["domination_block"] == launches + 2,
              f"the sort at pool {p} did not make exactly two launches")
        want = domination.non_dominated_rank_plain(objs)
        err = int((got - want).abs().max())
        check(err == 0, f"the sort at pool {p} differs from the host loop by "
              f"{err} ranks")
        errs.append(err)
        ms, plain_ms, text = timed(
            lambda: domination.non_dominated_rank(objs),
            lambda: domination.non_dominated_rank_plain(objs),
            None, reps=20, plain_reps=3)
        n_ops = 3 * 2 * p * p + peel_ops(got)
        n_bytes = p * 2 * 4 + p * 4
        bms, by = bound(n_bytes, n_ops, FP32_OPS_PER_S)
        fronts = int(got.max()) + 1
        log(f"[kernel] sort (domination_bits + peel) pool {p} M=2, {fronts} "
            f"fronts: ranks equal the host loop, 2 launches, no host sync; "
            f"{text}; bound {bms:.5f} ms ({by}; {n_ops} compares and "
            f"popcounts, {n_bytes} bytes)")
        if p == 2 * POP:
            main = (ms, plain_ms, bms, by)
    record("domination_block", float(max(errs)), *main)

    # tree_infer_scores: serving buckets (P=1), the --verify-rtl leg
    # (P=1, B=3090) and a population slab (P=8, B=3090)
    operands = ops.prepare_operands(
        problem.feature, problem.path, problem.path_len, problem.n_neg,
        problem.leaf_class, c, n_feat)
    errs, main = [], None
    for p, rows in ((1, 1), (1, 37), (1, 1024), (1, b), (8, b)):
        g = genes_t[:p] if p > 1 else genes_t[1:2]
        shift_p, thr_p, _ = ops.decode_population(problem.threshold, g)
        x8 = problem.x8[:rows].contiguous()
        got = tree_infer.tree_infer_scores(x8, operands, shift_p, thr_p)
        torch.cuda.synchronize()
        want = tree_infer.tree_infer_scores_plain(x8, operands, shift_p,
                                                  thr_p)
        err = int((got - want).abs().max())
        check(err == 0, f"tree_infer_scores P={p} B={rows} differs from its "
              f"plain version by {err}")
        errs.append(err)
        ms, plain_ms, text = timed(
            lambda: tree_infer.tree_infer_scores(x8, operands, shift_p, thr_p),
            lambda: tree_infer.tree_infer_scores_plain(x8, operands, shift_p,
                                                       thr_p),
            "tree_infer_kernel", reps=20, plain_reps=5)
        n_ops = tree_ops(p, rows, n, l, c)
        n_bytes = (rows * n_feat * 4 + n * 4 + 2 * p * n * 4
                   + 2 * l * operands.pos.shape[1] * 4 + 2 * l * 4
                   + p * rows * c * 4)
        bms, by = bound(n_bytes, n_ops, INT8_OPS_PER_S)
        log(f"[kernel] tree_infer_scores P={p} B={rows}: equal; {text}; "
            f"bound {bms:.5f} ms ({by}; {n_ops:.4g} int ops, {n_bytes} bytes)")
        if (p, rows) == (1, b):
            main = (ms, plain_ms, bms, by)
    # the other design for the P = 1 legs: the fitness kernel's int8
    # mma.sync path product, timed at P = 1 on the verify leg's rows
    one = genes_t[1:2]
    shift_1, thr_1, _, cap_1 = ops.decode_population_full(problem.threshold,
                                                          one)
    mma_ms = device_ms(lambda: fitness.fitness_correct_counts(
        fit_ops, shift_1, thr_1, cap_1), 20, "fitness_mma_kernel")
    log(f"[kernel] the int8 path product at P=1 (fitness_mma_kernel on the "
        f"same {b} rows, correct counts only): "
        + ("not in the trace" if mma_ms is None else
           f"{mma_ms:.4f} ms device time, against tree_infer_scores' "
           f"{main[0]:.4f} ms for the votes"))
    # the widest masks the kernel takes: N = 2048 comparators, 2049 leaves
    # of eight comparators each, on the har rows
    n_w, l_w = 2048, 2049
    path = np.zeros((l_w, n_w), np.int8)
    for i in range(l_w):
        path[i, rng.choice(n_w, 8, replace=False)] = rng.choice([-1, 1], 8)
    ops_w = ops.prepare_operands(
        rng.integers(0, n_feat, n_w), path, (path != 0).sum(1),
        (path == -1).sum(1), rng.integers(0, c, l_w), c, n_feat, device=dev)
    bits = rng.integers(1, 9, (2, n_w))
    shift_w = torch.as_tensor(8 - bits, dtype=torch.int32, device=dev)
    thr_w = torch.as_tensor(rng.integers(0, 256, (2, n_w)) % (1 << bits),
                            dtype=torch.int32, device=dev)
    got = tree_infer.tree_infer_scores(problem.x8, ops_w, shift_w, thr_w)
    torch.cuda.synchronize()
    want = tree_infer.tree_infer_scores_plain(problem.x8, ops_w, shift_w,
                                              thr_w)
    err = int((got - want).abs().max())
    check(err == 0 and int(want.sum()) > 0, f"tree_infer_scores at N={n_w} "
          f"differs from its plain version by {err}")
    errs.append(err)
    log(f"[kernel] tree_infer_scores P=2 B={b} N={n_w} L={l_w}: equal "
        f"({int(want.sum())} votes)")
    record("tree_infer_scores", float(max(errs)), *main)
    return results


TREE_KERNELS = ("fitness_errors", "domination_block", "tree_infer_scores")


def check_sort_launches(counts: dict, gens: int) -> None:
    """In ``counts`` (`kernels.launch_counts()` over one search), every
    generation and the initial population sorted their pool on the card:
    `domination_block` counts the sort's two launches (the relation and the
    peel), so at least 2 (1 + ``gens``), two per sort."""
    n = counts["domination_block"]
    check(n % 2 == 0 and n >= 2 * (1 + gens),
          f"the sort launched {n} times over {gens} generations, not twice "
          f"per sort")


def serve_latency(server, codes, oracle, what: str) -> dict:
    """Serve requests of 1, 37, 1024 and all rows of ``codes``, each
    checked against ``oracle(rows) -> (name, predictions)`` pairs; returns
    the host-clock latency (ms) per request size and the last predictions."""
    latency = {}
    for rows in (1, 37, 1024, codes.shape[0]):
        t0 = time.perf_counter()
        served = server.classify(codes[:rows])
        latency[rows] = (time.perf_counter() - t0) * 1e3
        for name, want in oracle(rows):
            check(np.array_equal(served, want),
                  f"{what}: served predictions of a {rows}-row request "
                  f"differ from the {name} on {int((served != want).sum())} "
                  f"rows")
    return latency, served


def best_point(art) -> int:
    """The served point: smallest area within 1% loss, else least loss."""
    idx = art.best_under_loss(0.01)
    if idx is None:
        idx = min(range(len(art.points)),
                  key=lambda i: art.points[i]["acc_loss"])
    return idx


def phase_main_path(problem, out_dir: str) -> dict:
    """The tree path: search -> pareto.json (netlists verified) -> serve,
    counted."""
    from repro_torch import kernels, search
    from repro_torch.core import netlist
    from repro_torch.datasets import load_dataset
    from repro_torch.runtime.classify import ClassifyServer

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = search.run_search(problem, backend="kernel", pop_size=POP,
                               n_generations=GENS, seed=SEED, dataset=DATASET,
                               out_dir=out_dir, verify_rtl=True)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    searched = kernels.launch_counts()
    objs = result.pareto_objs
    log(f"[main] run_search {DATASET} backend=kernel pop={POP} gens={GENS}: "
        f"search {result.wall_s:.2f} s, pareto.json + verify_rtl "
        f"{t_run - result.wall_s:.2f} s over {len(objs)} points; "
        f"{result.n_dispatches} device dispatches; launches {searched}")
    check(searched["fitness_errors"] >= 1 + GENS,
          "fitness_errors launched fewer than once per generation")
    check_sort_launches(searched, GENS)
    check(searched["tree_infer_scores"] >= len(objs),
          "tree_infer_scores launched fewer than once per pareto point")
    exact_on_front = bool(((objs[:, 0] == 0) & (objs[:, 1] == 1)).any())
    check(bool(((objs[:, 0] <= 0) & (objs[:, 1] <= 1)).any()),
          "no front point matches or dominates the exact design (0, 1)")
    check(np.isfinite(objs).all() and objs.shape[1] == 2,
          "pareto objectives are not finite (K, 2)")
    log(f"[main] front: {len(objs)} points, loss "
        f"[{objs[:, 0].min():+.4f}, {objs[:, 0].max():+.4f}], area "
        f"[{objs[:, 1].min():.4f}, {objs[:, 1].max():.4f}]; exact design "
        f"(0, 1) {'on' if exact_on_front else 'dominated on'} the front")

    art = search.load_pareto_artifact(str(pathlib.Path(out_dir) /
                                          "pareto.json"))
    check(art.payload["rtl_verified"] and all(
        p.get("verified") for p in art.points),
        "pareto.json does not record every point as verified")
    idx = best_point(art)
    server = ClassifyServer.from_artifact(art, point=idx, backend="kernel",
                                          device=problem.device)
    bits, t_int, trunc, vote_adder = art.point_design(idx)
    circuit = netlist.build_circuit(art.ptrees(), bits, t_int, art.n_classes,
                                    trunc=trunc, vote_adder=vote_adder)
    ds = load_dataset(DATASET)
    codes = server.featurize(ds.x_test)
    latency, served = serve_latency(
        server, codes, lambda rows: [("netlist", netlist.simulate(
            circuit, torch.as_tensor(codes[:rows], device=problem.device))
            .cpu().numpy())], "tree")
    acc = float((served == ds.y_test).mean())
    check(abs(acc - art.point_accuracy(idx)) <= 1e-6,
          f"served accuracy {acc} != recorded {art.point_accuracy(idx)}")
    counts = kernels.launch_counts()
    check(all(counts[k] > 0 for k in TREE_KERNELS),
          f"a kernel of the tree path never launched: {counts}")
    log(f"[main] served point {idx} (acc_loss {art.points[idx]['acc_loss']:+.4f}, "
        f"norm_area {art.points[idx]['norm_area']:.4f}) over requests of "
        f"{sorted(latency)} rows == netlist simulation; accuracy {acc:.6f} "
        f"== recorded; latency ms {json.dumps({k: round(v, 3) for k, v in latency.items()})}; "
        f"buckets {server.compiled_buckets()}")
    log(f"[main] launches over search + serve: {counts}")
    return dict(counts=counts, state=result.state, art=art)


def phase_qmatmul(problem, rng) -> dict:
    """`qmatmul` against its plain version. On uint8 codes (the integer
    tensor-core kernel): exact at the MLP fitness shape (3090 x 561 @ 561 x
    8192, the problem's own codes buffer) and at the serving and verify
    shapes (N=16, M = 1, 37, 1024, 3090), and within (QMM_RTOL, QMM_ATOL)
    at a ragged shape with int8 weights over [-128, 127] and a random
    scale. On random float32 and bfloat16 x (the CUDA-core kernel) within
    the same tolerance at the ragged shape. The kernel backend scores the
    exact design (0, 1). Each case is timed beside its bound (operations at
    the int8 rate for uint8 x, at the float32 or bf16 rate for float x)
    and, for uint8 and float32 x, beside `torch.mm` on the same values as
    float32 (TF32 off; the casts, and the weight times the scale, are made
    before the timed window)."""
    from repro_torch.families import printed_mlp as pm
    from repro_torch.kernels import qmatmul as qmm

    dev = problem.device
    x = problem.x8u
    b, f = x.shape
    h = problem.n_hidden
    n = POP * h
    w = torch.as_tensor(rng.integers(-8, 8, (f, n)).astype(np.int8),
                        device=dev)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    cases = [("fitness uint8", x, w, ones, True)]
    for rows in (1, 37, 1024, b):
        cases.append((f"serve/verify uint8 M={rows}", x[:rows],
                      w[:, :h].contiguous(), ones[:h].contiguous(), True))
    m_g, k_g, n_g = 300, 777, 515
    xg = torch.as_tensor(rng.standard_normal((m_g, k_g)).astype(np.float32),
                         device=dev)
    xu = torch.as_tensor(rng.integers(0, 256, (m_g, k_g)).astype(np.uint8),
                         device=dev)
    wg = torch.as_tensor(rng.integers(-128, 128, (k_g, n_g)).astype(np.int8),
                         device=dev)
    sg = torch.as_tensor(rng.uniform(0.001, 0.1, n_g).astype(np.float32),
                         device=dev)
    cases += [("general uint8", xu, wg, sg, False),
              ("general float32", xg, wg, sg, False),
              ("general bfloat16", xg.to(torch.bfloat16), wg, sg, False)]

    err = 0.0
    for name, xc, wc, sc, exact in cases:
        got = qmm.qmatmul(xc, wc, sc)
        torch.cuda.synchronize()
        want = qmm.qmatmul_plain(xc, wc, sc)
        e = float((got - want).abs().max())
        where = f"qmatmul {name} {tuple(xc.shape)} @ {tuple(wc.shape)}"
        if exact:
            check(torch.equal(got, want),
                  f"{where} differs from its plain version by {e}")
        else:
            check(torch.allclose(got, want, rtol=QMM_RTOL, atol=QMM_ATOL),
                  f"{where} differs from its plain version by {e} (rtol "
                  f"{QMM_RTOL}, atol {QMM_ATOL})")
        err = max(err, e)
    exact_objs = pm.make_kernel_fitness(problem)(torch.as_tensor(
        problem.exact_genes(), device=dev)[None])
    check(exact_objs.tolist() == [[0.0, 1.0]],
          f"the MLP kernel backend scores the exact design "
          f"{exact_objs.tolist()[0]}, not (0, 1)")

    results = None
    for name, xc, wc, sc, exact in cases:
        m, k = xc.shape
        nn = wc.shape[1]
        ms, plain_ms, text = timed(lambda: qmm.qmatmul(xc, wc, sc),
                                   lambda: qmm.qmatmul_plain(xc, wc, sc),
                                   "qmatmul", reps=20, plain_reps=5)
        lib_ms, lib_text = None, "torch.mm n/a (no one call takes bf16 x " \
                                 "with float32 weights)"
        if xc.dtype != torch.bfloat16:
            xf = xc.to(torch.float32)
            wf = wc.to(torch.float32) * sc
            lib_ms, _ = device_or_stream_ms(lambda: torch.mm(xf, wf), 20)
            lib_text = (f"torch.mm {lib_ms:.4f} ms (TF32 off, float32 "
                        f"operands made outside the window)")
        n_ops = 2 * m * k * nn
        n_bytes = m * k * xc.element_size() + k * nn + nn * 4 + m * nn * 4
        # codes fit the int8 (u8 x s8) tensor cores exactly; float32 x needs
        # float32 FMAs, bfloat16 x the bf16 tensor cores
        rate = (INT8_OPS_PER_S if xc.dtype == torch.uint8 else FP32_OPS_PER_S
                if xc.dtype == torch.float32 else BF16_OPS_PER_S)
        bms, by = bound(n_bytes, n_ops, rate)
        lib_vs = f", {ms / lib_ms:.2f}x torch.mm" if lib_ms else ""
        log(f"[kernel] qmatmul {name} {m}x{k} @ {k}x{nn}: "
            f"{'equal' if exact else 'within tolerance'}; {text}; "
            f"{lib_text}; bound {bms:.5f} ms ({by}; {n_ops:.4g} ops, "
            f"{n_bytes} bytes); {ms / bms:.2f}x its bound{lib_vs}")
        if results is None:
            results = dict(
                name="qmatmul", route="cuda", source=TPU_KERNELS["qmatmul"][0],
                replaces=TPU_KERNELS["qmatmul"][1], launches=0,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)
    log(f"[kernel] qmatmul: the largest difference from the plain version "
        f"over all cases is {err:.3g} (fitness, serve and verify cases "
        f"exact)")
    return results


def phase_mlp_path(problem, dataset: str, pop: int, out_dir: str) -> dict:
    """The printed-MLP path: search -> pareto.json (netlists verified) ->
    serve, counted; then the kernel fitness against the reference on the
    final population."""
    from repro_torch import kernels, search
    from repro_torch.core import netlist
    from repro_torch.datasets import load_dataset
    from repro_torch.families import printed_mlp as pm
    from repro_torch.runtime import trace
    from repro_torch.runtime.classify import ClassifyServer

    tag = f"[mlp {dataset}]"
    float_launches = trace.counters().get("launches.qmatmul.float", 0)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = search.run_search(problem, backend="kernel", pop_size=pop,
                               n_generations=GENS, seed=SEED, dataset=dataset,
                               out_dir=out_dir, verify_rtl=True)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    searched = kernels.launch_counts()
    objs = result.pareto_objs
    log(f"{tag} run_search backend=kernel hidden={problem.n_hidden} "
        f"pop={pop} gens={GENS}: search {result.wall_s:.2f} s, pareto.json "
        f"+ verify_rtl {t_run - result.wall_s:.2f} s over {len(objs)} "
        f"points; launches {searched}")
    check(searched["qmatmul"] >= 1 + GENS + len(objs),
          "qmatmul launched fewer than once per generation and pareto point")
    check_sort_launches(searched, GENS)
    check(bool(((objs[:, 0] <= 0) & (objs[:, 1] <= 1)).any()),
          "no front point matches or dominates the exact design (0, 1)")
    check(np.isfinite(objs).all() and objs.shape[1] == 2,
          "pareto objectives are not finite (K, 2)")
    log(f"{tag} exact accuracy {problem.exact_accuracy:.6f}; front: "
        f"{len(objs)} points, loss [{objs[:, 0].min():+.4f}, "
        f"{objs[:, 0].max():+.4f}], area [{objs[:, 1].min():.4f}, "
        f"{objs[:, 1].max():.4f}]")

    art = search.load_pareto_artifact(str(pathlib.Path(out_dir) /
                                          "pareto.json"))
    check(art.family == "mlp" and art.payload["rtl_verified"] and all(
        p.get("verified") for p in art.points),
        "pareto.json does not record every point as verified")
    idx = best_point(art)
    server = ClassifyServer.from_artifact(art, point=idx, backend="kernel",
                                          device=problem.device)
    w1, w2 = art.point_design(idx)
    circuit = netlist.build_mlp_circuit(w1, w2, art.shift, art.n_classes)
    ds = load_dataset(dataset)
    codes = server.featurize(ds.x_test)

    def oracle(rows):
        x = torch.as_tensor(codes[:rows], device=problem.device)
        return [("netlist", netlist.simulate(circuit, x).cpu().numpy()),
                ("integer predict", pm.predict_master(w1, w2, art.shift,
                                                      codes[:rows]))]

    latency, served = serve_latency(server, codes, oracle, f"mlp {dataset}")
    acc = float((served == ds.y_test).mean())
    check(abs(acc - art.point_accuracy(idx)) <= 1e-6,
          f"served accuracy {acc} != recorded {art.point_accuracy(idx)}")
    counts = kernels.launch_counts()
    check(counts["qmatmul"] > searched["qmatmul"],
          "serving the MLP point never launched qmatmul")
    check(trace.counters().get("launches.qmatmul.float", 0)
          == float_launches,
          "the MLP path ran qmatmul's float kernel, not the integer one")
    log(f"{tag} served point {idx} (acc_loss "
        f"{art.points[idx]['acc_loss']:+.4f}, norm_area "
        f"{art.points[idx]['norm_area']:.4f}) over requests of "
        f"{sorted(latency)} rows == netlist simulation == integer predict; "
        f"accuracy {acc:.6f} == recorded; latency ms "
        f"{json.dumps({k: round(v, 3) for k, v in latency.items()})}")
    log(f"{tag} launches over search + serve: {counts}")

    genes = result.state.genes
    ker = pm.make_kernel_fitness(problem)(genes)
    ref = pm.make_reference_fitness(problem)(genes)
    check(torch.equal(ker, ref), "the MLP kernel fitness differs from the "
          "reference fitness on the final population")
    log(f"{tag} kernel fitness == reference fitness on the final "
        f"population ({genes.shape[0]} chromosomes)")
    return dict(counts=counts, state=result.state, art=art)


def phase_breakdown(what: str, fitness, state, n_genes: int, device,
                    kernel: str) -> None:
    """Where one generation's time goes: a whole `make_step` against its
    fitness call (and, from a profiler trace, the device time of the
    fitness kernel ``kernel`` in it) and its survivor selection (sort +
    crowding) on the step's own pool of parents and children, host clock
    around synchronised calls, median of 3, with the device time of the
    sort's two kernels (relation and front peel) on that pool; survivors
    must run without a host sync, and its ranks must equal the host loop's
    on that pool. The device's busy time in a step (every
    device activity in a profiler trace of it) gives the step's device idle
    share."""
    from repro_torch.core import nsga2
    from repro_torch.kernels import domination

    pop = state.genes.shape[0]
    cfg = nsga2.NSGA2Config(pop_size=pop)
    children = {}

    def fitness_seen(genes):
        children["objs"] = fitness(genes)
        return children["objs"]

    step = nsga2.make_step(fitness_seen, cfg)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)

    draws = nsga2.draw_step(gen, pop, n_genes, device)
    t_step = host_ms(lambda: step(state, draws))
    busy = device_ms(lambda: step(state, draws), 3)
    t_fit = host_ms(lambda: fitness(state.genes))
    t_kernel = device_ms(lambda: fitness(state.genes), 3, kernel)
    pool = torch.cat([state.objs, children["objs"]])
    rank, _, _ = sync_free(lambda: nsga2.survivors(pool, pop),
                           f"{what}: survivors")
    check(torch.equal(rank, domination.non_dominated_rank_plain(pool)),
          f"{what}: the card's ranks of the search pool differ from the "
          f"host loop's")
    t_surv = host_ms(lambda: nsga2.survivors(pool, pop))
    t_sort = device_ms(lambda: nsga2.non_dominated_sort(pool), 10)
    fronts = int(rank.max()) + 1
    p2 = pool.shape[0]
    sort_ops = 3 * 2 * p2 * p2 + peel_ops(rank)
    sort_bound, sort_by = bound(p2 * 2 * 4 + p2 * 4, sort_ops, FP32_OPS_PER_S)
    sort_text = ("not in the trace" if t_sort is None
                 else f"{t_sort:.4f} ms")
    sort_text += (f", bound {sort_bound:.6f} ms ({sort_by}; {sort_ops} "
                  f"compares and popcounts)")
    kernel_text = ("not in the trace" if t_kernel is None
                   else f"{t_kernel:.3f} ms")
    busy_text = ("not in the trace" if busy is None else
                 f"{busy:.2f} ms, idle share {1 - busy / t_step:.3f}")
    log(f"[breakdown] {what}: one generation (pop {pop}, pool {2 * pop}): "
        f"step {t_step:.2f} ms = fitness {t_fit:.2f} ms (device time of "
        f"{kernel} in it: {kernel_text}) + survivors {t_surv:.2f} ms "
        f"({fronts} fronts peeled on the card, no host sync; device time "
        f"of the sort's two kernels {sort_text}) + operators and draws "
        f"{t_step - t_fit - t_surv:.2f} ms; device busy in a step: "
        f"{busy_text}")


def forest_nl(ptrees) -> int:
    """sum_k N_k L_k: the path product's multiply-adds per row of a forest
    (N L for one tree)."""
    return sum(pt.n_comparators * pt.n_leaves for pt in ptrees)


def random_chromosomes(rng, p: int, n: int, dev):
    """(shift, thr, cap) of p random chromosomes over n comparators, both
    vote caps."""
    from repro_torch.core import quant

    bits = rng.integers(1, 9, (p, n))
    shift = torch.as_tensor(8 - bits, dtype=torch.int32, device=dev)
    thr = torch.as_tensor(rng.integers(0, 256, (p, n)) % (1 << bits),
                          dtype=torch.int32, device=dev)
    cap = torch.as_tensor(np.where(rng.random(p) < 0.5, 1,
                                   quant.NO_VOTE_CAP), dtype=torch.int32,
                          device=dev)
    return shift, thr, cap


def phase_wide_kernels(what: str, ptrees, x8: torch.Tensor, y, c: int,
                       fit_pop: int, rng) -> None:
    """Both widened kernels against their plain versions at one wide
    layout (the forest's block-diagonal super-tree, or a single wide tree):
    `fitness_correct_counts` at P = ``fit_pop`` over the rows of ``x8`` and
    `tree_infer_scores` at P = 1 (the verify leg), exact, each timed beside
    its bound with the path product counted tree by tree."""
    from repro_torch.core.tree import concatenate_ptrees
    from repro_torch.kernels import fitness, ops, tree_infer

    dev = x8.device
    arrays = concatenate_ptrees(ptrees)
    n, l = arrays["path"].shape[1], arrays["path"].shape[0]
    b, n_feat = x8.shape
    nl = forest_nl(ptrees)
    feature = torch.as_tensor(arrays["feature"], device=dev).long()
    fit_ops = ops.prepare_fitness_operands(
        x8[:, feature], y, arrays["path"], arrays["path_len"],
        arrays["n_neg"], arrays["leaf_class"], c)
    shift, thr, cap = random_chromosomes(rng, fit_pop, n, dev)
    got = fitness.fitness_correct_counts(fit_ops, shift, thr, cap)
    torch.cuda.synchronize()
    want = fitness.fitness_correct_counts_plain(fit_ops, shift, thr, cap)
    err = int((got.long() - want.long()).abs().max())
    check(err == 0 and int(want.sum()) > 0,
          f"fitness_errors at {what} differs from its plain version by {err}")
    ms, plain_ms, text = timed(
        lambda: fitness.fitness_correct_counts(fit_ops, shift, thr, cap),
        lambda: fitness.fitness_correct_counts_plain(fit_ops, shift, thr, cap),
        "fitness_mma_kernel", reps=10, plain_reps=2)
    spans = fit_ops.spans.cpu().numpy()
    span_work = int(((spans[:, 1] - spans[:, 0]) * fitness.LEAF_TILE).sum())
    n_ops = tree_ops(fit_pop, b, n, l, c, nl)
    n_bytes = (b * fit_ops.x_sel.shape[1] + 2 * fit_pop * n * 4
               + fit_ops.path.numel() + 2 * fit_ops.path.shape[0] * 4
               + b * 4 + 2 * fit_pop * 4)
    bms, by = bound(n_bytes, n_ops, INT8_OPS_PER_S)
    log(f"[forest] fitness_errors {what} P={fit_pop} B={b} N={n} L={l} C={c}:"
        f" equal; {text}; bound {bms:.4f} ms ({by}; {n_ops:.4g} int ops with "
        f"the path product tree by tree, sum N_k L_k = {nl}, dense N L = "
        f"{n * l}; {n_bytes} bytes); {n_ops / ms / 1e9:.1f} TOP/s, "
        f"{ms / bms:.2f}x its bound; chunk {fit_ops.chunk} comparators, the "
        f"tiles' spans {span_work} leaf-comparator pairs "
        f"({span_work / (n * l):.3f} of the dense product)")
    operands = ops.prepare_operands(
        arrays["feature"], arrays["path"], arrays["path_len"],
        arrays["n_neg"], arrays["leaf_class"], c, n_feat, device=dev)
    s1, t1 = shift[:1].contiguous(), thr[:1].contiguous()
    got = tree_infer.tree_infer_scores(x8, operands, s1, t1)
    torch.cuda.synchronize()
    want = tree_infer.tree_infer_scores_plain(x8, operands, s1, t1)
    err = int((got - want).abs().max())
    check(err == 0 and int(want.sum()) > 0,
          f"tree_infer_scores at {what} differs from its plain version by "
          f"{err}")
    ms, plain_ms, text = timed(
        lambda: tree_infer.tree_infer_scores(x8, operands, s1, t1),
        lambda: tree_infer.tree_infer_scores_plain(x8, operands, s1, t1),
        "tree_infer_kernel", reps=20, plain_reps=5)
    n_ops = tree_ops(1, b, n, l, c, nl)
    n_bytes = (b * n_feat * 4 + n * 4 + 2 * n * 4
               + 2 * operands.pos.numel() * 4 + 3 * l * 4 + b * c * 4)
    bms, by = bound(n_bytes, n_ops, INT8_OPS_PER_S)
    log(f"[forest] tree_infer_scores {what} P=1 B={b}: equal; {text}; bound "
        f"{bms:.5f} ms ({by}; {n_ops:.4g} int ops, {n_bytes} bytes); "
        f"{ms / bms:.1f}x its bound; masks of {operands.nwp} words x "
        f"{operands.n_seg} segment(s) a leaf, {operands.d_words} decision "
        f"words a sample")


def phase_forest(rng, out_dir: str, device="cuda") -> dict:
    """`--trees 5` on har: train the forest (timed), hold both widened
    kernels to their plain versions at its super-tree and at a synthetic
    single tree of 4096 comparators, then the forest path through the
    user's entry points, counted: `run_search(backend="kernel")` with
    `verify_rtl` into a `pareto.json`, and serving at the 1 / 37 / 1024 /
    3090-row buckets against the netlist."""
    from repro_torch import kernels, search
    from repro_torch.core import netlist
    from repro_torch.core.forest import train_forest
    from repro_torch.core.tree import random_tree, to_parallel
    from repro_torch.datasets import load_dataset
    from repro_torch.runtime.classify import ClassifyServer

    ds = load_dataset(DATASET)
    t0 = time.perf_counter()
    forest = train_forest(ds.x_train, ds.y_train, ds.n_classes,
                          n_trees=FOREST_TREES)
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    problem = search.build_forest_problem(forest, ds.x_test, ds.y_test,
                                          device=device)
    t_build = time.perf_counter() - t0
    n, l = problem.n_comparators, problem.n_leaves
    widest = max(problem.tree_comparators)
    log(f"[forest] {DATASET} --trees {FOREST_TREES}: N={n} L={l} "
        f"B={problem.x8.shape[0]} C={problem.n_classes}; trees' comparators "
        f"{list(problem.tree_comparators)} (widest {widest}), leaves "
        f"{list(problem.tree_leaves)}; exact accuracy "
        f"{problem.exact_accuracy:.6f}, exact area "
        f"{problem.exact_area_mm2:.2f} mm^2 (vote adder "
        f"{problem.vote_units_exact} / {problem.vote_units_approx} quanta "
        f"exact / approximate); training {t_train:.1f} s, problem "
        f"{t_build:.1f} s")
    check(n > 2048, f"the forest has N={n} comparators, not past the old "
          f"2048 cap")
    c = problem.n_classes
    y = problem.y.cpu().numpy()
    phase_wide_kernels(f"forest[{FOREST_TREES}]", forest.ptrees, problem.x8,
                       y, c, POP, rng)
    wide = to_parallel(random_tree(rng, WIDE_N, problem.n_features, c))
    phase_wide_kernels(f"synthetic tree N={WIDE_N}", [wide], problem.x8, y, c,
                       WIDE_POP, rng)

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = search.run_search(problem, backend="kernel", pop_size=POP,
                               n_generations=GENS, seed=SEED,
                               dataset=DATASET, out_dir=out_dir,
                               verify_rtl=True)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    searched = kernels.launch_counts()
    objs = result.pareto_objs
    log(f"[forest] run_search backend=kernel pop={POP} gens={GENS}: search "
        f"{result.wall_s:.2f} s, pareto.json + verify_rtl "
        f"{t_run - result.wall_s:.2f} s over {len(objs)} points; "
        f"{result.n_dispatches} device dispatches; launches {searched}")
    check(searched["fitness_errors"] >= 1 + GENS,
          "fitness_errors launched fewer than once per generation")
    check_sort_launches(searched, GENS)
    check(bool(((objs[:, 0] <= 0) & (objs[:, 1] <= 1)).any()),
          "no front point matches or dominates the exact design (0, 1)")
    check(np.isfinite(objs).all() and objs.shape[1] == 2,
          "pareto objectives are not finite (K, 2)")
    art = search.load_pareto_artifact(str(pathlib.Path(out_dir) /
                                          "pareto.json"))
    check(art.n_trees == FOREST_TREES and art.payload["rtl_verified"]
          and all(p.get("verified") for p in art.points),
          "the forest's pareto.json does not record every point as verified")
    log(f"[forest] front: {len(objs)} points, loss "
        f"[{objs[:, 0].min():+.4f}, {objs[:, 0].max():+.4f}], area "
        f"[{objs[:, 1].min():.4f}, {objs[:, 1].max():.4f}]; every point's "
        f"netlist == predict_votes == tree_infer_scores over "
        f"{problem.x8.shape[0]} rows")
    idx = best_point(art)
    server = ClassifyServer.from_artifact(art, point=idx, backend="kernel",
                                          device=device)
    bits, t_int, trunc, vote_adder = art.point_design(idx)
    circuit = netlist.build_circuit(art.ptrees(), bits, t_int, art.n_classes,
                                    trunc=trunc, vote_adder=vote_adder)
    codes = server.featurize(ds.x_test)
    latency, served = serve_latency(
        server, codes, lambda rows: [("netlist", netlist.simulate(
            circuit, torch.as_tensor(codes[:rows], device=device))
            .cpu().numpy())], "forest")
    acc = float((served == ds.y_test).mean())
    check(abs(acc - art.point_accuracy(idx)) <= 1e-6,
          f"served accuracy {acc} != recorded {art.point_accuracy(idx)}")
    counts = kernels.launch_counts()
    check(all(counts[k] > 0 for k in TREE_KERNELS),
          f"a kernel of the forest path never launched: {counts}")
    log(f"[forest] served point {idx} ({vote_adder} vote adder, acc_loss "
        f"{art.points[idx]['acc_loss']:+.4f}, norm_area "
        f"{art.points[idx]['norm_area']:.4f}) over requests of "
        f"{sorted(latency)} rows == netlist simulation; accuracy {acc:.6f} "
        f"== recorded; latency ms "
        f"{json.dumps({k: round(v, 3) for k, v in latency.items()})}")
    log(f"[forest] launches over search + serve: {counts}")
    return dict(counts=counts, art=art)


def eager_run(problem, fitness, pop: int, gens: int, seed: int):
    """The per-generation loop `run_search` replaced: the same initial
    population and generator, then `make_step` once per generation."""
    from repro_torch.core import nsga2

    dev = problem.device
    cfg = nsga2.NSGA2Config(pop_size=pop)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = nsga2.init_state(fitness, cfg, nsga2.draw_init(
        gen, pop, problem.n_genes, 1, dev), seed_genes=problem.exact_genes())
    step = nsga2.make_step(fitness, cfg)
    for _ in range(gens):
        state = step(state, nsga2.draw_step(gen, pop, problem.n_genes, dev))
    return state, gen


def same_state(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("genes", "objs", "rank", "crowd"))


def phase_chunk(what: str, problem, fitness, out_dir: str) -> None:
    """A chunked run (`run_search`, ``checkpoint_every`` = CHUNK: one CUDA
    graph a chunk) equals the per-generation loop element for element; then
    one generation's time inside a captured chunk beside an eager step
    (draws included in both), host clock around synchronised calls, median
    of 3, with the device's busy time from a profiler trace and the idle
    share; the graphs captured and the dispatches."""
    from repro_torch import search
    from repro_torch.core import nsga2

    captures = nsga2.make_chunk.captures
    result = search.run_search(problem, backend="kernel", pop_size=POP,
                               n_generations=GENS, seed=SEED,
                               out_dir=out_dir, checkpoint_every=CHUNK)
    torch.cuda.synchronize()
    graphs = nsga2.make_chunk.captures - captures
    eager, _ = eager_run(problem, fitness, POP, GENS, SEED)
    check(same_state(result.state, eager),
          f"{what}: the chunked run differs from the per-generation loop")
    check(result.n_dispatches == 1 + -(-GENS // CHUNK),
          f"{what}: {result.n_dispatches} dispatches for {GENS} generations "
          f"in chunks of {CHUNK}")

    state = result.state
    dev = problem.device
    cfg = nsga2.NSGA2Config(pop_size=POP)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    step = nsga2.make_step(fitness, cfg)
    chunk = nsga2.make_chunk(fitness, cfg, CHUNK)
    chunk(state, gen)                        # capture

    def eager_step():
        return step(state, nsga2.draw_step(gen, POP, problem.n_genes, dev))

    t_eager = host_ms(eager_step)
    busy_eager = device_ms(eager_step, 3)
    t_chunk = host_ms(lambda: chunk(state, gen)) / CHUNK
    busy_chunk = device_ms(lambda: chunk(state, gen), 3)

    def busy_text(busy, t):
        if busy is None:
            return "not in the trace"
        return f"{busy:.2f} ms, idle share {1 - busy / t:.3f}"

    log(f"[chunk] {what}: {GENS} generations in chunks of {CHUNK} == the "
        f"per-generation loop (genes, objs, rank, crowd); "
        f"{result.n_dispatches} device dispatches, {graphs} CUDA graphs "
        f"captured")
    log(f"[chunk] {what}: one generation (pop {POP}, draws included): eager "
        f"step {t_eager:.2f} ms, device busy "
        f"{busy_text(busy_eager, t_eager)}; in a captured chunk of {CHUNK} "
        f"{t_chunk:.2f} ms, device busy "
        + busy_text(None if busy_chunk is None else busy_chunk / CHUNK,
                    t_chunk))


def phase_resume(problem, root: str) -> None:
    """8 generations with saves every 3 (3, 6, 8); a fresh `run_search` that
    resumes from the step-6 save must end equal to the uninterrupted run:
    the population, ranks and crowding, and every leaf of the step-8 save,
    the CUDA generator's state included."""
    import shutil

    from repro_torch import search

    a, b = pathlib.Path(root) / "full", pathlib.Path(root) / "resumed"
    full = search.run_search(problem, backend="kernel", pop_size=POP,
                             n_generations=GENS, seed=SEED, out_dir=str(a),
                             checkpoint_every=RESUME_EVERY)
    saved = sorted(p.name for p in (a / "ckpt").iterdir())
    check(saved == ["ckpt_00000003", "ckpt_00000006", "ckpt_00000008"],
          f"saves {saved}, not at 3, 6 and 8")
    (b / "ckpt").mkdir(parents=True)
    shutil.copytree(a / "ckpt" / "ckpt_00000006", b / "ckpt" / "ckpt_00000006")
    resumed = search.run_search(problem, backend="kernel", pop_size=POP,
                                n_generations=GENS, seed=SEED,
                                out_dir=str(b), checkpoint_every=RESUME_EVERY,
                                resume=True)
    check(same_state(full.state, resumed.state),
          "the resumed run differs from the uninterrupted one")
    with np.load(a / "ckpt" / "ckpt_00000008" / "arrays.npz") as x, \
            np.load(b / "ckpt" / "ckpt_00000008" / "arrays.npz") as y:
        check(sorted(x.files) == sorted(y.files) and all(
            np.array_equal(x[k], y[k]) for k in x.files),
            "the step-8 saves differ (population or generator state)")
        rng_bytes = x["4"].size
    log(f"[resume] {DATASET} tree pop {POP}: {GENS} generations saving every "
        f"{RESUME_EVERY} (steps {[int(s[5:]) for s in saved]}); resumed from "
        f"step 6 in a fresh run_search ({resumed.n_dispatches} dispatch, "
        f"{resumed.n_evaluations} evaluations) == the uninterrupted run, and "
        f"the step-8 saves are equal leaf for leaf (genes, objs, rank, "
        f"crowd, the {rng_bytes}-byte CUDA generator state, generation)")


SWEEP_POP, SWEEP_GENS = 64, 40     # the sweep CLI's defaults
SWEEP_MIXED = dict(datasets=("seeds", "vertebral"), n_trees=2,
                   mlp_datasets=("seeds", "pendigits"), pop=16, gens=4,
                   max_buckets=2)   # one forest bucket, one MLP bucket


def same_results(a, b) -> bool:
    """Two `SweepResult`s equal array for array: every problem's final
    population (genes, objs, rank, crowd) and its pareto front."""
    if a.results.keys() != b.results.keys():
        return False
    return all(same_state(a.results[n].state, b.results[n].state)
               and np.array_equal(a.results[n].pareto_objs,
                                  b.results[n].pareto_objs)
               and np.array_equal(a.results[n].pareto_genes,
                                  b.results[n].pareto_genes)
               for n in a.results)


def bucket_dims_text(bucket) -> str:
    keys = ("N", "L", "C", "F", "B") if bucket.family == "tree" else (
        "H", "C", "F", "B")
    return ", ".join(f"{k}={v}" for k, v in zip(keys, bucket.dims))


def sweep_generation_ms(problems, bucket) -> tuple[float, float | None]:
    """(host ms, device busy ms) of one generation of ``bucket`` inside a
    captured chunk of CHUNK generations of the batched sweep (draws
    included), host clock around synchronised replays, median of 3, and the
    device's busy time from a profiler trace of 3 replays."""
    from repro_torch.core import nsga2
    from repro_torch.families import get_family
    from repro_torch.search import sweep

    fam = get_family(bucket.family)
    stacked = sweep.stack_padded([fam.pad_problem(problems[n], bucket.dims)
                                  for n in bucket.names])
    n_genes = fam.padded_n_genes(bucket.dims)
    cfg = nsga2.NSGA2Config(pop_size=SWEEP_POP)

    def fitness(pop):
        return fam.population_objectives(stacked, pop)

    gens = list(sweep.problem_generators(list(bucket.names), SEED + 3,
                                         "cuda").values())
    state = nsga2.make_batched_init(fitness, n_genes, cfg,
                                    fam.padded_exact_genes(bucket.dims))(
        gens, torch.device("cuda"))
    chunk = nsga2.make_batched_chunk(fitness, cfg, CHUNK)
    chunk(state, gens)                            # capture
    t = host_ms(lambda: chunk(state, gens)) / CHUNK
    busy = device_ms(lambda: chunk(state, gens), 3)
    return t, None if busy is None else busy / CHUNK


def padded_exact_objs(problems, bucket, name) -> np.ndarray:
    """The padded exact design's objectives of problem ``name``."""
    from repro_torch.families import get_family

    fam = get_family(bucket.family)
    pp = fam.pad_problem(problems[name], bucket.dims)
    genes = torch.as_tensor(fam.padded_exact_genes(bucket.dims),
                            device="cuda")[None]
    return fam.population_objectives(pp, genes)[0].cpu().numpy()


def check_fronts(what: str, sweep_result, problems, buckets) -> None:
    """Every dataset's front holds a point no worse in both objectives than
    its padded exact design, and every front is finite (K, 2)."""
    for bucket in buckets:
        for name in bucket.names:
            objs = sweep_result.results[name].pareto_objs
            exact = padded_exact_objs(problems, bucket, name)
            check(np.isfinite(objs).all() and objs.ndim == 2
                  and objs.shape[1] == 2,
                  f"{what} {name}: the front is not finite (K, 2)")
            check(bool(((objs[:, 0] <= exact[0])
                        & (objs[:, 1] <= exact[1])).any()),
                  f"{what} {name}: no front point matches or dominates the "
                  f"padded exact design {exact.tolist()}")


def phase_sweep_kernels(problems, bucket, rng, counts: dict) -> dict:
    """The batched fitness kernel and the batched sort at ``bucket``'s shape
    (bucket 0 of the campaign: K=5, pool 2 x SWEEP_POP) against K single
    launches and their plain versions, exactly; each timed beside its
    bound and the K single launches. Returns the kernel-line rows."""
    from repro_torch.core import quant
    from repro_torch.kernels import domination, fitness
    from repro_torch.search import problem_ptrees, sweep

    padded = [sweep.pad_problem(problems[n], bucket.dims)
              for n in bucket.names]
    stacked = sweep.stack_padded(padded)
    k = len(padded)
    genes = torch.as_tensor(rng.random((k, SWEEP_POP, padded[0].n_genes),
                                       dtype=np.float32), device="cuda")
    genes[:, 0] = torch.as_tensor(quant.exact_tree_genes(bucket.dims[0]))
    shift, t_sub, cap = sweep.padded_fitness_args(stacked, genes)
    ops = stacked.fit_ops
    got = fitness.fitness_correct_counts(ops, shift, t_sub, cap)
    torch.cuda.synchronize()
    want = fitness.fitness_correct_counts_plain(ops, shift, t_sub, cap)
    singles = [(p.fit_ops, shift[i].contiguous(), t_sub[i].contiguous(),
                cap[i].contiguous()) for i, p in enumerate(padded)]
    one_by_one = torch.stack([fitness.fitness_correct_counts(*a)
                              for a in singles])
    err = int((got.long() - want.long()).abs().max())
    check(err == 0 and torch.equal(got, one_by_one),
          f"the batched fitness kernel differs from its plain version "
          f"({err}) or from {k} single launches")
    for i, name in enumerate(bucket.names):
        b_real = int(problems[name].y.shape[0])
        check(int(got[i, 0]) == round(problems[name].exact_accuracy * b_real),
              f"the batched fitness kernel miscounts {name}'s exact design")
    ms, plain_ms, text = timed(
        lambda: fitness.fitness_correct_counts(ops, shift, t_sub, cap),
        lambda: fitness.fitness_correct_counts_plain(ops, shift, t_sub, cap),
        "fitness_mma_kernel", reps=20, plain_reps=3)
    single_ms = device_ms(lambda: [fitness.fitness_correct_counts(*a)
                                   for a in singles], 20,
                          "fitness_mma_kernel")
    n_ops = n_bytes = 0
    for name in bucket.names:
        p = problems[name]
        b_real = int(p.y.shape[0])
        n_ops += tree_ops(SWEEP_POP, b_real, p.n_comparators, p.n_leaves,
                          p.n_classes, forest_nl(problem_ptrees(p)))
        n_bytes += (b_real * p.n_comparators + 2 * SWEEP_POP
                    * p.n_comparators * 4 + p.n_leaves * p.n_comparators
                    + 2 * p.n_leaves * 4 + b_real * 4 + 2 * SWEEP_POP * 4)
    bms, by = bound(n_bytes, n_ops, INT8_OPS_PER_S)
    single_text = ("not in the trace" if single_ms is None
                   else f"{single_ms:.4f} ms")
    log(f"[sweep] batched fitness_errors, bucket of K={k} "
        f"({bucket_dims_text(bucket)}), P={SWEEP_POP}: equal to its plain "
        f"version and to {k} single launches; one launch {text}; {k} single "
        f"launches {single_text} device time; bound {bms:.5f} ms ({by}; "
        f"{n_ops:.4g} int ops of the real trees, {n_bytes} bytes)")
    fit_row = dict(name="fitness_errors[bucket]", route="cuda",
                   source=TPU_KERNELS["fitness_errors"][0],
                   replaces=TPU_KERNELS["fitness_errors"][1],
                   launches=counts["fitness_errors"], max_abs_err=float(err),
                   ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                   library_ms=None,
                   what=f"fitness_correct_counts over a stacked bucket: "
                        f"K={k} problems ({', '.join(bucket.names)}) padded "
                        f"to ({bucket_dims_text(bucket)}), P={SWEEP_POP}; "
                        f"launches: the ten-dataset campaign's")

    pool = 2 * SWEEP_POP
    objs = torch.as_tensor((rng.integers(0, 64, (k, pool, 2)) / 63)
                           .astype(np.float32), device="cuda")
    got = sync_free(lambda: domination.non_dominated_rank(objs),
                    "the batched sort")
    torch.cuda.synchronize()
    one_by_one = torch.stack([domination.non_dominated_rank(objs[i])
                              for i in range(k)])
    want = domination.non_dominated_rank_plain(objs)
    err = int((got - want).abs().max())
    check(err == 0 and torch.equal(got, one_by_one),
          f"the batched sort differs from the host loop ({err}) or from {k} "
          f"single sorts")
    ms_s, plain_s, text = timed(
        lambda: domination.non_dominated_rank(objs),
        lambda: domination.non_dominated_rank_plain(objs), None, reps=20,
        plain_reps=3)
    single_s = device_ms(lambda: [domination.non_dominated_rank(objs[i])
                                  for i in range(k)], 20)
    n_ops = sum(3 * 2 * pool * pool + peel_ops(got[i]) for i in range(k))
    n_bytes = k * (pool * 2 * 4 + pool * 4)
    bms, by = bound(n_bytes, n_ops, FP32_OPS_PER_S)
    fronts = [int(r.max()) + 1 for r in got]
    single_text = ("not in the trace" if single_s is None
                   else f"{single_s:.4f} ms")
    log(f"[sweep] batched sort, K={k} pools of {pool} ({fronts} fronts): "
        f"ranks equal {k} single sorts and the host loop, 2 launches, no "
        f"host sync; {text}; {k} single sorts {single_text} device time; "
        f"bound {bms:.6f} ms ({by}; {n_ops} compares and popcounts)")
    sort_row = dict(name="domination_block[bucket]", route="cuda",
                    source=TPU_KERNELS["domination_block"][0],
                    replaces=TPU_KERNELS["domination_block"][1],
                    launches=counts["domination_block"],
                    max_abs_err=float(err), ms=ms_s, plain_ms=plain_s,
                    bound_ms=bms, bound_by=by, library_ms=None,
                    what=f"the sort of K={k} random pools of {pool}, M=2: "
                         f"domination_bits on a (words, K) grid + the peel "
                         f"on K blocks; launches: the ten-dataset "
                         f"campaign's, two per sort")
    return {fit_row["name"]: fit_row, sort_row["name"]: sort_row}


def phase_sweep(rng, root: str) -> dict:
    """`[sweep]`: the paper's campaign over the ten datasets at their real
    sizes, batched (with --verify-rtl and the report) and serial, equal
    array for array; per bucket its dims, K, a generation's host and busy
    ms and its launches; the batched kernels held at bucket 0; then a mixed
    campaign (trees, forests and MLPs) batched == serial."""
    from repro_torch import kernels
    from repro_torch.datasets import DATASET_SPECS
    from repro_torch.search import sweep

    t_start = time.perf_counter()
    names = sorted(DATASET_SPECS)
    problems = sweep.build_problems(names, device="cuda")
    t_build = time.perf_counter() - t_start
    buckets = sweep.plan_buckets(problems)
    log(f"[sweep] {len(names)} datasets trained and built in {t_build:.1f} s "
        f"(host CART training + problem set-up); {len(buckets)} buckets")

    out_dir = str(pathlib.Path(root) / "campaign")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    batched = sweep.run_sweep(problems, pop_size=SWEEP_POP,
                              n_generations=SWEEP_GENS, seed=SEED,
                              out_dir=out_dir, verify_rtl=True)
    torch.cuda.synchronize()
    t_batched = time.perf_counter() - t0
    counts = kernels.launch_counts()
    json_path, _ = sweep.write_sweep_report(
        batched, problems, out_dir, meta={"datasets": "all", "trees": 1,
                                          "pop": SWEEP_POP,
                                          "gens": SWEEP_GENS, "seed": SEED,
                                          "mode": "vmapped"})
    t1 = time.perf_counter()
    serial = sweep.run_sweep(problems, pop_size=SWEEP_POP,
                             n_generations=SWEEP_GENS, seed=SEED,
                             vmapped=False)
    torch.cuda.synchronize()
    t_serial = time.perf_counter() - t1
    check(same_results(batched, serial),
          "the batched ten-dataset campaign differs from the serial loop")
    check([r.bucket for r in batched.bucket_runs] == buckets,
          "the campaign's buckets are not the planner's")
    check_fronts("[sweep]", batched, problems, buckets)
    n_pts = sum(len(r.pareto_objs) for r in batched.results.values())
    log(f"[sweep] batched campaign pop={SWEEP_POP} gens={SWEEP_GENS}: "
        f"{t_batched:.1f} s with verify_rtl over {n_pts} pareto points "
        f"({batched.n_dispatches} dispatches); serial {t_serial:.1f} s "
        f"without verify ({serial.n_dispatches} dispatches); batched == "
        f"serial (genes, objs, rank, crowd, fronts) for all {len(names)}; "
        f"every front holds a point no worse than its padded exact design")
    fit_sort = {"fitness_errors": 0, "domination_block": 0}
    for run, srun in zip(batched.bucket_runs, serial.bucket_runs):
        b = run.bucket
        k = len(b.names)
        # the initial population, the graph capture's warm-up step, then
        # one fitness launch and one sort (two launches) a generation
        want_b = {"fitness_errors": 2 + SWEEP_GENS,
                  "domination_block": 2 * (2 + SWEEP_GENS)}
        got_b = {n: run.launches.get(n, 0) for n in want_b}
        got_s = {n: srun.launches.get(n, 0) for n in want_b}
        check(got_b == want_b,
              f"bucket {b.names}: batched launches {got_b}, not {want_b}: "
              f"one fitness launch and one sort a generation (and the "
              f"initial population's and the warm-up step's)")
        check(got_s == {n: k * v for n, v in want_b.items()},
              f"bucket {b.names}: serial launches {got_s}, not K times "
              f"{want_b}")
        for n in fit_sort:
            fit_sort[n] += got_b[n]
        t_gen, busy = sweep_generation_ms(problems, b)
        busy_text = ("not in the trace" if busy is None else
                     f"device busy {busy:.3f} ms, idle share "
                     f"{1 - busy / t_gen:.3f}")
        log(f"[sweep] bucket [{b.family}] {', '.join(b.names)}: "
            f"({bucket_dims_text(b)}), K={k}; search {run.search_s:.3f} s "
            f"batched / {srun.search_s:.3f} s serial for init + "
            f"{SWEEP_GENS} generations; one generation in a captured chunk "
            f"of {CHUNK}: {t_gen:.3f} ms host clock, {busy_text}; launches "
            f"per run batched {got_b}, serial {got_s}")
    report = json.load(open(json_path))
    s = report["summary"]
    log(f"[sweep] report: mean area reduction at the 1% budget "
        f"{s['mean_area_reduction_at_budget']}x over {s['n_at_budget']}/"
        f"{s['n_datasets']} datasets (paper: "
        f"{s['paper_mean_area_reduction_1pct']}x); mean |accuracy delta| vs "
        f"Table I {s['mean_abs_accuracy_delta_vs_paper']}")
    rows = phase_sweep_kernels(problems, buckets[0], rng, fit_sort)

    mixed = sweep.build_problems(SWEEP_MIXED["datasets"],
                                 n_trees=SWEEP_MIXED["n_trees"],
                                 mlp_datasets=SWEEP_MIXED["mlp_datasets"],
                                 device="cuda")
    kw = dict(pop_size=SWEEP_MIXED["pop"],
              n_generations=SWEEP_MIXED["gens"], seed=SEED,
              max_buckets=SWEEP_MIXED["max_buckets"])
    kernels.reset_launch_counts()
    mb = sweep.run_sweep(mixed, out_dir=str(pathlib.Path(root) / "mixed"),
                         verify_rtl=True, **kw)
    torch.cuda.synchronize()
    mixed_counts = kernels.launch_counts()
    ms_ = sweep.run_sweep(mixed, vmapped=False, **kw)
    torch.cuda.synchronize()
    check(same_results(mb, ms_),
          "the batched mixed campaign differs from the serial loop")
    check_fronts("[sweep mixed]", mb, mixed,
                 [r.bucket for r in mb.bucket_runs])
    check(mixed_counts["qmatmul"] > 0 and mixed_counts["fitness_errors"] > 0,
          f"the mixed campaign did not run both families' kernels: "
          f"{mixed_counts}")
    log(f"[sweep] mixed campaign {sorted(mixed)} (--trees "
        f"{SWEEP_MIXED['n_trees']}, pop {SWEEP_MIXED['pop']}, gens "
        f"{SWEEP_MIXED['gens']}): buckets "
        f"{[(r.bucket.family, r.bucket.names) for r in mb.bucket_runs]}; "
        f"batched == serial; launches {mixed_counts}")
    for n, v in mixed_counts.items():
        counts[n] += v
    log(f"[sweep] launches over both campaigns (batched, verify included): "
        f"{counts}; phase {time.perf_counter() - t_start:.1f} s, of which "
        f"{t_build:.1f} s the ten trees' host training")
    return dict(counts=counts, rows=rows, mixed=mixed, mixed_result=mb)


FAULT_SPREAD = 16       # [faults]: single-fault lanes held to the numpy oracle
FAULT_CHUNK = 64        # [faults]: the har campaign's second run, --chunk 64
FAULT_WIDE_CHUNK = 256  # MAX_CHUNK: the MLP campaign's second run
FAULT_PLAIN_LANES = 1024   # lanes a call of the plain level chain, timed


def busy_ms(fn) -> float:
    """Device time of one call of ``fn``: the summed device activities of a
    `torch.profiler` trace of the device alone, with no warm-up call."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def fault_campaign(what: str, sim, x8, gates, values, chunk):
    """The exhaustive single stuck-at campaign over ``gates``/``values`` at
    ``chunk`` (None: the default, every lane in one launch of the
    fault-lane kernel): its predictions and wall s, with its launches and
    the device busy s of a second, traced call (`busy_ms`)."""
    from repro_torch import kernels
    from repro_torch.kernels import fault_sim

    before = kernels.launched(fault_sim.fault_lanes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    preds = sim.run_sites(x8, gates, values, chunk=chunk)
    wall = time.perf_counter() - t0
    launches = kernels.launched(fault_sim.fault_lanes) - before
    want = 1 if chunk is None else -(-len(gates) // chunk)
    check(launches == want, f"{what}: the campaign launched the fault-lane "
          f"kernel {launches} times, not {want}")
    busy = busy_ms(lambda: sim.run_sites(x8, gates, values, chunk=chunk))
    # a trace that holds no device activity measured nothing
    busy_text = (f"device busy {busy / 1e3:.3f} s (a traced call), idle "
                 f"share {1 - busy / 1e3 / wall:.3f}" if busy else
                 "device busy not measured (the traced call holds no device "
                 "activity)")
    log(f"[faults] {what}: {len(gates)} lanes over {x8.shape[0]} rows, "
        f"G={sim.circuit.n_gates}, "
        f"{'default chunk' if chunk is None else f'--chunk {chunk}'}: "
        f"{launches} launches, wall {wall:.3f} s, {busy_text}")
    return preds, wall


def fault_kernel_row(what: str, circuit, x8, gates, values) -> dict:
    """`fault_lanes` over the single lanes ``gates``/``values`` of
    ``circuit`` against its plain version (`FAULT_PLAIN_LANES` lanes a
    call) on the same operands on the card: equal; its device ms a call
    beside its bound. Returns its row of the kernels line."""
    from repro_torch.core import faults
    from repro_torch.kernels import fault_sim

    sim = faults.FaultSimulator(circuit, device="cuda")
    tables, b = sim._tables, x8.shape[0]
    mask, val = faults.site_masks(circuit.n_gates, gates, values)
    mask_t = torch.as_tensor(mask, device="cuda")
    val_t = torch.as_tensor(val, device="cuda")
    base = fault_sim.pack_words(sim._base_bits(
        torch.as_tensor(x8, device="cuda").to(torch.int32)))

    def kernel():
        return fault_sim.fault_lanes(base, tables, mask_t, val_t, b)

    def plain():
        return [fault_sim.fault_lanes_plain(
            base, tables, mask_t[lo:lo + FAULT_PLAIN_LANES],
            val_t[lo:lo + FAULT_PLAIN_LANES], b)
            for lo in range(0, len(mask), FAULT_PLAIN_LANES)]

    got = kernel()
    torch.cuda.synchronize()
    err = int((got != torch.cat(plain())).sum())
    check(err == 0, f"{what}: fault_lanes differs from its plain version on "
          f"{err} of {got.numel()} classes")
    ms, plain_ms, text = timed(kernel, plain, "fault_lanes_kernel", reps=10,
                               plain_reps=1)
    s, g = mask.shape
    words = -(-b // 32)
    n_ops = (g - tables.n_base) * words * s   # a logic op a gate a word
    n_bytes = 2 * s * g + 4 * s * b + 4 * tables.n_base * words
    bms, by = bound(n_bytes, n_ops, FP32_OPS_PER_S)
    log_t, in_smem = fault_sim.placement(g)
    log(f"[kernel] fault_lanes {what}: G={g} ({tables.n_base} base, "
        f"{tables.level_off.numel() - 1} levels), {s} lanes x {b} rows, "
        f"{1 << log_t}-word tiles in "
        f"{'shared memory' if in_smem else 'global scratch'}: "
        f"equal to the plain version; {text}; bound {bms:.5f} ms ({by}; "
        f"{n_ops} logic word ops, {n_bytes} bytes); {ms / bms:.0f}x")
    return dict(name="fault_lanes", route="cuda",
                source=TPU_KERNELS["fault_lanes"][0],
                replaces=TPU_KERNELS["fault_lanes"][1], launches=0,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None)


def fault_spread(what: str, sim, x8, gates, values):
    """FAULT_SPREAD single-fault lanes spread over the campaign, run alone
    at the default chunk, against the numpy per-gate oracle: ``(lanes,
    oracle rows)``, which `check_lanes` holds each campaign's rows to."""
    from repro_torch.core import faults

    sel = np.unique(np.linspace(0, len(gates) - 1, FAULT_SPREAD).astype(int))
    want = np.stack([faults.simulate_faulty_serial(
        sim.circuit, x8, [(gates[lane], values[lane])]) for lane in sel])
    check_lanes(what, sim.run_sites(x8, gates[sel], values[sel]), want, sel,
                gates, values)
    log(f"[faults] {what}: {len(sel)} single-fault lanes spread over the "
        f"{len(gates)} == simulate_faulty_serial")
    return sel, want


def check_lanes(what: str, got, want, sel, gates, values) -> None:
    """``got`` (a row for each lane of ``sel``) == the oracle's ``want``."""
    for lane, g, w in zip(sel, got, want):
        check(np.array_equal(g, w),
              f"{what}: fault lane {lane} (gate {gates[lane]} stuck-at-"
              f"{values[lane]}) differs from the numpy oracle on "
              f"{int((g != w).sum())} rows")


def phase_faults(tree_art, mlp_art, forest_art, root: str) -> dict:
    """`[faults]`: the stuck-at campaign on the card. The har tree's best
    point over its whole test split: zero-fault lane == `netlist.simulate`
    == the `tree_infer_scores` leg (`ops.classify`), a spread of lanes ==
    the numpy oracle, the fault-lane kernel == its plain version over every
    single lane, timed (the kernels line's row), the exhaustive campaign at
    the default chunk (one launch) and at --chunk 64 (equal, and equal to
    the oracle at the spread lanes); the pendigits MLP's best point the
    same way (its zero-fault lane == the `qmatmul` server), at the default
    chunk and at 256; the har forest's at the default chunk; the card's
    reports == the CPU's on a seeds tree and a vertebral three-tree forest
    under both vote adders, Monte-Carlo draws reproducible; then `sweep
    --fault-report` on the mixed campaign, a robustness row per dataset,
    each report == the CPU's. The phase's launch count is that sweep's
    alone."""
    from repro_torch import kernels
    from repro_torch.core import faults, netlist, quant
    from repro_torch.core.forest import train_forest
    from repro_torch.core.train import train_tree
    from repro_torch.core.tree import concatenate_ptrees, to_parallel
    from repro_torch.datasets import load_dataset, quantize_u8
    from repro_torch.families import get_family
    from repro_torch.kernels import ops as kops
    from repro_torch.runtime.classify import ClassifyServer
    from repro_torch.search import load_pareto_artifact, robustness
    from repro_torch.search.__main__ import sweep_main

    t_start = time.perf_counter()
    marks = {}

    # the har tree's best point, every row of the test split
    ds = load_dataset(DATASET)
    x8 = quantize_u8(ds.x_test)
    x8_t = torch.as_tensor(x8, dtype=torch.int32, device="cuda")
    idx = best_point(tree_art)
    circuit = get_family("tree").build_point_circuit(tree_art, idx)
    sim = faults.FaultSimulator(circuit, device="cuda")
    zero = sim.run_zero_fault(x8)
    simulated = netlist.simulate(circuit, x8_t).cpu().numpy()
    bits, t_int, trunc, vote_adder = tree_art.point_design(idx)
    arrays = concatenate_ptrees(tree_art.ptrees())
    operands = kops.prepare_operands(
        arrays["feature"], arrays["path"], arrays["path_len"],
        arrays["n_neg"], arrays["leaf_class"], tree_art.n_classes,
        x8.shape[1], device="cuda")
    design = kops.prepare_design(bits, t_int, trunc=trunc,
                                 vote_adder=vote_adder, device="cuda")
    voted = kops.classify(x8_t, operands, design).cpu().numpy()
    check(np.array_equal(zero, simulated) and np.array_equal(zero, voted),
          f"har tree point {idx}: the zero-fault lane, netlist.simulate and "
          f"tree_infer_scores differ on "
          f"{int((zero != simulated).sum())} / {int((zero != voted).sum())} "
          f"rows")
    log(f"[faults] har tree point {idx} (G={circuit.n_gates}, "
        f"{len(netlist.level_gates(circuit)[1])} levels): zero-fault lane == "
        f"netlist.simulate == tree_infer_scores over {x8.shape[0]} rows")
    gates, values = faults.single_fault_lanes(circuit)
    sel, want = fault_spread("har tree", sim, x8, gates, values)
    row = fault_kernel_row(f"har tree point {idx}", circuit, x8, gates,
                           values)
    marks["har tree checks"] = time.perf_counter()
    auto, t_auto = fault_campaign("har tree", sim, x8, gates, values, None)
    check_lanes("har tree, default chunk", auto[sel], want, sel, gates,
                values)
    at64, t_64 = fault_campaign("har tree", sim, x8, gates, values,
                                FAULT_CHUNK)
    check(np.array_equal(auto, at64),
          "the har campaign at --chunk 64 differs from the default chunk")
    accs = (auto == ds.y_test[None, :]).mean(axis=1)
    log(f"[faults] har tree: default chunk == --chunk {FAULT_CHUNK}; "
        f"baseline {(zero == ds.y_test).mean():.4f}, single-fault mean "
        f"{accs.mean():.4f} / worst {accs.min():.4f}")
    marks["har tree campaigns"] = time.perf_counter()

    # the pendigits MLP's best point
    name = MLP_RUNS[1][0]
    mds = load_dataset(name)
    mx8 = quantize_u8(mds.x_test)
    idx = best_point(mlp_art)
    circuit = get_family("mlp").build_point_circuit(mlp_art, idx)
    sim = faults.FaultSimulator(circuit, device="cuda")
    zero = sim.run_zero_fault(mx8)
    simulated = netlist.simulate(
        circuit, torch.as_tensor(mx8, device="cuda")).cpu().numpy()
    served = ClassifyServer.from_artifact(
        mlp_art, point=idx, backend="kernel", device="cuda").classify_codes(
        mx8)
    check(np.array_equal(zero, simulated) and np.array_equal(zero, served),
          f"{name} mlp point {idx}: the zero-fault lane, netlist.simulate "
          f"and the qmatmul server differ")
    log(f"[faults] {name} mlp point {idx} (G={circuit.n_gates}, "
        f"{len(netlist.level_gates(circuit)[1])} levels): zero-fault lane "
        f"== netlist.simulate == qmatmul server over {mx8.shape[0]} rows")
    gates, values = faults.single_fault_lanes(circuit)
    sel, want = fault_spread(f"{name} mlp", sim, mx8, gates, values)
    marks[f"{name} mlp checks"] = time.perf_counter()
    t_mlp = {}
    for chunk in (None, FAULT_WIDE_CHUNK):
        got, t_mlp[chunk] = fault_campaign(f"{name} mlp", sim, mx8, gates,
                                           values, chunk)
        check_lanes(f"{name} mlp, chunk {chunk}", got[sel], want, sel, gates,
                    values)
    log(f"[faults] {name} mlp: the campaign at the default chunk and at "
        f"{FAULT_WIDE_CHUNK} == simulate_faulty_serial at the {len(sel)} "
        f"spread lanes")
    marks[f"{name} mlp campaign"] = time.perf_counter()

    # the har forest's campaign
    idx = best_point(forest_art)
    circuit = get_family("tree").build_point_circuit(forest_art, idx)
    sim = faults.FaultSimulator(circuit, device="cuda")
    gates, values = faults.single_fault_lanes(circuit)
    what = f"har forest[{forest_art.n_trees}] point {idx}"
    sel, want = fault_spread(what, sim, x8, gates, values)
    got, t_forest = fault_campaign(what, sim, x8, gates, values, None)
    check_lanes(what, got[sel], want, sel, gates, values)
    marks["har forest campaign"] = time.perf_counter()

    # the card's reports against the CPU's on small circuits
    small = {}
    sds = load_dataset("seeds")
    pt = to_parallel(train_tree(sds.x_train, sds.y_train, sds.n_classes))
    small["seeds tree"] = ([pt], sds, "exact")
    vds = load_dataset("vertebral")
    forest = train_forest(vds.x_train, vds.y_train, vds.n_classes, n_trees=3)
    for adder in ("exact", "approx"):
        small[f"vertebral forest[3] {adder}"] = (forest.ptrees, vds, adder)
    rng = np.random.default_rng(SEED)
    for what, (ptrees, d, adder) in small.items():
        thr = np.concatenate([p.threshold for p in ptrees])
        bits = rng.integers(quant.MIN_BITS, quant.MAX_BITS + 1, len(thr))
        t_int = quant.threshold_to_int(torch.as_tensor(thr),
                                       torch.as_tensor(bits)).numpy()
        circuit = netlist.build_circuit(ptrees, bits, t_int, d.n_classes,
                                        vote_adder=adder)
        sx8 = quantize_u8(d.x_test)
        card, cpu = (robustness.point_robustness(circuit, sx8, d.y_test,
                                                 device=dev)
                     for dev in ("cuda", "cpu"))
        check(card == cpu, f"{what}: the card's report differs from the "
              f"CPU's: {card} != {cpu}")
        sim = faults.FaultSimulator(circuit, device="cuda")
        mc = [robustness.monte_carlo(sim, sx8, d.y_test, seed=7,
                                     defect_rate=0.1) for _ in range(2)]
        check(np.array_equal(mc[0].pop("_accuracies"),
                             mc[1].pop("_accuracies")) and mc[0] == mc[1],
              f"{what}: Monte-Carlo under one seed did not reproduce")
        draws = [robustness.draw_defects(card["n_sites"], seed=s)
                 for s in (7, 8)]
        check(not np.array_equal(draws[0][0], draws[1][0]),
              f"{what}: Monte-Carlo under another seed drew the same masks")
        log(f"[faults] {what} (G={circuit.n_gates}, {card['n_sites']} "
            f"sites, {d.x_test.shape[0]} rows): card report == CPU report "
            f"(baseline {card['baseline_accuracy']:.4f}, 1-fault worst "
            f"{card['single_fault']['worst_accuracy']:.4f}, MC "
            f"{card['monte_carlo']['expected_accuracy']:.4f}); Monte-Carlo "
            f"reproduces under seed 7, moves under 8")
    marks["card == CPU"] = time.perf_counter()

    # sweep --fault-report on the mixed campaign
    out = str(pathlib.Path(root) / "fault_sweep")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sweep_main(["--datasets", ",".join(SWEEP_MIXED["datasets"]),
                "--trees", str(SWEEP_MIXED["n_trees"]),
                "--mlp-datasets", ",".join(SWEEP_MIXED["mlp_datasets"]),
                "--pop", str(SWEEP_MIXED["pop"]),
                "--gens", str(SWEEP_MIXED["gens"]),
                "--max-buckets", str(SWEEP_MIXED["max_buckets"]),
                "--out", out, "--verify-rtl", "--report", "--fault-report",
                "--fault-chunk", str(FAULT_WIDE_CHUNK), "--device", "cuda"])
    torch.cuda.synchronize()
    t_sweep = time.perf_counter() - t0
    counts = kernels.launch_counts()
    report = json.load(open(pathlib.Path(out) / "sweep_report.json"))
    rows = {n: r.get("robustness") for n, r in report["datasets"].items()}
    check(len(rows) == len(SWEEP_MIXED["datasets"]) + len(
        SWEEP_MIXED["mlp_datasets"]) and all(rows.values()),
          f"sweep --fault-report: a dataset has no robustness row: {rows}")
    check("## Robustness vs area" in open(pathlib.Path(out) /
                                          "REPORT.md").read(),
          "REPORT.md has no robustness table")
    for n in rows:
        if n == f"{MLP_RUNS[1][0]}_mlp":
            continue   # the card's campaign above; on the CPU too slow
        path = str(pathlib.Path(out) / n / "fault_report.json")
        card = robustness.load_fault_report(path)
        d = load_dataset(n.removesuffix("_mlp"))
        cpu = robustness.run_campaign(
            load_pareto_artifact(str(pathlib.Path(out) / n / "pareto.json")),
            quantize_u8(d.x_test), d.y_test, source=path, dataset=n,
            point="best", chunk=FAULT_WIDE_CHUNK, device="cpu")
        check(json.loads(json.dumps(cpu)) == {**card, "source": path},
              f"sweep --fault-report {n}: the card's report differs from "
              f"the CPU's")
    marks["sweep --fault-report"] = time.perf_counter()
    log(f"[faults] sweep --fault-report on the mixed campaign "
        f"{sorted(rows)}: {t_sweep:.1f} s with search, verify_rtl and the "
        f"report; robustness rows {json.dumps(rows)}; every report but "
        f"{MLP_RUNS[1][0]}_mlp's == the CPU's")
    check(all(counts[k] > 0 for k in (*TREE_KERNELS, "qmatmul",
                                      "fault_lanes")),
          f"a kernel of the fault path never launched: {counts}")
    steps, last = [], t_start
    for step, t in marks.items():
        steps.append(f"{step} {t - last:.1f} s")
        last = t
    log(f"[faults] launches of sweep --fault-report: {counts}; phase "
        f"{time.perf_counter() - t_start:.1f} s: {', '.join(steps)} (har "
        f"tree campaign {t_auto:.2f} s at the default chunk, {t_64:.2f} s "
        f"at --chunk {FAULT_CHUNK}; {name} mlp {t_mlp[None]:.2f} s at the "
        f"default chunk, {t_mlp[FAULT_WIDE_CHUNK]:.2f} s at chunk "
        f"{FAULT_WIDE_CHUNK}; har forest {t_forest:.2f} s)")
    return dict(counts=counts, row=row)


def attention_pairs(sq: int, skv: int) -> int:
    """(query, key) pairs a causal mask keeps: query i sees keys 0..i."""
    i = np.arange(sq)
    return int(np.minimum(i + 1, skv).sum())


def phase_flash(rng) -> dict:
    """`flash_attention` against its plain version on the card: the LM
    prefill's shape (llama3.2-3b at B=4, S=4096), zamba2-7b's (B=4,
    S=4096, H=Hkv=32, hd 112), grok-1-314b's (48 query / 8 kv heads,
    softcap 30) and kimi-k2-1t-a32b's (64 / 8) in the model's (B, S, H, hd)
    layout through `flash_attention_bshd`, then float32 (hd 64 and 112),
    grok's softcap at S=1024, gemma's MQA with head dim 256 and a ragged S
    in the (H, S, hd) layout; the four model shapes timed beside their
    bounds and, without a softcap, `scaled_dot_product_attention` (causal,
    GQA, the one PyTorch call that computes the same function; it has no
    softcap); and the device activities other than the kernel in the
    model's prefill attention. Returns the kernel line's rows of the
    llama, zamba2 and grok shapes."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.models import attention

    cfg = get_config(LM_ARCH)
    zcfg = get_config(SSM_ARCHS[1])
    gcfg, kcfg = (get_config(arch) for arch, _ in MOE_ARCHS)
    b, kv, g = LM_BATCH, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    rows_of = {"main": "flash_attention", "hd 112": FLASH_112,
               "grok": FLASH_SOFTCAP, "kimi": None}   # the model layouts
    cases = [  # (name, H, Hkv, S, hd, dtype, softcap)
        ("main", b * cfg.n_heads, b * kv, LM_PROMPT, cfg.head_dim,
         torch.bfloat16, 0.0),
        ("hd 112", b * zcfg.n_heads, b * zcfg.n_kv_heads, LM_PROMPT,
         zcfg.head_dim, torch.bfloat16, 0.0),
        ("grok", b * gcfg.n_heads, b * gcfg.n_kv_heads, LM_PROMPT,
         gcfg.head_dim, torch.bfloat16, gcfg.attn_softcap),
        ("kimi", b * kcfg.n_heads, b * kcfg.n_kv_heads, LM_PROMPT,
         kcfg.head_dim, torch.bfloat16, 0.0),
        ("float32", 8, 4, 512, 64, torch.float32, 0.0),
        ("float32 hd 112", 8, 8, 777, 112, torch.float32, 0.0),
        ("softcap 30", 48, 8, 1024, 128, torch.bfloat16, 30.0),
        ("MQA hd 256", 8, 1, 2048, 256, torch.bfloat16, 0.0),
        ("ragged", 24, 8, 1000, 128, torch.bfloat16, 0.0),
    ]
    err, rows = 0.0, {}
    for name, h, hkv, s, hd, dtype, cap in cases:
        model = name in rows_of
        if model:   # (B, S, heads, hd), as the model holds them
            q, k, v = (torch.as_tensor(rng.standard_normal(
                (b, s, n // b, hd), dtype=np.float32), device="cuda")
                .to(dtype) for n in (h, hkv, hkv))
            got = fa.flash_attention_bshd(q, k, v, softcap=cap)
            torch.cuda.synchronize()
            want = fa.flash_attention_bshd_plain(q, k, v, softcap=cap)
        else:
            q, k, v = (torch.as_tensor(rng.standard_normal(
                (n, s, hd), dtype=np.float32), device="cuda")
                .to(dtype) for n in (h, hkv, hkv))
            got = fa.flash_attention(q, k, v, group=h // hkv, softcap=cap)
            torch.cuda.synchronize()
            want = fa.flash_attention_plain(q, k, v, group=h // hkv,
                                            softcap=cap)
        e = float((got.float() - want.float()).abs().max())
        where = (f"flash_attention {name} H={h} Hkv={hkv} S={s} hd={hd} "
                 f"{str(dtype)[6:]} softcap={cap}")
        check(bool(torch.isfinite(got).all()), f"{where}: non-finite output")
        if dtype == torch.float32:
            check(torch.allclose(got, want, rtol=FLASH_F32_TOL,
                                 atol=FLASH_F32_TOL), f"{where} differs "
                  f"from its plain version by {e} (tol {FLASH_F32_TOL})")
            how = f"within {FLASH_F32_TOL} of the plain version"
        else:
            row_err = fa.row_error(got, want)
            check(row_err <= FLASH_BF16_ROW_TOL, f"{where}: row error "
                  f"{row_err} against its plain version (limit "
                  f"{FLASH_BF16_ROW_TOL})")
            late = float(want[:, s // 2:].float().abs().median())
            how = (f"row error {row_err:.4f} against the plain version "
                   f"(limit {FLASH_BF16_ROW_TOL}; median |out| in the second "
                   f"half of the rows {late:.4f})")
        err = max(err, e)
        log(f"[flash] {where}: {how}; largest difference {e:.3g}")
        if not model:
            continue
        del want
        ms, plain_ms, text = timed(
            lambda: fa.flash_attention_bshd(q, k, v, softcap=cap),
            lambda: fa.flash_attention_bshd_plain(q, k, v, softcap=cap),
            "flash_attn", reps=20, plain_reps=2)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)

        lib_ms, lib_text = None, "no library call (SDPA has no softcap)"
        if not cap:
            lib_ms, lib_how = device_or_stream_ms(sdpa, 20)
            lib_err = float((sdpa().transpose(1, 2).float() - got.float())
                            .abs().max())
            lib_text = (f"scaled_dot_product_attention {lib_ms:.4f} ms "
                        f"{lib_how} (differs from the kernel by "
                        f"{lib_err:.3g}; the kernel {ms / lib_ms:.2f}x SDPA)")
        n_ops = 4 * attention_pairs(s, s) * hd * h
        n_bytes = (2 * h + 2 * hkv) * s * hd * q.element_size()
        bms, by = bound(n_bytes, n_ops, BF16_OPS_PER_S)
        log(f"[flash] {name} shape, model layout, softcap {cap}: {text}; "
            f"{lib_text}; bound {bms:.4f} ms ({by}; {n_ops:.4g} FLOPs at 989 "
            f"TFLOP/s bf16, {n_bytes} bytes); kernel at "
            f"{n_ops / ms / 1e9:.1f} TFLOP/s, {ms / bms:.2f}x its bound")
        key = rows_of[name]
        if key is not None:
            rows[key] = dict(
                name=key, route="cuda",
                source=TPU_KERNELS["flash_attention"][0],
                replaces=TPU_KERNELS["flash_attention"][1], launches=0,
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)
        if name == "main":
            # what else the model's prefill attention runs on the card: the
            # kernel reads q, k, v and writes its output in the model's
            # layout
            qg = q.view(b, s, kv, g, hd)
            attention.chunked_prefill_attention(qg, k, v)
            torch.cuda.synchronize()
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                attention.chunked_prefill_attention(qg, k, v)
                torch.cuda.synchronize()
            others = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and "flash_attn" not in e.name]
            other_ms = sum(e.time_range.elapsed_us() for e in others) / 1e3
            log(f"[flash] device activities beside the kernel in one "
                f"chunked_prefill_attention at the main shape: {len(others)} "
                f"({other_ms:.4f} ms){': ' if others else ''}"
                f"{', '.join(sorted({e.name[:60] for e in others}))}")
            check(not others, "the model's prefill attention copies around "
                  "the kernel")
            del qg
        del q, k, v, got, qt, kt, vt
    for row in rows.values():
        row["max_abs_err"] = err
    log(f"[flash] the largest difference from the plain version over all "
        f"cases is {err:.3g}")
    return rows


class BwdCase(NamedTuple):
    """One check of `flash_attention_backward`: inputs (B, Sq, H, hd) and
    (B, Skv, Hkv, hd), unit normal, q scaled by ``q_scale``; ``row`` names
    the kernel line's row the case is timed for ("" timed without a row,
    None not timed)."""
    name: str
    b: int
    h: int
    hkv: int
    sq: int
    skv: int
    hd: int
    dtype: torch.dtype
    softcap: float = 0.0
    q_scale: float = 1.0
    row: str | None = None


def flash_bwd_cases() -> list:
    """The backward's checks, here and in `tests/test_torch_flash.py`'s card
    tests: llama3.2-3b's training shape (B=2, S=4096, 24 / 8 heads, hd
    128), zamba2-7b's hd 112, grok-1-314b's softcap 30 and kimi-k2's heads
    (B=1, a training microbatch); MQA at hd 256, ragged S, Sq != Skv both
    ways, one query, groups 1 to 8; softcap 5 on q scaled by 2.5, whose
    scores reach the cap (1 - tanh^2 down to ~0.1), in bf16 and float32;
    and, in bf16, the edges of the wgmma kernels' 128- and 64-row tiles."""
    from repro_torch.configs import get_config

    cfg, zcfg = get_config(LM_ARCH), get_config(SSM_ARCHS[1])
    gcfg, kcfg = (get_config(arch) for arch, _ in MOE_ARCHS)
    bf, f32 = torch.bfloat16, torch.float32
    s = TRAIN_SEQ

    def model(name, b, c, row, cap=0.0):
        return BwdCase(name, b, c.n_heads, c.n_kv_heads, s, s, c.head_dim,
                       bf, cap, row=row)

    return [
        model("llama train", TRAIN_BATCH, cfg, FLASH_BWD),
        model("zamba2 hd 112", TRAIN_BATCH, zcfg, FLASH_BWD_112),
        model("grok softcap", 1, gcfg, FLASH_BWD_SOFTCAP, gcfg.attn_softcap),
        model("kimi", 1, kcfg, ""),
        BwdCase("MQA hd 256", 1, 8, 1, 1024, 1024, 256, bf),
        BwdCase("ragged", 2, 24, 8, 1000, 1000, 128, bf),
        BwdCase("ragged hd 112", 1, 8, 8, 1000, 1000, 112, bf),
        BwdCase("group 3 hd 64", 3, 6, 2, 777, 777, 64, bf),
        BwdCase("softcap 30 hd 64", 2, 8, 8, 256, 256, 64, bf, 30.0),
        BwdCase("Sq < Skv", 2, 4, 2, 300, 900, 128, bf),
        BwdCase("Sq > Skv", 2, 4, 2, 900, 300, 128, bf),
        BwdCase("one query", 1, 4, 2, 1, 1, 128, bf),
        BwdCase("cap reached", 1, 8, 2, 512, 512, 64, bf, 5.0, 2.5),
        # the wgmma kernels' tile edges: one row past a 128-row tile, one
        # 64-row tile, the largest group at hd 64, and kv tiles of 128
        # keys that no query sees
        BwdCase("S 129", 1, 8, 2, 129, 129, 128, bf),
        BwdCase("S 64 hd 112", 2, 4, 4, 64, 64, 112, bf),
        BwdCase("group 8 hd 64", 1, 16, 2, 640, 640, 64, bf),
        BwdCase("Sq 200 < Skv 517", 1, 8, 2, 200, 517, 128, bf),
        BwdCase("float32", 1, 8, 4, 512, 512, 64, f32),
        BwdCase("float32 softcap 30", 2, 6, 2, 333, 333, 128, f32, 30.0),
        BwdCase("float32 hd 256 Sq < Skv", 1, 4, 1, 200, 517, 256, f32),
        BwdCase("float32 hd 112", 1, 4, 4, 130, 130, 112, f32),
        BwdCase("float32 cap reached", 1, 8, 2, 512, 512, 64, f32, 5.0, 2.5),
    ]


def flash_bwd_inputs(case: BwdCase, device):
    """(q, k, v, do) of ``case`` in its dtype on ``device``, from SEED."""
    rng = np.random.default_rng(SEED)

    def draw(s, n, scale=1.0):
        x = rng.standard_normal((case.b, s, n, case.hd), dtype=np.float32)
        return torch.as_tensor(x * np.float32(scale)).to(device, case.dtype)

    return (draw(case.sq, case.h, case.q_scale), draw(case.skv, case.hkv),
            draw(case.skv, case.hkv), draw(case.sq, case.h))


def flash_backward_ref(q, k, v, o, do, softcap: float, *,
                       bf16_operands: bool = False, fault: str = "none"):
    """(dq, dk, dv) by the backward's equations in float64, from model-layout
    tensors and the forward's output ``o`` as the kernel gets it (D =
    rowsum(do * o) reads the output in its dtype); with ``bf16_operands``, P
    and dS rounded to bf16 as the kernel rounds the operands of its
    products; with ``fault`` planted, "no_D" drops D and
    "no_cap_derivative" drops 1 - tanh^2(u / cap): what a check must
    tell from a sound kernel."""
    b, sq, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qf, kf, vf, dof = (t.double().permute(0, 2, 1, 3) for t in (q, k, v, do))
    kf, vf = kf.repeat_interleave(g, 1), vf.repeat_interleave(g, 1)
    u = qf @ kf.transpose(-1, -2) * hd ** -0.5
    sc = torch.tanh(u / softcap) * softcap if softcap else u
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(torch.where(mask, sc, -1e30), -1)
    o = o.double().permute(0, 2, 1, 3)

    def rnd(t):
        return t.to(torch.bfloat16).double() if bf16_operands else t

    d = 0.0 if fault == "no_D" else (dof * o).sum(-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - d)
    if softcap and fault != "no_cap_derivative":
        ds = ds * (1 - torch.tanh(u / softcap) ** 2)
    ds, p = rnd(ds * hd ** -0.5), rnd(p)

    def kv_heads(t):
        return t.reshape(b, hkv, g, skv, hd).sum(2).permute(0, 2, 1, 3)

    return ((ds @ kf).permute(0, 2, 1, 3), kv_heads(ds.transpose(-1, -2) @ qf),
            kv_heads(p.transpose(-1, -2) @ dof))


def check_flash_backward(case: BwdCase) -> dict:
    """Hold `flash_attention_backward` at ``case`` on the card: the forward
    with its log-sum-exp kept equal to the forward without, the log-sum-exp
    within FLASH_LSE_TOL of the plain one; dq, dk and dv finite, two calls
    bit-equal, each within its limit (float32 FLASH_BWD_F32_TOL, bf16
    FLASH_BF16_ROW_TOL) of `flash_attention_backward_plain` by `grad_error`;
    dk and dv exactly zero at keys past the last query (Skv > Sq);
    autograd through both wrappers giving the kernel's bits; and, where the
    scores reach the cap, each planted fault of `flash_backward_ref` reading
    at least FAULT_MARGIN limits on the same inputs. Returns the readings
    and the case's tensors (q, k, v, o, lse, do)."""
    from repro_torch.kernels import flash_attn as fa

    q, k, v, do = flash_bwd_inputs(case, "cuda")
    cap = case.softcap
    where = (f"flash_attention_backward {case.name} B={case.b} H={case.h} "
             f"Hkv={case.hkv} Sq={case.sq} Skv={case.skv} hd={case.hd} "
             f"{str(case.dtype)[6:]} softcap={cap}"
             + (f" q x {case.q_scale}" if case.q_scale != 1 else ""))
    o, lse = fa.flash_attention_forward(q, k, v, softcap=cap)
    check(torch.equal(o, fa.flash_attention_bshd(q, k, v, softcap=cap)),
          f"{where}: the forward with its log-sum-exp kept differs from the "
          f"forward without")
    lse_err = float((lse - fa.flash_attention_lse_plain(
        q, k, softcap=cap)).abs().max())
    check(lse_err <= FLASH_LSE_TOL, f"{where}: the log-sum-exp differs from "
          f"the plain one by {lse_err}")
    got = fa.flash_attention_backward(q, k, v, o, lse, do, softcap=cap)
    again = fa.flash_attention_backward(q, k, v, o, lse, do, softcap=cap)
    torch.cuda.synchronize()
    want = fa.flash_attention_backward_plain(q, k, v, o, lse, do,
                                             softcap=cap)
    limit = FLASH_BWD_F32_TOL if case.dtype == torch.float32 \
        else FLASH_BF16_ROW_TOL
    errs, max_abs = [], 0.0
    unseen = ""
    if case.skv > case.sq:   # keys past the last query: no query sees them
        rows = [float(g[:, case.sq:].abs().max()) for g in got[1:]]
        check(max(rows) == 0.0, f"{where}: dk, dv of the keys past the last "
              f"query reach {rows}, not zero")
        unseen = f"; dk, dv of the {case.skv - case.sq} unseen keys zero"
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        check(g.dtype == case.dtype and bool(torch.isfinite(g).all()),
              f"{where}: {name} is not finite {str(case.dtype)[6:]}")
        check(torch.equal(g, a), f"{where}: {name} differs between two calls")
        max_abs = max(max_abs, float((g.float() - w.float()).abs().max()))
        if name != "dv" and case.sq == 1:
            # one query sees one key: a softmax over one score has zero
            # gradient (dS = 0), so dq and dk are rounding alone
            errs.append(float(g.float().abs().max()))
            check(errs[-1] <= 1e-3, f"{where}: {name} of one query is "
                  f"{errs[-1]}, not ~0")
            continue
        errs.append(fa.grad_error(g, w))
        check(errs[-1] <= limit, f"{where}: {name} grad_error {errs[-1]} "
              f"against the plain backward (limit {limit})")
    text = ""
    if case.q_scale > 1:
        bf16 = case.dtype == torch.bfloat16
        sound = flash_backward_ref(q, k, v, o, do, cap, bf16_operands=bf16)
        text = "; the equations in float64 read " + ", ".join(
            f"{fa.grad_error(a, w):.3g}" for a, w in zip(sound, want))
        for fault in ("no_D", "no_cap_derivative"):
            bad = flash_backward_ref(q, k, v, o, do, cap, bf16_operands=bf16,
                                     fault=fault)
            reads = [fa.grad_error(a, w) for a, w in zip(bad[:2], want[:2])]
            check(min(reads) >= FAULT_MARGIN * limit, f"{where}: the planted "
                  f"fault {fault} reads only {reads} (limit {limit})")
            text += f"; {fault} reads dq {reads[0]:.3g} dk {reads[1]:.3g}"
        del sound, bad
    del want, again
    # through autograd: the Function's backward is the kernel, in the
    # model's layout and (one sequence) in the (H, S, hd) layout
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    fa.flash_attention_bshd(qg, kg, vg, softcap=cap).backward(do)
    for name, t, g in zip(("dq", "dk", "dv"), (qg, kg, vg), got):
        check(torch.equal(t.grad, g), f"{where}: autograd's {name} is not the "
              f"kernel's")
    if case.b == 1:
        qh, kh, vh = (t[0].transpose(0, 1).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        fa.flash_attention(qh, kh, vh, group=case.h // case.hkv,
                           softcap=cap).backward(do[0].transpose(0, 1))
        for name, t, g in zip(("dq", "dk", "dv"), (qh, kh, vh), got):
            check(torch.equal(t.grad, g[0].transpose(0, 1)), f"{where}: the "
                  f"(H, S, hd) wrapper's {name} is not the kernel's")
    del qg, kg, vg, got
    log(f"[flash] {where}: lse within {lse_err:.3g}; grad_error dq "
        f"{errs[0]:.4g}, dk {errs[1]:.4g}, dv {errs[2]:.4g} against the plain "
        f"backward (limit {limit}){text}{unseen}; two calls bit-equal; "
        f"autograd == the kernel")
    return dict(errs=errs, max_abs=max_abs, tensors=(q, k, v, o, lse, do))


def phase_flash_backward(timing: bool = True) -> dict:
    """`check_flash_backward` at every case of `flash_bwd_cases`; with
    ``timing``, the timed cases beside the plain backward, the bound (5/2
    of the forward's causal FLOPs at the bf16 tensor-core rate) and,
    without a softcap, the backward of `scaled_dot_product_attention`
    (causal, GQA; timed, never used). Returns the kernel line's rows."""
    from repro_torch.kernels import flash_attn as fa

    rows, err = {}, 0.0
    for case in flash_bwd_cases():
        res = check_flash_backward(case)
        err = max(err, res["max_abs"])
        q, k, v, o, lse, do = res.pop("tensors")
        if case.row is None or not timing:
            del q, k, v, o, lse, do
            continue
        b, h, hkv, s, hd, cap = (case.b, case.h, case.hkv, case.sq, case.hd,
                                 case.softcap)
        ms, plain_ms, text = timed(
            lambda: fa.flash_attention_backward(q, k, v, o, lse, do,
                                                softcap=cap),
            lambda: fa.flash_attention_backward_plain(q, k, v, o, lse, do,
                                                      softcap=cap),
            "flash_bwd", reps=10, plain_reps=1)
        lib_ms, lib_text = None, "no library call (SDPA has no softcap)"
        if not cap:
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                          for t in (q, k, v))
            out_t = torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)
            do_t = do.transpose(1, 2)

            def sdpa_backward():
                return torch.autograd.grad(out_t, (qt, kt, vt), do_t,
                                           retain_graph=True)

            lib_ms, lib_how = device_or_stream_ms(sdpa_backward, 10)
            lib_text = (f"scaled_dot_product_attention's backward "
                        f"{lib_ms:.4f} ms {lib_how} (the kernel "
                        f"{ms / lib_ms:.2f}x)")
            del qt, kt, vt, out_t, do_t
        n_ops = 10 * attention_pairs(s, s) * hd * h * b
        n_bytes = (4 * b * s * h * hd + 4 * b * s * hkv * hd) \
            * q.element_size() + 4 * b * h * s
        bms, by = bound(n_bytes, n_ops, BF16_OPS_PER_S)
        log(f"[flash] backward {case.name} shape: {text}; {lib_text}; bound "
            f"{bms:.4f} ms ({by}; {n_ops:.4g} FLOPs at 989 TFLOP/s bf16, "
            f"{n_bytes} bytes); kernel at {n_ops / ms / 1e9:.1f} TFLOP/s, "
            f"{ms / bms:.2f}x its bound")
        # by kernel: the dQ kernel (D too) forms S, dP and dS K, 3/2 of the
        # forward's causal FLOPs; the dK/dV kernel S^T, dP^T, P^T dO and
        # dS^T q, 2; on the tiles' width (hd 112 runs 128 columns)
        split = device_split_ms(
            lambda: fa.flash_attention_backward(q, k, v, o, lse, do,
                                                softcap=cap),
            10, ("flash_bwd_dq", "flash_bwd_dkv"))
        fwd = 4 * attention_pairs(s, s) * (128 if hd == 112 else hd) * h * b
        issued = {"flash_bwd_dq": 1.5 * fwd, "flash_bwd_dkv": 2 * fwd}
        log(f"[flash] backward {case.name} by kernel (device time, "
            f"profiler): " + "; ".join(
                f"{name} {t:.4f} ms, {issued[name] / max(t, 1e-9) / 1e9:.1f} "
                f"TFLOP/s issued ({issued[name] / fwd:g}x the forward's FLOPs)"
                for name, t in split.items())
            + f"; both issue {sum(issued.values()) / fwd:g}x the forward's "
            f"FLOPs where 5/2 are needed")
        if case.row:
            rows[case.row] = dict(
                name=case.row, route="cuda",
                source=TPU_KERNELS[FLASH_BWD][0],
                replaces=TPU_KERNELS[FLASH_BWD][1], launches=0,
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)
        del q, k, v, o, lse, do
        torch.cuda.empty_cache()
    for r in rows.values():
        r["max_abs_err"] = err
    log(f"[flash] the backward's largest difference from its plain version "
        f"over all cases is {err:.3g}")
    return rows


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def phase_lm() -> dict:
    """The LM serving path at llama3.2-3b width: random bf16 parameters and a
    B=4 x 4096-token prompt from the seed, greedy `generate` of 32 tokens,
    counted (one `flash_attention` launch per layer of the prefill); decode
    against a fresh prefill over the same tokens; a second `generate`
    giving the same tokens; prefill and decode times, peak memory and
    where one prefill's device time goes."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import attention, lm, transformer
    from repro_torch.runtime import lm_serve

    cfg = get_config(LM_ARCH)
    s_max = LM_PROMPT + LM_TOKENS
    t0 = time.perf_counter()
    params = transformer.init_params(SEED, cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=gen, device="cuda", dtype=torch.int32)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[lm] {LM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} query / {cfg.n_kv_heads} kv heads of {cfg.head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {n_params:,} parameters "
        f"in {cfg.dtype} ({time.perf_counter() - t0:.1f} s to draw); prompt "
        f"B={LM_BATCH} x {LM_PROMPT} tokens, {LM_TOKENS} new, s_max {s_max}")

    batch = {"tokens": prompt}
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = lm_serve.generate(params, cfg, batch, n_tokens=LM_TOKENS,
                            s_max=s_max)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(counts["flash_attention"] == cfg.n_layers,
          f"flash_attention launched {counts['flash_attention']} times in "
          f"one generate, not once per layer of the prefill ({cfg.n_layers})")
    check(tuple(out.shape) == (LM_BATCH, LM_TOKENS)
          and out.dtype == torch.int32, f"generate gave {tuple(out.shape)} "
          f"{out.dtype}")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          "generated tokens outside the vocabulary")
    log(f"[lm] generate: {t_gen * 1e3:.1f} ms for {LM_BATCH} x {LM_TOKENS} "
        f"tokens after the prompt; launches {counts}; peak memory "
        f"{peak / 2**30:.2f} GiB")

    # decode at position 4096 against a fresh prefill of the 4097 tokens
    logits_p, caches = lm.prefill(params, cfg, batch, s_max=s_max)
    check(torch.equal(logits_p[:, -1, :cfg.vocab_size].argmax(-1).int(),
                      out[:, 0]), "prefill's argmax is not generate's first "
          "token")
    logits_d, _ = lm.decode_step(params, cfg, out[:, :1], caches, LM_PROMPT)
    check(torch.equal(logits_d[:, -1, :cfg.vocab_size].argmax(-1).int(),
                      out[:, 1]), "decode's argmax is not generate's second "
          "token")
    longer = {"tokens": torch.cat([prompt, out[:, :1]], dim=1)}
    logits_f, _ = lm.prefill(params, cfg, longer)
    hold_rows(f"[lm] decode at position {LM_PROMPT} vs a fresh prefill of "
              f"{LM_PROMPT + 1} tokens (ragged: the kernel masks the edge)",
              [True] * LM_BATCH, logits_d[:, -1, :cfg.vocab_size].float(),
              logits_f[:, -1, :cfg.vocab_size].float())
    del caches, logits_p, logits_d, logits_f, longer

    again = lm_serve.generate(params, cfg, batch, n_tokens=LM_TOKENS,
                              s_max=s_max)
    check(torch.equal(out, again), "a second generate gave other tokens")
    log("[lm] a second generate gave identical tokens")

    t_prefill = host_ms(lambda: lm.prefill(params, cfg, batch, s_max=s_max))
    _, caches = lm.prefill(params, cfg, batch, s_max=s_max)
    tok = out[:, :1]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(LM_TOKENS - 1):
        lm.decode_step(params, cfg, tok, caches, LM_PROMPT + i)
    torch.cuda.synchronize()
    t_dec = (time.perf_counter() - t) * 1e3 / (LM_TOKENS - 1)
    decode_dev, decode_how = device_or_stream_ms(
        lambda: lm.decode_step(params, cfg, tok, caches, LM_PROMPT), 3)
    # one layer's decode attention over the whole s_max cache, and the
    # float32 cast of its k and v caches inside it
    k_l, v_l = caches["kv"][0][0], caches["kv"][1][0]
    qg = torch.zeros((LM_BATCH, 1, cfg.n_kv_heads,
                      cfg.n_heads // cfg.n_kv_heads, cfg.head_dim),
                     dtype=k_l.dtype, device="cuda")
    attn_dev, attn_how = device_or_stream_ms(
        lambda: attention.decode_attention(qg, k_l, v_l, LM_PROMPT + 1), 5)
    cast_dev, cast_how = device_or_stream_ms(
        lambda: (k_l.float(), v_l.float()), 5)
    prompt_rate = LM_BATCH * LM_PROMPT / t_prefill * 1e3
    log(f"[lm] prefill {t_prefill:.1f} ms ({prompt_rate:.0f} prompt "
        f"tokens/s); decode {t_dec:.2f} ms per step of "
        f"{LM_BATCH} tokens ({LM_BATCH / t_dec * 1e3:.1f} tokens/s), "
        f"{decode_dev:.2f} ms of it {decode_how}; per layer, decode "
        f"attention over the {s_max}-slot cache {attn_dev:.4f} ms "
        f"{attn_how}, of which the float32 cast of its k and v "
        f"{cast_dev:.4f} ms {cast_how} (x "
        f"{cfg.n_layers} layers: {attn_dev * cfg.n_layers:.2f} / "
        f"{cast_dev * cfg.n_layers:.2f} ms); generate "
        f"{LM_BATCH * LM_TOKENS / t_gen:.1f} new tokens/s end to end "
        f"(host clock)")
    del caches

    prefill_profile("[lm]", lambda: lm.prefill(params, cfg, batch,
                                                s_max=s_max), t_prefill)
    return dict(counts=counts)


TRAIN_STEPS = 4           # [train]: llama3.2-3b steps through train_loop
TRAIN_FIXED = 3           # then steps on one fixed batch: the loss falls
GROK_TRAIN = ("grok-1-314b", 1, 4, 2)   # arch, layers, batch, steps
# [train]: one float32 reduced step on the card against the CPU (head dim
# 64, so both attention kernels run): its loss and grad norm within
# TRAIN_RTOL, and every parameter's gradient (`train.loss_and_grads`)
# within TRAIN_GRAD_REL of the CPU gradient's largest magnitude in that
# leaf. Both sides are float32 throughout (TF32 off): only summation
# orders differ (cuBLAS and the kernels against MKL and the plain
# attention). The step's own parameters are not compared: AdamW's update is
# lr m / (sqrt(v) + 1e-8), so a gradient within a few 1e-8 of zero, where
# the sides' roundings differ by as much as the value, moves its update by
# up to ~lr (1.78e-4 measured on an H100 against a 4e-4 update), as much as
# an update left out would. So every parameter must move in the card's
# step, and the update itself is held given the same gradients: the CPU's,
# applied on each device from the same state, give parameters within
# TRAIN_ULPS float32 ulps of the larger of the new and the old value (p -
# lr upd can cancel) and moments within TRAIN_ULPS ulps of their value.
# Each element takes the same float32 operations on both sides; `pow` (the
# bias corrections) may differ by an ulp, which moves an update that
# outweighs its parameter by up to 6 ulps (bias corrections moved an ulp
# each way on the CPU); an update left out reads ~2.6e7 ulps. The clip is
# held by the grad norm above.
TRAIN_RTOL, TRAIN_GRAD_REL, TRAIN_ULPS = 1e-5, 1e-4, 8
ATTN_FWD_NAMES = ("flash_attn_tc_kernel", "flash_attn_kernel")


def _profile_split(fn, ranges=(), comm: bool = False):
    """(device ms by category, the device span of each named
    `record_function` range, busy ms, host ms, the eight largest device
    activities by name) of one ``fn()`` call, from a profiler trace:
    categories matmuls (cuBLAS), attention forward, attention backward and
    the rest, and with ``comm`` the collectives' device work (NCCL's
    kernels, or the host copies that stage gloo's). A range shows on the
    device as an annotation spanning its kernels, so it is read apart and
    not counted as busy time; so do the profiler's ``nccl:*`` annotations,
    which span NCCL's kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
    split = {"matmuls": 0.0, "attention forward": 0.0,
             "attention backward": 0.0, "rest": 0.0}
    if comm:
        split["collectives"] = 0.0
    by_name: dict[str, float] = {}
    in_range = dict.fromkeys(ranges, 0.0)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        if e.name in in_range:   # a range's span on the device, not a kernel
            in_range[e.name] += us / 1e3
            continue
        if e.name.startswith(NCCL_ANNOTATION):
            continue
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        if comm and any(n in e.name for n in COMM_NAMES):
            split["collectives"] += us
        elif "flash_bwd" in e.name:
            split["attention backward"] += us
        elif any(n in e.name for n in ATTN_FWD_NAMES):
            split["attention forward"] += us
        elif any(w in e.name.lower() for w in MATMUL_NAMES):
            split["matmuls"] += us
        else:
            split["rest"] += us
    split = {k: v / 1e3 for k, v in split.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return split, in_range, sum(split.values()), host, top


def train_breakdown(tag, cfg, state, opt, batch, steady_ms: float):
    """Where one training step's device time goes: a traced step whose
    optimizer update runs in a `record_function` range, beside the CE loss
    (`chunked_ce_loss` forward and backward, the table's gradient included,
    on the step's shapes) traced alone: matmuls, the attention forward and
    backward, the CE loss's own kernels (its matmuls counted under
    matmuls), the optimizer and the elementwise rest; the idle share
    against the untraced steady step's ``steady_ms``. Returns the state
    after the traced step."""
    from repro_torch import optim
    from repro_torch.models import lm
    from repro_torch.runtime import train

    def update(*args):
        with torch.profiler.record_function("optimizer.update"):
            return opt.update(*args)

    step_fn = train.make_train_step(
        cfg, optimizer=optim.Optimizer(opt.init, update, opt.name))
    holder = [state]

    def one_step():
        holder[0], _ = step_fn(holder[0], batch)

    split, ranges, busy, host, top = _profile_split(one_step,
                                                    ("optimizer.update",))
    tokens = batch["tokens"]
    table = state.params["embed" if cfg.tie_embeddings else "lm_head"]
    hidden = torch.randn((*tokens.shape, cfg.d_model), device="cuda",
                         dtype=table.dtype, requires_grad=True)
    mask = torch.ones_like(tokens)

    def ce():
        table.requires_grad_(True)
        loss, _ = lm.chunked_ce_loss(holder[0].params, cfg, hidden, tokens,
                                     mask)
        loss.backward()
        table.requires_grad_(False)
        table.grad = hidden.grad = None

    ce()
    ce_split, _, ce_busy, _, _ = _profile_split(ce)
    ce_own = ce_busy - ce_split["matmuls"]
    opt_ms = ranges["optimizer.update"]
    parts = {"matmuls": split["matmuls"],
             "attention forward": split["attention forward"],
             "attention backward": split["attention backward"],
             "CE loss (beside its matmuls)": ce_own,
             "optimizer": opt_ms,
             "elementwise rest": split["rest"] - ce_own - opt_ms}
    log(f"{tag} one traced step's device time {busy:.1f} ms in {host:.1f} "
        f"ms on the host clock (idle share {1 - busy / host:.3f}; the "
        f"untraced steady step {steady_ms:.1f} ms): "
        + ", ".join(f"{k} {v:.1f} ms ({v / busy:.1%})"
                    for k, v in parts.items())
        + f"; the CE loss alone {ce_busy:.1f} ms of device time, "
        f"{ce_split['matmuls']:.1f} of it matmuls")
    log(f"{tag} largest device activities of the step: " + "; ".join(
        f"{n[:70]} {us / 1e3:.2f} ms" for n, us in top))
    del hidden
    return holder[0]


def _ulps(got, want, before=None) -> float:
    """The largest difference of ``got`` from ``want`` in float32 ulps of
    ``want`` (of the larger of ``want`` and ``before`` when given)."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    mag = np.abs(w) if before is None else np.maximum(
        np.abs(w), np.abs(before.cpu().numpy()))
    return float((np.abs(g - w) / np.spacing(mag.astype(np.float32))).max())


def reduced_step_check(device: str = "cuda") -> dict:
    """One step of a float32 reduced llama3.2-3b (head dim 64, so both
    attention kernels run) on ``device`` against the same step on the CPU:
    the loss and grad norm within TRAIN_RTOL, every gradient within
    TRAIN_GRAD_REL of its leaf's scale, every parameter moved by the step;
    then the CPU's gradients applied by the optimizer on each device from
    the same state, parameters and moments within TRAIN_ULPS ulps. Returns
    the readings."""
    from repro_torch import pytree
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import train as launch_train
    from repro_torch.runtime import train

    cfg = reduced_config(get_config(LM_ARCH), head_dim=64)
    data = SyntheticLMData(cfg.vocab_size, 128, 4, seed=0)
    steps, start = 20, 12

    def state_on(dev):
        state = launch_train.build(cfg, steps=steps, device="cpu")[0]
        return train.TrainState(
            pytree.tree_map(lambda t: t.to(dev), state.params),
            pytree.tree_map(lambda t: t.to(dev), state.opt_state),
            torch.full((), start, dtype=torch.int32, device=dev))

    step_fn = train.make_train_step(
        cfg, optimizer=launch_train.optimizer_for(cfg, steps))
    metrics, grads = {}, {}
    for dev in ("cpu", device):
        state = state_on(dev)
        before = [t.clone() for t in pytree.leaves(state.params)]
        batch = launch_train.device_batch(data, 0, cfg, 4, dev)
        grads[dev] = train.loss_and_grads(cfg, state.params, batch)[2]
        metrics[dev] = step_fn(state, batch)[1]
        for (path, t), b in zip(pytree.leaves_with_paths(state.params),
                                before):
            check(not torch.equal(t, b), f"[train] reduced float32 step on "
                  f"{dev}: {pytree.path_str(path)} did not move")
        del before
    worst = 0.0
    for key in ("loss", "grad_norm"):
        a, b = float(metrics["cpu"][key]), float(metrics[device][key])
        worst = max(worst, abs(a - b) / abs(a))
        check(abs(a - b) <= TRAIN_RTOL * abs(a), f"[train] reduced float32 "
              f"step: {key} {b} on the card, {a} on the CPU")
    rel = 0.0
    for (path, a), b in zip(pytree.leaves_with_paths(grads["cpu"]),
                            pytree.leaves(grads[device])):
        err = float((a - b.cpu()).abs().max()) / max(
            float(a.abs().max()), 1e-30)
        rel = max(rel, err)
        check(err <= TRAIN_GRAD_REL, f"[train] reduced float32 step: the "
              f"gradient of {pytree.path_str(path)} on the card differs "
              f"from the CPU's by {err} of its scale")
    opt = launch_train.optimizer_for(cfg, steps)
    updated = {}
    for dev in ("cpu", device):
        state = state_on(dev)
        before = pytree.tree_map(lambda t: t.clone(), state.params)
        g = pytree.tree_map(lambda t: t.to(dev, copy=True), grads["cpu"])
        updated[dev] = opt.update(g, state.opt_state, state.params,
                                  state.step)
    p_ulps = max(_ulps(b, a, w) for (_, a), b, w in zip(
        pytree.leaves_with_paths(updated["cpu"][0]),
        pytree.leaves(updated[device][0]), pytree.leaves(before)))
    s_ulps = max(_ulps(b, a) for a, b in zip(pytree.leaves(updated["cpu"][1]),
                                            pytree.leaves(updated[device][1])))
    check(max(p_ulps, s_ulps) <= TRAIN_ULPS, f"[train] reduced float32 "
          f"step: {opt.name} given the CPU's gradients gives parameters "
          f"within {p_ulps} ulps and moments within {s_ulps} ulps of the "
          f"CPU's on the card, not {TRAIN_ULPS}")
    log(f"[train] reduced float32 llama3.2-3b (hd 64, {cfg.n_layers} layers) "
        f"one step on the card == the CPU's: loss and grad norm within "
        f"{worst:.3g} (rtol {TRAIN_RTOL}), every gradient within {rel:.3g} "
        f"of its leaf's scale (limit {TRAIN_GRAD_REL}), every parameter "
        f"moved; {opt.name} on the CPU's gradients: parameters within "
        f"{p_ulps:.3g} ulps, moments within {s_ulps:.3g} ulps of the CPU's "
        f"(limit {TRAIN_ULPS})")
    return dict(worst=worst, rel=rel, p_ulps=p_ulps, s_ulps=s_ulps)


def reduced_train_checks(tmp: str, device: str = "cuda") -> None:
    """`reduced_step_check` on ``device``; then six checkpointed steps of
    the same reduced config, and a fresh state resumed from the save after
    step 2 equal to them bit for bit."""
    from repro_torch import pytree
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import train as launch_train
    from repro_torch.runtime import checkpoint, train

    reduced_step_check(device)
    cfg = reduced_config(get_config(LM_ARCH), head_dim=64)
    data = SyntheticLMData(cfg.vocab_size, 128, 4, seed=0)

    def run(start_state, start, steps, ckpt_dir=None):
        step_fn = train.make_train_step(
            cfg, optimizer=launch_train.optimizer_for(cfg, steps))
        state, _ = launch_train.train_loop(
            start_state, step_fn, data, cfg, start=start, steps=steps,
            batch=4, device=device, ckpt_dir=ckpt_dir, ckpt_every=2,
            log=lambda m: None)
        return state

    full = run(launch_train.build(cfg, steps=6, device=device)[0], 0, 6,
               tmp)
    fresh = launch_train.build(cfg, steps=6, device=device)[0]
    fresh, label = checkpoint.restore_tree(tmp, 2, fresh)
    resumed = run(fresh, int(fresh.step), 6)
    same = all(torch.equal(a, b) for a, b in zip(pytree.leaves(full),
                                                 pytree.leaves(resumed)))
    check(same, "[train] a run resumed from its step-2 checkpoint differs "
          "from the uninterrupted run")
    log(f"[train] reduced float32 run of 6 steps resumed on the card from "
        f"its checkpoint {label} (state step {int(fresh.step)} on restore) "
        f"== the uninterrupted run, every parameter, moment and the step bit "
        f"for bit")


def card_step_analysis(step_fn, state, batch) -> dict:
    """`[dryrun]` (a)'s card side: one more `[train]` step under
    `launch.step_analysis.analyze`, with `torch.cuda.max_memory_allocated`
    around it (the state's tensors are updated in place, as a step
    does)."""
    from repro_torch.launch import step_analysis

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    got = step_analysis.analyze(step_fn, state, batch)
    torch.cuda.synchronize()
    got["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return got


def phase_train() -> dict:
    """LM training through `launch.train`'s code path on the card:
    llama3.2-3b at full width and depth, B=2 x 4096 from `SyntheticLMData`,
    AdamW on the launcher's warmup-cosine schedule, TRAIN_STEPS steps
    through `train_loop`, counted (`flash_attention` twice a layer a step
    under remat, `flash_attention_backward` once), then TRAIN_FIXED steps on
    one fixed batch whose loss must fall, step time, tokens/s, peak memory
    and the step's device time split; the reduced float32 checks
    (`reduced_train_checks`); then grok-1-314b cut to 1 layer, B=4 x 4096
    with its grad_accum 4 in bf16 and Adafactor, counted the same way."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import train as launch_train

    counts = dict.fromkeys(kernels.launch_counts(), 0)
    by_arch, dry_card = {}, None
    for arch, layers, batch, steps in ((LM_ARCH, None, TRAIN_BATCH,
                                        TRAIN_STEPS), GROK_TRAIN):
        cfg = launch_train.model_config(arch, layers=layers)
        t0 = time.perf_counter()
        state, step_fn = launch_train.build(cfg, steps=steps, device="cuda",
                                            seed=SEED)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in _leaves(state.params))
        tag = f"[train] {arch}"
        log(f"{tag}: {cfg.n_layers} of {get_config(arch).n_layers} layers, "
            f"d_model {cfg.d_model}, {n_params:,} parameters in {cfg.dtype}, "
            f"{cfg.optimizer}, grad_accum {cfg.grad_accum} in "
            f"{cfg.grad_accum_dtype}, remat {cfg.remat}, loss_chunk "
            f"{cfg.loss_chunk}; batch {batch} x {TRAIN_SEQ} "
            f"({time.perf_counter() - t0:.1f} s to draw)")
        data = SyntheticLMData(cfg.vocab_size, TRAIN_SEQ, batch, seed=0)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        marks, losses, gnorms = [time.perf_counter()], [], []

        def on_step(step, metrics):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            losses.append(float(metrics["loss"]))
            gnorms.append(float(metrics["grad_norm"]))

        state, _ = launch_train.train_loop(
            state, step_fn, data, cfg, start=0, steps=steps, batch=batch,
            device="cuda", log=lambda m: log(f"{tag} {m}"), on_step=on_step)
        got = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        for name, n in got.items():
            counts[name] += n
        by_arch[arch] = got
        per = cfg.n_layers * max(cfg.grad_accum, 1) * steps
        check(got["flash_attention"] == 2 * per and got[FLASH_BWD] == per,
              f"{tag}: {got['flash_attention']} forward and {got[FLASH_BWD]} "
              f"backward attention launches in {steps} steps, not "
              f"{2 * per} and {per} (twice and once a layer a microbatch)")
        check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
              f"{tag}: losses {losses}, grad norms {gnorms}")
        step_s = np.diff(marks)
        steady = float(np.median(step_s[1:])) if len(step_s) > 1 \
            else float(step_s[0])
        log(f"{tag}: {steps} steps, losses {[round(x, 4) for x in losses]}, "
            f"grad norms {[round(x, 4) for x in gnorms]}; step time "
            f"{[round(float(x) * 1e3, 1) for x in step_s]} ms on the host "
            f"clock "
            f"(synchronised; the first with warm-up), steady {steady * 1e3:.1f}"
            f" ms = {batch * TRAIN_SEQ / steady:.0f} tokens/s; launches "
            f"{got}; peak memory {peak / 2**30:.2f} GiB")

        batch_t = launch_train.device_batch(data, 0, cfg, batch, "cuda")
        if arch == LM_ARCH:
            fixed = []
            for _ in range(TRAIN_FIXED):
                state, m = step_fn(state, batch_t)
                fixed.append(float(m["loss"]))
            check(fixed[-1] < fixed[0], f"{tag}: the loss on one fixed "
                  f"batch did not fall over {TRAIN_FIXED} steps: {fixed}")
            log(f"{tag}: {TRAIN_FIXED} more steps on one fixed batch: "
                f"losses {[round(x, 4) for x in fixed]}, falling")
            dry_card = card_step_analysis(step_fn, state, batch_t)
        state = train_breakdown(tag, cfg, state,
                                launch_train.optimizer_for(cfg, steps),
                                batch_t, steady * 1e3)
        del state, step_fn, batch_t
        torch.cuda.empty_cache()
        if arch == LM_ARCH:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as d:
                reduced_train_checks(d)
    return dict(counts=counts, by_arch=by_arch, dryrun_card=dry_card)


def phase_ssm(arch: str) -> dict:
    """The SSM / hybrid serving path at ``arch``'s full width: random bf16
    parameters and the [lm] phase's B=4 x 4096-token prompt from the seed,
    greedy `generate` of 32 tokens, counted (zamba2-7b: one
    `flash_attention` launch, at head dim 112, per super-block of the
    prefill; mamba2-1.3b runs no kernel of the TPU's). The SSD takes a
    prompt longer than its chunk only in whole chunks, so no prefill of
    P + 1 tokens exists past one chunk: decode at position P right after a
    prefill of P tokens is held to position P of one causal forward over
    the whole prompt, at P = 255 and 3840 (`decode_vs_prefill`); the decode
    step after the prompt must pick `generate`'s second token, a second
    `generate` the same tokens; then prefill and decode times, peak memory
    and where one prefill's device time goes."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import lm, transformer
    from repro_torch.runtime import lm_serve

    cfg = get_config(arch)
    tag = f"[ssm {arch}]"
    s_max = LM_PROMPT + LM_TOKENS
    n_super = (transformer.hybrid_layout(cfg)[0] if cfg.family == "hybrid"
               else 0)
    t0 = time.perf_counter()
    params = transformer.init_params(SEED, cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=gen, device="cuda", dtype=torch.int32)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"{tag} {cfg.family}: {cfg.n_layers} mamba2 layers, d_model "
        f"{cfg.d_model}, d_inner {cfg.d_inner}, {cfg.ssm_nheads} SSD heads "
        f"of {cfg.ssm_head_dim}, state {cfg.ssm_state}"
        + (f", {n_super} super-blocks of {cfg.shared_attn_every} + tail "
           f"{transformer.hybrid_layout(cfg)[2]}, {cfg.n_shared_blocks} "
           f"shared attention blocks ({cfg.n_heads} heads of "
           f"{cfg.head_dim}, d_ff {cfg.d_ff})" if n_super else "")
        + f", vocab {cfg.vocab_size}, {n_params:,} parameters in "
        f"{cfg.dtype} ({time.perf_counter() - t0:.1f} s to draw); prompt "
        f"B={LM_BATCH} x {LM_PROMPT} tokens, {LM_TOKENS} new, s_max {s_max}")

    batch = {"tokens": prompt}
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = lm_serve.generate(params, cfg, batch, n_tokens=LM_TOKENS,
                            s_max=s_max)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(counts["flash_attention"] == n_super,
          f"{arch}: flash_attention launched {counts['flash_attention']} "
          f"times in one generate, not once per super-block of the prefill "
          f"({n_super})")
    check(tuple(out.shape) == (LM_BATCH, LM_TOKENS)
          and out.dtype == torch.int32, f"generate gave {tuple(out.shape)} "
          f"{out.dtype}")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          "generated tokens outside the vocabulary")
    log(f"{tag} generate: {t_gen * 1e3:.1f} ms for {LM_BATCH} x "
        f"{LM_TOKENS} tokens after the prompt; launches {counts}; peak "
        f"memory {peak / 2**30:.2f} GiB")

    logits_f, caches = lm.prefill(params, cfg, batch, s_max=s_max)
    check(torch.equal(logits_f[:, -1, :cfg.vocab_size].argmax(-1).int(),
                      out[:, 0]), "prefill's argmax is not generate's first "
          "token")
    logits_n, _ = lm.decode_step(params, cfg, out[:, :1], caches, LM_PROMPT)
    check(torch.equal(logits_n[:, -1, :cfg.vocab_size].argmax(-1).int(),
                      out[:, 1]), "decode's argmax is not generate's second "
          "token")
    del caches, logits_n
    # decode at position P right after a prefill of P tokens vs position P
    # of one causal forward over the whole prompt (the logits of a fresh
    # prefill of P + 1 tokens, which the SSD refuses past one chunk): P =
    # 255, inside the first chunk, and 3840, after 15 whole chunks
    hidden, _, _ = transformer.forward(params, cfg, prompt)
    for p in (SSD_CHUNK - 1, LM_PROMPT - SSD_CHUNK):
        _, caches = lm.prefill(params, cfg, {"tokens": prompt[:, :p]},
                               s_max=s_max)
        logits_d, _ = lm.decode_step(params, cfg, prompt[:, p:p + 1],
                                     caches, p)
        fresh = transformer.logits_from_hidden(params, cfg,
                                               hidden[:, p:p + 1])
        decode_vs_prefill(
            f"{tag} decode at position {p} after a prefill of {p} vs "
            f"position {p} of a forward over the prompt",
            logits_d[:, -1, :cfg.vocab_size].float(),
            fresh[:, -1, :cfg.vocab_size].float())
        del caches, logits_d, fresh
    del hidden, logits_f

    again = lm_serve.generate(params, cfg, batch, n_tokens=LM_TOKENS,
                              s_max=s_max)
    check(torch.equal(out, again), "a second generate gave other tokens")
    log(f"{tag} a second generate gave identical tokens")

    t_prefill = host_ms(lambda: lm.prefill(params, cfg, batch, s_max=s_max))
    _, caches = lm.prefill(params, cfg, batch, s_max=s_max)
    tok = out[:, :1]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(LM_TOKENS - 1):
        lm.decode_step(params, cfg, tok, caches, LM_PROMPT + i)
    torch.cuda.synchronize()
    t_dec = (time.perf_counter() - t) * 1e3 / (LM_TOKENS - 1)
    decode_dev, decode_how = device_or_stream_ms(
        lambda: lm.decode_step(params, cfg, tok, caches, LM_PROMPT), 3)
    log(f"{tag} prefill {t_prefill:.1f} ms "
        f"({LM_BATCH * LM_PROMPT / t_prefill * 1e3:.0f} prompt tokens/s); "
        f"decode {t_dec:.2f} ms per step of {LM_BATCH} tokens "
        f"({LM_BATCH / t_dec * 1e3:.1f} tokens/s), {decode_dev:.2f} ms of "
        f"it {decode_how}; generate {LM_BATCH * LM_TOKENS / t_gen:.1f} new "
        f"tokens/s end to end (host clock)")
    del caches
    prefill_profile(tag, lambda: lm.prefill(params, cfg, batch, s_max=s_max),
                    t_prefill)
    del params
    torch.cuda.empty_cache()
    return dict(counts=counts)


def decode_vs_prefill(what: str, ld: torch.Tensor, lf: torch.Tensor) -> None:
    """Hold decode's logits ``ld`` (B, V) to a fresh prefill's ``lf`` within
    SSM_LOGIT_RTOL of the prefill's largest logit; the argmax must agree in
    every row whose top-2 gap exceeds twice that row's difference (a
    closer pair is within the rounding spread)."""
    check(bool(torch.isfinite(ld).all() and torch.isfinite(lf).all()),
          f"{what}: non-finite logits")
    row_diff = (ld - lf).abs().amax(-1)
    diff = float(row_diff.max())
    scale = float(lf.abs().max())
    top2 = lf.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    same = ld.argmax(-1) == lf.argmax(-1)
    decided = gap > 2 * row_diff
    log(f"{what}: largest logit difference {diff:.4f}, {diff / scale:.4f} "
        f"of the largest logit {scale:.3f} (limit {SSM_LOGIT_RTOL}; by row "
        f"{[round(x, 4) for x in row_diff.tolist()]}); same argmax in rows "
        f"{same.tolist()}; top-2 gaps {[round(x, 4) for x in gap.tolist()]}")
    check(diff <= SSM_LOGIT_RTOL * scale, f"{what}: decode logits differ "
          f"from a fresh prefill's by {diff} ({diff / scale} of the largest)")
    check(bool(same[decided].all()), f"{what}: decode and prefill pick "
          f"other tokens in a row whose top-2 gap exceeds twice its "
          f"difference")


def prefill_profile(tag: str, prefill, t_prefill: float) -> None:
    """Print where one ``prefill()``'s device time goes (a profiler trace
    after a warm-up call): the attention kernel, matmuls (cuBLAS) and the
    rest, the idle share against its host-clock ``t_prefill`` ms, and the
    largest device activities by name."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prefill()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        prefill()
        torch.cuda.synchronize()
    split = {"attention kernel": 0.0, "matmuls": 0.0, "rest": 0.0}
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        if "flash_attn" in e.name:
            split["attention kernel"] += us
        elif any(w in e.name.lower() for w in MATMUL_NAMES):
            split["matmuls"] += us
        else:
            split["rest"] += us
    busy = sum(split.values()) / 1e3
    if busy == 0:
        log(f"{tag} the profiler saw no device activity in one prefill: no "
            f"split")
        return
    log(f"{tag} one prefill's device time {busy:.1f} ms (host clock "
        f"{t_prefill:.1f} ms, idle share {1 - busy / t_prefill:.3f}): "
        + ", ".join(f"{k} {v / 1e3:.1f} ms ({v / 1e3 / busy:.1%})"
                    for k, v in split.items()))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"{tag} largest device activities of one prefill: " + "; ".join(
        f"{n[:70]} {us / 1e3:.2f} ms" for n, us in top))


def moe_routes(fn):
    """``fn()`` with the port's `moe._route` and `moe._dispatch` wrapped:
    returns (its result, a record a MoE layer of the call: the router
    logits (T, E), the picks (T, k) and whether each pick was kept, (T, k)
    in pick order)."""
    from repro_torch.models import moe

    route, dispatch = moe._route, moe._dispatch
    calls: list[dict] = []

    def route_rec(router, cfg, xf):
        gates, eids, aux = route(router, cfg, xf)
        calls.append({"logits": xf.to(torch.float32) @ router, "eids": eids})
        return gates, eids, aux

    def dispatch_rec(cfg, xf, eids, capacity):
        out = dispatch(cfg, xf, eids, capacity)
        kept = torch.empty_like(out[1])
        kept[torch.argsort(eids.reshape(-1), stable=True)] = out[1]
        calls[-1]["kept"] = kept.view(eids.shape)
        return out

    moe._route, moe._dispatch = route_rec, dispatch_rec
    try:
        return fn(), calls
    finally:
        moe._route, moe._dispatch = route, dispatch


def moe_rows_held(tag: str, dec: list, pf: list, rows: torch.Tensor):
    """Which batch rows routed alike in decode (records ``dec``, one token
    a row) and in a fresh prefill (records ``pf``; ``rows`` are the
    compared tokens' flat indices): in every layer the same experts picked
    and the same kept. Logs every other row with the first layer where it
    parted (the layers after it see other inputs): a flipped pick, which
    must be a near-tie (its prefill router-logit gap within the two sides'
    difference of those logits), or a pick dropped on one side alone.
    Returns one bool a row."""
    layers = [tuple(t.cpu() for t in (d["logits"], f["logits"][rows],
                                       d["eids"], f["eids"][rows],
                                       d["kept"], f["kept"][rows]))
              for d, f in zip(dec, pf)]
    held = [True] * len(rows)
    for r in range(len(rows)):
        for layer, (ld, lf, ed, ef, kd, kf) in enumerate(layers):
            sd, sf = set(ed[r].tolist()), set(ef[r].tolist())
            diff = (ld[r] - lf[r]).abs()
            if sd != sf:
                # expert a picked by the prefill alone, c by decode alone:
                # decode put c above a, the prefill a above c, so a's lead
                # in the prefill is at most the two logits' differences
                pairs = [(float(lf[r, a] - lf[r, c]), float(diff[a] + diff[c]))
                         for a in sf - sd for c in sd - sf]
                gap, room = max(pairs, key=lambda gr: gr[0] - gr[1])
                log(f"{tag} row {r} not held: layer {layer} picks "
                    f"{sorted(sd)} in decode, {sorted(sf)} in the prefill; "
                    f"router-logit gap {gap:.3g} in the prefill, the sides' "
                    f"difference of those logits {room:.3g} (largest in the "
                    f"layer {float(diff.max()):.3g})")
                check(gap <= room, f"{tag} row {r} layer {layer}: a flipped "
                      f"pick that is no near-tie")
                held[r] = False
                break
            kept_d = {e for e, k in zip(ed[r].tolist(), kd[r].tolist()) if k}
            kept_f = {e for e, k in zip(ef[r].tolist(), kf[r].tolist()) if k}
            if kept_d != kept_f:
                log(f"{tag} row {r} not held: layer {layer} picks "
                    f"{sorted(sd)}; dropped in decode {sorted(sd - kept_d)}, "
                    f"in the prefill {sorted(sf - kept_f)}")
                held[r] = False
                break
    return held


def hold_rows(what: str, held: list, ld: torch.Tensor,
              lf: torch.Tensor) -> None:
    """Hold decode's logits ``ld`` (B, V) to a fresh prefill's ``lf`` on
    the ``held`` rows (`[lm]`: every row): within LM_LOGIT_ATOL and the
    same argmax; every row's difference is logged."""
    check(bool(torch.isfinite(ld).all() and torch.isfinite(lf).all()),
          f"{what}: non-finite logits")
    row_diff = (ld - lf).abs().amax(-1)
    top2 = lf.topk(2, dim=-1).values
    same = ld.argmax(-1) == lf.argmax(-1)
    log(f"{what}: rows held {held}; largest "
        f"logit difference by row {[round(x, 4) for x in row_diff.tolist()]}"
        f" (atol {LM_LOGIT_ATOL} on the held rows; logits up to "
        f"{float(lf.abs().max()):.3f}); same argmax {same.tolist()}; top-2 "
        f"gaps {[round(x, 4) for x in (top2[:, 0] - top2[:, 1]).tolist()]}")
    sel = torch.tensor(held, device=ld.device)
    if not any(held):
        return
    diff = float(row_diff[sel].max())
    check(diff <= LM_LOGIT_ATOL, f"{what}: decode logits differ from the "
          f"prefill's by {diff} on a held row (atol {LM_LOGIT_ATOL})")
    check(bool(same[sel].all()), f"{what}: decode and prefill pick other "
          f"tokens on a held row")


def last_token_as_batch(fn):
    """``fn()`` with every `moe.moe_block` call's last position run again
    as one batch of its own (B tokens: the capacity and drops a decode
    step gives them) and put in place of that position's output. The last
    position feeds no other, so the rest of the call is as served."""
    from repro_torch.models import moe

    block = moe.moe_block

    def block_last(p, cfg, x):
        y, aux = block(p, cfg, x)
        y[:, -1:] = block(p, cfg, x[:, -1:])[0]
        return y, aux

    moe.moe_block = block_last
    try:
        return fn()
    finally:
        moe.moe_block = block


def moe_split(tag: str, cfg, params, b: int, s: int) -> None:
    """Device time of one MoE layer's pieces at the prefill's shape (random
    bf16 activations from the seed, layer 0's weights): the route, the
    dispatch, the experts' three products and the combine, each alone
    from a profiler trace, and x the layers."""
    from repro_torch.models import moe

    p = {k: v[0] for k, v in params["layers"]["ffn"].items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    xf = torch.randn((b * s, cfg.d_model), generator=gen, device="cuda",
                     dtype=torch.float32).to(torch.bfloat16)
    cap = moe._capacity(cfg, b * s)
    gates, eids, _ = moe._route(p["router"], cfg, xf)
    buf, keep, slot, _ = moe._dispatch(cfg, xf, eids, cap)
    out_buf = moe._expert_ffn(cfg, buf, p["wi"], p.get("wg"), p["wo"])
    pieces = {
        "route": lambda: moe._route(p["router"], cfg, xf),
        "dispatch": lambda: moe._dispatch(cfg, xf, eids, cap),
        "expert FFN": lambda: moe._expert_ffn(cfg, buf, p["wi"], p.get("wg"),
                                              p["wo"]),
        "combine": lambda: moe._combine(out_buf, gates, eids, keep, slot),
    }
    times = {}
    for name, fn in pieces.items():
        times[name], how = device_or_stream_ms(fn, 2)
    mults = 3 if p.get("wg") is not None else 2
    flops = 2 * cfg.n_experts * cap * cfg.d_model * cfg.moe_d_ff * mults
    log(f"{tag} one MoE layer at the prefill's shape (T={b * s}, capacity "
        f"{cap}, {how}): " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in times.items())
        + f"; x {cfg.n_layers} layers {sum(times.values()) * cfg.n_layers:.1f}"
        f" ms; the experts' products {flops:.4g} FLOPs a layer, "
        f"{flops / times['expert FFN'] / 1e9:.1f} TFLOP/s")


def phase_moe(arch: str, n_layers: int) -> dict:
    """The MoE serving path at ``arch``'s published width, cut to
    ``n_layers`` layers: random bf16 parameters and the [lm] phase's B=4 x
    4096-token prompt from the seed, greedy `generate` of 32 tokens,
    counted (one `flash_attention` launch per layer of the prefill; grok
    with its softcap 30); the prefill's and decode's argmax against
    `generate`'s first two tokens; a second `generate` identical; one
    `moe_block` call at the prefill's and at decode's shape under sync
    debug mode "error"; decode at position 4096 against a fresh prefill of
    the 4097 tokens, (a) as served and (b) with the last tokens' MoE run as
    the decode step runs it, one batch of B (`last_token_as_batch`), on the
    rows that routed alike in every layer on both sides (`moe_routes`,
    `moe_rows_held`: routing flips at near-ties and capacity drops are the
    design's, so they are logged, not held), at least one row held in (b);
    then prefill and decode times, peak memory, one prefill's device time
    split and the MoE layer's pieces."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import lm, moe, transformer
    from repro_torch.runtime import lm_serve

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=n_layers)
    tag = f"[moe {arch}]"
    s_max = LM_PROMPT + LM_TOKENS
    t0 = time.perf_counter()
    params = transformer.init_params(SEED, cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=gen, device="cuda", dtype=torch.int32)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    leaves = list(_leaves(params))
    n_params = sum(t.numel() for t in leaves)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    t_prompt = LM_BATCH * LM_PROMPT
    log(f"{tag} reduced: n_layers {n_layers} of {full.n_layers}, every other "
        f"field as published; {n_params:,} parameters, {n_bytes / 1e9:.2f} GB "
        f"of weights ({n_bytes / 2**30:.2f} GiB; {t_init:.1f} s to draw)")
    log(f"{tag} d_model {cfg.d_model}, {cfg.n_heads} query / {cfg.n_kv_heads} "
        f"kv heads of {cfg.head_dim}, softcap {cfg.attn_softcap}, "
        f"{cfg.n_experts} {cfg.act} experts of d_ff {cfg.moe_d_ff}, top "
        f"{cfg.experts_per_token}, capacity factor {cfg.capacity_factor} "
        f"(capacity {moe._capacity(cfg, t_prompt)} a prefill of {t_prompt} "
        f"tokens, {moe._capacity(cfg, LM_BATCH)} a decode step), vocab "
        f"{cfg.vocab_size}; prompt B={LM_BATCH} x {LM_PROMPT} tokens, "
        f"{LM_TOKENS} new, s_max {s_max}")

    batch = {"tokens": prompt}
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = lm_serve.generate(params, cfg, batch, n_tokens=LM_TOKENS,
                            s_max=s_max)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(counts["flash_attention"] == n_layers,
          f"{arch}: flash_attention launched {counts['flash_attention']} "
          f"times in one generate, not once per layer of the prefill "
          f"({n_layers})")
    check(tuple(out.shape) == (LM_BATCH, LM_TOKENS)
          and out.dtype == torch.int32, f"generate gave {tuple(out.shape)} "
          f"{out.dtype}")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          "generated tokens outside the vocabulary")
    log(f"{tag} generate: {t_gen * 1e3:.1f} ms for {LM_BATCH} x {LM_TOKENS} "
        f"tokens after the prompt; launches {counts}; peak memory "
        f"{peak / 2**30:.2f} GiB")

    p0 = {k: v[0] for k, v in params["layers"]["ffn"].items()}
    for what, shape in (("prefill", (LM_BATCH, LM_PROMPT)),
                        ("decode", (LM_BATCH, 1))):
        x = torch.randn((*shape, cfg.d_model), generator=gen, device="cuda",
                        dtype=torch.float32).to(torch.bfloat16)
        y, aux = sync_free(lambda: moe.moe_block(p0, cfg, x),
                           f"{tag} moe_block at the {what} shape")
        check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(aux)),
              f"{tag} moe_block at the {what} shape: non-finite output")
        del x, y
    log(f"{tag} moe_block at the prefill's and decode's shapes made no host "
        f"sync (sync debug mode \"error\")")

    # decode at position 4096 against a fresh prefill of the 4097 tokens,
    # routing recorded on both sides: (a) the prefill as served; (b) the
    # same with the compared (last) tokens' MoE run as one batch of B, the
    # capacity and drops of the decode step, since in (a) a row's last
    # token is the last of that row in every expert's queue
    logits_p, caches = lm.prefill(params, cfg, batch, s_max=s_max)
    check(torch.equal(logits_p[:, -1, :cfg.vocab_size].argmax(-1).int(),
                      out[:, 0]), "prefill's argmax is not generate's first "
          "token")
    (logits_d, _), dec = moe_routes(
        lambda: lm.decode_step(params, cfg, out[:, :1], caches, LM_PROMPT))
    check(torch.equal(logits_d[:, -1, :cfg.vocab_size].argmax(-1).int(),
                      out[:, 1]), "decode's argmax is not generate's second "
          "token")
    del caches, logits_p
    longer = {"tokens": torch.cat([prompt, out[:, :1]], dim=1)}
    ld = logits_d[:, -1, :cfg.vocab_size].float()
    what = f"decode at position {LM_PROMPT} vs a fresh prefill of " \
           f"{LM_PROMPT + 1} tokens"
    (logits_f, _), pf = moe_routes(lambda: lm.prefill(params, cfg, longer))
    check(len(dec) == len(pf) == n_layers, f"{tag} recorded {len(dec)} / "
          f"{len(pf)} MoE layers, not {n_layers}")
    rows = torch.arange(LM_BATCH, device="cuda") * (LM_PROMPT + 1) + LM_PROMPT
    held = moe_rows_held(f"{tag} (a)", dec, pf, rows)
    hold_rows(f"{tag} (a) {what}", held, ld,
              logits_f[:, -1, :cfg.vocab_size].float())
    del logits_f, pf
    (logits_f, _), pf = moe_routes(lambda: last_token_as_batch(
        lambda: lm.prefill(params, cfg, longer)))
    check(len(pf) == 2 * n_layers, f"{tag} recorded {len(pf)} MoE calls, "
          f"not {2 * n_layers}")
    held = moe_rows_held(f"{tag} (b)", dec, pf[1::2],
                         torch.arange(LM_BATCH, device="cuda"))
    hold_rows(f"{tag} (b) {what}, its last tokens' MoE as one batch", held,
              ld, logits_f[:, -1, :cfg.vocab_size].float())
    check(any(held), f"{tag} (b): no row routed alike on both sides")
    del logits_d, logits_f, longer, dec, pf

    again = lm_serve.generate(params, cfg, batch, n_tokens=LM_TOKENS,
                              s_max=s_max)
    check(torch.equal(out, again), "a second generate gave other tokens")
    log(f"{tag} a second generate gave identical tokens")

    t_prefill = host_ms(lambda: lm.prefill(params, cfg, batch, s_max=s_max))
    _, caches = lm.prefill(params, cfg, batch, s_max=s_max)
    tok = out[:, :1]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(LM_TOKENS - 1):
        lm.decode_step(params, cfg, tok, caches, LM_PROMPT + i)
    torch.cuda.synchronize()
    t_dec = (time.perf_counter() - t) * 1e3 / (LM_TOKENS - 1)
    decode_dev, decode_how = device_or_stream_ms(
        lambda: lm.decode_step(params, cfg, tok, caches, LM_PROMPT), 3)
    expert_bytes = sum(p0[k].numel() * p0[k].element_size()
                       for k in ("wi", "wg", "wo") if k in p0) * n_layers
    log(f"{tag} prefill {t_prefill:.1f} ms ({t_prompt / t_prefill * 1e3:.0f} "
        f"prompt tokens/s); decode {t_dec:.2f} ms per step of {LM_BATCH} "
        f"tokens ({LM_BATCH / t_dec * 1e3:.1f} tokens/s), {decode_dev:.2f} ms "
        f"of it {decode_how}; a decode step reads every expert's weights, "
        f"{expert_bytes / 1e9:.2f} GB: "
        f"{expert_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms at 3.35 TB/s; "
        f"generate {LM_BATCH * LM_TOKENS / t_gen:.1f} new tokens/s end to end "
        f"(host clock)")
    del caches
    prefill_profile(tag, lambda: lm.prefill(params, cfg, batch, s_max=s_max),
                    t_prefill)
    moe_split(tag, cfg, params, LM_BATCH, LM_PROMPT)
    del params, p0
    torch.cuda.empty_cache()
    return dict(counts=counts)


# substrings of the cuBLAS / CUTLASS GEMM kernels' names in a trace
MESH_RANKS = 2          # [mesh]: ranks sharing the one card over gloo
MESH_MIGRATE = 4        # [mesh]: --migrate-every of the islands run


def _cpu_state(state) -> dict:
    return {f: getattr(state, f).cpu() for f in ("genes", "objs", "rank",
                                                 "crowd")}


def mesh_rank(problems_path: str, dirs: dict, n_ranks: int) -> dict:
    """One rank of `[mesh]` on ``n_ranks``: (a) the har tree on
    ``--mesh n_ranks`` with verify_rtl, (b) the same run saved at
    generation 4, (c) islands on an ``n_ranks``-ring, (d) the mixed sweep
    on an ``n_ranks``x1 mesh, all through `run_search` / `run_sweep` with
    the kernels' counters set to 0 just before and read just after; then
    one sharded generation and one all_reduce timed. Returns the states,
    counts and times to the parent (the counters are per process)."""
    t_enter = time.time()
    from repro_torch import kernels, search
    from repro_torch.core import dist, nsga2
    from repro_torch.kernels import domination
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.search import make_kernel_fitness, sweep
    from repro_torch.sharding import search as layout

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = launch_mesh.rank_device("cuda")
    loaded = torch.load(problems_path, map_location=dev, weights_only=False)
    problem, mixed = loaded["tree"], loaded["mixed"]
    out = {"t_enter": t_enter, "device": str(dev)}
    kernels.reset_launch_counts()
    dist.reset_collectives()
    t0 = time.perf_counter()
    res = search.run_search(problem, backend="kernel", pop_size=POP,
                            n_generations=GENS, seed=SEED, dataset=DATASET,
                            out_dir=dirs["a"], verify_rtl=True,
                            mesh=str(n_ranks))
    torch.cuda.synchronize()
    out["a"] = _cpu_state(res.state)
    out["a_s"] = (time.perf_counter() - t0, res.wall_s)
    out["a_counts"] = kernels.launch_counts()
    out["a_slab"] = kernels.launched(domination.domination_block)
    search.run_search(problem, backend="kernel", pop_size=POP,
                      n_generations=GENS // 2, seed=SEED, out_dir=dirs["b"],
                      checkpoint_every=GENS // 2, mesh=str(n_ranks))
    res = search.run_search(problem, backend="islands", pop_size=POP,
                            n_generations=GENS, seed=SEED,
                            migrate_every=MESH_MIGRATE, mesh=str(n_ranks))
    out["c"] = _cpu_state(res.state)
    sw = sweep.run_sweep(mixed, pop_size=SWEEP_MIXED["pop"],
                         n_generations=SWEEP_MIXED["gens"], seed=SEED,
                         max_buckets=SWEEP_MIXED["max_buckets"],
                         mesh=f"{n_ranks}x1")
    torch.cuda.synchronize()
    out["d"] = {n: (_cpu_state(r.state), r.pareto_objs, r.pareto_genes)
                for n, r in sw.results.items()}
    out["counts"] = kernels.launch_counts()
    out["slab"] = kernels.launched(domination.domination_block)
    out["collectives"] = dict(dist.COLLECTIVES)

    # one sharded generation's host time, from (a)'s final population
    mesh = launch_mesh.make_search_mesh(str(n_ranks), ("pop",),
                                        device=dev)
    cfg = nsga2.NSGA2Config(pop_size=POP)
    state = layout.shard_state(nsga2.NSGA2State(
        *(out["a"][f].to(dev) for f in ("genes", "objs", "rank", "crowd")),
        GENS), mesh, dist.sharded_state_sharding(mesh))
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    chunk = dist.make_sharded_chunk(make_kernel_fitness(problem), mesh, cfg,
                                    CHUNK)
    chunk(state, gen)                                  # warm-up
    dist.reset_collectives()
    out["gen_ms"] = host_ms(lambda: chunk(state, gen)) / CHUNK
    out["gen_collectives"] = {k: v / (3 * CHUNK)
                              for k, v in dist.COLLECTIVES.items()}
    # one all_reduce of the peel's (2P,) int32 counts, alone: on host
    # tensors (gloo's round trip) and on the card's (staged through the
    # host, so each waits for the card, which the ranks share)
    group = mesh.get_group("pop")
    for where in ("cpu", dev):
        x = torch.ones(2 * POP, dtype=torch.int32, device=where)
        out[f"reduce_ms_{torch.device(where).type}"] = host_ms(
            lambda: [dist.all_reduce_sum(x, group) for _ in range(50)]) / 50
    return out


def phase_mesh(problem, tree_path: dict, sweep_path: dict, root: str,
               rng, n_ranks: int = MESH_RANKS) -> dict:
    """`[mesh]`: the port's multi-device search, ``n_ranks`` ranks spawned
    on the cards (gloo where they share one, NCCL refusing two ranks on a
    GPU; NCCL where every rank has a card of its own), checked against the
    single-card runs: (a) the har tree, kernel backend, pop 512,
    ``mesh=n_ranks``, 8 generations with verify_rtl == `phase_main_path`'s
    run (state and pareto.json); (b) saved at generation 4 under the mesh
    and resumed with no mesh == the same; (c) islands on an n_ranks-ring,
    pop 512 (512 / n_ranks an island), migrate_every 4 ==
    `dist.run_islands_serial` of the same islands on one card; (d) the
    mixed sweep on an n_ranks x 1 mesh == the batched single-card campaign
    of `phase_sweep`. The ranks' launch counts
    come back to the parent; `domination_block` (the bool slab, its first
    caller) must have launched. The slab at the sharded sort's shape and
    `fitness_errors` at the shard's P are timed beside their bounds."""
    from repro_torch import search
    from repro_torch.core import dist, nsga2
    from repro_torch.kernels import domination, fitness, ops
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.search import make_fitness, make_kernel_fitness

    root = pathlib.Path(root)
    dirs = {k: str(root / k) for k in ("a", "b")}
    path = str(root / "problems.pt")
    torch.save({"tree": problem, "mixed": sweep_path["mixed"]}, path)
    backend = launch_mesh.collective_backend("cuda", n_ranks,
                                             torch.cuda.device_count())
    t_spawn = time.time()
    outs = launch_mesh.spawn(mesh_rank, n_ranks, "cuda",
                             (path, dirs, n_ranks))
    t_all = time.time() - t_spawn
    rendezvous = max(o["t_enter"] for o in outs) - t_spawn
    devices = sorted({o["device"] for o in outs})
    shared = ("the ranks share one card: this checks the code and its "
              "arithmetic, not NVLink" if len(devices) < n_ranks
              else "a card a rank")
    log(f"[mesh] {n_ranks} ranks on {devices} over {backend} ({shared}): "
        f"spawn and rendezvous {rendezvous:.1f} s, the ranks' whole work "
        f"{t_all:.1f} s")

    want = tree_path["state"]
    for o in outs:
        check(all(torch.equal(o["a"][f], getattr(want, f).cpu())
                  for f in o["a"]),
              "(a) the --mesh 2 run differs from the single-card run")
    got_art = json.load(open(pathlib.Path(dirs["a"]) / "pareto.json"))
    want_art = dict(tree_path["art"].payload)
    for d in (got_art, want_art):
        d.pop("wall_s")
    check(got_art == want_art, "(a) the --mesh 2 pareto.json differs from "
          "the single-card run's")
    a_counts = outs[0]["a_counts"]
    log(f"[mesh] (a) run_search {DATASET} kernel pop={POP} gens={GENS} "
        f"mesh={n_ranks}: {outs[0]['a_s'][1]:.2f} s search, "
        f"{outs[0]['a_s'][0]:.2f} s with pareto.json + verify_rtl on rank "
        f"0; final state and pareto.json ({len(got_art['pareto'])} points, "
        f"all verified) == the single-card run; launches on rank 0 "
        f"{a_counts}, the bool slab {outs[0]['a_slab']} of them")
    check(all(o["a_slab"] == GENS for o in outs)
          and a_counts["fitness_errors"] >= 1 + GENS,
          "(a) the sharded sort's slab did not launch once a generation on "
          "every rank, or the fitness kernel launched fewer times")

    resumed = search.run_search(
        problem, backend="kernel", pop_size=POP, n_generations=GENS,
        seed=SEED, out_dir=dirs["b"], checkpoint_every=GENS // 2,
        resume=True)
    check(same_state(resumed.state, want),
          "(b) saved under the mesh, resumed with none: differs from the "
          "uninterrupted run")
    log(f"[mesh] (b) saved at generation {GENS // 2} under mesh="
        f"{n_ranks}, resumed on one card with no mesh: == the "
        f"uninterrupted run")

    local = max(8, POP // n_ranks)     # the engine's islands rule
    cfg = dist.IslandConfig(
        local_pop=local, migrate_every=MESH_MIGRATE,
        n_migrate=min(4, local // 2),
        nsga=nsga2.NSGA2Config(pop_size=local, n_generations=GENS))
    serial = dist.run_islands_serial(
        SEED, make_fitness(problem, "reference"), problem.n_genes,
        n_ranks, cfg, -(-GENS // MESH_MIGRATE),
        seed_genes=problem.exact_genes(), device=problem.device)
    for o in outs:
        check(all(torch.equal(o["c"][f], torch.cat(
            [getattr(s, f) for s in serial]).cpu()) for f in o["c"]),
            "(c) the islands ring differs from the serial islands")
    log(f"[mesh] (c) islands: {n_ranks} islands of {local}, "
        f"migrate_every {MESH_MIGRATE}, {GENS} generations (reference "
        f"fitness, the card's sort in each island and migration) == the "
        f"same islands run one after another in one process")

    mb = sweep_path["mixed_result"]
    for o in outs:
        check(o["d"].keys() == mb.results.keys() and all(
            all(torch.equal(o["d"][n][0][f], getattr(r.state, f).cpu())
                for f in o["d"][n][0])
            and np.array_equal(o["d"][n][1], r.pareto_objs)
            and np.array_equal(o["d"][n][2], r.pareto_genes)
            for n, r in mb.results.items()),
            "(d) the mixed sweep on a 2x1 mesh differs from the batched "
            "single-card campaign")
    log(f"[mesh] (d) sweep mesh={n_ranks}x1 on the mixed campaign "
        f"{sorted(mb.results)}: == the batched single-card campaign")

    # one generation: sharded (eager, generation by generation) against a
    # captured single-card chunk, from the same population
    fit = make_kernel_fitness(problem)
    gen = torch.Generator(device=problem.device).manual_seed(SEED + 2)
    chunk = nsga2.make_chunk(fit, nsga2.NSGA2Config(pop_size=POP), CHUNK)
    chunk(want, gen)
    t_one = host_ms(lambda: chunk(want, gen)) / CHUNK
    per_gen = outs[0]["gen_collectives"]
    how = (f"{backend}, CUDA tensors staged through the host"
           if backend == "gloo" else backend)
    log(f"[mesh] one generation, {DATASET} pop {POP}: sharded over {n_ranks} "
        f"ranks ({how}) "
        f"{outs[0]['gen_ms']:.2f} ms host clock, against {t_one:.2f} ms in "
        f"a captured single-card chunk of {CHUNK}; collectives per "
        f"generation on a rank: {per_gen['all_gather']:.1f} all_gather, "
        f"{per_gen['all_reduce']:.1f} all_reduce (one a front, plus the "
        f"counts); one all_reduce of {2 * POP} int32 alone "
        f"{outs[0]['reduce_ms_cpu']:.3f} ms on host tensors, "
        f"{outs[0]['reduce_ms_cuda']:.3f} ms on the card's")

    # the kernels at the shard's shapes
    rows = {}
    pi, pj = 2 * POP // n_ranks, 2 * POP
    oi = torch.as_tensor((rng.integers(0, 64, (pi, 2)) / 63)
                         .astype(np.float32), device="cuda")
    oj = torch.as_tensor((rng.integers(0, 64, (pj, 2)) / 63)
                         .astype(np.float32), device="cuda")
    got = domination.domination_block(oi, oj)
    torch.cuda.synchronize()
    err = int((got.int() - domination.domination_block_plain(oi, oj).int())
              .abs().max())
    check(err == 0, f"domination_block {pi}x{pj} differs from its plain "
          f"version")
    ms, plain_ms, text = timed(
        lambda: domination.domination_block(oi, oj),
        lambda: domination.domination_block_plain(oi, oj),
        "domination_kernel", reps=50, plain_reps=50)
    bms, by = bound((pi + pj) * 2 * 4 + pi * pj, 3 * 2 * pi * pj,
                    FP32_OPS_PER_S)
    log(f"[mesh] domination_block {pi}x{pj} M=2 (a rank's rows of the "
        f"sharded sort): equal; {text}; bound {bms:.5f} ms ({by})")
    rows["domination_block[shard]"] = dict(
        name="domination_block[shard]", route="cuda",
        source=TPU_KERNELS["domination_block"][0],
        replaces=TPU_KERNELS["domination_block"][1],
        launches=sum(o["slab"] for o in outs), max_abs_err=float(err),
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None,
        what=f"the bool slab ({pi}, {pj}, 2): a rank's rows of the sharded "
             f"sort, har pop {POP} on {n_ranks} ranks; launches are the "
             f"slab's alone, over the ranks")
    p_s = POP // n_ranks
    genes = rng.random((p_s, problem.n_genes), dtype=np.float32)
    genes[0] = problem.exact_genes()
    genes_t = torch.as_tensor(genes, device="cuda")
    shift, thr, _, cap = ops.decode_population_full(problem.threshold,
                                                    genes_t)
    fit_ops = ops.prepare_fitness_operands(
        problem.x_sel, problem.y, problem.path, problem.path_len,
        problem.n_neg, problem.leaf_class, problem.n_classes)
    got = fitness.fitness_correct_counts(fit_ops, shift, thr, cap)
    torch.cuda.synchronize()
    err = int((got.long() - fitness.fitness_correct_counts_plain(
        fit_ops, shift, thr, cap).long()).abs().max())
    check(err == 0, f"fitness_errors at P={p_s} differs from its plain "
          f"version by {err}")
    ms, plain_ms, text = timed(
        lambda: fitness.fitness_correct_counts(fit_ops, shift, thr, cap),
        lambda: fitness.fitness_correct_counts_plain(fit_ops, shift, thr,
                                                     cap),
        "fitness_mma_kernel", reps=10, plain_reps=3)
    n, l, c = problem.n_comparators, problem.n_leaves, problem.n_classes
    b = int(problem.y.shape[0])
    bms, by = bound(b * fit_ops.x_sel.shape[1] + 2 * p_s * n * 4
                    + fit_ops.path.numel() + 2 * fit_ops.path.shape[0] * 4
                    + b * 4 + 2 * p_s * 4, tree_ops(p_s, b, n, l, c),
                    INT8_OPS_PER_S)
    log(f"[mesh] fitness_errors P={p_s} B={b} N={n} (a rank's child slab): "
        f"equal; {text}; bound {bms:.4f} ms ({by})")
    counts = {k: sum(o["counts"][k] for o in outs) for k in outs[0]["counts"]}
    rows["fitness_errors[shard]"] = dict(
        name="fitness_errors[shard]", route="cuda",
        source=TPU_KERNELS["fitness_errors"][0],
        replaces=TPU_KERNELS["fitness_errors"][1],
        launches=counts["fitness_errors"], max_abs_err=float(err), ms=ms,
        plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None,
        what=f"fitness_correct_counts at a rank's slab, P={p_s}, B={b}, "
             f"N={n}; launches over the ranks of [mesh]")
    check(rows["domination_block[shard]"]["launches"] > 0,
          "the bool slab never launched on the sharded sort")
    log(f"[mesh] launches over the ranks (a)-(d): {counts}; the bool slab "
        f"{rows['domination_block[shard]']['launches']}; collectives on rank "
        f"0 {outs[0]['collectives']}")
    return dict(counts=counts, rows=rows)


LM_MESH_RANKS = 4     # [lm-mesh]: a (data=2, model=2) mesh
LM_MESH_PLAN = dict(arch=LM_ARCH, layers=2, batch=4, seq=1024, steps=3)
# (a) again for the ssm kind, on the same ranks: no trace, no checkpoint
LM_MESH_SSM_PLAN = dict(arch="mamba2-1.3b", layers=2, batch=4, seq=1024,
                        steps=2, trace=False)
# [lm-mesh] (a)'s limits: each reading of the sharded bf16 run against the
# single-card bf16 step within LM_MESH_SAFETY times the spread the
# single-card path itself shows when the same sums run in float32 (the
# step's own bf16 rounding; for the loss and grad norm its largest over the
# steps so far, as one step's may come near 0 by chance: 2.19e-5 at step
# 1 against 3.0e-4 at step 0 on an H100), at least one bf16
# ulp of a parameter leaf's largest magnitude and 1e-6 of a metric (float32's rounding, for a config
# in float32 already). A reordering on one card (grad_accum 1 against 2)
# spreads less than the sharded run's own roundings: its row-parallel
# products round each rank's partial sum to bf16 before they are added
# (as GSPMD's do), which one card never does (on an H100: that spread 0
# to 9.4e-5, the sharded run's differences 7e-5 to 9.8e-4).
LM_MESH_SAFETY = 4
# (b): reduced float32 configs, (name, arch, overrides, reference, S), head
# dims the kernels take: reduced_step_check's llama3.2-3b in both head
# modes at tp 2 (4 heads over 2 kv heads: "sharded"; 3 heads:
# "replicated"), mamba2-1.3b, zamba2-7b at 7 layers (2 super-blocks and a
# tail layer) at its own head dim 112, and the MoE in both expert-parallel
# modes (kimi: 4 experts over the 2 data ranks, the int8 dispatch,
# grad_accum 2 summed in float32; grok: 3 experts, "gathered", the
# softcap). "one": held to the CPU's single-device step; "mesh": to the
# same sharded step on CPU tensors (an MoE rank routes its own tokens at
# its own capacity, so one device is not its reference). B=4 x the last
# entry: the SSMs at tests/test_torch_train.py's 64 positions, where its
# 2^-8 limit was measured
LM_MESH_REDUCED = (
    ("sharded heads", LM_ARCH, dict(head_dim=64), "one", 128),
    ("replicated heads", LM_ARCH, dict(head_dim=64, n_heads=3,
                                       n_kv_heads=1), "one", 128),
    ("ssm", "mamba2-1.3b", {}, "one", 64),
    ("hybrid", "zamba2-7b", dict(n_layers=7, head_dim=112), "one", 64),
    ("moe alltoall", "kimi-k2-1t-a32b", dict(
        head_dim=64, moe_a2a_int8=True, grad_accum=2,
        grad_accum_dtype="float32"), "mesh", 128),
    ("moe gathered", "grok-1-314b", dict(head_dim=64, n_experts=3), "mesh",
     128),
)
# the SSD rounds its weight block and its cotangent to bf16 in every
# dtype, so an SSM's gradients on two devices agree to a bf16 rounding of
# their scale, not float32's: 2^-8 port against JAX on the CPU
# (tests/test_torch_train.py), the hybrid's sharded step on an H100
# against the CPU's single device 4.15e-3 (its 7 layers); the grad norm
# over them to 1e-4
LM_MESH_SSD_GRAD_REL, LM_MESH_SSD_NORM_RTOL = 2.0 ** -7, 1e-4
LM_MESH_PSUM = ((64, 33), (1000,))   # (d): the leaves of the pod mean
# (e) sharded serving: the reduced float32 cases of
# tests/test_torch_lm_mesh_serve.py (name, arch, overrides, reference), at
# head dims the kernels take (zamba2 its own 112), B=4 x 32 prompt
# tokens, s_max 64, 4 greedy tokens. "one": the tokens == the port's
# single-device generate on the card; "mesh": == the same sharded serve on
# CPU tensors (an MoE rank routes its own tokens at its own capacity, so
# one device is not its reference)
LM_MESH_SERVE_REDUCED = (
    ("sharded heads", LM_ARCH, dict(head_dim=64), "one"),
    ("replicated heads, vlm prefix", "paligemma-3b",
     dict(head_dim=64, n_heads=3), "one"),
    ("ssm", "mamba2-1.3b", {}, "one"),
    ("hybrid", "zamba2-7b", dict(n_layers=7, head_dim=112), "one"),
    ("moe alltoall", "kimi-k2-1t-a32b", dict(head_dim=64, moe_a2a_int8=True),
     "mesh"),
    ("moe gathered", "grok-1-314b", dict(head_dim=64, n_experts=3), "mesh"),
)
LM_MESH_SERVE_SHAPE = dict(batch=4, prompt=32, s_max=64, tokens=4)
# (e) at full width: llama3.2-3b cut to 2 layers, B=4 x 1024, s_max 1056,
# 8 greedy tokens, held to one card's generate from the same seed
LM_MESH_SERVE_PLAN = dict(arch=LM_ARCH, layers=2, batch=4, prompt=1024,
                          s_max=1056, tokens=8)
# the collectives' device work: NCCL's kernels, and the copies that stage
# gloo's through the host (the step uploads its batch before it starts)
COMM_NAMES = ("ncclDevKernel", "ncclKernel", "Memcpy DtoH", "Memcpy HtoD")
NCCL_ANNOTATION = "nccl:"   # the profiler's span of a collective's kernels


def _on(dev, fn, default=None):
    """``fn()`` when ``dev`` is a card (the synchronising and memory
    calls), else ``default``: [lm-mesh]'s ranks also rehearse on the CPU."""
    return fn() if torch.device(dev).type == "cuda" else default


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(abs(x), 2.0 ** -126))) - 7)


def lm_mesh_reference(cfg, data, plan: dict, dev) -> dict:
    """The single-card step that [lm-mesh] (a) is held to, from the same
    seed through `launch.train.build`: run A (the config as the sharded run
    takes it) and run B (the same sums in float32, with ``plan``'s
    ``ref_accum`` microbatches, 1 by default: the single-card path's own
    bf16 rounding). Returns A's loss, grad norm and parameters (on the
    host) after each step, and the spread |A - B| of each."""
    from repro_torch import pytree
    from repro_torch.launch import train as launch_train

    runs = {"A": [], "spread": []}
    ref = dataclasses.replace(cfg, dtype="float32",
                              grad_accum=plan.get("ref_accum", 1))
    for name, c in (("A", cfg), ("B", ref)):
        state, step_fn = launch_train.build(c, steps=plan["steps"],
                                            device=dev, seed=SEED)
        for step in range(plan["steps"]):
            state, m = step_fn(state, launch_train.device_batch(
                data, step, c, plan["batch"], dev))
            loss, gn = float(m["loss"]), float(m["grad_norm"])
            if name == "A":
                runs["A"].append((loss, gn, {
                    pytree.path_str(p): t.cpu().clone()
                    for p, t in pytree.leaves_with_paths(state.params)}))
                continue
            a = runs["A"][step]
            runs["spread"].append((abs(a[0] - loss), abs(a[1] - gn), {
                pytree.path_str(p): float(
                    (a[2][pytree.path_str(p)].to(t.device).float() - t)
                    .abs().max())
                for p, t in pytree.leaves_with_paths(state.params)}))
        del state, step_fn
        _on(dev, torch.cuda.empty_cache)
    return runs


def _reduced_cfg(arch: str, over: dict):
    from repro_torch.configs import get_config, reduced_config

    return reduced_config(get_config(arch), **over)


def _reduced_cpu_refs() -> list:
    """[lm-mesh] (b)'s CPU side: for each reduced float32 config, the
    parameters of `launch.train.build`'s state (seed 0) as numpy and the
    batch; for the "one" cases also the single-device step on the CPU: its
    gradients and one step's loss and grad norm."""
    from repro_torch import pytree
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import train as launch_train
    from repro_torch.runtime import train

    refs = []
    for name, arch, over, against, seq in LM_MESH_REDUCED:
        cfg = _reduced_cfg(arch, over)
        data = SyntheticLMData(cfg.vocab_size, seq, 4, seed=0)
        state, step_fn = launch_train.build(cfg, steps=20, device="cpu")
        params = pytree.tree_map(lambda t: t.numpy().copy(), state.params)
        batch = launch_train.device_batch(data, 0, cfg, 4, "cpu")
        ref = dict(name=name, arch=arch, over=over, against=against,
                   params=params, tokens=batch["tokens"].numpy())
        if against == "one":
            grads = train.loss_and_grads(cfg, state.params, batch)[2]
            _, m = step_fn(state, batch)
            ref.update(grads=pytree.tree_map(lambda t: t.numpy(), grads),
                       loss=float(m["loss"]),
                       grad_norm=float(m["grad_norm"]))
        refs.append(ref)
    return refs


def _psum_input(pod: int, i: int) -> torch.Tensor:
    rng = np.random.default_rng(100 + 10 * pod + i)
    return torch.as_tensor((rng.normal(size=LM_MESH_PSUM[i]) * 10 ** i)
                           .astype(np.float32))


def _psum_plain() -> list:
    """(d)'s CPU side: the int8 pod mean of the two pods' leaves, written
    out: the scale maxed over the pods, the codes summed in int32, times
    the scale over 2."""
    out = []
    for i in range(len(LM_MESH_PSUM)):
        g = [_psum_input(pod, i) for pod in (0, 1)]
        scale = torch.stack([torch.clamp(x.abs().max() / 127.0, min=1e-30)
                             for x in g]).max()
        total = sum(torch.clamp(torch.round(x / scale), -127, 127)
                    .to(torch.int32) for x in g)
        out.append((total.to(torch.float32) * scale / 2).numpy())
    return out


def lm_mesh_rank(plans: tuple, extras: dict) -> dict:
    """One rank of `[lm-mesh]` (a (data=2, model=2) mesh): (a) with each
    of ``plans`` (`_lm_mesh_a`, its readings in ``out["a"]``), and with
    ``extras``: (c) the first plan's state through a sharded checkpoint
    (``ckpt_dir``), (b) the reduced float32 configs (``reduced``,
    `_lm_mesh_b`), (d) the int8 mean over a 2-rank pod axis (``psum``).
    Returns readings to the parent (counters are per process)."""
    t_enter = time.time()
    import torch.distributed as dist

    from repro_torch.launch import mesh as launch_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = launch_mesh.rank_device(
        (plans[0] if plans else extras).get("device", "cuda"))
    out = {"t_enter": t_enter, "device": str(dev), "rank": dist.get_rank(),
           "backend": dist.get_backend(),
           "marks": {"enter": time.perf_counter()}, "a": []}
    mesh = launch_mesh.make_host_mesh(LM_MESH_RANKS, ("data", "model"),
                                      device=dev)
    for i, plan in enumerate(plans):
        sub = {"rank": out["rank"], "marks": out["marks"]}
        _lm_mesh_a(plan, mesh, dev, sub,
                   extras.get("ckpt_dir") if i == 0 else None)
        out["a"].append(sub)
    if "reduced" in extras:
        out["b"] = _lm_mesh_b(extras["reduced"], mesh, dev)
        out["marks"]["(b)"] = time.perf_counter()
    if "serve" in extras:    # (e) sharded serving
        out["e"] = dict(
            reduced=_lm_mesh_e_reduced(extras["serve"]["reduced"], mesh, dev),
            full=_lm_mesh_e_full(extras["serve"]["full"], mesh, dev))
        out["marks"]["(e)"] = time.perf_counter()
    if extras.get("psum"):
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.optim import compress

        pods = init_device_mesh(dev.type, (2, 2),
                                mesh_dim_names=("pod", "model"))
        pod = pods.get_local_rank("pod")
        mean = compress.make_crosspod_mean(pods, "pod")(
            [_psum_input(pod, i).to(dev) for i in range(len(LM_MESH_PSUM))])
        out["d"] = [t.cpu().numpy() for t in mean]
        out["marks"]["(d)"] = time.perf_counter()
    return out


class _Marks:
    """A rank's time marks, each name prefixed with a plan's arch."""

    def __init__(self, marks: dict, prefix: str):
        self.marks, self.prefix = marks, prefix

    def __setitem__(self, name: str, t: float) -> None:
        self.marks[f"{self.prefix} {name}"] = t


def _lm_mesh_a(plan: dict, mesh, dev, out: dict, ckpt_dir) -> None:
    """(a) on this rank: ``plan``'s model trained ``plan["steps"]`` steps
    through `launch.train.train_loop` with the sharded step, counted, every
    parameter gathered after each step and, on rank 0, held to the
    single-card step (rank 0 runs it first, `lm_mesh_reference`); one more
    step traced on rank 0 (unless ``plan["trace"]`` is False); then, with
    ``ckpt_dir``, (c): the state saved sharded and restored onto one card
    (rank 0) and onto (data=1, model=2), each against the gathered state.
    Fills ``out``; its marks are named by the plan's arch."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch import kernels, pytree
    from repro_torch.core import comm
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch import train as launch_train
    from repro_torch.models import attention
    from repro_torch.runtime import checkpoint
    from repro_torch.sharding import params as sp
    from repro_torch.sharding.rules import MeshRules

    rank, arch = out["rank"], plan["arch"]
    marks_t = _Marks(out["marks"], arch)
    cfg = launch_train.model_config(plan["arch"], plan.get("reduced", False),
                                    plan["layers"])
    data = SyntheticLMData(cfg.vocab_size, plan["seq"], plan["batch"],
                           seed=0)
    ref = lm_mesh_reference(cfg, data, plan, dev) if rank == 0 else None
    marks_t["reference"] = time.perf_counter()
    if ref is not None:
        out["spread"] = [(a, b) for a, b, _ in ref["spread"]]
    rules = launch_mesh.rules_for(mesh)
    specs = sp.train_state_specs(cfg, rules, sp.mesh_axes(mesh),
                                 cfg.optimizer)
    state, step_fn = launch_train.build_sharded(cfg, rules,
                                                steps=plan["steps"] + 1,
                                                device=dev, seed=SEED)
    params = state.params          # updated in place by every step
    marks_t["init"] = time.perf_counter()
    heads = []
    kernel = attention.flash_attention_bshd

    def counted(q, k, v, **kw):
        heads.append((q.shape[2], k.shape[2]))
        return kernel(q, k, v, **kw)

    attention.flash_attention_bshd = counted
    _on(dev, torch.cuda.synchronize)
    _on(dev, torch.cuda.reset_peak_memory_stats)
    losses, gnorms, errs, coll, step_s = [], [], [], [], []
    marks = [time.perf_counter()]
    kernels.reset_launch_counts()
    comm.reset_collectives()

    def on_step(step, m):
        _on(dev, torch.cuda.synchronize)
        step_s.append(time.perf_counter() - marks[-1])
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        coll.append((dict(comm.COLLECTIVES), dict(comm.COLLECTIVE_BYTES),
                     dict(comm.COLLECTIVE_RESULT_BYTES)))
        full = sp.gather_tree(params, specs.params, mesh)
        if ref is not None:
            want = ref["A"][step][2]
            errs.append({pytree.path_str(p): float(
                (t.float() - want[pytree.path_str(p)].to(dev).float())
                .abs().max()) for p, t in pytree.leaves_with_paths(full)})
        del full
        comm.reset_collectives()
        marks.append(time.perf_counter())

    state, _ = launch_train.train_loop(
        state, step_fn, data, cfg, start=0, steps=plan["steps"],
        batch=plan["batch"], device=dev, log=lambda m: None,
        on_step=on_step)
    out["counts"] = kernels.launch_counts()
    attention.flash_attention_bshd = kernel
    marks_t["steps"] = time.perf_counter()
    out.update(heads=sorted(set(heads)), losses=losses, gnorms=gnorms,
               step_s=step_s, coll=coll,
               peak=_on(dev, torch.cuda.max_memory_allocated, 0))
    if ref is not None:
        out["ref"] = [(a, b) for a, b, _ in ref["A"]]
        out["errs"] = errs
        out["limits"] = [{k: max(LM_MESH_SAFETY * s,
                                 _bf16_ulp(float(ref["A"][i][2][k].float()
                                                 .abs().max())))
                          for k, s in sp_[2].items()}
                         for i, sp_ in enumerate(ref["spread"])]
        del ref
    _on(dev, torch.cuda.empty_cache)

    if plan.get("trace", True):     # one more step, traced on rank 0
        batch = launch_train.device_batch(data, plan["steps"], cfg,
                                          plan["batch"], dev)
        holder = [state]

        def one_step():
            holder[0], _ = step_fn(holder[0], batch)

        if rank == 0 and dev.type == "cuda":
            out["split"] = _profile_split(one_step, comm=True)
        else:
            one_step()
            _on(dev, torch.cuda.synchronize)
        state = holder[0]
        del holder, batch
        marks_t["traced step"] = time.perf_counter()
    if not ckpt_dir:
        del state, step_fn, params
        _on(dev, torch.cuda.empty_cache)
        return

    # (c) the state saved sharded, restored onto one card and onto (1, 2)
    checkpoint.save_tree(ckpt_dir, int(state.step), state, specs=specs,
                         mesh=mesh)
    marks_t["(c) save"] = time.perf_counter()
    gathered = sp.gather_tree(state, specs, mesh)
    del state, step_fn
    _on(dev, torch.cuda.empty_cache)
    # (data=1, model=2) on ranks 0 and 1 (every rank makes the mesh)
    mesh12 = DeviceMesh(dev.type, torch.tensor([[0, 1]]),
                        mesh_dim_names=("data", "model"))
    if rank < 2:
        rules12 = MeshRules(tp=2, mesh=mesh12)
        specs12 = sp.train_state_specs(cfg, rules12, sp.mesh_axes(mesh12),
                                       cfg.optimizer)
        like = launch_train.build_sharded(cfg, rules12, steps=1, device=dev,
                                          seed=SEED + 1)[0]
        like, _ = checkpoint.restore_tree(ckpt_dir, int(gathered.step),
                                          like, specs=specs12, mesh=mesh12)
        # the restored blocks against this rank's blocks of the gathered
        # state
        out["c_1x2"] = all(torch.equal(a, b) for a, b in zip(
            pytree.leaves(like),
            pytree.leaves(sp.shard_tree(gathered, specs12, mesh12))))
        del like
    if rank == 0:
        one = launch_train.build(cfg, steps=1, device=dev, seed=SEED + 1)[0]
        one, _ = checkpoint.restore_tree(ckpt_dir, int(gathered.step), one)
        out["c_one"] = all(torch.equal(a, b) for a, b in zip(
            pytree.leaves(one), pytree.leaves(gathered)))
        out["c_leaves"] = len(pytree.leaves(one))
        del one
    del gathered
    _on(dev, torch.cuda.empty_cache)
    marks_t["(c) restores"] = time.perf_counter()


def _lm_mesh_b(refs: list, mesh, dev) -> list:
    """(b) on this rank: each reduced float32 config's gradients (the
    sharded step's, gathered) and one sharded step's loss and grad norm,
    from the CPU's parameters (`_reduced_cpu_refs`) cut to this rank's
    blocks; the per-leaf error against the reference's gradient over its
    scale. A "mesh" case computes its reference first, the same sharded
    step on this rank's CPU tensors. The attention's launches of each case
    on this rank (the card's kernels; none on the CPU)."""
    from repro_torch import kernels, pytree
    from repro_torch.launch import train as launch_train
    from repro_torch.runtime import train
    from repro_torch.sharding import params as sp
    from repro_torch.sharding.rules import MeshRules, head_sharding

    def sharded_step(c, r, params, tokens, on):
        p_local = pytree.tree_map(lambda t: t.to(on), sp.shard_tree(
            pytree.tree_map(torch.as_tensor, params),
            sp.param_specs(c, r, sp.mesh_axes(mesh)), mesh))
        batch = {"tokens": torch.as_tensor(tokens, device=on)}
        _, _, g = train.make_sharded_grads(c, r, c.optimizer)(p_local,
                                                              batch)
        g = sp.gather_tree(g, train.grad_specs(c, r, c.optimizer), mesh)
        g = pytree.tree_map(lambda t: t.cpu().numpy(), g)
        opt = launch_train.optimizer_for(c, 20)
        st = train.init_sharded_train_state(p_local, opt, c, r)
        _, m = train.make_train_step(c, rules=r, optimizer=opt)(st, batch)
        return g, float(m["loss"]), float(m["grad_norm"])

    got = []
    for ref in refs:
        c = _reduced_cfg(ref["arch"], ref["over"])
        r = MeshRules(tp=2, mesh=mesh)
        want = ref
        if ref["against"] == "mesh":
            g, loss, gn = sharded_step(c, r, ref["params"], ref["tokens"],
                                       "cpu")
            want = dict(grads=g, loss=loss, grad_norm=gn)
        kernels.reset_launch_counts()
        g, loss, gn = sharded_step(c, r, ref["params"], ref["tokens"], dev)
        launches = kernels.launch_counts()
        rel = {}
        for p, t in pytree.leaves_with_paths(g):
            w = np.asarray(pytree.get(want["grads"], p))
            rel[pytree.path_str(p)] = float(np.abs(t - w).max()) / max(
                float(np.abs(w).max()), 1e-30)
        got.append(dict(name=ref["name"], mode=head_sharding(c, r)[0],
                        rel=rel, loss=loss, grad_norm=gn,
                        want_loss=want["loss"],
                        want_grad_norm=want["grad_norm"],
                        launches={k: launches[k] for k in (
                            "flash_attention", FLASH_BWD)}))
    return got


def _serve_prompt(cfg, batch: int, prompt: int, dev) -> dict:
    """A prompt batch from SEED: tokens (and a vlm prefix) on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt),
                                   generator=gen, device=dev,
                                   dtype=torch.int32)}
    if cfg.prefix_len:
        out["prefix_embed"] = torch.randn(
            (batch, cfg.prefix_len, cfg.d_model), generator=gen, device=dev,
            dtype=torch.float32).to(getattr(torch, cfg.dtype))
    return out


def _lm_mesh_e_reduced(cases, mesh, dev) -> list:
    """Each reduced float32 case of ``cases`` served sharded on this rank's
    device, its rows' greedy tokens against its reference (the
    single-device generate on the same device, or the same sharded serve
    on CPU tensors), the attention's launches of the sharded generate."""
    from repro_torch import kernels, pytree
    from repro_torch.models import transformer
    from repro_torch.runtime import lm_serve
    from repro_torch.sharding import params as sp
    from repro_torch.sharding.rules import MeshRules, head_sharding

    rules = MeshRules(tp=2, mesh=mesh)
    shape = LM_MESH_SERVE_SHAPE
    d = mesh.get_local_rank("data")
    n = shape["batch"] // mesh.shape[0]
    rows = slice(d * n, (d + 1) * n)
    got = []
    for name, arch, over, against in cases:
        cfg = _reduced_cfg(arch, over)
        full = transformer.init_params(SEED, cfg, device="cpu")
        local = sp.shard_tree(full, sp.param_specs(cfg, rules,
                                                   sp.mesh_axes(mesh)), mesh)
        batch = _serve_prompt(cfg, shape["batch"], shape["prompt"], "cpu")

        def sharded(on):
            return lm_serve.generate(
                pytree.tree_map(lambda t: t.to(on), local), cfg,
                {k: v[rows].to(on) for k, v in batch.items()},
                shape["tokens"], shape["s_max"], rules=rules).cpu()

        kernels.reset_launch_counts()
        toks = sharded(dev)
        launches = kernels.launch_counts()["flash_attention"]
        if against == "mesh":
            want = sharded("cpu")
        else:
            want = lm_serve.generate(
                pytree.tree_map(lambda t: t.to(dev), full), cfg,
                {k: v.to(dev) for k, v in batch.items()}, shape["tokens"],
                shape["s_max"]).cpu()[rows]
        got.append(dict(name=name, mode=head_sharding(cfg, rules)[0],
                        tokens=toks, want=want, launches=launches))
    return got


def serve_config(plan: dict):
    """``plan``'s config: its arch at full width (or reduced), depth cut to
    ``layers``, and with ``no_drop`` the MoE at capacity factor n_experts
    / experts_per_token, where no pick is dropped."""
    from repro_torch.launch.train import model_config

    cfg = model_config(plan["arch"], plan.get("reduced", False),
                       plan["layers"])
    if plan.get("no_drop"):
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
    return cfg


def _lm_mesh_e_full(plan: dict, mesh, dev, params=None) -> dict:
    """``plan``'s model (`serve_config`) served sharded on this rank: its
    rows' greedy tokens and prefill logits; on rank 0 first (unless
    ``plan["reference"]`` is False) the single card's generate and prefill
    logits from the same seed; the attention's launches and (query, kv)
    heads of the sharded generate; prefill ms, decode ms a step,
    collectives of one decode step (with ``plan["trace"]`` one traced on
    rank 0), peak memory. ``params``: the rank's blocks, default
    `init_sharded_params` from SEED."""
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.core import comm
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models import attention, lm, transformer
    from repro_torch.runtime import lm_serve
    from repro_torch.sharding import params as sp

    cfg = serve_config(plan)
    rules = launch_mesh.rules_for(mesh)
    batch = _serve_prompt(cfg, plan["batch"], plan["prompt"], dev)
    s_max, n_tok = plan["s_max"], plan["tokens"]
    out = {"rank": dist.get_rank(), "backend": dist.get_backend()}
    if out["rank"] == 0 and plan.get("reference", True):
        one = transformer.init_params(SEED, cfg, device=dev)
        out["one_tokens"] = lm_serve.generate(one, cfg, batch, n_tok,
                                              s_max).cpu()
        logits, _ = lm.prefill(one, cfg, batch, s_max=s_max)
        out["one_logits"] = logits[:, -1].float().cpu()
        del one, logits
        _on(dev, torch.cuda.empty_cache)
    t0 = time.perf_counter()
    if params is None:
        params = sp.init_sharded_params(SEED, cfg, rules, mesh, device=dev)
    _on(dev, torch.cuda.synchronize)
    out["init_s"] = time.perf_counter() - t0
    out["after_init"] = _on(dev, torch.cuda.memory_allocated, 0)
    d = mesh.get_local_rank("data")
    n = plan["batch"] // mesh.shape[0]
    rows = {k: v[d * n:(d + 1) * n] for k, v in batch.items()}
    heads = []
    kernel = attention.flash_attention_bshd

    def counted(q, k, v, **kw):
        heads.append((q.shape[2], k.shape[2]))
        return kernel(q, k, v, **kw)

    attention.flash_attention_bshd = counted
    _on(dev, torch.cuda.synchronize)
    _on(dev, torch.cuda.reset_peak_memory_stats)
    kernels.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        toks = lm_serve.generate(params, cfg, rows, n_tok, s_max, rules=rules)
        _on(dev, torch.cuda.synchronize)
        out["generate_s"] = time.perf_counter() - t0
        out["counts"] = kernels.launch_counts()
    finally:
        attention.flash_attention_bshd = kernel
    out.update(tokens=toks.cpu(), heads=sorted(set(heads)))

    def sync_ms(fn, reps: int) -> float:
        times = []
        for _ in range(reps):
            _on(dev, torch.cuda.synchronize)
            t0 = time.perf_counter()
            fn()
            _on(dev, torch.cuda.synchronize)
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    out["prefill_ms"] = sync_ms(lambda: lm.prefill(params, cfg, rows,
                                                   s_max=s_max, rules=rules),
                                3)
    logits, caches = lm.prefill(params, cfg, rows, s_max=s_max, rules=rules)
    out["logits"] = logits[:, -1].float().cpu()
    prompt_len = plan["prompt"]
    tok = toks[:, :1]
    pos = iter(range(prompt_len, s_max))
    out["decode_ms"] = sync_ms(lambda: lm.decode_step(
        params, cfg, tok, caches, next(pos), rules=rules), n_tok - 1)
    comm.reset_collectives()
    lm.decode_step(params, cfg, tok, caches, next(pos), rules=rules)
    out["decode_coll"] = (dict(comm.COLLECTIVES), dict(comm.COLLECTIVE_BYTES))
    if plan.get("trace") and out["rank"] == 0 and dev.type == "cuda":
        out["split"] = _profile_split(lambda: lm.decode_step(
            params, cfg, tok, caches, next(pos), rules=rules), comm=True)
    elif plan.get("trace"):
        lm.decode_step(params, cfg, tok, caches, next(pos), rules=rules)
    out["peak"] = _on(dev, torch.cuda.max_memory_allocated, 0)
    del params, caches
    _on(dev, torch.cuda.empty_cache)
    return out


def check_lm_mesh_e(tag: str, cases, plan: dict, ranks: list,
                    on_card: bool = True) -> dict:
    """(e)'s checks and readings: every reduced case's tokens on every
    rank equal to its reference's, each rank's attention launches one an
    attention layer of the prefill; then the full-width serve
    (`check_serve_full`). Returns the launch counts of the sharded
    generates summed over the ranks."""
    from repro_torch.models.transformer import hybrid_layout

    counts = {"flash_attention": 0}
    for i, (name, arch, over, against) in enumerate(cases):
        cfg = _reduced_cfg(arch, over)
        n_attn = (0 if cfg.family == "ssm" else hybrid_layout(cfg)[0]
                  if cfg.family == "hybrid" else cfg.n_layers)
        for r, rank in enumerate(ranks):
            g = rank["reduced"][i]
            check(torch.equal(g["tokens"], g["want"]),
                  f"{tag} (e) {name}: rank {r}'s sharded tokens "
                  f"{g['tokens'].tolist()} differ from its reference's "
                  f"{g['want'].tolist()} ({against})")
            check(not on_card or g["launches"] == n_attn,
                  f"{tag} (e) {name}: {g['launches']} attention launches on "
                  f"rank {r}, not {n_attn} (one an attention layer)")
            counts["flash_attention"] += g["launches"]
        g = ranks[0]["reduced"][i]
        ref = "one device" if against == "one" else \
            "the same sharded serve on CPU tensors"
        log(f"{tag} (e) reduced float32 {arch} {over} ({name}, {g['mode']} "
            f"heads at tp 2): B={LM_MESH_SERVE_SHAPE['batch']} x "
            f"{LM_MESH_SERVE_SHAPE['prompt']}, s_max "
            f"{LM_MESH_SERVE_SHAPE['s_max']}: every rank's "
            f"{LM_MESH_SERVE_SHAPE['tokens']} greedy tokens == {ref}; "
            f"attention launches a rank {g['launches']}")

    counts["flash_attention"] += check_serve_full(
        tag + " (e)", plan, [r["full"] for r in ranks],
        on_card)["flash_attention"]
    return counts


def check_serve_full(tag: str, plan: dict, full: list,
                     on_card: bool = True) -> dict:
    """A full-width sharded serve's checks and readings (`_lm_mesh_e_full`'s
    results from every rank): the model ranks of a row give it the same
    tokens, in the vocabulary; with the single card's reference, the
    ranks' rows of tokens against it (agreement and the first flipped
    position reported), the prefill logits within LM_LOGIT_ATOL of it with
    the same argmax wherever the top-2 gap exceeds twice the row's
    difference (their bf16 row error reported); each rank's attention
    launches one a layer on its local heads. Returns the launch counts
    summed over the ranks."""
    from repro_torch.kernels.flash_attn import row_error

    cfg = serve_config(plan)
    counts = {"flash_attention": 0}
    o = full[0]
    n = plan["batch"] // 2
    ref_t, ref_l = o.get("one_tokens"), o.get("one_logits")
    agree, flips, worst = [], [], 0.0
    for r in full:
        for m in full:      # the model ranks of a row agree
            if m["rank"] // 2 == r["rank"] // 2:
                check(torch.equal(m["tokens"], r["tokens"]),
                      f"{tag} ranks {r['rank']} and {m['rank']} give "
                      f"their rows other tokens")
        check(bool(((r["tokens"] >= 0) & (r["tokens"] < cfg.vocab_size))
                   .all()) and bool(torch.isfinite(r["logits"]).all()),
              f"{tag} rank {r['rank']}: tokens outside the vocabulary or "
              f"non-finite logits")
        if ref_t is None:
            continue
        d = r["rank"] // 2
        want_t, want_l = ref_t[d * n:(d + 1) * n], ref_l[d * n:(d + 1) * n]
        same = r["tokens"] == want_t
        if r["rank"] % 2 == 0:      # model rank 0 of its rows
            agree.append(float(same.float().mean()))
            for row in range(n):
                bad = (~same[row]).nonzero()
                flips.append(int(bad[0]) if len(bad) else None)
        got_l = r["logits"][:, :cfg.vocab_size]
        want_l = want_l[:, :cfg.vocab_size]
        diff = (got_l - want_l).abs().amax(-1)
        top2 = want_l.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > 2 * diff
        check(float(diff.max()) <= LM_LOGIT_ATOL,
              f"{tag} rank {r['rank']}: prefill logits differ from one "
              f"card's by {float(diff.max())} (atol {LM_LOGIT_ATOL})")
        check(bool((got_l.argmax(-1) == want_l.argmax(-1))[decided].all()),
              f"{tag} rank {r['rank']}: the first token differs from "
              f"one card's on a row whose top-2 gap exceeds twice its "
              f"difference")
        worst = max(worst, row_error(got_l, want_l))
    heads = [(cfg.n_heads // 2, cfg.n_kv_heads // 2)]
    on = on_card and plan.get("device", "cuda") == "cuda"
    for r in full:
        c = r["counts"]["flash_attention"]
        check(not on or c == cfg.n_layers, f"{tag} rank {r['rank']}: "
              f"{c} attention launches, not {cfg.n_layers} (one a layer)")
        check(r["heads"] == heads, f"{tag} rank {r['rank']}: the "
              f"attention ran on {r['heads']} (query, kv) heads, not "
              f"{heads}")
        counts["flash_attention"] += c
    coll, nbytes = o["decode_coll"]
    against = (f"tokens == one card's {[round(a, 3) for a in agree]} by "
               f"data rank (first flipped position by row {flips}); "
               f"prefill logits' bf16 row error against one card "
               f"{worst:.4f}" if ref_t is not None else "no single-card "
               "reference")
    log(f"{tag} {plan['arch']} full width, {cfg.n_layers} layers"
        f"{' (capacity with no drops)' if plan.get('no_drop') else ''}, "
        f"B={plan['batch']} x {plan['prompt']}, s_max {plan['s_max']}, "
        f"{plan['tokens']} greedy tokens on (data=2, model=2) over "
        f"{o['backend']}: {against}; prefill {o['prefill_ms']:.1f} ms, "
        f"decode {o['decode_ms']:.2f} ms a step (rank 0's host clock), "
        f"generate {o['generate_s']:.2f} s; sharded init {o['init_s']:.1f} "
        f"s; a rank holds "
        + ", ".join(f"{r['after_init'] / 2**30:.2f}" for r in full)
        + " GiB after init, peak "
        + ", ".join(f"{r['peak'] / 2**30:.2f}" for r in full)
        + " GiB; collectives a decode step on rank 0: "
        + ", ".join(f"{coll[k]} {k} ({nbytes[k] / 1e6:.3f} MB)"
                    for k in coll)
        + f"; attention launches by rank "
        f"{[r['counts']['flash_attention'] for r in full]} on (query, kv) "
        f"heads {o['heads']}")
    if "split" in o:
        split, _, busy, host, top = o["split"]
        log(f"{tag} one traced decode step on rank 0: {busy:.2f} ms of "
            f"device time in {host:.2f} ms on the host clock (idle share "
            f"{1 - busy / host:.3f}): " + ", ".join(
                f"{k} {v:.2f} ms" for k, v in split.items())
            + "; largest: " + "; ".join(f"{nm[:60]} {us / 1e3:.3f} ms"
                                        for nm, us in top[:5]))
    return counts


def check_lm_mesh_b(tag: str, refs: list, ranks: list,
                    on_card: bool = True) -> None:
    """(b)'s checks: every gradient within TRAIN_GRAD_REL of its leaf's
    scale (an SSM's: LM_MESH_SSD_GRAD_REL), the step's loss and grad norm
    within TRAIN_RTOL (an SSM's grad norm: LM_MESH_SSD_NORM_RTOL) of the
    reference's; on the card, the attention's launches on each rank: the
    gradients and the step, each twice the forward (remat) and once the
    backward an attention layer."""
    from repro_torch.models.transformer import hybrid_layout, layer_kind

    for i, (ref, g) in enumerate(zip(refs, ranks[0])):
        cfg = _reduced_cfg(ref["arch"], ref["over"])
        ssd = layer_kind(cfg) == "ssm"
        limit = LM_MESH_SSD_GRAD_REL if ssd else TRAIN_GRAD_REL
        worst = max(g["rel"], key=g["rel"].get)
        rel = g["rel"][worst]
        for key in ("loss", "grad_norm"):
            rtol = LM_MESH_SSD_NORM_RTOL if ssd and key == "grad_norm" \
                else TRAIN_RTOL
            want = g["want_" + key]
            check(abs(g[key] - want) <= rtol * abs(want),
                  f"{tag} (b) {g['name']}: {key} {g[key]} sharded on the "
                  f"card, {want} on the CPU ({ref['against']})")
        check(rel <= limit, f"{tag} (b) {g['name']}: the gradient of "
              f"{worst} differs from the CPU's by {rel:.3g} of its scale "
              f"(limit {limit:.3g})")
        n_attn = (0 if cfg.family == "ssm" else hybrid_layout(cfg)[0]
                  if cfg.family == "hybrid" else cfg.n_layers)
        n_attn *= max(cfg.grad_accum, 1)
        want_l = {"flash_attention": 4 * n_attn, FLASH_BWD: 2 * n_attn}
        for r, rank in enumerate(ranks):
            check(not on_card or rank[i]["launches"] == want_l,
                  f"{tag} (b) {g['name']}: attention launches "
                  f"{rank[i]['launches']} on rank {r}, not {want_l}")
        log(f"{tag} (b) reduced float32 {ref['arch']} {ref['over']} "
            f"({g['name']}, {g['mode']} heads at tp 2): loss "
            f"{g['loss']:.7f} / CPU {g['want_loss']:.7f}, grad norm "
            f"{g['grad_norm']:.7f} / {g['want_grad_norm']:.7f} (the CPU's "
            f"{'sharded step' if ref['against'] == 'mesh' else 'one device'}"
            f"); every gradient within {rel:.3g} of its leaf's scale "
            f"({worst}; limit {limit:.3g}); attention launches on each rank "
            f"{g['launches']}")


def reduced_mesh_check(device: str = "cuda") -> list:
    """[lm-mesh] (b) alone: LM_MESH_RANKS ranks spawned on ``device``, the
    reduced float32 configs in both head modes against the CPU's
    single-device step. Returns the ranks' readings."""
    from repro_torch.launch import mesh as launch_mesh

    refs = _reduced_cpu_refs()
    outs = launch_mesh.spawn(lm_mesh_rank, LM_MESH_RANKS, device,
                             ((), dict(reduced=refs, device=device)))
    check_lm_mesh_b("[lm-mesh]", refs, [o["b"] for o in outs],
                    torch.device(device).type == "cuda")
    return outs[0]["b"]


def _check_lm_mesh_a(tag: str, outs: list, plan: dict) -> dict:
    """(a)'s checks and readings, from the ranks' results: the sharded
    run's losses, grad norms and every gathered parameter after each step
    against the single-card step (rank 0's), within LM_MESH_SAFETY times
    the single-card spread; the launches and their head counts."""
    from repro_torch.launch.train import model_config
    from repro_torch.models.transformer import hybrid_layout

    o = outs[0]
    cfg = model_config(plan["arch"], plan.get("reduced", False),
                       plan["layers"])
    for r in outs:
        check(r["losses"] == o["losses"] and r["gnorms"] == o["gnorms"],
              f"{tag} the ranks report different losses or grad norms")
    worst = {"loss": 0.0, "grad_norm": 0.0, "params": 0.0}
    top = [0.0, 0.0]    # the spreads' running maxima over the steps
    for i, ((a_loss, a_gn), (s_loss, s_gn)) in enumerate(zip(o["ref"],
                                                           o["spread"])):
        top = [max(top[0], s_loss), max(top[1], s_gn)]
        for key, got, want, spread in (("loss", o["losses"][i], a_loss,
                                        top[0]),
                                       ("grad_norm", o["gnorms"][i], a_gn,
                                        top[1])):
            limit = max(LM_MESH_SAFETY * spread, 1e-6 * abs(want))
            worst[key] = max(worst[key], abs(got - want) / limit)
            check(abs(got - want) <= limit,
                  f"{tag} step {i}: {key} {got} sharded, {want} on one card "
                  f"(limit {limit:.3g}: {LM_MESH_SAFETY} x the single-card "
                  f"bf16-to-float32 spread {spread:.3g})")
        for leaf, err in o["errs"][i].items():
            limit = max(o["limits"][i][leaf], 1e-30)
            worst["params"] = max(worst["params"], err / limit)
            check(err <= limit, f"{tag} step {i}: {leaf} differs from the "
                  f"single-card step by {err:.3g}, limit {limit:.3g}")
        log(f"{tag} step {i}: loss {o['losses'][i]:.6f} sharded / "
            f"{a_loss:.6f} one card (spread {s_loss:.3g}), grad norm "
            f"{o['gnorms'][i]:.6f} / {a_gn:.6f} (spread {s_gn:.3g}); "
            f"parameters: largest error / limit "
            f"{max(e / o['limits'][i][k] for k, e in o['errs'][i].items()):.3f}"
            f" (limits: {LM_MESH_SAFETY} x each leaf's single-card bf16-to-"
            f"float32 spread, at least one bf16 ulp of its largest value; "
            f"e.g. embed "
            f"{o['errs'][i]['embed']:.3g} / {o['limits'][i]['embed']:.3g})")
    n_attn = (0 if cfg.family == "ssm" else hybrid_layout(cfg)[0]
              if cfg.family == "hybrid" else cfg.n_layers)
    per = n_attn * plan["steps"] * max(cfg.grad_accum, 1)
    heads = [(cfg.n_heads // 2, cfg.n_kv_heads // 2)] if n_attn else []
    on_card = plan.get("device", "cuda") == "cuda"   # else plain versions
    for r in outs:
        c = r["counts"]
        check(not on_card or (c["flash_attention"] == 2 * per
                              and c[FLASH_BWD] == per),
              f"{tag} rank {r['rank']}: {c['flash_attention']} forward and "
              f"{c[FLASH_BWD]} backward attention launches, not {2 * per} "
              f"and {per} (twice and once an attention layer a microbatch)")
        check(r["heads"] == heads, f"{tag} rank {r['rank']}: the "
              f"attention ran on {r['heads']} (query, kv) heads, not the "
              f"rank's {heads}")
    return worst


def _log_lm_mesh_timing(tag: str, outs: list, plan: dict) -> None:
    o = outs[0]
    steady = statistics.median(o["step_s"][1:]) if len(o["step_s"]) > 1 \
        else o["step_s"][0]
    tokens = plan["batch"] * plan["seq"]
    coll, nbytes, _ = o["coll"][-1]
    peaks = ", ".join(f"{r['peak'] / 2**30:.2f}" for r in outs)
    log(f"{tag} a step {[round(s * 1e3, 1) for s in o['step_s']]} ms on "
        f"rank 0's host clock (the first with warm-up), steady "
        f"{steady * 1e3:.1f} ms = {tokens / steady:.0f} tokens/s, "
        f"{tokens / steady / len(outs):.0f} a rank; peak memory a rank "
        f"{peaks} GiB; "
        f"collectives a step on a rank: " + ", ".join(
            f"{coll[k]} {k} ({nbytes[k] / 1e6:.1f} MB)" for k in coll))
    if "split" not in o:
        return
    split, _, busy, host, top = o["split"]
    log(f"{tag} one traced step on rank 0: {busy:.1f} ms of device time in "
        f"{host:.1f} ms on the host clock (idle share "
        f"{1 - busy / host:.3f}): " + ", ".join(
            f"{k} {v:.1f} ms" for k, v in split.items())
        + "; largest: " + "; ".join(f"{n[:60]} {us / 1e3:.2f} ms"
                                    for n, us in top[:5]))
    # the step's kernels and copies run one after another (a collective's
    # stream waits on the step's and the step's on it): more device time
    # than the host waited counts something twice
    check(busy <= host, f"{tag} the traced step's device time {busy:.1f} ms "
          f"exceeds its {host:.1f} ms on the host clock (idle share "
          f"{1 - busy / host:.3f} < 0)")


def phase_lm_mesh(root: str, plans: tuple = (LM_MESH_PLAN, LM_MESH_SSM_PLAN),
                  extras: bool = True) -> dict:
    """`[lm-mesh]`: sharded LM training and serving on a (data=2, model=2)
    mesh of LM_MESH_RANKS ranks spawned on the cards (gloo where they
    share one, NCCL with a card a rank), one spawn for every part: (a) for
    each of
    ``plans``: llama3.2-3b at full width, 2 layers, B=4 x 1024, AdamW on
    the launcher's schedule, 3 steps through `launch.train.train_loop`,
    then mamba2-1.3b the same way (2 layers, 2 steps), each held to the
    single-card step from the same seed (`_check_lm_mesh_a`), counted:
    each rank's attention launches (twice and once an attention layer a
    microbatch) on its local heads (llama: 12 of 24 query and 4 of 8 kv;
    mamba2: none); (b) the reduced float32 configs (`LM_MESH_REDUCED`:
    both head modes, the ssm kind, the hybrid, the MoE in both
    expert-parallel modes) on the ranks: every gradient within
    TRAIN_GRAD_REL of its leaf's scale (an SSM's: LM_MESH_SSD_GRAD_REL) and
    a step's loss and grad norm within TRAIN_RTOL of the CPU's step (one
    device's, or for the MoE the same sharded step on CPU tensors), each
    rank's attention launches counted; (c) the first plan's state saved
    sharded and restored onto one card and onto (data=1, model=2): equal
    to the gathered state bit for bit; (d) `compress.compressed_psum`
    over a 2-rank pod axis == the CPU's arithmetic; (e) sharded serving
    (`check_lm_mesh_e`). Step time, tokens/s, peak memory and collectives
    a rank, and one traced step's device time split. Returns the launch
    counts of (a), (b) and (e) summed over the ranks and plans, and (b)'s
    hybrid's attention launches over the ranks."""
    from repro_torch.launch import mesh as launch_mesh

    tag = "[lm-mesh]"
    extras = dict(ckpt_dir=str(pathlib.Path(root) / "ckpt"),
                  reduced=_reduced_cpu_refs(), psum=True,
                  serve=dict(reduced=LM_MESH_SERVE_REDUCED,
                             full=LM_MESH_SERVE_PLAN)) if extras else {}
    device = plans[0].get("device", "cuda")
    t0 = time.time()
    outs = launch_mesh.spawn(lm_mesh_rank, LM_MESH_RANKS, device,
                             (tuple(plans), extras))
    devices = sorted({o["device"] for o in outs})
    how = ("a card a rank" if len(devices) == LM_MESH_RANKS else
           "sharing a card: this checks the code and its arithmetic, not "
           "NVLink")
    log(f"{tag} {LM_MESH_RANKS} ranks on {devices} over "
        f"{outs[0]['backend']} ({how}): rendezvous "
        f"{max(o['t_enter'] for o in outs) - t0:.1f} s, the ranks' whole "
        f"work {time.time() - t0:.1f} s")
    names = list(outs[0]["marks"])
    log(f"{tag} rank 0's time by part: " + ", ".join(
        f"{b} {outs[0]['marks'][b] - outs[0]['marks'][a]:.1f} s"
        for a, b in zip(names, names[1:])))
    counts = {}
    for i, plan in enumerate(plans):
        subs = [o["a"][i] for o in outs]
        o = subs[0]
        log(f"{tag} (a) {plan['arch']} steps "
            f"{[round(x * 1e3, 1) for x in o['step_s']]} ms, losses "
            f"{o['losses']} sharded / {[r[0] for r in o['ref']]} one card")
        log(f"{tag} (a) {plan['arch']} {plan['layers'] or 'all'} layers, "
            f"B={plan['batch']} x {plan['seq']}, {plan['steps']} steps on a "
            f"(data=2, model=2) mesh through train_loop")
        worst = _check_lm_mesh_a(tag, subs, plan)
        log(f"{tag} (a) {plan['arch']} == the single-card step: worst "
            f"error / limit: loss {worst['loss']:.3f}, grad norm "
            f"{worst['grad_norm']:.3f}, parameters {worst['params']:.3f}; "
            f"launches a rank {o['counts']} on (query, kv) heads "
            f"{o['heads']}")
        _log_lm_mesh_timing(f"{tag} (a) {plan['arch']}", subs, plan)
        for r in subs:
            for k, n in r["counts"].items():
                counts[k] = counts.get(k, 0) + n
    if not extras:
        return dict(counts=counts, outs=outs)

    on_card = torch.device(device).type == "cuda"
    check_lm_mesh_b(tag, extras["reduced"], [o["b"] for o in outs], on_card)
    hybrid = [i for i, r in enumerate(extras["reduced"])
              if r["name"] == "hybrid"][0]
    for o in outs:
        for b in o["b"]:
            for k, n in b["launches"].items():
                counts[k] = counts.get(k, 0) + n
    first = [o["a"][0] for o in outs]
    check(first[0]["c_1x2"] and first[1]["c_1x2"] and first[0]["c_one"],
          f"{tag} (c) a restored checkpoint differs from the gathered state")
    log(f"{tag} (c) (a)'s state saved sharded ({first[0]['c_leaves']} "
        f"leaves), restored onto one card and onto (data=1, model=2): "
        f"== the gathered state, bit for bit")
    want = _psum_plain()
    check(all(all(np.array_equal(a, b) for a, b in zip(o["d"], want))
              for o in outs), f"{tag} (d) compressed_psum differs from the "
          f"CPU's arithmetic")
    log(f"{tag} (d) compressed_psum over a 2-rank pod axis, leaves "
        f"{LM_MESH_PSUM}: == the CPU's int8 mean on every rank")
    served = check_lm_mesh_e(tag, LM_MESH_SERVE_REDUCED, LM_MESH_SERVE_PLAN,
                             [o["e"] for o in outs], on_card)
    counts["flash_attention"] += served["flash_attention"]
    return dict(counts=counts, outs=outs, hybrid_launches={
        k: sum(o["b"][hybrid]["launches"][k] for o in outs)
        for k in ("flash_attention", FLASH_BWD)})


MATMUL_NAMES = ("gemm", "nvjet", "xmma", "cutlass", "matmul")


def dryrun_side(out_path: str) -> None:
    """`[dryrun]`'s host side, run in a subprocess of the script (a fake
    group wants a process with no group; the dry run starts no CUDA
    context): (a) `[train]`'s llama3.2-3b step on meta tensors, (b) each
    rank's collectives of `[lm-mesh]` (a)'s first cell on a fake (data=2,
    model=2) group, (c) the production cells `DRYRUN_CELLS`; written to
    ``out_path`` as JSON."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(2)     # the card's phases share the host's cores
    t0 = time.perf_counter()
    cfg = launch_train.model_config(LM_ARCH)
    state, step_fn = launch_train.build(cfg, steps=TRAIN_STEPS,
                                        device="meta", seed=SEED)
    batch = {"tokens": torch.empty((TRAIN_BATCH, TRAIN_SEQ),
                                   dtype=torch.int32, device="meta")}
    out = {"a": dryrun.timed_analysis(step_fn, (state, batch)), "b": [],
           "c": []}
    del state, step_fn
    plan = LM_MESH_PLAN
    cell = launch_train.model_config(plan["arch"], layers=plan["layers"])
    shape = ShapeConfig("lm-mesh (a)", plan["seq"], plan["batch"], "train")
    for rank in range(LM_MESH_RANKS):
        with dryrun.fake_group(LM_MESH_RANKS, rank):
            mesh = make_host_mesh(LM_MESH_RANKS, ("data", "model"),
                                  device="cpu")
            out["b"].append(dryrun.timed_analysis(
                *dryrun.cell_inputs(cell, shape, mesh))["collectives"])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as d:
        for arch, shape_name, multi in DRYRUN_CELLS:
            out["c"].append(dryrun.run_ga_cell(multi, d, force=True)
                            if shape_name is None else
                            dryrun.run_cell(arch, shape_name, multi, d,
                                            force=True))
    out["seconds"] = time.perf_counter() - t0
    pathlib.Path(out_path).write_text(json.dumps(out))


def start_dryrun(out_path: str) -> subprocess.Popen:
    """`dryrun_side` in a subprocess, its output in ``out_path``.log;
    stopped when the script exits."""
    log_file = open(out_path + ".log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "chip_smoke.dryrun_side(sys.argv[1])", out_path], cwd=ROOT,
        stdout=log_file, stderr=subprocess.STDOUT)
    log_file.close()
    atexit.register(_stop, proc)
    return proc


def _stop(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def phase_dryrun(proc: subprocess.Popen, out_path: str, card: dict,
                 lm_mesh_outs: list) -> None:
    """`[dryrun]`'s checks (module doc, phase 18): (a) against `[train]`'s
    card step (``card``), (b) against `[lm-mesh]` (a)'s ranks
    (``lm_mesh_outs``), (c) the records printed."""
    from repro_torch.launch import dryrun, step_analysis

    tag = "[dryrun]"
    t0 = time.perf_counter()
    try:
        proc.wait(timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        _stop(proc)
        fail(f"{tag} the dry run took over {DRYRUN_TIMEOUT_S} s")
    check(proc.returncode == 0, f"{tag} the dry run failed (exit "
          f"{proc.returncode}):\n" + pathlib.Path(out_path + ".log")
          .read_text()[-4000:])
    got = json.loads(pathlib.Path(out_path).read_text())
    log(f"{tag} the host's subprocess: {got['seconds']:.1f} s, beside the "
        f"card's phases ({time.perf_counter() - t0:.1f} s waited for it)")

    a = got["a"]
    peak, card_peak = a["memory"]["peak_bytes"], card["max_memory_allocated"]
    gap = (peak - card_peak) / card_peak
    log(f"{tag} (a) {LM_ARCH} full depth, B={TRAIN_BATCH} x {TRAIN_SEQ}, "
        f"AdamW, one card: FLOPs {a['flops']:.6e} on meta, "
        f"{card['flops']:.6e} on the card (kernels: "
        f"{card['kernel_flops']}); peak {peak / 2**30:.2f} GiB on meta, "
        f"{card_peak / 2**30:.2f} GiB max_memory_allocated on the card "
        f"({gap:+.2%}; the card's own storage count "
        f"{card['memory']['peak_bytes'] / 2**30:.2f} GiB); meta analysis "
        f"{a['seconds']:.1f} s on the host")
    check(a["flops"] == card["flops"], f"{tag} (a) the meta step's FLOPs "
          f"{a['flops']} differ from the card step's {card['flops']}")
    check(abs(gap) <= DRYRUN_PEAK_RTOL, f"{tag} (a) the meta peak "
          f"{peak} B is {gap:+.2%} off the card's {card_peak} B (limit "
          f"{DRYRUN_PEAK_RTOL:.0%})")

    kinds = step_analysis.JAX_KIND
    for o in lm_mesh_outs:
        want = got["b"][o["rank"]]
        for i, (counts, sent, result) in enumerate(o["a"][0]["coll"]):
            for kind, name in kinds.items():
                check((counts[kind], result[kind], sent[kind]) == (
                    want[name]["count"], want[name]["bytes"],
                    want[name]["sent_bytes"]),
                      f"{tag} (b) rank {o['rank']} step {i}: {kind} "
                      f"{counts[kind]} calls, {result[kind]} result and "
                      f"{sent[kind]} sent bytes on gloo; the dry run: "
                      f"{want[name]}")
    w0 = got["b"][0]
    log(f"{tag} (b) [lm-mesh] (a)'s {LM_MESH_PLAN['arch']} cell on a fake "
        f"group of {LM_MESH_RANKS}: every rank's collectives == its gloo "
        f"rank's in each of the {len(lm_mesh_outs[0]['a'][0]['coll'])} "
        f"steps; rank 0 a step: " + ", ".join(
            f"{w0[n]['count']} {n} ({w0[n]['bytes'] / 2**20:.1f} MiB "
            f"result, {w0[n]['sent_bytes'] / 2**20:.1f} MiB sent)"
            for n in kinds.values()))

    for rec in got["c"]:
        check(rec["status"] == "ok", f"{tag} (c) {rec['arch']} "
              f"{rec['shape']} {rec['mesh']}: {rec.get('error')}")
        secs = [r["seconds"] for r in rec["ranks"].values()]
        log(f"{tag} (c) {dryrun.summary(rec)} (ranks "
            f"{sorted(rec['ranks'], key=int)}, {sum(secs):.1f} s; "
            f"predictions, not card measurements)")


EXAMPLE_FILES = ("torch_quickstart.py", "torch_distributed_ga.py",
                 "torch_lm_serve.py", "torch_lm_train.py",
                 "torch_lm_quant_search.py")


def _front(out: str) -> list:
    lines = out.splitlines()
    i = lines.index("pareto front (acc_loss, normalized area):")
    return [ln for ln in lines[i + 1:] if ln.startswith("  ")]


def phase_examples() -> None:
    """`[examples]` (module doc, phase 19): each example and the search
    CLI at the quickstart's defaults, all started at once on the card;
    each one's exit code and wall time."""
    import os

    tag = "[examples]"
    cmds = {name: [sys.executable, str(ROOT / "examples" / name)]
            for name in EXAMPLE_FILES}
    cmds["python -m repro_torch.search"] = [
        sys.executable, "-m", "repro_torch.search", "--pop", "64", "--gens",
        "40"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as d:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=d)
        procs, done, outs = {}, {}, {}
        t0 = time.perf_counter()
        for i, (name, cmd) in enumerate(cmds.items()):
            with open(pathlib.Path(d) / f"{i}.log", "w") as f:
                procs[name] = subprocess.Popen(cmd, cwd=ROOT, env=env,
                                               stdout=f,
                                               stderr=subprocess.STDOUT)
        try:
            while len(done) < len(procs):
                check(time.perf_counter() - t0 < EXAMPLES_TIMEOUT_S,
                      f"{tag} {sorted(set(procs) - set(done))} still "
                      f"running after {EXAMPLES_TIMEOUT_S} s")
                for name, p in procs.items():
                    if name not in done and p.poll() is not None:
                        done[name] = time.perf_counter() - t0
                time.sleep(0.2)
        finally:
            for p in procs.values():
                _stop(p)
        for i, name in enumerate(cmds):
            outs[name] = (pathlib.Path(d) / f"{i}.log").read_text()
    for name, p in procs.items():
        check(p.returncode == 0, f"{tag} {name} exited {p.returncode}:\n"
              + outs[name][-3000:])
    log(f"{tag} {len(cmds)} processes at once on the card, each at its "
        f"defaults, exit 0; seconds to exit: " + ", ".join(
            f"{name} {done[name]:.1f}" for name in cmds))
    q, cli = outs[EXAMPLE_FILES[0]], outs["python -m repro_torch.search"]
    check(_front(q) == _front(cli) and _front(q), f"{tag} the quickstart's "
          f"front differs from the search CLI's")
    ga = outs[EXAMPLE_FILES[1]]
    check("restored onto 4 ranks: [48, 48, 48, 48] rows a rank" in ga,
          f"{tag} the distributed GA's elastic restart:\n{ga[-2000:]}")
    log(f"{tag} the quickstart's front ({len(_front(q))} points) == the "
        f"search CLI's; the distributed GA restarted 8 islands' checkpoint "
        f"on 4 ranks of 48 rows; " + "; ".join(
            ln for name in EXAMPLE_FILES[2:] for ln in outs[name].splitlines()
            if ln.startswith(("throughput", "final loss", "@<="))))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA "
             "device and prints no result without one")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    from repro_torch import kernels, search
    from repro_torch.core.train import train_tree
    from repro_torch.core.tree import to_parallel
    from repro_torch.datasets import load_dataset
    from repro_torch.families import printed_mlp as pm

    t_start = time.perf_counter()
    dry_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_")
    dry_out = str(pathlib.Path(dry_dir.name) / "dryrun.json")
    dry_proc = start_dryrun(dry_out)
    phase_build()

    t0 = time.perf_counter()
    ds = load_dataset(DATASET)
    tree = train_tree(ds.x_train, ds.y_train, ds.n_classes)
    problem = search.build_problem(to_parallel(tree), ds.x_test, ds.y_test,
                                   device="cuda")
    log(f"[setup] {DATASET} tree: N={problem.n_comparators} "
        f"L={problem.n_leaves} B={problem.x8.shape[0]} "
        f"C={problem.n_classes} F={problem.n_features}, exact accuracy "
        f"{problem.exact_accuracy:.6f} ({time.perf_counter() - t0:.1f} s to "
        f"load, train and build)")
    mlp_problems = {}
    for name, _ in MLP_RUNS:
        t0 = time.perf_counter()
        mp = pm.build_problem(name, n_hidden=MLP_HIDDEN, seed=SEED,
                              device="cuda")
        mlp_problems[name] = mp
        log(f"[setup] {name} mlp: F={mp.n_features} H={mp.n_hidden} "
            f"C={mp.n_classes} B={mp.x8.shape[0]} shift={mp.shift}, exact "
            f"accuracy {mp.exact_accuracy:.6f}, exact area "
            f"{mp.exact_area_mm2:.2f} mm^2 ({time.perf_counter() - t0:.1f} s "
            f"to load, train and build)")

    rng = np.random.default_rng(SEED)
    results = phase_kernels(problem, rng)
    results["qmatmul"] = phase_qmatmul(mlp_problems[MLP_RUNS[0][0]], rng)
    flash_rows = phase_flash(rng)
    results["flash_attention"] = flash_rows["flash_attention"]
    bwd_rows = phase_flash_backward()
    results[FLASH_BWD] = bwd_rows[FLASH_BWD]
    launches = dict.fromkeys(kernels.KERNEL_WRAPPERS, 0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        tree_path = phase_main_path(problem, out_dir)
    mlp_paths = {}
    for name, pop in MLP_RUNS:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mlp_") as out_dir:
            mlp_paths[name] = phase_mlp_path(mlp_problems[name], name, pop,
                                             out_dir)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_forest_") as out_dir:
        forest_path = phase_forest(rng, out_dir)
    lm_path = phase_lm()
    torch.cuda.empty_cache()
    train_path = phase_train()
    torch.cuda.empty_cache()
    ssm_paths = {arch: phase_ssm(arch) for arch in SSM_ARCHS}
    moe_paths = {arch: phase_moe(arch, n) for arch, n in MOE_ARCHS}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sweep_") as d:
        sweep_path = phase_sweep(rng, d)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_faults_") as d:
        faults_path = phase_faults(tree_path["art"],
                                   mlp_paths[MLP_RUNS[1][0]]["art"],
                                   forest_path["art"], d)
    results["fault_lanes"] = faults_path["row"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as d:
        mesh_path = phase_mesh(problem, tree_path, sweep_path, d, rng)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_mesh_") as d:
        lm_mesh_path = phase_lm_mesh(d)
    phase_dryrun(dry_proc, dry_out, train_path["dryrun_card"],
                 lm_mesh_path["outs"])
    dry_dir.cleanup()
    for path in (tree_path, *mlp_paths.values(), forest_path, lm_path,
                 train_path, *ssm_paths.values(), *moe_paths.values(), sweep_path,
                 faults_path, mesh_path, lm_mesh_path):
        for name, count in path["counts"].items():
            launches[name] += count
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main paths never launched: {launches}")
    for name, count in launches.items():
        results[name]["launches"] = count
        results[name]["what"] = TPU_KERNELS[name][2]
    check(all(row["launches"] > 0 for row in sweep_path["rows"].values()),
          "a batched kernel never launched in the campaign")
    results[FLASH_112] = flash_rows[FLASH_112]
    results[FLASH_112]["launches"] = \
        ssm_paths[SSM_ARCHS[1]]["counts"]["flash_attention"]
    results[FLASH_112]["what"] = (
        "bf16 zamba2-7b prefill, q, k and v (4, 4096, 32, 112), the model's "
        "layout: the HD=128 tiles on 112-column TMA maps (1.14x the work); "
        "launches: the [ssm] zamba2-7b generate's")
    results[FLASH_SOFTCAP] = flash_rows[FLASH_SOFTCAP]
    results[FLASH_SOFTCAP]["launches"] = \
        moe_paths[MOE_ARCHS[0][0]]["counts"]["flash_attention"]
    results[FLASH_SOFTCAP]["what"] = (
        "bf16 grok-1-314b prefill, q (4, 4096, 48, 128), k and v (4, 4096, "
        "8, 128), the model's layout, tanh softcap 30; no library call (SDPA "
        "has no softcap); launches: the [moe] grok-1-314b generate's")
    results[FLASH_BWD_112] = bwd_rows[FLASH_BWD_112]
    results[FLASH_BWD_112]["launches"] = \
        lm_mesh_path["hybrid_launches"][FLASH_BWD]
    results[FLASH_BWD_112]["what"] = (
        "bf16 zamba2-7b shapes, q, o, dout, k and v (2, 4096, 32, 112), the "
        "model's layout, no GQA grouping; launches: [lm-mesh] (b)'s sharded "
        "reduced float32 zamba2-7b at head dim 112 over its 4 ranks (the "
        "float32 kernels; tools/lm_mesh_check.py (g) counts the bf16 ones "
        "at full width)")
    results[FLASH_BWD_SOFTCAP] = bwd_rows[FLASH_BWD_SOFTCAP]
    results[FLASH_BWD_SOFTCAP]["launches"] = \
        train_path["by_arch"][GROK_TRAIN[0]][FLASH_BWD]
    results[FLASH_BWD_SOFTCAP]["what"] = (
        "bf16 grok-1-314b training microbatch, q, o, dout (1, 4096, 48, "
        "128), k and v (1, 4096, 8, 128), tanh softcap 30; no library call "
        "(SDPA has no softcap); launches: the [train] grok-1-314b steps'")
    results.update(sweep_path["rows"])
    results.update(mesh_path["rows"])

    from repro_torch.search import make_kernel_fitness
    phase_breakdown(f"tree {DATASET}", make_kernel_fitness(problem),
                    tree_path["state"], problem.n_genes, problem.device,
                    "fitness_mma_kernel")
    mp = mlp_problems[MLP_RUNS[0][0]]
    phase_breakdown(f"mlp {MLP_RUNS[0][0]}", pm.make_kernel_fitness(mp),
                    mlp_paths[MLP_RUNS[0][0]]["state"], mp.n_genes,
                    mp.device, "qmatmul_u8")

    for what, prob, fit in (
            (f"tree {DATASET}", problem, make_kernel_fitness(problem)),
            (f"mlp {MLP_RUNS[0][0]}", mp, pm.make_kernel_fitness(mp))):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_chunk_") as d:
            phase_chunk(what, prob, fit, d)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as d:
        phase_resume(problem, d)
    torch.cuda.empty_cache()
    phase_examples()

    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    log("kernels: " + ", ".join(results))
    log(smi_line())
    log(json.dumps({"kernels": list(results.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
