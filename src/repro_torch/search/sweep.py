"""The full-suite campaign: the paper's ten datasets in a handful of
batched programs.

The counterpart of `repro.search.sweep`. `run_search` drives one problem
at a time; the paper's evaluation is one campaign over ten datasets
(Tables I/II), which this module runs bucket by bucket:

  1. **Pad** every problem to power-of-two bucket shapes (`pad_problem`)
     with *inert* padding: padded comparators carry zero path columns and
     threshold 0.5 (and are masked out of the area by `comp_valid`),
     padded leaves an all-zero path row with target 1, which no score
     reaches, padded samples the label -1, which no prediction matches.
     On the real rows a padded prediction equals the unpadded one, and
     genes in pad columns never move an objective bit.
  2. **Bucket** problems of one family sharing a padded shape
     (`plan_buckets`), greedily merging the pair that costs the least
     extra padded work until at most ``max_buckets`` remain.
  3. **Stack and advance**: a bucket's padded problems stack on a leading
     problem axis (`stack_padded`) and `nsga2.make_batched_init` /
     `make_batched_chunk` advance every member at once: on the card the
     fitness kernel and the non-dominated sort each launch once per
     generation for the whole bucket, and the chunk of generations is one
     captured CUDA graph. `SweepResult.n_dispatches` is 2 per bucket
     against 2 per dataset for the serial loop.

The serial loop (``vmapped=False``, the JAX package's name for the batched
path's switch) is the oracle: it runs the SAME padded
problems one at a time through the unbatched `nsga2.make_chunk`, and the
two give equal populations array for array. Each problem draws from its
own generator, seeded from (seed, its index in the name-sorted campaign),
so its numbers do not depend on the plan beyond its padded gene count.

The padded objectives are the JAX package's padded formula, operation for
operation: accuracy the float32 division of the correct count by the real
sample count, area ``(units * AREA_QUANTUM_MM2 + overhead_mm2) /
exact_area_mm2`` in float32 over the integer-quanta LUT. They differ from
`search.problem.objectives` (a reciprocal product, and integer quanta over
integer quanta) by float32 rounding; the exact design's area they divide
by is the JAX package's float-LUT sum (`_float_lut_areas`).

Each problem's final population is unpadded and written through the
single-run pipeline (`pareto.json`, ``emit_rtl``, ``verify_rtl``);
`write_sweep_report` scores the campaign against the paper's Tables I/II.

CLI: ``python -m repro_torch.search sweep --datasets all --report``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core import area as area_mod
from repro_torch.core import nsga2, quant
from repro_torch.kernels import fitness as _fit
from repro_torch.kernels import ops as kops
from repro_torch.search import engine as _engine
from repro_torch.search.problem import SearchProblem

GRANULE = 8            # minimum padded extent per axis
DEFAULT_MAX_BUCKETS = 6


# ---------------------------------------------------------------------------
# padding
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PaddedProblem:
    """One `SearchProblem` padded to bucket shapes with inert genes (see
    the module doc), or a bucket of them stacked on a leading problem axis
    (`stack_padded`). ``fit_ops`` holds the fitness kernel's operands of
    the padded problem (stacked with it)."""

    feature: torch.Tensor          # ([K,] Np) int32
    threshold: torch.Tensor        # ([K,] Np) float32
    path: torch.Tensor             # ([K,] Lp, Np) int8
    path_len: torch.Tensor         # ([K,] Lp) int32 (1 on padded leaves)
    n_neg: torch.Tensor            # ([K,] Lp) int32
    leaf_class: torch.Tensor       # ([K,] Lp) int32 (0 on padded leaves)
    x8: torch.Tensor               # ([K,] Bp, Fp) int32
    x_sel: torch.Tensor            # ([K,] Bp, Np) int32 hoisted x8[:, feature]
    y: torch.Tensor                # ([K,] Bp) int32 (-1 on padded rows)
    comp_valid: torch.Tensor       # ([K,] Np) bool
    n_valid: torch.Tensor          # ([K]) float32 real sample count
    area_lut_units: torch.Tensor   # ([K,] LUT) float32 integer quanta
    lut_offsets: torch.Tensor      # ([K,] MAX_BITS + 1) int64
    overhead_mm2: torch.Tensor     # ([K]) float32
    exact_area_mm2: torch.Tensor   # ([K]) float32
    exact_accuracy: torch.Tensor   # ([K]) float32
    vote_units_exact: torch.Tensor   # ([K]) float32 integer quanta
    vote_units_approx: torch.Tensor  # ([K]) float32 (both 0 for one tree)
    n_classes: int                 # Cp
    fit_ops: _fit.FitnessOperands  # the fitness kernel's operands

    @property
    def n_genes(self) -> int:
        # 3 genes per padded comparator slot + the trailing vote gene
        return 3 * int(self.feature.shape[-1]) + 1

    @property
    def stacked(self) -> bool:
        return self.feature.dim() == 2


def round_up_pow2(n: int, granule: int = GRANULE) -> int:
    """Next power of two >= max(n, granule): the bucket boundary per axis."""
    n = max(int(n), int(granule))
    p = 1
    while p < n:
        p <<= 1
    return p


def problem_dims(problem: SearchProblem) -> tuple[int, int, int, int, int]:
    """Real (unpadded) operand extents: (N, L, C, F, B)."""
    return (problem.n_comparators, problem.n_leaves, problem.n_classes,
            problem.n_features, int(problem.x8.shape[0]))


def _float_lut_areas(problem: SearchProblem) -> tuple[float, float]:
    """(overhead, exact design) in mm^2 as the JAX package's
    `build_problem` prices them: the float32 mm^2 LUT summed in numpy, then
    the float overheads and vote adder. The padded area's constants, so
    that the padded objectives equal the JAX package's; `SearchProblem`'s
    own are whole quanta (`exact_units`), which can round to another
    float32."""
    lut, offsets = area_mod.build_area_lut()
    thr = problem.threshold.cpu().numpy().astype(np.float64)
    t8 = np.clip(np.floor(thr * 256.0), 0, 255).astype(np.int64)
    overhead = area_mod.tree_overhead_mm2(problem.n_comparators,
                                          problem.n_leaves)
    vote = area_mod.vote_adder_area_mm2(problem.n_trees, problem.n_classes,
                                        approx=False)
    return (float(overhead),
            float(lut[offsets[quant.MAX_BITS] + t8].sum() + overhead + vote))


def pad_problem(problem: SearchProblem,
                dims: tuple[int, int, int, int, int]) -> PaddedProblem:
    """Pad a `SearchProblem` to `dims` = (Np, Lp, Cp, Fp, Bp) on its
    device (see the module doc)."""
    np_, lp, cp, fp, bp = dims
    n, l, c, f, b = problem_dims(problem)
    if not (np_ >= n and lp >= l and cp >= c and fp >= f and bp >= b):
        raise ValueError(f"padded dims {dims} smaller than problem dims "
                         f"{(n, l, c, f, b)}")

    def host(t):
        return t.cpu().numpy()

    feature = np.zeros(np_, np.int32)
    feature[:n] = host(problem.feature)
    threshold = np.full(np_, 0.5, np.float32)
    threshold[:n] = host(problem.threshold)
    path = np.zeros((lp, np_), np.int8)
    path[:l, :n] = host(problem.path)
    path_len = np.ones(lp, np.int32)              # unreachable target for pads
    path_len[:l] = host(problem.path_len)
    n_neg = np.zeros(lp, np.int32)
    n_neg[:l] = host(problem.n_neg)
    leaf_class = np.zeros(lp, np.int32)           # padded leaves never vote
    leaf_class[:l] = host(problem.leaf_class)
    x8 = np.zeros((bp, fp), np.int32)
    x8[:b, :f] = host(problem.x8)
    y = np.full(bp, -1, np.int32)
    y[:b] = host(problem.y)
    comp_valid = np.zeros(np_, bool)
    comp_valid[:n] = True
    lut_units, offsets = area_mod.build_area_unit_lut()
    x_sel = x8[:, feature]

    dev = problem.device

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    def f32(v):
        return torch.full((), float(np.float32(v)), dtype=torch.float32,
                          device=dev)

    overhead_mm2, exact_area_mm2 = _float_lut_areas(problem)
    return PaddedProblem(
        feature=t(feature), threshold=t(threshold), path=t(path),
        path_len=t(path_len), n_neg=t(n_neg), leaf_class=t(leaf_class),
        x8=t(x8), x_sel=t(x_sel), y=t(y), comp_valid=t(comp_valid),
        n_valid=f32(b),
        area_lut_units=t(lut_units.astype(np.float32)),
        lut_offsets=t(offsets, torch.int64),
        overhead_mm2=f32(overhead_mm2),
        exact_area_mm2=f32(exact_area_mm2),
        exact_accuracy=f32(problem.exact_accuracy),
        vote_units_exact=f32(problem.vote_units_exact),
        vote_units_approx=f32(problem.vote_units_approx),
        n_classes=int(cp),
        fit_ops=kops.prepare_fitness_operands(
            t(x_sel), t(y), t(path), t(path_len), t(n_neg), t(leaf_class),
            cp))


def stack_padded(padded: list) -> "PaddedProblem":
    """Stack same-shape padded problems (of one family) on a leading
    problem axis: tensors stacked (uint8 codes into one `code_buffer`, rows
    16-byte aligned for the `qmatmul` kernel), kernel operands through
    `fitness.stack_operands`, integers shared."""
    from repro_torch.kernels.qmatmul import code_buffer

    first = padded[0]
    out = {}
    for f in dataclasses.fields(first):
        vals = [getattr(p, f.name) for p in padded]
        if isinstance(vals[0], torch.Tensor):
            out[f.name] = torch.stack(vals)
            if vals[0].dtype == torch.uint8:
                out[f.name] = code_buffer(out[f.name])
        elif isinstance(vals[0], _fit.FitnessOperands):
            out[f.name] = _fit.stack_operands(vals)
        else:
            if any(v != vals[0] for v in vals):
                raise ValueError(f"cannot stack {f.name}: {vals}")
            out[f.name] = vals[0]
    return type(first)(**out)


# ---------------------------------------------------------------------------
# padded evaluation (the JAX package's padded formula)
# ---------------------------------------------------------------------------

def _per_problem(pp: PaddedProblem, x: torch.Tensor) -> torch.Tensor:
    """A per-problem value against (..., P) results: ([K], 1) for a stacked
    bucket, as it is for one problem."""
    return x[..., None] if pp.stacked else x


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` per problem: table ([K,] T), idx ([K,] ...)."""
    if table.dim() == 1:
        return table[idx]
    base = torch.arange(table.shape[0], device=idx.device) * table.shape[1]
    return table.reshape(-1)[idx + base.view(-1, *([1] * (idx.dim() - 1)))]


def _padded_decode(pp: PaddedProblem, genes: torch.Tensor):
    """ONE gene decode shared by predictions and area: the EFFECTIVE
    (bits, t_sub, vote_cap), truncation folded in; genes ([K,] P, 3Np+1)
    against a (stacked) padded problem, or one chromosome (3Np+1,)."""
    bits, margin, trunc, vote = quant.decode_tree_genes(genes)
    t_int = quant.threshold_to_int(pp.threshold.unsqueeze(-2)
                                   if genes.dim() > 1 else pp.threshold, bits)
    t_sub = quant.substitute(t_int, margin, bits)
    return bits - trunc, t_sub >> trunc, quant.vote_cap_of(vote)


def _padded_predict_decoded(pp: PaddedProblem, bits, t_sub, vote_cap):
    """(..., Bp) voted class from decoded operands (..., Np) of ONE padded
    problem: the plain float32 dataflow."""
    x_p = quant.inputs_at_precision(pp.x_sel, bits[..., None, :])
    d = (x_p > t_sub[..., None, :]).to(torch.float32)
    score = d @ pp.path.T.to(torch.float32)
    target = (pp.path_len - pp.n_neg).to(torch.float32)
    sat = (score == target).to(torch.float32)
    votes = sat @ torch.nn.functional.one_hot(
        pp.leaf_class.long(), pp.n_classes).to(torch.float32)
    votes = torch.minimum(votes, vote_cap[..., None, None].to(torch.float32))
    return torch.argmax(votes, dim=-1)


def padded_predict(pp: PaddedProblem, genes: torch.Tensor) -> torch.Tensor:
    """(Bp,) voted class per sample of one padded chromosome (3Np+1,); on
    the real rows it equals `search.predict_votes` with the real genes."""
    return _padded_predict_decoded(pp, *_padded_decode(pp, genes))


def _padded_area(pp: PaddedProblem, bits, t_sub, vote_cap) -> torch.Tensor:
    """Normalised area: masked integer-quanta LUT sum (exact in float32 in
    any order) plus the vote adder of the decoded mode, scaled to mm^2 once
    and divided by the exact design's area, all float32."""
    idx = _take(pp.lut_offsets, bits.long()) + t_sub.long()
    valid = pp.comp_valid.unsqueeze(-2) if pp.stacked else pp.comp_valid
    units = torch.where(valid, _take(pp.area_lut_units, idx), 0.0).sum(-1)
    units = units + torch.where(vote_cap == 1,
                                _per_problem(pp, pp.vote_units_approx),
                                _per_problem(pp, pp.vote_units_exact))
    quantum = torch.full((), area_mod.AREA_QUANTUM_MM2, dtype=torch.float32,
                         device=units.device)
    return ((units * quantum + _per_problem(pp, pp.overhead_mm2))
            / _per_problem(pp, pp.exact_area_mm2))


def padded_objectives(pp: PaddedProblem, genes: torch.Tensor) -> torch.Tensor:
    """(accuracy loss, normalized area) of one padded chromosome (3Np+1,):
    the plain dataflow, the JAX package's `padded_objectives` operation for
    operation (accuracy a float32 division by the real sample count)."""
    bits, t_sub, vote_cap = _padded_decode(pp, genes)
    pred = _padded_predict_decoded(pp, bits, t_sub, vote_cap)
    acc = (pred == pp.y).sum().to(torch.float32) / pp.n_valid
    return torch.stack([pp.exact_accuracy - acc,
                        _padded_area(pp, bits, t_sub, vote_cap)])


def padded_fitness_args(pp: PaddedProblem, pop: torch.Tensor):
    """(shift, t_sub, vote_cap): the per-chromosome operands that
    `population_objectives` hands the fitness kernel beside ``pp.fit_ops``,
    decoded from genes ([K,] P, 3Np+1), contiguous."""
    bits, t_sub, vote_cap = _padded_decode(pp, pop)
    return ((quant.MASTER_BITS - bits).contiguous(), t_sub.contiguous(),
            vote_cap.contiguous())


def population_objectives(pp: PaddedProblem, pop: torch.Tensor) -> torch.Tensor:
    """The sweep's tree fitness: (P, 3Np+1) -> (P, 2) for one padded
    problem, (K, P, 3Np+1) -> (K, P, 2) for a stacked bucket. The correct
    counts come from the fitness kernel (one launch for the whole bucket;
    its plain version on the CPU), the area from the LUT gather; equal to
    `padded_objectives` chromosome by chromosome."""
    shift, t_sub, vote_cap = padded_fitness_args(pp, pop)
    correct = _fit.fitness_correct_counts(pp.fit_ops, shift, t_sub, vote_cap)
    acc = correct.to(torch.float32) / _per_problem(pp, pp.n_valid)
    loss = _per_problem(pp, pp.exact_accuracy) - acc
    area = _padded_area(pp, quant.MASTER_BITS - shift, t_sub, vote_cap)
    return torch.stack([loss, area], -1)


# ---------------------------------------------------------------------------
# bucketing
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Bucket:
    """A set of problems of ONE family sharing a padded operand shape.

    Tree buckets carry dims (N, L, C, F, B); MLP buckets (H, C, F, B).
    Problems of different families never share a bucket.
    """
    names: tuple[str, ...]
    dims: tuple[int, ...]
    family: str = "tree"

    def dims_dict(self) -> dict:
        keys = (("n_comparators", "n_leaves", "n_classes", "n_features",
                 "n_samples") if self.family == "tree"
                else ("n_hidden", "n_classes", "n_features", "n_samples"))
        return dict(zip(keys, self.dims))


def _eval_cost(dims: tuple[int, ...]) -> float:
    """Dominant per-chromosome operation terms of the tree dataflow at
    padded shapes."""
    np_, lp, cp, fp, bp = dims
    return float(bp) * (np_ + np_ * lp + lp * cp)


def plan_buckets(problems: dict, *, granule: int = GRANULE,
                 max_buckets: int = DEFAULT_MAX_BUCKETS) -> list[Bucket]:
    """Group problems by (family, power-of-two-rounded operand shape), then
    greedily merge the SAME-FAMILY pair costing the least extra padded
    compute until at most `max_buckets` buckets remain (a mixed-family
    campaign may exceed `max_buckets` when no intra-family merge is left).
    Deterministic given the problem dict (name-sorted); merged dims are
    elementwise maxima, so they stay powers of two."""
    from repro_torch.families import family_of, get_family

    if max_buckets < 1:
        raise ValueError(f"max_buckets must be >= 1, got {max_buckets}")
    groups: dict[tuple, list[str]] = {}
    for name in sorted(problems):
        fam = family_of(problems[name])
        dims = tuple(round_up_pow2(d, granule)
                     for d in fam.problem_dims(problems[name]))
        groups.setdefault((fam.name, dims), []).append(name)
    buckets = [Bucket(names=tuple(v), dims=k[1], family=k[0])
               for k, v in sorted(groups.items())]

    while len(buckets) > max_buckets:
        best = None
        for i in range(len(buckets)):
            for j in range(i + 1, len(buckets)):
                bi, bj = buckets[i], buckets[j]
                if bi.family != bj.family:
                    continue
                cost = get_family(bi.family).eval_cost
                merged = tuple(max(a, b) for a, b in zip(bi.dims, bj.dims))
                extra = (cost(merged) * (len(bi.names) + len(bj.names))
                         - cost(bi.dims) * len(bi.names)
                         - cost(bj.dims) * len(bj.names))
                if best is None or extra < best[0]:
                    best = (extra, i, j, merged)
        if best is None:  # only cross-family pairs left: cannot merge further
            break
        _, i, j, merged = best
        buckets[i] = Bucket(names=tuple(sorted(buckets[i].names
                                               + buckets[j].names)),
                            dims=merged, family=buckets[i].family)
        del buckets[j]
    return sorted(buckets, key=lambda b: b.names)


# ---------------------------------------------------------------------------
# running the campaign
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SweepConfig:
    pop_size: int = 64
    n_generations: int = 40
    seed: int = 0
    vmapped: bool = True            # batched; False = the serial oracle
    granule: int = GRANULE
    max_buckets: int = DEFAULT_MAX_BUCKETS
    # a `launch.mesh.make_search_mesh(axes=("bucket", "pop"))` spec: "2x4"
    # spreads each bucket's problem stack over 2 bucket ranks and every
    # population over 4; "4"/"auto" put every rank on the population axis.
    # None = one device. Requires vmapped (the serial loop is the oracle)
    mesh: str | None = None
    out_dir: str | None = None      # per-dataset artifacts under OUT/<name>/
    emit_rtl: bool = False
    verify_rtl: bool = False


@dataclasses.dataclass
class BucketRun:
    bucket: Bucket
    n_dispatches: int
    wall_s: float
    search_s: float = 0.0   # init + generations, to a synchronised end
    launches: dict = dataclasses.field(default_factory=dict)  # in search_s


@dataclasses.dataclass
class SweepResult:
    results: dict
    bucket_runs: list
    wall_s: float

    @property
    def n_dispatches(self) -> int:
        """Generation-loop dispatches summed over buckets: 2 per bucket
        (init + one chunk) against 2 per dataset serially."""
        return sum(r.n_dispatches for r in self.bucket_runs)

    def serial_baseline_dispatches(self) -> int:
        """What the same campaign costs as per-dataset `run_search` calls."""
        return 2 * len(self.results)


def problem_generators(names_sorted: list[str], seed: int,
                       device) -> dict[str, torch.Generator]:
    """One generator per problem on ``device``: dataset i of the
    name-sorted campaign is seeded from (seed, i), so its stream never
    depends on the bucket plan (the counterpart of JAX's ``fold_in``)."""
    return {name: nsga2.stream_generator(seed, i, device)
            for i, name in enumerate(names_sorted)}


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launch_delta(before: dict) -> dict:
    now = kernels.launch_counts()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def _run_bucket_mesh(fam, padded: list, generators: list, n_genes: int,
                     seed_genes, nsga_cfg: nsga2.NSGA2Config, mesh,
                     n_generations: int) -> list:
    """A bucket on a (bucket, pop) mesh: the stack split over the bucket
    axis (padded to a multiple of it by repeating the last problem, with a
    generator of its own in the same state) and each population over the
    pop axis; returns every lane's whole final state, on every rank."""
    from repro_torch.core import dist
    from repro_torch.sharding import search as _specs

    pad_k = (-len(padded)) % _specs.axis_extent(mesh, "bucket")
    extra = []
    for _ in range(pad_k):
        gen = torch.Generator(device=generators[-1].device)
        gen.set_state(generators[-1].get_state())
        extra.append(gen)
    specs = _specs.batched_state_specs()
    lanes = _specs.split(padded + [padded[-1]] * pad_k, specs["generator"],
                         mesh)
    gens = _specs.split(generators + extra, specs["generator"], mesh)
    stacked = stack_padded(lanes)
    init = nsga2.make_batched_init(
        dist.sharded_fitness(
            lambda pop: fam.population_objectives(stacked, pop), mesh),
        n_genes, nsga_cfg, seed_genes=seed_genes)
    state = _specs.split_pop(init(gens, stacked.exact_accuracy.device),
                             mesh, specs)
    chunk = dist.make_sharded_batched_chunk(fam.population_objectives, mesh,
                                            nsga_cfg, n_generations)
    state = dist.gather_state(chunk(state, stacked, gens), mesh, specs)
    return [state.member(i) for i in range(len(padded))]


def run_bucket(fam, padded: list, generators: list, n_genes: int, seed_genes,
               cfg: SweepConfig, mesh=None):
    """Advance one bucket's padded problems: batched (one init and one
    chunk for all; on a mesh, `_run_bucket_mesh`) or, with ``cfg.vmapped``
    False, one problem at a time through the unbatched `nsga2.make_chunk`.
    Returns (per-problem states, dispatches)."""
    nsga_cfg = nsga2.NSGA2Config(pop_size=cfg.pop_size,
                                 n_generations=cfg.n_generations)
    device = padded[0].exact_accuracy.device
    if mesh is not None:
        return _run_bucket_mesh(fam, padded, generators, n_genes, seed_genes,
                                nsga_cfg, mesh, cfg.n_generations), 2
    if cfg.vmapped:
        stacked = stack_padded(padded)

        def fitness(pop):
            return fam.population_objectives(stacked, pop)

        init = nsga2.make_batched_init(fitness, n_genes, nsga_cfg,
                                       seed_genes=seed_genes)
        state = init(generators, device)
        chunk = nsga2.make_batched_chunk(fitness, nsga_cfg,
                                         cfg.n_generations)
        state = chunk(state, generators)
        return [state.member(i) for i in range(len(padded))], 2
    states = []
    n_seed = nsga2.seed_count(seed_genes)
    for pp, gen in zip(padded, generators):
        def fitness(pop, pp=pp):
            return fam.population_objectives(pp, pop)

        draws = nsga2.draw_init(gen, cfg.pop_size, n_genes, n_seed, device)
        state = nsga2.init_state(fitness, nsga_cfg, draws,
                                 seed_genes=seed_genes)
        state = nsga2.make_chunk(fitness, nsga_cfg, cfg.n_generations)(
            state, gen)
        states.append(state)
    return states, 2 * len(padded)


def run_sweep(problems: dict, cfg: SweepConfig | None = None,
              **overrides) -> SweepResult:
    """Run the NSGA-II campaign over every problem in `problems` (all on
    one device, or on every rank of a ``cfg.mesh``, each rank returning
    the whole result and rank 0 alone writing the artifacts).

    Returns per-dataset `SearchResult`s (pareto genes unpadded back to
    each problem's real layout) and bucket-level dispatch and time
    accounting. With `out_dir`, each dataset writes the standard
    `pareto.json` (and RTL, per `emit_rtl`/`verify_rtl`) under
    `out_dir/<dataset>/` through the single-run pipeline.
    """
    cfg = dataclasses.replace(cfg or SweepConfig(), **overrides)
    if not problems:
        raise ValueError("run_sweep needs at least one problem")
    if (cfg.emit_rtl or cfg.verify_rtl) and not cfg.out_dir:
        raise ValueError("emit_rtl/verify_rtl require out_dir")
    if cfg.pop_size < 2 or cfg.pop_size % 2:
        raise ValueError(f"pop_size must be even and >= 2, got {cfg.pop_size}")
    from repro_torch.families import get_family
    from repro_torch.launch import mesh as _mesh

    devices = {problems[n].device for n in problems}
    if len(devices) != 1:
        raise ValueError(f"a campaign runs on one device, got {devices}")
    device = devices.pop()
    mesh = None
    if cfg.mesh:
        if not cfg.vmapped:
            raise ValueError("mesh sharding requires the vmapped path "
                             "(the serial loop is the mesh-free oracle)")
        mesh = _mesh.make_search_mesh(cfg.mesh, axes=("bucket", "pop"),
                                      device=device)
        n_pop = mesh.size(1) if mesh is not None else 1
        if cfg.pop_size % n_pop:
            raise ValueError(
                f"pop_size={cfg.pop_size} not divisible by the mesh's pop "
                f"axis ({n_pop})")
    names_sorted = sorted(problems)
    generators = problem_generators(names_sorted, cfg.seed, device)
    buckets = plan_buckets(problems, granule=cfg.granule,
                           max_buckets=cfg.max_buckets)

    t0 = time.time()
    results: dict = {}
    bucket_runs: list[BucketRun] = []
    for bucket in buckets:
        t_b = time.time()
        fam = get_family(bucket.family)
        padded = [fam.pad_problem(problems[n], bucket.dims)
                  for n in bucket.names]
        _synchronize(device)
        t_s, before = time.perf_counter(), kernels.launch_counts()
        states, n_dispatches = run_bucket(
            fam, padded, [generators[n] for n in bucket.names],
            fam.padded_n_genes(bucket.dims),
            fam.padded_exact_genes(bucket.dims), cfg, mesh)
        _synchronize(device)
        search_s = time.perf_counter() - t_s
        launches = _launch_delta(before)
        wall_b = time.time() - t_b
        bucket_runs.append(BucketRun(bucket, n_dispatches, wall_b, search_s,
                                     launches))

        for name, state in zip(bucket.names, states):
            problem = problems[name]
            genes = fam.unpad_genes(problem, state.genes.cpu().numpy(),
                                    bucket.dims)
            p_objs, p_genes = nsga2.pareto_front(
                state.objs, torch.as_tensor(genes))
            result = _engine.SearchResult(
                state=state, pareto_objs=p_objs, pareto_genes=p_genes,
                backend="sweep" if cfg.vmapped else "sweep-serial",
                wall_s=wall_b,
                n_evaluations=cfg.pop_size * (1 + cfg.n_generations),
                n_dispatches=n_dispatches)  # shared across the bucket
            results[name] = result
            if cfg.out_dir and _mesh.is_writer():
                fam.write_artifact(
                    problem, result, os.path.join(cfg.out_dir, name),
                    emit_rtl=cfg.emit_rtl, verify_rtl=cfg.verify_rtl,
                    dataset=name)

    _mesh.barrier()
    return SweepResult(results=results, bucket_runs=bucket_runs,
                       wall_s=time.time() - t0)


# ---------------------------------------------------------------------------
# campaign construction + paper scoring
# ---------------------------------------------------------------------------

def build_problems(datasets, n_trees: int = 1, verbose: bool = False, *,
                   mlp_datasets=(), n_hidden: int = 16,
                   device="cuda") -> dict:
    """Train the exact design per dataset on ``device``: bespoke trees (or
    forests, ``n_trees > 1``) for `datasets`, printed MLPs for
    `mlp_datasets` (campaign keys suffixed ``_mlp``, so one dataset can run
    in both families; the bucket planner keeps the families apart)."""
    from repro_torch.families import get_family

    out = {}
    for name in datasets:
        t0 = time.time()
        problem = get_family("tree").build_problem(name, n_trees=n_trees,
                                                   device=device)
        out[name] = problem
        if verbose:
            print(f"  {name}: comparators={problem.n_comparators} "
                  f"leaves={problem.n_leaves} "
                  f"exact_acc={problem.exact_accuracy:.3f} "
                  f"({time.time() - t0:.1f}s)")
    for name in mlp_datasets:
        t0 = time.time()
        problem = get_family("mlp").build_problem(name, n_hidden=n_hidden,
                                                  device=device)
        out[f"{name}_mlp"] = problem
        if verbose:
            print(f"  {name}_mlp: hidden={problem.n_hidden} "
                  f"shift={problem.shift} "
                  f"exact_acc={problem.exact_accuracy:.3f} "
                  f"({time.time() - t0:.1f}s)")
    return out


def _netlist_ratios(pareto_path: str) -> dict | None:
    """Estimated-vs-netlist area spread from a written pareto.json."""
    if not os.path.exists(pareto_path):
        return None
    with open(pareto_path) as f:
        artifact = json.load(f)
    ratios = _engine.netlist_area_ratios(artifact["pareto"])
    if not ratios:
        return None
    return {"min": round(min(ratios), 4),
            "mean": round(sum(ratios) / len(ratios), 4),
            "max": round(max(ratios), 4),
            "n_points": len(ratios)}


def _robustness_summary(report_path: str) -> dict | None:
    """Condensed robustness metrics from a written fault_report.json.

    Loose by design (like `_netlist_ratios`): a dataset without a fault
    campaign — or with an invalid report — simply contributes no
    robustness row rather than failing the sweep report.
    """
    from repro_torch.search import robustness

    if not os.path.exists(report_path):
        return None
    try:
        report = robustness.load_fault_report(report_path)
    except (OSError, ValueError):
        return None
    if not report["points"]:
        return None
    pt = report["points"][0]    # --fault-report runs the best point
    return {
        "point": pt["point"],
        "norm_area": round(pt["norm_area"], 4),
        "n_sites": pt["n_sites"],
        "baseline_accuracy": round(pt["baseline_accuracy"], 4),
        "single_fault_mean_accuracy":
            round(pt["single_fault"]["mean_accuracy"], 4),
        "single_fault_worst_accuracy":
            round(pt["single_fault"]["worst_accuracy"], 4),
        "mc_expected_accuracy":
            round(pt["monte_carlo"]["expected_accuracy"], 4),
        "defect_rate": report["defect_rate"],
    }


def write_sweep_report(sweep: SweepResult, problems: dict, out_dir: str, *,
                       meta: dict | None = None,
                       max_loss: float = 0.01) -> tuple[str, str]:
    """Score the campaign against the paper and write the report artifacts.

    Emits `out_dir/sweep_report.json` (per-dataset accuracy deltas vs
    Table I, normalized area at the loss budget vs Table II,
    estimated-vs-netlist spreads from each dataset's pareto.json,
    bucket/dispatch accounting, and the robustness summary of each
    dataset's fault_report.json where `sweep --fault-report` wrote one),
    with the JAX package's keys, and `out_dir/REPORT.md` (the same as
    tables). Returns (json_path, md_path).
    """
    from repro_torch.datasets.paper_refs import (
        PAPER_MEAN_AREA_REDUCTION_1PCT,
        PAPER_TABLE1,
        PAPER_TABLE2_NORM,
    )

    os.makedirs(out_dir, exist_ok=True)
    rows: dict[str, dict] = {}
    reductions = []
    acc_deltas = []
    for name in sorted(sweep.results):
        result = sweep.results[name]
        problem = problems[name]
        paper1 = PAPER_TABLE1.get(name)
        paper2 = PAPER_TABLE2_NORM.get(name)
        if hasattr(problem, "n_comparators"):   # tree row
            row: dict = {
                "exact_accuracy": round(problem.exact_accuracy, 4),
                "n_comparators": problem.n_comparators,
                "n_trees": problem.n_trees,
                "exact_area_mm2": round(problem.exact_area_mm2, 2),
                "n_pareto_points": int(len(result.pareto_objs)),
                "wall_s": round(result.wall_s, 2),
            }
        else:                                   # printed-MLP row
            row = {
                "family": "mlp",
                "exact_accuracy": round(problem.exact_accuracy, 4),
                "n_hidden": problem.n_hidden,
                "exact_area_mm2": round(problem.exact_area_mm2, 2),
                "n_pareto_points": int(len(result.pareto_objs)),
                "wall_s": round(result.wall_s, 2),
            }
            paper1 = paper2 = None  # paper tables are tree-family numbers
        if paper1:
            row["paper_accuracy"] = paper1[0]
            row["accuracy_delta"] = round(problem.exact_accuracy - paper1[0], 4)
            row["paper_n_comparators"] = paper1[1]
            row["paper_area_mm2"] = paper1[3]
            acc_deltas.append(abs(row["accuracy_delta"]))
        best = result.best_under_loss(max_loss)
        if best is not None:
            objs, _ = best
            norm_area = float(objs[1])
            area_mm2 = norm_area * problem.exact_area_mm2
            row["at_budget"] = {
                "max_loss": max_loss,
                "acc_loss": round(float(objs[0]), 4),
                "norm_area": round(norm_area, 4),
                "area_mm2": round(area_mm2, 2),
                "power_mw": round(area_mod.power_mw(area_mm2), 3),
            }
            if norm_area > 0:
                reductions.append(1.0 / norm_area)
            if paper2:
                row["at_budget"]["paper_norm_area"] = paper2[0]
                row["at_budget"]["norm_area_delta"] = round(
                    norm_area - paper2[0], 4)
        else:
            row["at_budget"] = None
        ratios = _netlist_ratios(os.path.join(out_dir, name, "pareto.json"))
        if ratios:
            row["netlist_vs_estimated_area"] = ratios
        robust = _robustness_summary(
            os.path.join(out_dir, name, "fault_report.json"))
        if robust:
            row["robustness"] = robust
        rows[name] = row

    payload = {
        "meta": meta or {},
        "buckets": [{
            "datasets": list(r.bucket.names),
            "family": r.bucket.family,
            "dims": r.bucket.dims_dict(),
            "n_dispatches": r.n_dispatches,
            "wall_s": round(r.wall_s, 2),
        } for r in sweep.bucket_runs],
        "n_dispatches": sweep.n_dispatches,
        "serial_baseline_dispatches": sweep.serial_baseline_dispatches(),
        "wall_s": round(sweep.wall_s, 2),
        "datasets": rows,
        "summary": {
            "n_datasets": len(rows),
            "n_at_budget": len(reductions),
            "mean_area_reduction_at_budget":
                round(float(np.mean(reductions)), 3) if reductions else None,
            "paper_mean_area_reduction_1pct": PAPER_MEAN_AREA_REDUCTION_1PCT,
            "mean_abs_accuracy_delta_vs_paper":
                round(float(np.mean(acc_deltas)), 4) if acc_deltas else None,
        },
    }
    json_path = os.path.join(out_dir, "sweep_report.json")
    tmp = json_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
    os.replace(tmp, json_path)

    md_path = os.path.join(out_dir, "REPORT.md")
    with open(md_path + ".tmp", "w") as f:
        f.write(_report_markdown(payload, max_loss))
    os.replace(md_path + ".tmp", md_path)
    return json_path, md_path


def _report_markdown(payload: dict, max_loss: float) -> str:
    lines = ["# Full-suite sweep report", ""]
    meta = payload.get("meta") or {}
    if meta:
        opts = " ".join(f"{k}={v}" for k, v in sorted(meta.items()))
        lines += [f"Campaign: {opts}", ""]
    lines += [
        f"Dispatches: **{payload['n_dispatches']}** over "
        f"{len(payload['buckets'])} buckets (serial per-dataset baseline: "
        f"{payload['serial_baseline_dispatches']}); "
        f"wall {payload['wall_s']}s.",
        "",
        "| bucket | family | datasets | padded dims | dispatches |",
        "|---|---|---|---|---|",
    ]
    for i, b in enumerate(payload["buckets"]):
        d = b["dims"]
        dims = "(" + ", ".join(str(v) for v in d.values()) + ")"
        lines.append(f"| {i} | {b.get('family', 'tree')} "
                     f"| {', '.join(b['datasets'])} | {dims} "
                     f"| {b['n_dispatches']} |")
    lines += [
        "",
        f"Per dataset, scored against paper Tables I/II "
        f"(budget: {max_loss:.0%} accuracy loss):",
        "",
        "| dataset | acc (paper) | Δacc | comparators (paper) "
        "| norm area @budget (paper) | netlist/LUT mean |",
        "|---|---|---|---|---|---|",
    ]
    for name, row in payload["datasets"].items():
        pacc = row.get("paper_accuracy")
        acc = (f"{row['exact_accuracy']:.3f} ({pacc:.3f})"
               if pacc is not None else f"{row['exact_accuracy']:.3f} (—)")
        dacc = (f"{row['accuracy_delta']:+.3f}"
                if "accuracy_delta" in row else "—")
        if "n_comparators" in row:
            ncmp = (f"{row['n_comparators']} ({row['paper_n_comparators']})"
                    if "paper_n_comparators" in row
                    else f"{row['n_comparators']} (—)")
        else:
            ncmp = f"mlp h={row['n_hidden']}"
        at = row.get("at_budget")
        if at:
            pna = at.get("paper_norm_area")
            na = (f"{at['norm_area']:.3f} ({pna:.3f})"
                  if pna is not None else f"{at['norm_area']:.3f} (—)")
        else:
            na = "none under budget"
        ratios = row.get("netlist_vs_estimated_area")
        ratio = f"{ratios['mean']:.2f}" if ratios else "—"
        lines.append(f"| {name} | {acc} | {dacc} | {ncmp} | {na} | {ratio} |")
    s = payload["summary"]
    lines += [
        "",
        f"Mean area reduction at budget: "
        f"**{s['mean_area_reduction_at_budget']}x** over "
        f"{s['n_at_budget']}/{s['n_datasets']} datasets "
        f"(paper: {s['paper_mean_area_reduction_1pct']}x at 1%). "
        f"Mean |Δaccuracy| vs Table I: "
        f"{s['mean_abs_accuracy_delta_vs_paper']}.",
        "",
    ]
    robust = {name: row["robustness"]
              for name, row in payload["datasets"].items()
              if row.get("robustness")}
    if robust:
        rate = next(iter(robust.values()))["defect_rate"]
        lines += [
            "## Robustness vs area (stuck-at campaign, DESIGN.md §17)",
            "",
            f"Best-under-budget point per dataset: exhaustive single "
            f"stuck-at over every fault site + Monte-Carlo expected "
            f"accuracy at a {rate:.0%} iid defect rate.",
            "",
            "| dataset | point | norm area | sites | baseline acc "
            "| 1-fault mean | 1-fault worst | MC expected |",
            "|---|---|---|---|---|---|---|---|",
        ]
        for name, r in robust.items():
            lines.append(
                f"| {name} | {r['point']} | {r['norm_area']:.3f} "
                f"| {r['n_sites']} | {r['baseline_accuracy']:.3f} "
                f"| {r['single_fault_mean_accuracy']:.3f} "
                f"| {r['single_fault_worst_accuracy']:.3f} "
                f"| {r['mc_expected_accuracy']:.3f} |")
        lines.append("")
    return "\n".join(lines)
