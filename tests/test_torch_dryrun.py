"""The port's dry run (`launch.dryrun`) and its step accounting
(`launch.step_analysis`), on the CPU.

- `step_analysis.analyze` on toy steps: a matmul's FLOPs, the 1 MiB bytes
  rule, peak, alias and temp bytes equal hand counts; a 4-layer reduced
  llama step runs (1.7, 2.3)x the FLOPs of a 2-layer one, as
  `tests/test_hlo_analysis.py` holds the JAX analyzer.
- The attention wrappers' meta branch, forward and backward: the shapes
  and dtypes of the CPU's plain version, the card's allocations (the
  backward's 128-row float32 scratch), no launch counted, and reported
  FLOPs equal to `FlopCounterMode` over the plain version (its forward;
  autograd's backward of it).
- A reduced single-rank train step analysed on meta equals the same step
  analysed on CPU tensors: FLOPs and argument bytes exactly.
- At full width, for the ten archs on 16x16 and 2x16x16 with no ranks, a
  rank's parameter, optimizer-state and cache bytes equal the per-device
  bytes reckoned from the JAX package's spec trees (each dim over the
  extents its spec names), the SSM conv cache from `cache_blocks`'
  layout (a rank keeps its d_inner/tp x channels, where JAX's spec
  replicates the leaf over ``model``).
- A reduced ``attn_mlp`` train cell in sharded-head mode on a fake (2, 2)
  group: FLOPs within 5% of `repro.launch.hlo_analysis.analyze` of JAX's
  same sharded step compiled with 4 host devices (both in subprocesses:
  ``XLA_FLAGS`` must be set before JAX starts, and a fake group wants a
  process with no group).
- The CLI writes ``"ok"`` records for llama3.2-3b ``decode_32k`` and the
  paper's GA cell.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import kernels
from repro_torch import pytree
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, reduced_config
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attn as fa
from repro_torch.launch import step_analysis as sa
from repro_torch.models import lm, transformer
from repro_torch.optim import get_optimizer
from repro_torch.runtime import train
from repro_torch.sharding import params as t_sp
from repro_torch.sharding import rules as t_rules

ROOT = pathlib.Path(__file__).resolve().parents[1]
MiB = 1 << 20
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
# the reduced cells: head dim 64 (a head dim the attention kernel takes,
# which the meta branch holds to as the card does)
HD = 64
CELL_B, CELL_S = 4, 64
FLOP_RTOL = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
                + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1")


# ---------------------------------------------------------------------------
# step_analysis on toy steps
# ---------------------------------------------------------------------------

def test_analyze_counts_a_toy_step_by_hand():
    """(256 x 512) @ (512 x 1024) float32: 2*256*512*1024 FLOPs; its 1 MiB
    result and the relu's count as bytes, the transpose (a view) and the
    512 KiB in-place add do not; the peak holds the arguments (2.5 MiB)
    and both results; the output is the relu's new 1 MiB and the
    argument ``a`` returned (an alias)."""
    def step(a, b):
        c = a @ b
        _ = c.t()
        e = torch.relu(c)
        a.add_(1)
        return e, a

    for dev in ("cpu", "meta"):
        a = torch.zeros(256, 512, device=dev)
        b = torch.zeros(512, 1024, device=dev)
        got = sa.analyze(step, a, b)
        assert got["flops"] == 2 * 256 * 512 * 1024
        assert got["bytes"] == 2 * MiB
        assert got["memory"] == {
            "argument_bytes": 2 * MiB + MiB // 2, "output_bytes": MiB,
            "alias_bytes": MiB // 2, "peak_bytes": 4 * MiB + MiB // 2,
            "temp_bytes": MiB}
        assert got["collectives"]["total_bytes"] == 0


def test_analyze_frees_what_dies():
    """A temporary freed before the next one is made is not live beside
    it: the peak is the argument, one temporary and the 4-byte sum made
    while it lives, not two temporaries."""
    def step(a):
        x = a * 2
        del x
        y = a * 3
        return y.sum()

    a = torch.zeros(1024, 256, device="meta")     # 1 MiB
    got = sa.analyze(step, a)
    assert got["memory"]["peak_bytes"] == 2 * MiB + 4
    assert got["memory"]["output_bytes"] == 4


def _llama(layers: int = 2, **over):
    return reduced_config(get_config("llama3.2-3b"), head_dim=HD,
                          n_layers=layers, **over)


def _train_analysis(cfg, dev: str) -> dict:
    params = transformer.init_params(0, cfg, device=dev)
    opt = get_optimizer(cfg)
    state = train.init_train_state(params, opt)
    batch = {"tokens": torch.zeros((CELL_B, CELL_S), dtype=torch.int32,
                                   device=dev)}
    return sa.analyze(train.make_train_step(cfg, optimizer=opt), state,
                      batch)


def test_flops_scale_with_layers():
    """As tests/test_hlo_analysis.py holds JAX's loop-aware count: 4
    layers run (1.7, 2.3)x the FLOPs of 2 (the embedding and the head
    stay)."""
    f2 = _train_analysis(_llama(2, loss_chunk=CELL_S), "meta")["flops"]
    f4 = _train_analysis(_llama(4, loss_chunk=CELL_S), "meta")["flops"]
    assert f2 > 0 and 1.7 < f4 / f2 < 2.3, f4 / f2


def test_meta_step_equals_the_cpu_step():
    """The same reduced train step on meta and on CPU tensors: FLOPs and
    argument bytes equal exactly (the kernels' reports on meta, the plain
    version's products on the CPU); the state is returned in place."""
    cfg = _llama(2, loss_chunk=CELL_S)
    cpu, meta = _train_analysis(cfg, "cpu"), _train_analysis(cfg, "meta")
    assert meta["flops"] == cpu["flops"]
    assert meta["memory"]["argument_bytes"] == \
        cpu["memory"]["argument_bytes"]
    assert meta["memory"]["alias_bytes"] == cpu["memory"]["alias_bytes"]
    assert cpu["kernel_flops"] == {}
    assert set(meta["kernel_flops"]) == {"flash_attention",
                                         "flash_attention_backward"}


# ---------------------------------------------------------------------------
# the attention's meta branch
# ---------------------------------------------------------------------------

def _qkv(dev, b=2, sq=48, skv=48, h=4, hkv=2, dtype=torch.float32,
         grad=False):
    gen = torch.Generator().manual_seed(3)
    out = []
    for s, n in ((sq, h), (skv, hkv), (skv, hkv)):
        t = torch.randn((b, s, n, HD), generator=gen).to(dtype)
        t = t if dev == "cpu" else torch.empty_like(t, device="meta")
        out.append(t.requires_grad_(grad))
    return out


def _reported(fn) -> dict:
    got: dict = {}

    def sink(kernel, flops):
        got[kernel] = got.get(kernel, 0) + flops

    _build.FLOP_SINKS.append(sink)
    try:
        fn()
    finally:
        _build.FLOP_SINKS.remove(sink)
    return got


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_forward_is_the_plain_forward_in_shape_and_flops(dtype):
    """Both wrappers on meta: the plain version's shapes and dtypes, no
    launch counted, and the FLOPs `FlopCounterMode` counts over the plain
    version on the CPU."""
    q, k, v = _qkv("cpu", dtype=dtype)
    mq, mk, mv = _qkv("meta", dtype=dtype)
    before = kernels.launched(fa.flash_attention)
    want = fa.flash_attention_bshd_plain(q, k, v)
    got = {}
    rep = _reported(lambda: got.setdefault(
        "o", fa.flash_attention_bshd(mq, mk, mv)))
    assert got["o"].is_meta and got["o"].shape == want.shape \
        and got["o"].dtype == want.dtype
    assert rep == {"flash_attention": _counted(
        lambda: fa.flash_attention_bshd_plain(q, k, v))}
    assert rep["flash_attention"] == fa.forward_flops(q, k)
    fold = (lambda t: t[0].transpose(0, 1).contiguous())
    rep = _reported(lambda: got.setdefault(
        "h", fa.flash_attention(fold(mq), fold(mk), fold(mv), group=2)))
    assert got["h"].shape == fold(q).shape and got["h"].is_meta
    assert rep == {"flash_attention": _counted(
        lambda: fa.flash_attention_plain(fold(q), fold(k), fold(v),
                                         group=2))}
    assert kernels.launched(fa.flash_attention) == before


def test_meta_backward_is_autograd_of_the_plain_forward_in_flops():
    """With grad on meta the wrapper goes through the kernel's autograd
    function: the forward keeps a float32 (B, H, Sq) log-sum-exp, the
    backward allocates the card's 128-row float32 scratch, gives
    gradients of the inputs' shapes and dtypes, and reports twice the
    forward's FLOPs: what `FlopCounterMode` counts for autograd's
    backward of the plain forward, the CPU's training path."""
    q, k, v = _qkv("cpu", grad=True)
    out = fa.flash_attention_bshd_plain(q, k, v)
    dout = torch.ones_like(out)
    want = _counted(lambda: torch.autograd.grad(out, (q, k, v), dout))
    mq, mk, mv = _qkv("meta", grad=True)
    mout = fa.flash_attention_bshd(mq, mk, mv)
    rep = _reported(lambda: torch.autograd.grad(
        mout, (mq, mk, mv), torch.ones_like(mout)))
    assert rep == {"flash_attention_backward": want}
    assert want == fa.backward_flops(q, k)

    b, sq, h, _ = q.shape
    lse = torch.empty((b, h, sq), device="meta")
    mo = torch.empty_like(mq, device="meta")
    got = sa.analyze(fa.flash_attention_backward, mq.detach(), mk.detach(),
                     mv.detach(), mo, lse, mo)
    grads = fa.flash_attention_backward_plain(
        *(t.detach() for t in (q, k, v)), out.detach(),
        fa.flash_attention_lse_plain(q.detach(), k.detach()), dout)
    scratch = 2 * b * h * 128 * 4             # Sq = 48 padded to 128 rows
    assert got["memory"]["output_bytes"] == sum(
        t.numel() * t.element_size() for t in grads)
    assert got["memory"]["peak_bytes"] == got["memory"]["argument_bytes"] \
        + got["memory"]["output_bytes"] + scratch


def test_wrappers_keep_refusing_other_devices():
    """No fallback: a device that is neither cuda, cpu nor meta raises,
    and the other kernels' `on_cuda` refuses meta as well."""
    for dev in ("meta", "xpu"):
        with pytest.raises(ValueError, match="unsupported device"):
            _build.on_cuda(types.SimpleNamespace(device=torch.device(dev)),
                           "qmatmul")


# ---------------------------------------------------------------------------
# a rank's bytes at full width against the JAX package's spec trees
# ---------------------------------------------------------------------------

class _Rank0:
    """Rank 0 of a mesh of the given axis sizes, with no group."""

    def __init__(self, sizes: dict):
        self.shape = sizes

    def get_local_rank(self, axis):
        return 0


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in pytree.leaves(tree)
               if isinstance(t, torch.Tensor))


def _jax_bytes(jx, shapes, specs, sizes: dict) -> int:
    """Per-device bytes of a JAX shape tree under its spec tree: each dim
    over the extents its spec entry names."""
    P = jx.jax.sharding.PartitionSpec
    total = 0
    for leaf, spec in zip(jx.jax.tree.leaves(shapes),
                          jx.jax.tree.leaves(
                              specs, is_leaf=lambda x: isinstance(x, P))):
        n = leaf.dtype.itemsize
        for i, d in enumerate(leaf.shape):
            entry = spec[i] if i < len(spec) else None
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else tuple(entry))
            n *= d // int(np.prod([sizes[a] for a in axes]))
        total += n
    return total


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro import configs
    from repro.models import lm as j_lm
    from repro.models import transformer as j_tf
    from repro.optim import get_optimizer as j_opt
    from repro.runtime import train as j_train
    from repro.sharding import params as j_sp
    from repro.sharding import rules as j_rules
    return types.SimpleNamespace(jax=jax, configs=configs, lm=j_lm, tf=j_tf,
                                 opt=j_opt, train=j_train, sp=j_sp,
                                 rules=j_rules)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rank_bytes_equal_jax_spec_trees(jx, arch, mesh):
    sizes = MESHES[mesh]
    ms = types.SimpleNamespace(shape=sizes)
    multi = "pod" in sizes
    t_r = t_rules.RULES_3D if multi else t_rules.RULES_2D
    j_r = jx.rules.RULES_3D if multi else jx.rules.RULES_2D
    rules = dataclasses.replace(t_r, mesh=_Rank0(sizes))
    cfg, cfg_j = get_config(arch), jx.configs.get_config(arch)

    params = t_sp.init_sharded_params(0, cfg, rules, rules.mesh,
                                      device="meta")
    opt = get_optimizer(cfg)
    state = train.init_sharded_train_state(params, opt, cfg, rules)
    p_shapes = jx.jax.eval_shape(lambda k: jx.tf.init_params(k, cfg_j),
                                 jx.jax.random.PRNGKey(0))
    j_state = jx.jax.eval_shape(
        lambda p: jx.train.init_train_state(p, jx.opt(cfg_j)), p_shapes)
    sspecs = jx.sp.train_state_specs(cfg_j, j_r, ms, opt.name)
    assert _nbytes(state.params) == _jax_bytes(jx, p_shapes, sspecs.params,
                                               sizes)
    assert _nbytes(state.opt_state) == _jax_bytes(
        jx, j_state.opt_state, sspecs.opt_state, sizes)

    names = ["decode_32k"] + (["long_500k"] if cfg.family in ("ssm",
                                                              "hybrid")
                              else [])
    for name in names:
        b, s = SHAPES[name].global_batch, SHAPES[name].seq_len
        caches = lm.init_caches(cfg, b, s, rules=rules, device="meta")
        c_shapes = jx.jax.eval_shape(lambda: jx.lm.init_caches(cfg_j, b, s))
        c_specs = jx.sp.cache_specs(cfg_j, j_r, ms, c_shapes)
        want = _jax_bytes(jx, c_shapes, c_specs, sizes)
        if "ssm" in caches:
            # JAX's spec replicates the conv cache over model; a rank
            # keeps its [d_inner/tp x | B | C] channels (cache_blocks)
            conv = c_shapes["ssm"][0]
            rows = t_sp.serve_rows(rules, ms, b)
            ch = cfg.d_inner // sizes["model"] + 2 * cfg.ssm_state
            want += (conv.shape[0] * rows * conv.shape[2] * ch
                     * conv.dtype.itemsize) - _jax_bytes(
                jx, conv, c_specs["ssm"][0], sizes)
        assert _nbytes(caches) == want, name


# ---------------------------------------------------------------------------
# a fake group against JAX's compiled step; the CLI
# ---------------------------------------------------------------------------

CELL = {"arch": "llama3.2-3b", "over": {"head_dim": HD, "loss_chunk": CELL_S},
        "batch": CELL_B, "seq": CELL_S}

JAX_CELL = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_config, reduced_config
from repro.launch import hlo_analysis
from repro.models import transformer
from repro.optim import get_optimizer
from repro.runtime import train
from repro.sharding import params as sp
from repro.sharding.rules import MeshRules

cell = json.loads(sys.argv[1])
cfg = reduced_config(get_config(cell["arch"]), **cell["over"])
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
rules = MeshRules(tp=2, mesh=mesh)
opt = get_optimizer(cfg)
named = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                               is_leaf=lambda x: isinstance(x, P))
sds = lambda shapes, sh: jax.tree.map(
    lambda l, s: jax.ShapeDtypeStruct(l.shape, l.dtype, sharding=s),
    shapes, sh)
params = jax.eval_shape(lambda k: transformer.init_params(k, cfg),
                        jax.random.PRNGKey(0))
state = jax.eval_shape(lambda p: train.init_train_state(p, opt), params)
batch = {"tokens": jax.ShapeDtypeStruct((cell["batch"], cell["seq"]),
                                        jnp.int32)}
with mesh:
    compiled = jax.jit(train.make_train_step(cfg, rules=rules, optimizer=opt),
                       donate_argnums=(0,)).lower(
        sds(state, named(sp.train_state_specs(cfg, rules, mesh, opt.name))),
        sds(batch, named(sp.batch_specs(cfg, rules, mesh, batch)))).compile()
print(json.dumps(hlo_analysis.analyze(compiled.as_text())))
"""

PORT_CELL = r"""
import json, sys
import torch
from repro_torch.configs import ShapeConfig, get_config, reduced_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh

torch.set_num_threads(1)
cell = json.loads(sys.argv[1])
cfg = reduced_config(get_config(cell["arch"]), **cell["over"])
shape = ShapeConfig("cell", cell["seq"], cell["batch"], "train")
with dryrun.fake_group(4, 0):
    mesh = make_host_mesh(4, ("data", "model"), device="cpu")
    print(json.dumps(dryrun.timed_analysis(
        *dryrun.cell_inputs(cfg, shape, mesh))))
"""


def _run(script: str, *args) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", script, *args],
                            env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _result(proc: subprocess.Popen) -> dict:
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


def test_fake_group_flops_match_jax_compiled_step():
    """Sharded heads (4 over 2 kv heads at tp 2): the port's rank runs the
    FLOPs JAX's per-device HLO runs, within 5%."""
    pytest.importorskip("jax")
    assert t_rules.head_sharding(reduced_config(
        get_config(CELL["arch"]), **CELL["over"]),
        t_rules.MeshRules(tp=2))[0] == "sharded"
    jax_proc = _run(JAX_CELL, json.dumps(CELL))
    port = _result(_run(PORT_CELL, json.dumps(CELL)))
    want = _result(jax_proc)["flops"]
    assert port["collectives"]["total_bytes"] > 0
    assert abs(port["flops"] - want) <= FLOP_RTOL * want, \
        (port["flops"], want)


@pytest.mark.parametrize("args", [
    ["--arch", "llama3.2-3b", "--shape", "decode_32k"],
    ["--arch", "paper-dt-ga"]], ids=["llama-decode", "paper-dt-ga"])
def test_cli_writes_ok_records(tmp_path, args):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
         "--mesh", "single", "--out", str(tmp_path)],
        env=_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    (path,) = (tmp_path / "pod16x16").glob("*.json")
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and set(rec["ranks"]) == {"0", "255"}
    assert rec["cost"]["flops"] > 0 and rec["memory"]["peak_bytes"] > 0
    if args[1] == "paper-dt-ga":
        assert rec["global_population"] == 16 * 32
        assert rec["collectives"]["all-gather"]["count"] == 2
    else:
        assert rec["collectives"]["total_bytes"] > 0
