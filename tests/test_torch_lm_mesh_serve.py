"""The port's sharded LM serving (`runtime.lm_serve` with ``rules``:
prefill, then context-parallel decode) on a (data=2, model=2) mesh of 4
gloo ranks on the CPU, held to the JAX package's jitted sharded serving
on a (data=2, model=2) mesh of 4 host devices, for every layer kind.

The JAX side runs as the JAX package's own sharded serving runs:
``jax.jit(make_prefill_step(cfg, rules))``, `lm.extend_caches` to s_max
slots, the caches placed by `cache_specs`, then ``jax.jit(
make_serve_step(cfg, rules))`` a token at a time, greedy. It runs in
subprocesses (``XLA_FLAGS`` must be set before JAX initialises, and
another test file in this worker may have imported it already) started
before the ranks: each writes its cases' initial parameters first
(`transformer.init_params(PRNGKey(0))`), which the ranks take through
`convert.lm_params_from_arrays(..., rules=)` while it compiles. One
group of 4 ranks is spawned once, on one intra-op thread each, and runs
every case.

Cases, B=4 x 32 prompt tokens, s_max 64, 4 greedy tokens, float32 reduced
configs:

- ``llama``: llama3.2-3b, "sharded" heads (4 over 2 kv heads at tp 2);
- ``paligemma``: paligemma-3b with 3 heads ("replicated" heads) and its
  8-position prefix (a 40-position prompt);
- ``mamba2``: mamba2-1.3b (the sharded Mamba2 block's caches);
- ``zamba2``: zamba2-7b at 7 layers (2 super-blocks over 2 shared
  attention blocks, and a tail layer);
- ``kimi``: kimi-k2-1t-a32b with the int8 all-to-all ("alltoall": 4
  experts over the 2 data ranks; int8 both ways in decode);
- ``grok``: grok-1-314b with 3 experts ("gathered", the softcap);
- ``llama_b1``: llama3.2-3b with a batch of ONE row, which does not
  divide over the 2 data ranks: replicated over them, as JAX's GSPMD
  replicates it (`sharding.params.serve_rows`), every rank serving it.

Held against JAX: the prefill's last logits, every cache leaf gathered
from the ranks (`convert.lm_caches_to_arrays(..., rules=)`) after the
prefill and after the last decode step, each decode step's logits, and
the greedy tokens, equal. Also: each rank's KV and state blocks laid out
as `cache_specs` cuts JAX's caches (`sharding.params.cache_blocks`); for
the non-MoE kinds the tokens equal the port's own single-device
`generate`; for kimi the sharded run differs from one device's (an MoE
rank routes its own tokens at its own capacity, the JAX package's
design); `generate(rules=)` and its sampling, equal on the model ranks of
a row; a port-only case with ``kv_repeat`` 2 (llama with one kv head)
against one device.

Tolerances: 1e-5 (rtol = atol, float32), as `tests/test_torch_lm.py`;
the SSM kinds at `tests/test_torch_ssm.py`'s model tolerance 2^-8 (the
SSD rounds its weight block to bf16 in every dtype).

The tests that need no ranks: the decode combine over tp blocks against
`decode_attention` over the whole cache (with and without softcap, and
with blocks that hold no valid slot), the serving refusals, and the MoE
block's one-token form.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import mesh as t_mesh
from repro_torch.models import attention, lm, moe, transformer
from repro_torch.runtime import lm_serve
from repro_torch.sharding import params as t_sp
from repro_torch.sharding.rules import MeshRules

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, S, S_MAX, N_TOKENS = 4, 32, 64, 4
TOL, SSD_TOL = 1e-5, 2.0 ** -8
CASES = {   # name: (arch, overrides)
    "llama": ("llama3.2-3b", {}),
    "paligemma": ("paligemma-3b", {"n_heads": 3}),
    "mamba2": ("mamba2-1.3b", {}),
    "zamba2": ("zamba2-7b", {"n_layers": 7}),
    "kimi": ("kimi-k2-1t-a32b", {"moe_a2a_int8": True}),
    "grok": ("grok-1-314b", {"n_experts": 3}),
    "llama_b1": ("llama3.2-3b", {}),
}
ROWS = {"llama_b1": 1}    # the global batch where it is not B
MOE = ("kimi", "grok")
SSD = ("mamba2", "zamba2")
# the JAX side's two subprocesses, run at once
JAX_PARTS = (("llama", "paligemma", "mamba2", "llama_b1"),
             ("zamba2", "kimi", "grok"))
KV_REPEAT = ("llama3.2-3b", {"n_kv_heads": 1})   # port-only: kv_repeat 2

# argv: the inputs (.npz), the initial parameters (.npz, written first),
# the results (.npz), the comma-separated cases it runs
JAX_SIDE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_config, reduced_config
from repro.models import lm, transformer
from repro.runtime import lm_serve
from repro.sharding import params as sp
from repro.sharding.rules import MeshRules

inp = np.load(sys.argv[1])
spec = json.loads(str(inp["spec"]))
part = sys.argv[4].split(",")


def flat(prefix, tree, out):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/" + "/".join(
            str(getattr(k, "key", getattr(k, "idx", k))) for k in path)] = \
            np.asarray(leaf)


init, out, todo = {}, {}, {}
for case in part:
    arch, over = spec["cases"][case]
    cfg = reduced_config(get_config(arch), **over)
    params = transformer.init_params(jax.random.PRNGKey(0), cfg)
    flat(case + "/params", params, init)
    todo[case] = (cfg, params)
np.savez(sys.argv[2] + ".part.npz", **init)
os.replace(sys.argv[2] + ".part.npz", sys.argv[2])

mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
rules = MeshRules(tp=2, mesh=mesh)


def put(tree, specs):
    return jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                        tree, specs)


with mesh:
    for case, (cfg, params) in todo.items():
        params = put(params, sp.param_specs(cfg, rules, mesh))
        batch = {k: inp[f"{case}/{k}"] for k in ("tokens", "prefix_embed")
                 if f"{case}/{k}" in inp.files}
        batch = put(batch, sp.batch_specs(cfg, rules, mesh, batch))
        logits, caches = jax.jit(lm_serve.make_prefill_step(cfg, rules))(
            params, batch)
        caches = lm.extend_caches(cfg, caches, spec["s_max"])
        caches = put(caches, sp.cache_specs(cfg, rules, mesh, caches))
        out[case + "/prefill_logits"] = np.asarray(logits)
        flat(case + "/prefill_caches", caches, out)
        prompt_len = batch["tokens"].shape[1] + (
            batch["prefix_embed"].shape[1] if "prefix_embed" in batch else 0)
        step = jax.jit(lm_serve.make_serve_step(cfg, rules))
        pick = lambda lg: jnp.argmax(lg[:, -1, :cfg.vocab_size],
                                     axis=-1).astype(jnp.int32)[:, None]
        tok = pick(logits)
        toks = [tok]
        for i in range(spec["n_tokens"] - 1):
            logits, caches = step(params, tok, caches,
                                  jnp.int32(prompt_len + i))
            out[f"{case}/decode_logits/{i}"] = np.asarray(logits)
            tok = pick(logits)
            toks.append(tok)
        out[case + "/tokens"] = np.asarray(jnp.concatenate(toks, axis=1))
        flat(case + "/final_caches", caches, out)
np.savez(sys.argv[3], **out)
"""


def _cfg(arch, over):
    return reduced_config(get_config(arch), **over)


def _b(case) -> int:
    return ROWS.get(case, B)


def _case_rows(case, data: int) -> slice:
    """Data rank ``data``'s rows of the case's batch: its half, or every
    row of a batch that does not divide over the 2 data ranks."""
    b = _b(case)
    return slice(None) if b % 2 else slice(data * b // 2,
                                           (data + 1) * b // 2)


def _inputs() -> dict:
    """Each case's prompt (the same rows on both sides) and the spec."""
    out = {"spec": np.asarray(json.dumps({"cases": CASES, "s_max": S_MAX,
                                          "n_tokens": N_TOKENS}))}
    rng = np.random.default_rng(5)
    for case, (arch, over) in CASES.items():
        cfg = _cfg(arch, over)
        out[case + "/tokens"] = rng.integers(
            0, cfg.vocab_size, (_b(case), S)).astype(np.int32)
        if cfg.prefix_len:
            out[case + "/prefix_embed"] = rng.normal(
                size=(_b(case), cfg.prefix_len, cfg.d_model)).astype(
                    np.float32)
    return out


def _unflat(arrays, prefix: str) -> dict:
    """The nested dict of the ``prefix/...`` keys of ``arrays``."""
    tree = {}
    for key in arrays:
        if key.startswith(prefix + "/"):
            *path, last = key[len(prefix) + 1:].split("/")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[last] = np.asarray(arrays[key])
    return tree


def _batch(inputs, case, rows=slice(None)) -> dict:
    return {k: torch.as_tensor(inputs[f"{case}/{k}"][rows])
            for k in ("tokens", "prefix_embed")
            if f"{case}/{k}" in inputs}


def _prompt_len(batch) -> int:
    pre = batch.get("prefix_embed")
    return batch["tokens"].shape[1] + (pre.shape[1] if pre is not None else 0)


def _blocks(caches) -> dict:
    return {k: tuple(t.numpy().copy() for t in pair)
            for k, pair in caches.items()}


def _serve(params, cfg, batch, rules, rows: int):
    """Prefill, then N_TOKENS - 1 greedy decode steps: the logits of each,
    the tokens, and the caches after the prefill and after the last step
    (this rank's blocks, and the whole ones of the ``rows``-row global
    batch)."""
    out = {}
    logits, caches = lm_serve.make_prefill_step(cfg, S_MAX, rules)(params,
                                                                   batch)
    out["prefill_logits"] = logits.numpy().copy()
    out["prefill_blocks"] = _blocks(caches)
    out["prefill_caches"] = convert.lm_caches_to_arrays(caches, cfg, rules,
                                                        rows)
    step = lm_serve.make_serve_step(cfg, rules)

    def pick(lg):
        return lg[:, -1, :cfg.vocab_size].argmax(-1).to(torch.int32)[:, None]

    tok = pick(logits)
    toks, decode = [tok], []
    for i in range(N_TOKENS - 1):
        logits, caches = step(params, tok, caches, _prompt_len(batch) + i)
        decode.append(logits.numpy().copy())
        tok = pick(logits)
        toks.append(tok)
    out["decode_logits"] = decode
    out["tokens"] = torch.cat(toks, dim=1).numpy()
    out["final_caches"] = convert.lm_caches_to_arrays(caches, cfg, rules,
                                                      rows)
    return out


def _ranks(init: dict, inputs: dict) -> dict:
    """Every case on this rank of the 4."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    mesh = t_mesh.make_host_mesh(4, ("data", "model"), device="cpu")
    rules = MeshRules(tp=2, mesh=mesh)
    d = mesh.get_local_rank("data")
    rows = _case_rows("llama", d)
    out = {"rank": dist.get_rank(), "data": d,
           "model": mesh.get_local_rank("model")}
    for case, (arch, over) in CASES.items():
        cfg = _cfg(arch, over)
        params = convert.lm_params_from_arrays(init[case], cfg, "cpu",
                                               rules=rules)
        batch = _batch(inputs, case, _case_rows(case, d))
        out[case] = _serve(params, cfg, batch, rules, _b(case))
        out[case]["generate"] = lm_serve.generate(
            params, cfg, batch, N_TOKENS, S_MAX, rules=rules).numpy()
        if case == "llama":    # each data row's own generator state
            gen = torch.Generator().manual_seed(100 + d)
            out["sampled"] = lm_serve.generate(
                params, cfg, batch, N_TOKENS, S_MAX, greedy=False,
                generator=gen, temperature=0.7, rules=rules).numpy()

    # kv_repeat 2: the repeated kv heads' true heads into the cache
    cfg = _cfg(*KV_REPEAT)
    full = transformer.init_params(0, cfg, device="cpu")
    local = t_sp.shard_tree(full, t_sp.param_specs(cfg, rules,
                                                   t_sp.mesh_axes(mesh)),
                            mesh)
    batch = _batch(inputs, "llama", rows)
    out["kv_repeat"] = lm_serve.generate(local, cfg, batch, N_TOKENS, S_MAX,
                                         rules=rules).numpy()
    return out


@pytest.fixture(scope="module")
def runs():
    """(JAX's results, the ranks' results), once for the module: the JAX
    side in two subprocesses at once (`JAX_PARTS`), the ranks spawned as
    soon as both have written their initial parameters."""
    pytest.importorskip("jax")
    with tempfile.TemporaryDirectory(prefix="lm_mesh_serve_") as d:
        inputs = _inputs()
        np.savez(os.path.join(d, "in.npz"), **inputs)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
                   + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu")
        procs = []
        for i, part in enumerate(JAX_PARTS):
            paths = [os.path.join(d, f) for f in
                     ("in.npz", f"init{i}.npz", f"out{i}.npz")]
            procs.append((paths, subprocess.Popen(
                [sys.executable, "-c", JAX_SIDE, *paths, ",".join(part)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        init, want = {}, {}
        for paths, proc in procs:
            while not os.path.exists(paths[1]) and proc.poll() is None:
                time.sleep(0.2)
            if not os.path.exists(paths[1]):
                pytest.fail("the JAX side wrote no initial parameters:\n"
                            + proc.communicate()[0][-4000:])
            with np.load(paths[1]) as f:
                init.update({case: _unflat(f, case + "/params")
                             for case in CASES
                             if case + "/params/embed" in f.files})
        outs = t_mesh.spawn(_ranks, 4, "cpu", (init, inputs))
        for paths, proc in procs:
            log = proc.communicate(timeout=600)[0]
            assert proc.returncode == 0, log[-4000:]
            with np.load(paths[2]) as f:
                want.update({k: f[k] for k in f.files})
    yield types.SimpleNamespace(want=want, outs=outs, init=init,
                                inputs=inputs)


def _tol(case) -> float:
    return SSD_TOL if case in SSD else TOL


def _rows(out, case="llama") -> slice:
    return _case_rows(case, out["data"])


def _jax_caches(want, prefix) -> dict:
    """JAX's cache tree {"kv": (k, v), ...} from its flat arrays."""
    tree = _unflat(want, prefix)
    return {k: (pair["0"], pair["1"]) for k, pair in tree.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_serving_matches_jax(runs, case):
    """The prefill's last logits, each decode step's, every cache leaf
    gathered after the prefill and after the last step: within the
    tolerance of JAX's; the greedy tokens equal to JAX's sharded tokens,
    by the decode loop and by `generate(rules=)`."""
    tol = _tol(case)
    for out in runs.outs:
        got, rows = out[case], _rows(out, case)
        np.testing.assert_allclose(
            got["prefill_logits"], runs.want[case + "/prefill_logits"][rows],
            rtol=tol, atol=tol)
        for i, lg in enumerate(got["decode_logits"]):
            np.testing.assert_allclose(
                lg, runs.want[f"{case}/decode_logits/{i}"][rows], rtol=tol,
                atol=tol, err_msg=f"decode step {i}")
        for when in ("prefill_caches", "final_caches"):
            want = _jax_caches(runs.want, f"{case}/{when}")
            assert set(got[when]) == set(want)
            for key in want:
                for a, w in zip(got[when][key], want[key]):
                    assert a.shape == w.shape, (when, key)
                    np.testing.assert_allclose(a, w, rtol=tol, atol=tol,
                                               err_msg=f"{when} {key}")
        np.testing.assert_array_equal(got["tokens"],
                                      runs.want[case + "/tokens"][rows])
        np.testing.assert_array_equal(got["generate"], got["tokens"])


class _Coords:
    """A rank's view of the (2, 2) mesh with no group: its coordinates."""

    def __init__(self, data: int, model: int):
        self.shape = {"data": 2, "model": 2}
        self._coords = {"data": data, "model": model}

    def get_local_rank(self, axis):
        return self._coords[axis]


@pytest.mark.parametrize("case", list(CASES))
def test_cache_blocks_follow_cache_specs(runs, case):
    """Each rank's blocks after the prefill are `cache_blocks` of JAX's
    caches at its coordinates: the KV caches (L, B/2, S_max/2, KV, hd) (the
    slots of model rank m from m·S_max/2, the true kv heads; B rows where
    B does not divide), the SSM states (L, B/2, NH/2, HD, N) as
    `cache_specs` cuts them, the conv caches [the rank's d_inner/2 x
    channels | B | C]."""
    arch, over = CASES[case]
    cfg = _cfg(arch, over)
    rules = MeshRules(tp=2)
    want_full = {k: tuple(torch.as_tensor(t) for t in pair) for k, pair in
                 _jax_caches(runs.want, case + "/prefill_caches").items()}
    for out in runs.outs:
        view = _Coords(out["data"], out["model"])
        rows = t_sp.serve_rows(rules, view, _b(case))
        want = t_sp.cache_blocks(cfg, rules, want_full, view)
        got = out[case]["prefill_blocks"]
        assert set(got) == set(want)
        for key in want:
            for a, w in zip(got[key], want[key]):
                assert a.shape == tuple(w.shape), key
                np.testing.assert_allclose(a, w.numpy(), rtol=_tol(case),
                                           atol=_tol(case), err_msg=key)
        if "kv" in got:
            assert got["kv"][0].shape == (cfg.n_layers, rows, S_MAX // 2,
                                          cfg.n_kv_heads, cfg.head_dim)
        if "ssm" in got:
            assert got["ssm"][1].shape == (cfg.n_layers, rows,
                                           cfg.ssm_nheads // 2,
                                           cfg.ssm_head_dim, cfg.ssm_state)
            assert got["ssm"][0].shape[-1] == \
                cfg.d_inner // 2 + 2 * cfg.ssm_state


def _one_device(runs, case):
    arch, over = CASES[case]
    cfg = _cfg(arch, over)
    params = convert.lm_params_from_arrays(runs.init[case], cfg, "cpu")
    batch = _batch(runs.inputs, case)
    logits, _ = lm.prefill(params, cfg, batch, s_max=S_MAX)
    return logits.numpy(), lm_serve.generate(params, cfg, batch, N_TOKENS,
                                             S_MAX).numpy()


@pytest.mark.parametrize("case", [c for c in CASES if c not in MOE])
def test_sharded_tokens_equal_one_device(runs, case):
    """Every kind but the MoE: the sharded greedy tokens are the port's
    single-device `generate`'s."""
    _, toks = _one_device(runs, case)
    for out in runs.outs:
        np.testing.assert_array_equal(out[case]["tokens"],
                                      toks[_rows(out, case)])


def test_sharded_moe_differs_from_one_device(runs):
    """The JAX package's design, held in decode as in training: each rank
    routes its own tokens at its own capacity and decode sends the
    experts' partial sums back in int8, so kimi's sharded serving is not
    one device's (its logits differ past any rounding)."""
    logits, toks = _one_device(runs, "kimi")
    gaps = [float(np.abs(out["kimi"]["prefill_logits"]
                         - logits[_rows(out)]).max()) for out in runs.outs]
    assert max(gaps) > 1e-2, gaps


def test_kv_repeat_tokens_equal_one_device(runs):
    """A "sharded" head layout with kv_repeat 2 (one kv head over 2 model
    ranks): the prefill writes the true kv head, and the tokens are one
    device's."""
    cfg = _cfg(*KV_REPEAT)
    full = transformer.init_params(0, cfg, device="cpu")
    toks = lm_serve.generate(full, cfg, _batch(runs.inputs, "llama"),
                             N_TOKENS, S_MAX).numpy()
    for out in runs.outs:
        np.testing.assert_array_equal(out["kv_repeat"], toks[_rows(out)])


def test_sampling_agrees_on_the_model_ranks(runs):
    """`generate(rules=, greedy=False)` with a generator in the same state
    on both model ranks of a data row: the same tokens on both."""
    by_row = {}
    for out in runs.outs:
        by_row.setdefault(out["data"], []).append(out["sampled"])
    for row, got in by_row.items():
        assert len(got) == 2
        np.testing.assert_array_equal(got[0], got[1])


# ---------------------------------------------------------------------------
# no ranks
# ---------------------------------------------------------------------------

def _decode_inputs(seed, kv=2, g=3, hd=16, s_max=24, b=2):
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.normal(size=(b, 1, kv, g, hd)).astype(np.float32))
    k = torch.as_tensor(rng.normal(size=(b, s_max, kv, hd)).astype(
        np.float32) * 3)
    v = torch.as_tensor(rng.normal(size=(b, s_max, kv, hd)).astype(
        np.float32))
    return q, k, v


def _combined(q, k, v, tp, length, softcap):
    sb = k.shape[1] // tp
    parts = torch.stack([attention.decode_partials(
        q, k[:, r * sb:(r + 1) * sb], v[:, r * sb:(r + 1) * sb], r * sb,
        length, softcap=softcap) for r in range(tp)])
    return parts, attention.combine_partials(parts)


@pytest.mark.parametrize("softcap", [0.0, 5.0])
@pytest.mark.parametrize("tp", [2, 4])
def test_combine_equals_decode_attention(tp, softcap):
    """The rank blocks' partials combined equal `decode_attention` over the
    whole cache (the single device's), at lengths in the middle of a
    block and at its edges."""
    q, k, v = _decode_inputs(tp)
    for length in (1, 5, 12, 24):
        want = attention.decode_attention(q, k, v, length, softcap=softcap)
        _, got = _combined(q, k, v, tp, length, softcap)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_combine_ignores_blocks_past_the_length():
    """Blocks whose slots all lie past the length (an early decode step on
    a long s_max) have m = NEG_INF and l = their slot count; their weight
    underflows to exactly 0, whatever their slots hold."""
    q, k, v = _decode_inputs(7, s_max=32)
    k[:, 8:] = 1e4      # garbage past the length must not leak in
    v[:, 8:] = 1e4
    parts, got = _combined(q, k, v, 4, 3, 0.0)
    assert torch.all(parts[1:, ..., -2] == attention.NEG_INF)
    assert torch.all(parts[1:, ..., -1] == 8)
    torch.testing.assert_close(
        got, attention.decode_attention(q, k[:, :8], v[:, :8], 3),
        rtol=1e-6, atol=1e-6)
    one_block = attention.combine_partials(parts[:1])
    assert torch.equal(got, one_block)


class _NoRanks:
    """A mesh of the given axis sizes with no process group behind it."""

    def __init__(self, **sizes):
        self.shape = sizes

    def get_group(self, axis):
        return None

    def get_local_rank(self, axis):
        return 0


def test_serving_refuses_shapes_that_do_not_divide():
    """s_max over the model ranks and the prompt (prefix included) over
    them: `ValueError` where the JAX package would replicate the dim. (A
    batch that does not divide over the data ranks is replicated, as JAX
    does: the ``llama_b1`` case of the spawn.)"""
    cfg = _cfg("llama3.2-3b", {})
    rules = MeshRules(tp=2, mesh=_NoRanks(data=2, model=2))
    with pytest.raises(ValueError, match=r"s_max=63 slots over the 2 model"):
        lm.init_caches(cfg, 4, 63, rules=rules, device="cpu")
    params = transformer.init_params(0, cfg, device="cpu")
    tokens = torch.zeros((2, 31), dtype=torch.int64)
    with pytest.raises(ValueError, match=r"sequence \(31 positions\) over "
                                         r"the 2 model ranks"):
        lm.prefill(params, cfg, {"tokens": tokens}, s_max=64, rules=rules)
    with pytest.raises(ValueError, match=r"s_max=33 slots"):
        lm.prefill(params, cfg, {"tokens": tokens[:, :30]}, s_max=33,
                   rules=rules)
    pali = _cfg("paligemma-3b", {"n_heads": 3})
    pali_rules = MeshRules(tp=2, mesh=_NoRanks(data=2, model=2))
    batch = {"tokens": torch.zeros((2, 31), dtype=torch.int64),
             "prefix_embed": torch.zeros((2, pali.prefix_len, pali.d_model))}
    with pytest.raises(ValueError, match=r"sequence \(39 positions\)"):
        lm.prefill(transformer.init_params(0, pali, device="cpu"), pali,
                   batch, s_max=64, rules=pali_rules)


def test_decode_refuses_a_position_past_s_max():
    """A decode step at position s_max has no slot on any rank: refused,
    where the single-device cache write fails on the shapes."""
    cfg = _cfg("llama3.2-3b", {})
    rules = MeshRules(tp=2, mesh=_NoRanks(data=2, model=2))
    params = transformer.init_params(0, cfg, device="cpu")
    caches = lm.init_caches(cfg, 4, 64, rules=rules, device="cpu")
    token = torch.zeros((2, 1), dtype=torch.int64)
    with pytest.raises(ValueError, match=r"position 64, past the caches' "
                                         r"s_max=64 slots"):
        lm.decode_step(params, cfg, token, caches, 64, rules=rules)


def test_moe_one_token_form(monkeypatch):
    """`moe_block_sharded(seq_sharded=False)` on a one-token input at tp 2
    (groups of one rank standing in): no sequence gather, the int8
    exchange both ways, and the partial sums all-reduced, not
    reduce-scattered; with exchanges that move nothing it is the local
    block's output. The train step's form (``seq_sharded=True``) gathers
    the sequence and sends the partial sums back at full width."""
    from repro_torch.core import comm
    from repro_torch.sharding.spmd import Layout

    cfg = _cfg("kimi-k2-1t-a32b", {"moe_a2a_int8": True})
    lay = Layout.build(cfg, MeshRules(tp=2, mesh=_NoRanks(data=2, model=2)))
    assert lay.ep_mode == "alltoall"
    calls = []

    def record(name, result=None):
        def fn(x, *args):
            calls.append(name)
            return x if result is None else result(x)
        return fn

    for name in ("gather_along", "reduce_scatter_along", "reduce_from_group",
                 "quantized_all_to_all", "all_to_all_along"):
        monkeypatch.setattr(comm, name, record(name))
    params = moe.init_moe(torch.Generator().manual_seed(0), cfg,
                          torch.float32)
    specs = {k: (None,) * t.ndim for k, t in params.items()}
    x = torch.randn((3, 1, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    y, _ = moe.moe_block_sharded(params, cfg, x, lay, specs,
                                 seq_sharded=False)
    assert calls == ["quantized_all_to_all", "quantized_all_to_all",
                     "reduce_from_group"]
    torch.testing.assert_close(y, moe.moe_block(params, cfg, x)[0],
                               rtol=1e-5, atol=1e-6)
    calls.clear()
    moe.moe_block_sharded(params, cfg, x, lay, specs, seq_sharded=True)
    assert calls == ["gather_along", "quantized_all_to_all",
                     "all_to_all_along", "reduce_scatter_along"]
