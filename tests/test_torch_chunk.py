"""The port's chunked generation loop (`nsga2.make_chunk`, the engine's
`_chunk_schedule` / `_drive_chunks`) and checkpoint/resume
(`runtime.checkpoint`), held to the JAX package's engine and checkpoint
format on the CPU. (On the card, a captured chunk is held to the eager loop
in tests/test_torch_kernels.py, which imports no JAX.)

Every comparison is exact: a chunked or resumed run must equal the
uninterrupted per-generation loop element for element.
"""
from __future__ import annotations

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import search as j_search
from repro.core import nsga2 as j_nsga2
from repro.core import train as j_train
from repro.core import tree as j_tree
from repro.runtime import checkpoint as j_ckpt
from repro.search import engine as j_engine
from repro_torch import search as t_search
from repro_torch.core import nsga2 as t_nsga2
from repro_torch.core import train as t_train
from repro_torch.core import tree as t_tree
from repro_torch.datasets import load_dataset
from repro_torch.runtime import checkpoint as t_ckpt
from repro_torch.search import engine as t_engine

STATE = ("genes", "objs", "rank", "crowd")


@functools.lru_cache(maxsize=None)
def _seeds(device="cpu"):
    ds = load_dataset("seeds")
    pt = t_tree.to_parallel(t_train.train_tree(ds.x_train, ds.y_train,
                                               ds.n_classes))
    return t_search.build_problem(pt, ds.x_test, ds.y_test, device=device)


def _zdt1(genes):
    f1 = genes[:, 0]
    g = 1 + 9 * genes[:, 1:].mean(1)
    return torch.stack([f1, g * (1 - torch.sqrt(f1 / g))], 1)


def _assert_states_equal(a, b):
    for f in STATE:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.generation == b.generation


def _start(fitness, p, g, device, seed=4):
    gen = torch.Generator(device=device).manual_seed(seed)
    cfg = t_nsga2.NSGA2Config(pop_size=p)
    state = t_nsga2.init_state(fitness, cfg, t_nsga2.draw_init(
        gen, p, g, 0, device))
    return cfg, gen, state


@pytest.mark.parametrize("lengths", [(9,), (4, 5), (1, 1, 7)])
def test_make_chunk_equals_stepped_loop(lengths):
    """Chunks of any split equal `make_step` called once per generation,
    each fed `draw_step` from the same generator (the counterpart of
    tests/test_core_nsga2.py::test_make_chunk_bitexact_vs_stepped_loop)."""
    cfg, gen, state = _start(_zdt1, 24, 6, "cpu")
    step = t_nsga2.make_step(_zdt1, cfg)
    stepped = state
    for _ in range(sum(lengths)):
        stepped = step(stepped, t_nsga2.draw_step(gen, 24, 6, "cpu"))
    _, gen2, chunked = _start(_zdt1, 24, 6, "cpu")
    for n in lengths:
        chunked = t_nsga2.make_chunk(_zdt1, cfg, n)(chunked, gen2)
    _assert_states_equal(stepped, chunked)
    assert chunked.generation == sum(lengths)
    assert torch.equal(gen.get_state(), gen2.get_state())


@pytest.mark.parametrize("length", [0, -3])
def test_make_chunk_rejects_empty_chunk(length):
    with pytest.raises(ValueError, match="chunk_len"):
        t_nsga2.make_chunk(_zdt1, t_nsga2.NSGA2Config(), length)


def test_draw_step_into_buffers_draws_the_same_numbers():
    a = torch.Generator().manual_seed(1)
    b = torch.Generator().manual_seed(1)
    want = t_nsga2.draw_step(a, 10, 3, "cpu")
    out = t_nsga2.draw_step(b, 10, 3, "cpu")
    out = t_nsga2.StepDraws(**{k: torch.empty_like(v)
                               for k, v in vars(out).items()})
    b.manual_seed(1)
    got = t_nsga2.draw_step(b, 10, 3, "cpu", out=out)
    for k, v in vars(want).items():
        assert torch.equal(getattr(got, k), v), k
        assert getattr(got, k) is getattr(out, k)


SCHEDULES = [(s, e, k) for s in (0, 1, 3, 6) for e in (0, 5, 7, 12)
             for k in (0, 1, 3, 5)]


@pytest.mark.parametrize("every", [0, 1, 3, 5])
def test_chunk_schedule_matches_jax(every):
    for start, stop, k in SCHEDULES:
        if k != every:
            continue
        assert (t_engine._chunk_schedule(start, stop, every)
                == j_engine._chunk_schedule(start, stop, every))
    with pytest.raises(ValueError, match="checkpoint_every"):
        t_engine._chunk_schedule(0, 5, -1)


def _run(problem, tmp, gens, **kw):
    return t_search.run_search(problem, backend="kernel", pop_size=16,
                               n_generations=gens, seed=3,
                               out_dir=str(tmp) if tmp else None, **kw)


def test_resume_is_bitexact_and_realigns(tmp_path):
    """A run cut at generation 5 (off the every-3 boundary) and resumed to
    7 equals the uninterrupted run: population, ranks, crowding and the
    generator state saved at the end; the resumed chunks realign to the
    cadence (6, then 7)."""
    problem = _seeds()
    full = _run(problem, tmp_path / "full", 7, checkpoint_every=3)
    part = _run(problem, tmp_path / "cut", 5, checkpoint_every=3)
    assert sorted(os.listdir(tmp_path / "cut" / "ckpt")) == [
        "ckpt_00000003", "ckpt_00000005"]
    resumed = _run(problem, tmp_path / "cut", 7, checkpoint_every=3,
                   resume=True)
    _assert_states_equal(full.state, resumed.state)
    assert part.n_dispatches == 1 + 2 and resumed.n_dispatches == 2
    assert resumed.n_evaluations == 16 * 2
    assert sorted(os.listdir(tmp_path / "cut" / "ckpt")) == [
        "ckpt_00000005", "ckpt_00000006", "ckpt_00000007"]
    like = t_engine._restore_template(problem, t_engine.SearchConfig(
        pop_size=16), torch.Generator())
    a, _ = t_ckpt.restore(str(tmp_path / "full" / "ckpt"), 7, like)
    b, _ = t_ckpt.restore(str(tmp_path / "cut" / "ckpt"), 7, like)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(full.pareto_objs, resumed.pareto_objs)


def _write_jax_checkpoint(path, p, n_genes, meta, step=2):
    state = j_nsga2.NSGA2State(
        genes=jnp.zeros((p, n_genes), jnp.float32),
        objs=jnp.zeros((p, 2), jnp.float32), rank=jnp.zeros((p,), jnp.int32),
        crowd=jnp.zeros((p,), jnp.float32), key=jax.random.PRNGKey(0),
        generation=jnp.int32(step))
    j_ckpt.save(str(path), step, state, meta=meta)


@pytest.mark.parametrize("what", ["family", "pop size", "rng"])
def test_resume_refuses_another_layout(tmp_path, what):
    problem = _seeds()
    ckpt = tmp_path / "ckpt"
    if what == "rng":   # a JAX search checkpoint: a threefry key, no "rng"
        _write_jax_checkpoint(ckpt, 16, problem.n_genes, {
            "family": "single", "backend": "kernel", "pop_size": 16})
        match = "threefry"
    else:
        _run(problem, tmp_path, 2, checkpoint_every=2)
        if what == "family":
            manifest = ckpt / "ckpt_00000002" / "manifest.json"
            data = json.loads(manifest.read_text())
            data["meta"]["family"] = "islands"
            manifest.write_text(json.dumps(data))
            match = "'islands' driver"
        else:
            match = "pop_size=16"
    with pytest.raises(ValueError, match=match) as err:
        t_search.run_search(problem, backend="kernel",
                            pop_size=16 if what != "pop size" else 8,
                            n_generations=4, out_dir=str(tmp_path),
                            checkpoint_every=2, resume=True)
    assert "\n" not in str(err.value)


def test_checkpoint_every_without_out_dir_is_one_dispatch():
    problem = _seeds()
    a = _run(problem, None, 5, checkpoint_every=2)
    b = _run(problem, None, 5)
    assert a.n_dispatches == b.n_dispatches == 2
    _assert_states_equal(a.state, b.state)
    with pytest.raises(ValueError, match="checkpoint_every"):
        _run(problem, None, 5, checkpoint_every=-1)


@pytest.mark.parametrize("gens,every", [(5, 2), (6, 3), (4, 0)])
def test_n_dispatches_match_jax(tmp_path, gens, every):
    """`SearchResult.n_dispatches` is 1 + the number of chunks, as in the
    JAX engine, for the same schedule (both record it in pareto.json)."""
    ds = load_dataset("seeds")
    jp = j_search.build_tree_problem(
        j_tree.to_parallel(j_train.train_tree(ds.x_train, ds.y_train,
                                              ds.n_classes)),
        ds.x_test, ds.y_test)
    want = j_search.run_search(jp, backend="reference", pop_size=8,
                               n_generations=gens, checkpoint_every=every,
                               out_dir=str(tmp_path / "j"))
    got = t_search.run_search(_seeds(), backend="reference", pop_size=8,
                              n_generations=gens, checkpoint_every=every,
                              out_dir=str(tmp_path / "t"))
    assert got.n_dispatches == want.n_dispatches
    assert got.n_evaluations == want.n_evaluations
    saved = json.loads((tmp_path / "t" / "pareto.json").read_text())
    assert saved["n_dispatches"] == want.n_dispatches
    if every:
        assert (sorted(os.listdir(tmp_path / "t" / "ckpt"))
                == sorted(os.listdir(tmp_path / "j" / "ckpt")))


# --- runtime.checkpoint (counterparts of tests/test_runtime.py:15-75) ------

def _leaves():
    return (torch.arange(12.0).reshape(3, 4), torch.ones((5,),
                                                         dtype=torch.int32),
            torch.tensor(3.5), np.arange(4, dtype=np.uint8))


def test_checkpoint_roundtrip(tmp_path):
    leaves = _leaves()
    path = t_ckpt.save(str(tmp_path), 7, leaves, meta={"rng": "torch"})
    assert os.path.isdir(path)
    like = [torch.zeros_like(torch.as_tensor(x)) for x in leaves]
    restored, step = t_ckpt.restore(str(tmp_path), 7, like)
    assert step == 7
    for a, b in zip(leaves, restored):
        assert torch.equal(torch.as_tensor(a), b)
        assert b.dtype == torch.as_tensor(a).dtype
    manifest = t_ckpt.read_manifest(str(tmp_path), 7)
    assert manifest["keys"] == ["0", "1", "2", "3"]
    assert manifest["meta"] == {"rng": "torch"}
    with pytest.raises(ValueError, match="shape"):
        t_ckpt.restore(str(tmp_path), 7, [torch.zeros(2)])


def test_checkpoint_retention_and_latest(tmp_path):
    for s in range(6):
        t_ckpt.save(str(tmp_path), s, (torch.zeros(2),), keep=3)
    assert t_ckpt.latest_step(str(tmp_path)) == 5
    kept = sorted(os.listdir(tmp_path))
    assert len([d for d in kept if d.startswith("ckpt_")]) == 3


def test_checkpoint_crash_safety(tmp_path):
    """A leftover .tmp dir (a crash mid-save) never corrupts a restore."""
    leaves = (torch.arange(4.0),)
    t_ckpt.save(str(tmp_path), 1, leaves)
    os.makedirs(os.path.join(tmp_path, "ckpt_00000002.tmp"))
    assert t_ckpt.latest_step(str(tmp_path)) == 1
    restored, _ = t_ckpt.restore(str(tmp_path), 1, leaves)
    assert torch.equal(restored[0], leaves[0])


def test_checkpoint_resume_skips_truncated_npz(tmp_path):
    leaves = (torch.arange(4.0), torch.ones((3,), dtype=torch.int32))
    t_ckpt.save(str(tmp_path), 1, leaves)
    t_ckpt.save(str(tmp_path), 2, leaves)
    npz = os.path.join(tmp_path, "ckpt_00000002", "arrays.npz")
    with open(npz, "rb") as f:
        blob = f.read()
    with open(npz, "wb") as f:
        f.write(blob[: len(blob) // 2])   # torn write
    with pytest.warns(UserWarning, match="skipping unreadable checkpoint"):
        step = t_ckpt.latest_step(str(tmp_path))
    assert step == 1
    restored, got = t_ckpt.restore(str(tmp_path), step, leaves)
    assert got == 1 and all(torch.equal(a, b)
                            for a, b in zip(leaves, restored))


def test_checkpoint_resume_skips_corrupt_manifest(tmp_path):
    leaves = (torch.arange(4.0),)
    t_ckpt.save(str(tmp_path), 1, leaves)
    t_ckpt.save(str(tmp_path), 2, leaves)
    with open(os.path.join(tmp_path, "ckpt_00000002",
                           "manifest.json"), "w") as f:
        f.write('{"step": 2, "keys"')   # truncated JSON
    with pytest.warns(UserWarning, match="ckpt_00000002"):
        assert t_ckpt.latest_step(str(tmp_path)) == 1
    os.remove(os.path.join(tmp_path, "ckpt_00000001", "manifest.json"))
    with pytest.warns(UserWarning):
        assert t_ckpt.latest_step(str(tmp_path)) is None


def test_port_reads_jax_checkpoints(tmp_path):
    """On a directory `repro.runtime.checkpoint.save` wrote, the port's
    `read_manifest`, `checkpoint_error` and `latest_step` agree with the
    JAX package's (the same layout), torn saves included."""
    for step in (1, 2, 3):
        _write_jax_checkpoint(tmp_path, 4, 7, {"family": "single",
                                               "pop_size": 4}, step=step)
    npz = tmp_path / "ckpt_00000003" / "arrays.npz"
    npz.write_bytes(npz.read_bytes()[:100])
    for step in (1, 2, 3):
        assert (t_ckpt.read_manifest(str(tmp_path), step)
                == j_ckpt.read_manifest(str(tmp_path), step))
        assert ((t_ckpt.checkpoint_error(str(tmp_path), step) is None)
                == (j_ckpt.checkpoint_error(str(tmp_path), step) is None))
    with pytest.warns(UserWarning):
        want = j_ckpt.latest_step(str(tmp_path))
    with pytest.warns(UserWarning):
        assert t_ckpt.latest_step(str(tmp_path)) == want == 2
    manifest = t_ckpt.read_manifest(str(tmp_path), 2)
    assert manifest["keys"] == ["0", "1", "2", "3", "4", "5"]
    # the port writes the same keys: genes, objs, rank, crowd, rng, gen
    problem = _seeds()
    _run(problem, tmp_path / "t", 2, checkpoint_every=2)
    ours = t_ckpt.read_manifest(str(tmp_path / "t" / "ckpt"), 2)
    assert ours["keys"] == manifest["keys"]
    assert ours["meta"]["rng"] == "torch"
    assert ours["dtypes"]["4"] == "uint8" and ours["dtypes"]["5"] == "int32"
