"""The port's train step, checkpoints and training launcher held to the
JAX package on the CPU: three `make_train_step` steps from the JAX
package's own state (converted with `convert.train_state_from_arrays`)
equal to its three jitted steps, AdamW with grad_accum 1 and 2 and
Adafactor with grad_accum 2 (bf16 accumulation), clipping active; a
checkpoint the JAX package wrote restores into the port (bf16 leaves by
their raw words, which the JAX package's own restore refuses); and
`python -m repro_torch.launch.train --device cpu --reduced` resumed from
its `--ckpt-dir` equal to the uninterrupted run, bit for bit.

Tolerances (float32 parameters): the metrics (loss, grad_norm) within
1e-5 of the JAX value, the optimizer states within 1e-4 of each leaf's
largest magnitude, and the parameters within 1% of one step's update,
0.01 lr (AdamW's update lr m / (sqrt v + 1e-8) is about lr in size,
Adafactor's RMS-clipped to lr). The sides' gradients differ by their
summation orders alone (`tests/test_torch_train.py`: 1e-4 of their scale),
and an update divides by sqrt v, so a gradient near zero moves its update
by more than its own share: measured at most 2.5e-6 (0.25% of an AdamW
step) and 5e-6 of a state's scale. Adafactor with its config's bf16
accumulation: each summed gradient is rounded to 8 bits, so an element
whose float32 sum falls on the other side of a rounding boundary differs
by a bf16 ulp (2^-8 of it), and the factored moments and the RMS clip
carry that on: held to 1e-4 in the metrics, 2^-5 of a state's scale and
0.1 lr in the parameters (measured at step 3: 4.1e-5, 9.5e-3 and 0.037
lr).

The JAX package is imported by a fixture, so the machine with the card
(which has no JAX) skips the parity tests.
"""
from __future__ import annotations

import json
import os
import shutil
import types

import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (the card's reduced step check)
from repro_torch import CudaUnavailableError, convert, pytree  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.optim import get_optimizer  # noqa: E402
from repro_torch.runtime import checkpoint, train  # noqa: E402

REL = 1e-5
CLIP = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module, restored after it: at these
    sizes PyTorch's threads only contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro import configs
    from repro.models import transformer as j_tf
    from repro.optim import get_optimizer as j_get_optimizer
    from repro.runtime import checkpoint as j_ckpt
    from repro.runtime import train as j_train
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, configs=configs,
                                 tf=j_tf, train=j_train, ckpt=j_ckpt,
                                 get_optimizer=j_get_optimizer)


def _hold(got_tree, want_tree, rel=None, atol=None):
    """Every leaf of ``got_tree`` within ``rel`` of the JAX leaf's largest
    magnitude, or within ``atol``."""
    got = {pytree.path_str(p): t for p, t in pytree.leaves_with_paths(
        got_tree)}
    for path, w in pytree.leaves_with_paths(want_tree):
        key = pytree.path_str(path)
        w = np.asarray(w, np.float32)
        g = got[key].to(torch.float32).numpy()
        tol = atol if atol is not None else \
            rel * max(float(np.abs(w).max()), 1e-30)
        assert np.abs(g - w).max() <= tol, (key, np.abs(g - w).max(), tol)


STEP_CASES = [  # (arch, grad_accum, accumulation dtype, metric rel,
    #              state rel, params atol in lr)
    ("llama3.2-3b", 1, "float32", 1e-5, 1e-4, 0.01),
    ("llama3.2-3b", 2, "float32", 1e-5, 1e-4, 0.01),
    ("grok-1-314b", 2, "float32", 1e-5, 1e-4, 0.01),
    ("grok-1-314b", 2, "bfloat16", 1e-4, 2.0 ** -5, 0.1),
]


@pytest.mark.parametrize("arch,accum,acc_dtype,m_rel,s_rel,p_lr",
                         STEP_CASES)
def test_three_steps_match_jax(jx, arch, accum, acc_dtype, m_rel, s_rel,
                               p_lr):
    over = dict(grad_accum=accum, grad_accum_dtype=acc_dtype)
    cfg_j = jx.configs.reduced_config(jx.configs.get_config(arch), **over)
    cfg_t = reduced_config(get_config(arch), **over)
    opt_j = jx.get_optimizer(cfg_j)
    lr = 1e-2 if cfg_t.optimizer == "adafactor" else 1e-3   # the defaults
    state_j = jx.train.init_train_state(
        jx.tf.init_params(jx.jax.random.PRNGKey(0), cfg_j), opt_j)
    step_j = jx.jax.jit(jx.train.make_train_step(cfg_j, optimizer=opt_j,
                                                 max_grad_norm=CLIP))
    to_np = lambda t: jx.jax.tree.map(np.asarray, t)  # noqa: E731
    state_t = convert.train_state_from_arrays(
        to_np(state_j.params), to_np(state_j.opt_state), int(state_j.step),
        cfg_t, device="cpu")
    step_t = train.make_train_step(cfg_t, optimizer=get_optimizer(cfg_t),
                                   max_grad_norm=CLIP)
    data = SyntheticLMData(cfg_t.vocab_size, 32, 4, seed=2)
    for step in range(3):
        tokens = data.batch(step)["tokens"]
        state_j, m_j = step_j(state_j, {"tokens": jx.jnp.asarray(tokens)})
        state_t, m_t = step_t(state_t, {"tokens": torch.as_tensor(tokens)})
        assert set(m_t) == set(m_j)
        for key in m_t:
            a, b = float(m_t[key]), float(m_j[key])
            assert abs(a - b) <= m_rel * max(abs(b), 1.0), (step, key, a, b)
        assert float(m_t["grad_norm"]) > CLIP        # the clip is active
        assert int(state_t.step) == int(state_j.step) == step + 1
        _hold(state_t.params, state_j.params, atol=p_lr * lr)
        _hold(state_t.opt_state, state_j.opt_state, rel=s_rel)


def test_make_train_step_refuses_rules():
    """The sharded step runs every layer kind (tests/test_torch_lm_mesh.py,
    tests/test_torch_lm_mesh_kinds.py) and refuses rules with no mesh of
    ranks behind them, for SSM, hybrid and MoE configs too: no kind falls
    back to one device quietly."""
    from repro_torch.sharding.rules import MeshRules

    for arch in ("mamba2-1.3b", "zamba2-7b", "grok-1-314b"):
        cfg = reduced_config(get_config(arch))
        with pytest.raises(ValueError, match=r"needs rules\.mesh"):
            train.make_train_step(cfg, rules=MeshRules(tp=2))


def test_jax_checkpoint_restores_into_the_port(jx, tmp_path):
    """A reduced float32 AdamW state the JAX package saved (its moments
    random, its step 7) restores leaf for leaf; a bfloat16 tree the JAX
    package saved restores bit for bit, and the port's save of it holds
    the same raw words under the same manifest dtype."""
    arch = "llama3.2-3b"
    cfg_j = jx.configs.reduced_config(jx.configs.get_config(arch))
    cfg_t = reduced_config(get_config(arch))
    opt_j = jx.get_optimizer(cfg_j)
    state_j = jx.train.init_train_state(
        jx.tf.init_params(jx.jax.random.PRNGKey(3), cfg_j), opt_j)
    rng = np.random.default_rng(0)
    state_j = jx.train.TrainState(
        state_j.params,
        jx.jax.tree.map(lambda a: jx.jnp.asarray(
            rng.normal(size=a.shape).astype(np.float32)), state_j.opt_state),
        jx.jnp.int32(7))
    jx.ckpt.save(str(tmp_path / "j"), 7, state_j)
    assert checkpoint.latest_step(str(tmp_path / "j")) == 7
    state_t, _ = launch_train.build(cfg_t, steps=10, device="cpu", seed=5)
    got, step = checkpoint.restore_tree(str(tmp_path / "j"), 7, state_t)
    assert step == 7 and int(got.step) == 7
    for (path, a), b in zip(pytree.leaves_with_paths(got),
                            jx.jax.tree.leaves(state_j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=pytree.path_str(path))

    words = rng.normal(size=(3, 5)).astype(np.float32)
    tree_j = {"w": jx.jnp.asarray(words, jx.jnp.bfloat16),
              "b": jx.jnp.asarray(words[0])}
    jx.ckpt.save(str(tmp_path / "bf"), 1, tree_j)
    like = {"w": torch.zeros((3, 5), dtype=torch.bfloat16),
            "b": torch.zeros(5)}
    got, _ = checkpoint.restore_tree(str(tmp_path / "bf"), 1, like)
    want = torch.as_tensor(words).to(torch.bfloat16)
    assert torch.equal(got["w"], want)
    checkpoint.save_tree(str(tmp_path / "bf_t"), 1, got)
    for name in ("bf", "bf_t"):
        path = tmp_path / name / "ckpt_00000001"
        with open(path / "manifest.json") as f:
            assert json.load(f)["dtypes"] == {"b": "float32",
                                              "w": "bfloat16"}
    with np.load(tmp_path / "bf" / "ckpt_00000001" / "arrays.npz") as a, \
            np.load(tmp_path / "bf_t" / "ckpt_00000001" / "arrays.npz") as b:
        assert a["w"].dtype == b["w"].dtype == np.dtype("V2")
        assert a["w"].tobytes() == b["w"].tobytes()


def _cli(args, capsys):
    rc = launch_train.main(args)
    return rc, capsys.readouterr().out


def test_cli_resume_equals_uninterrupted(tmp_path, capsys):
    """Six steps saved every 2 (saves 0, 2, 4, 5); the save at 2 copied
    alone into a second directory, as after a crash at step 3, and the run
    resumed there: its last save equals the uninterrupted one's."""
    base = ["--arch", "llama3.2-3b", "--reduced", "--steps", "6",
            "--seq", "48", "--batch", "4", "--ckpt-every", "2",
            "--device", "cpu"]
    a, b = tmp_path / "a", tmp_path / "b"
    rc, out = _cli(base + ["--ckpt-dir", str(a)], capsys)
    assert rc == 0 and "step     0 loss" in out and "step     5 loss" in out
    assert "done: 6 steps, final loss" in out
    assert sorted(os.listdir(a)) == ["ckpt_00000002", "ckpt_00000004",
                                     "ckpt_00000005"]
    shutil.copytree(a / "ckpt_00000002", b / "ckpt_00000002")
    rc, out = _cli(base + ["--ckpt-dir", str(b)], capsys)
    assert rc == 0 and "resumed from checkpoint step 2" in out
    assert "done: 3 steps" in out
    with np.load(a / "ckpt_00000005" / "arrays.npz") as x, \
            np.load(b / "ckpt_00000005" / "arrays.npz") as y:
        assert sorted(x.files) == sorted(y.files)
        assert "2" in x.files and int(x["2"]) == 6
        for key in x.files:
            np.testing.assert_array_equal(x[key], y[key], err_msg=key)


def test_cli_production_mesh_names_the_roadmap_item(capsys):
    """On one process (no torchrun group of 256 ranks) the production mesh
    exits 2 with one line naming the ranks it needs."""
    assert launch_train.main(["--production-mesh"]) == 2
    err = capsys.readouterr().err
    assert len(err.strip().splitlines()) == 1
    assert "needs 256 ranks" in err and "has 1" in err


def test_cli_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(CudaUnavailableError):
        launch_train.main(["--reduced", "--steps", "1"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.torch_cuda
class TestTrainOnCuda:
    """A float32 reduced step on the card (head dim 64: both attention
    kernels run) equals the CPU's; the step counts its launches."""

    def test_reduced_step_matches_cpu(self, cuda_device):
        """`chip_smoke.reduced_step_check`: the loss, grad norm and every
        gradient; every parameter moved; the optimizer given the CPU's
        gradients within a few ulps of the CPU's update (the step's own
        parameters move with the rounding of any gradient near zero, as
        AdamW divides by sqrt(v) + 1e-8: `chip_smoke.py`'s TRAIN_ULPS).
        Then the launches: the gradients and the step, each twice the
        forward (remat) and once the backward a layer."""
        from repro_torch import kernels

        torch.backends.cuda.matmul.allow_tf32 = False
        kernels.reset_launch_counts()
        res = cs.reduced_step_check(str(cuda_device))
        assert res["p_ulps"] <= cs.TRAIN_ULPS
        n_layers = reduced_config(get_config("llama3.2-3b")).n_layers
        counts = kernels.launch_counts()
        assert counts["flash_attention"] == 4 * n_layers
        assert counts["flash_attention_backward"] == 2 * n_layers

    def test_sharded_reduced_steps_match_cpu(self, cuda_device):
        """`chip_smoke.reduced_mesh_check` ([lm-mesh] (b)): 4 ranks of a
        (data=2, model=2) mesh on the card(s), the reduced float32 configs
        of every layer kind (attention in both head modes, the ssm kind,
        the hybrid, the MoE in both expert-parallel modes): every gradient
        of the sharded step within 1e-4 of its leaf's scale (an SSM's
        within 2^-7), a step's loss and grad norm within 1e-5 (an SSM's
        grad norm 1e-4) of the CPU's step, each rank's attention launches
        counted."""
        got = cs.reduced_mesh_check(str(cuda_device))
        assert [g["name"] for g in got] == [c[0] for c in cs.LM_MESH_REDUCED]
        assert [g["mode"] for g in got[:2]] == ["sharded", "replicated"]
