"""The port's three tree kernels: plain versions held to `repro.kernels.ref`
on the CPU, and (on a CUDA machine) each Hopper kernel held to its plain
version. Tolerance: exact equality (every quantity is an integer).

The JAX package is imported by a fixture, not at the top: the machine with
the card has no JAX, and runs this file's card tests alone with
``python -m pytest -m torch_cuda tests/test_torch_kernels.py``.
"""
from __future__ import annotations

import re
import types

import numpy as np
import pytest
import torch

from repro_torch.core import quant as t_quant
from repro_torch.kernels import _build
from repro_torch.kernels import domination as t_dom
from repro_torch.kernels import fitness as t_fit
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import tree_infer as t_ti


@pytest.fixture(scope="module")
def jref():
    """The JAX package's kernel wrappers (`ops`) and references (`ref`)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops, ref
    return types.SimpleNamespace(jnp=jnp, ops=ops, ref=ref)


def _random_case(seed, n_pop, batch, n_comp, n_leaves, n_classes,
                 n_features=None):
    """Random operands: any path in {-1, 0, 1}, targets that some samples
    reach, labels with -1 rows, mixed vote caps."""
    rng = np.random.default_rng(seed)
    path = rng.choice(np.array([-1, 0, 0, 0, 1], np.int8), (n_leaves, n_comp))
    target = rng.integers(-2, 3, n_leaves).astype(np.int32)
    leaf_class = rng.integers(0, n_classes, n_leaves).astype(np.int32)
    n_features = n_features or n_comp + 3
    feature = rng.integers(0, n_features, n_comp).astype(np.int32)
    x8 = rng.integers(0, 256, (batch, n_features)).astype(np.int32)
    y = rng.integers(-1, n_classes, batch).astype(np.int32)
    bits = rng.integers(0, 9, (n_pop, n_comp)).astype(np.int32)
    thr = (rng.integers(0, 256, (n_pop, n_comp)) % (1 << bits)).astype(np.int32)
    approx = rng.random(n_pop) < 0.5
    return dict(path=path, target=target, leaf_class=leaf_class,
                feature=feature, x8=x8, y=y, bits=bits, thr=thr,
                approx=approx, n_classes=n_classes, n_features=n_features)


def _pad(jref, x, mult, axis, value=0.0):
    return np.asarray(jref.ops._pad_to(jref.jnp.asarray(x), mult, axis, value))


def _ref_chromosome_operands(jref, case, n_pad):
    """JAX chromosome operands: scale 2^-(8-bits), thr, padded comparators
    that never fire (scale 0, thr 256), as `ops.fitness_errors` pads."""
    scale = np.exp2(-(8 - case["bits"]).astype(np.float32))
    scale = _pad(jref, scale, n_pad, 1)[:, :n_pad]
    thr = _pad(jref, case["thr"].astype(np.float32), n_pad, 1, 256.0)[:, :n_pad]
    return scale, thr


def _port_chromosome_operands(case):
    shift = torch.as_tensor(8 - case["bits"])
    thr = torch.as_tensor(case["thr"])
    cap = torch.as_tensor(np.where(case["approx"], 1, t_quant.NO_VOTE_CAP)
                          .astype(np.int32))
    return shift, thr, cap


FITNESS_CASES = [  # (seed, P, B, N, L, C)
    (0, 5, 37, 20, 45, 4),
    (1, 9, 130, 70, 150, 6),          # ragged P and B
    (2, 1, 1, 3, 4, 2),
    (3, 12, 64, 33, 33, 3),
]


@pytest.mark.parametrize("seed,p,b,n,l,c", FITNESS_CASES)
def test_fitness_plain_matches_ref(jref, seed, p, b, n, l, c):
    jnp, j_ops, j_ref = jref.jnp, jref.ops, jref.ref
    case = _random_case(seed, p, b, n, l, c)
    x_sel = case["x8"][:, case["feature"]]
    # path_len := target, n_neg := 0 makes the prepared target the random one
    j_fit = j_ops.prepare_fitness_operands(
        x_sel, case["y"], case["path"], case["target"],
        np.zeros(l, np.int32), case["leaf_class"], c)
    x_sel_p, path_t, target, cls1h, y_row = j_fit
    scale, thr = _ref_chromosome_operands(jref, case, x_sel_p.shape[1])
    cap = np.where(case["approx"], 1.0, np.inf).astype(np.float32)
    expect = np.asarray(j_ref.fitness_correct_counts(
        x_sel_p, jnp.asarray(scale), jnp.asarray(thr), path_t, target, cls1h,
        y_row, jnp.asarray(cap)))

    ops = t_ops.prepare_fitness_operands(
        torch.as_tensor(x_sel), case["y"], case["path"], case["target"],
        np.zeros(l, np.int32), case["leaf_class"], c)
    shift, thr_t, cap_t = _port_chromosome_operands(case)
    got = t_fit.fitness_correct_counts_plain(ops, shift, thr_t, cap_t)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), expect.astype(np.int32))
    # the wrapper takes the plain version for CPU tensors, launching nothing
    launches = t_fit.fitness_correct_counts.launches
    errors = t_ops.fitness_errors(ops, shift, thr_t, cap_t)
    assert t_fit.fitness_correct_counts.launches == launches
    np.testing.assert_array_equal(errors.numpy(),
                                  int((case["y"] >= 0).sum()) - expect)


# (seed, P, B, N, L, C): the comparator widths of a small tree, of har
# (N=588) and of the widest tree the kernel takes in shared memory (N=2000)
SCORE_CASES = FITNESS_CASES + [(5, 2, 9, 20, 21, 3), (6, 2, 7, 588, 589, 6),
                               (7, 2, 5, 2000, 2001, 4)]


def _port_fitness_operands(case, device=None):
    x_sel = case["x8"][:, case["feature"]]
    return t_ops.prepare_fitness_operands(
        torch.as_tensor(x_sel, device=device), case["y"], case["path"],
        case["target"], np.zeros(case["path"].shape[0], np.int32),
        case["leaf_class"], case["n_classes"])


@pytest.mark.parametrize("seed,p,b,n,l,c", SCORE_CASES)
def test_fitness_operands_padding(seed, p, b, n, l, c):
    """The kernel's layout: K and L padded to its tiles, zero path columns
    and codes past N, padded leaves with a zero path row and a target above
    any score, so they never satisfy."""
    case = _random_case(seed, p, b, n, l, c)
    ops = _port_fitness_operands(case)
    k_pad, l_pad = ops.x_sel.shape[1], ops.path.shape[0]
    assert k_pad == t_fit.k_padded(n) and k_pad % 32 == 0 and k_pad >= n
    assert l_pad % t_fit.LEAF_TILE == 0 and l_pad - l < t_fit.LEAF_TILE
    assert ops.path.dtype == torch.int8 and ops.path.is_contiguous()
    assert ops.x_sel.dtype == torch.uint8 and ops.x_sel.shape[0] == b
    np.testing.assert_array_equal(ops.path[:l, :n].numpy(), case["path"])
    assert not ops.path[:, n:].any() and not ops.path[l:].any()
    assert not ops.x_sel[:, n:].any()
    np.testing.assert_array_equal(ops.x_sel[:, :n].numpy(),
                                  case["x8"][:, case["feature"]])
    np.testing.assert_array_equal(ops.target[:l].numpy(), case["target"])
    np.testing.assert_array_equal(ops.leaf_class[:l].numpy(),
                                  case["leaf_class"])
    assert (ops.target[l:] > n).all() and not ops.leaf_class[l:].any()
    # a padded leaf's score is 0 for any decisions; even all-ones decisions
    # leave every score within [-N, N]
    assert ops.path.shape[1] == k_pad + t_fit.ROW_PAD
    ones = torch.ones((1, ops.path.shape[1]), dtype=torch.int32)
    scores = ones @ ops.path.to(torch.int32).T
    assert not (scores[0, l:] == ops.target[l:]).any()
    assert scores.abs().max() <= n


@pytest.mark.parametrize("seed,p,b,n,l,c", SCORE_CASES)
def test_padded_path_product_matches_ref_score(jref, seed, p, b, n, l, c):
    """The kernel's product ``D @ PATH_pad^T`` on the padded operands
    (decisions over K_pad, zero past N) equals the reference's `score`
    (`ref.fitness_correct_counts`: floor(x * 2^-(8-bits)) > thr, then the
    path product in float32), exactly."""
    jnp = jref.jnp
    case = _random_case(seed, p, b, n, l, c)
    ops = _port_fitness_operands(case)
    shift, thr, _ = _port_chromosome_operands(case)
    k_pad = ops.x_sel.shape[1]
    shift_pad = torch.zeros((p, k_pad), dtype=torch.int32)
    thr_pad = torch.full((p, k_pad), 256, dtype=torch.int32)
    shift_pad[:, :n], thr_pad[:, :n] = shift, thr
    d = (ops.x_sel.to(torch.int32)[None] >> shift_pad[:, None]) > thr_pad[:, None]
    got = d.to(torch.int32) @ ops.path[:, :k_pad].to(torch.int32).T
    x_sel = jnp.asarray(case["x8"][:, case["feature"]].astype(np.float32))
    scale = jnp.asarray(np.exp2(-(8 - case["bits"]).astype(np.float32)))
    dj = (jnp.floor(x_sel[None] * scale[:, None, :])
          > jnp.asarray(case["thr"].astype(np.float32))[:, None, :])
    want = np.asarray(jnp.einsum("pbn,nl->pbl", dj.astype(jnp.float32),
                                 jnp.asarray(case["path"].T.astype(np.float32))))
    np.testing.assert_array_equal(got[:, :, :l].numpy(), want.astype(np.int32))
    assert not got[:, :, l:].any()


def test_fitness_layout_matches_the_cuda_source():
    """`fitness.py`'s layout and block constants are the ones
    `csrc/fitness.cu` is compiled with."""
    src = (_build.CSRC / "fitness.cu").read_text()

    def const(name):
        hit = re.search(rf"constexpr int {name} = (\d+);", src)
        assert hit is not None, name
        return int(hit.group(1))

    assert const("kLeafTile") == t_fit.LEAF_TILE
    assert const("kMaxKPad") == t_fit.MAX_K_PAD
    assert "return k_pad + 16;" in src and t_fit.ROW_PAD == 16
    assert (16 * const("kWarps") * const("kRowTiles")
            == t_fit.BLOCK_ROWS)
    with pytest.raises(ValueError, match="exceed"):
        t_fit.k_padded(2049)


@pytest.mark.parametrize("seed,pi,pj,m", [(0, 40, 40, 2), (1, 17, 53, 2),
                                          (2, 64, 9, 3), (3, 1, 1, 1)])
def test_domination_plain_matches_ref(jref, seed, pi, pj, m):
    jnp, j_ref = jref.jnp, jref.ref
    rng = np.random.default_rng(seed)
    # coarse values make ties and equal rows common
    oi = (rng.integers(0, 5, (pi, m)) / 4).astype(np.float32)
    oj = (rng.integers(0, 5, (pj, m)) / 4).astype(np.float32)
    expect = np.asarray(j_ref.domination_matrix(jnp.asarray(oi),
                                                jnp.asarray(oj))) > 0.5
    got = t_dom.domination_block_plain(torch.as_tensor(oi), torch.as_tensor(oj))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), expect)
    square = np.asarray(j_ref.domination_matrix(jnp.asarray(oi))) > 0.5
    np.testing.assert_array_equal(
        t_ops.domination_matrix_bool(torch.as_tensor(oi)).numpy(), square)
    np.testing.assert_array_equal(
        t_ops.domination_block(torch.as_tensor(oi), torch.as_tensor(oj))
        .numpy(), expect.astype(np.float32))


@pytest.mark.parametrize("seed,p,b,n,l,c", [(0, 3, 37, 20, 45, 4),
                                            (1, 1, 1, 5, 6, 3),
                                            (2, 4, 150, 70, 140, 6)])
def test_tree_infer_plain_matches_ref(jref, seed, p, b, n, l, c):
    jnp, j_ops, j_ref = jref.jnp, jref.ops, jref.ref
    case = _random_case(seed, p, b, n, l, c)
    sel, path_t, target, cls1h = j_ops.prepare_operands(
        case["feature"], case["path"], case["target"], np.zeros(l, np.int32),
        case["leaf_class"], c, case["n_features"])
    x8f = _pad(jref, case["x8"].astype(np.float32), 128, 1)[:, :sel.shape[0]]
    scale, thr = _ref_chromosome_operands(jref, case, sel.shape[1])
    expect = np.asarray(j_ref.tree_infer_scores(
        jnp.asarray(x8f), sel, jnp.asarray(scale), jnp.asarray(thr), path_t,
        target, cls1h))[:, :, :c]

    ops = t_ops.prepare_operands(
        case["feature"], case["path"], case["target"], np.zeros(l, np.int32),
        case["leaf_class"], c, case["n_features"])
    shift, thr_t, cap_t = _port_chromosome_operands(case)
    x8 = torch.as_tensor(case["x8"])
    got = t_ti.tree_infer_scores(x8, ops, shift, thr_t)
    assert got.dtype == torch.int32 and got.shape == (p, b, c)
    np.testing.assert_array_equal(got.numpy(), expect.astype(np.int32))
    preds = t_ops.tree_infer_predict(x8, ops, shift, thr_t, cap_t)
    capped = np.minimum(expect, np.where(case["approx"], 1.0, np.inf)[:, None,
                                                                      None])
    np.testing.assert_array_equal(preds.numpy(), capped.argmax(-1))


@pytest.mark.parametrize("n_comp", [1, 31, 32, 33, 129, 588, 2048])
def test_pack_path_bits(n_comp):
    rng = np.random.default_rng(n_comp)
    path = rng.choice(np.array([-1, 0, 1], np.int8), (5, n_comp))
    pos, neg = t_ti.pack_path(torch.as_tensor(path))
    words = t_ti.mask_words(n_comp)
    assert pos.shape == neg.shape == (5, words) and words % 4 == 0
    assert 32 * words >= n_comp
    bits = np.arange(32 * words)
    for masks, sign in ((pos, 1), (neg, -1)):
        u = masks.numpy().view(np.uint32)
        unpacked = (u[:, bits // 32] >> (bits % 32).astype(np.uint32)) & 1
        assert not unpacked[:, n_comp:].any()
        np.testing.assert_array_equal(unpacked[:, :n_comp], path == sign)


def test_mask_widths_match_the_cuda_instantiations():
    """`NWP_CHOICES` and the widths `csrc/tree_common.cuh` instantiates the
    kernels for (`REPRO_NWP_CASES`) are one list: a width missing on the
    CUDA side would only show as a failed launch."""
    header = (_build.CSRC / "tree_common.cuh").read_text()
    macro = re.search(r"#define REPRO_NWP_CASES\(X\)((?:.*\\\n)*.*)", header)
    assert macro is not None
    widths = tuple(int(w) for w in re.findall(r"X\((\d+)\)", macro.group(1)))
    assert widths == t_ti.NWP_CHOICES


def test_mask_words_limit_and_device_routing():
    with pytest.raises(ValueError, match="exceed"):
        t_ti.mask_words(2049)
    # neither a CPU nor a CUDA tensor: the wrappers refuse, never fall back
    meta = torch.empty((2, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        t_dom.domination_block(meta, meta)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


def _to(device, *tensors):
    return [t.to(device) for t in tensors]


@pytest.mark.torch_cuda
class TestKernelsOnCuda:
    """Each Hopper kernel equals its plain version on the card."""

    @pytest.mark.parametrize("seed,p,b,n,l,c", FITNESS_CASES + [
        (4, 40, 700, 588, 589, 6),        # har width, decisions in registers
        (5, 1, 1, 588, 589, 6),           # one chromosome, one sample
        (6, 3, 300, 2000, 2001, 4),       # decisions in shared memory
        (7, 5, 80, 20, 21, 3)])
    @pytest.mark.parametrize("caps", ["mixed", "all 1"])
    def test_fitness_kernel(self, cuda_device, seed, p, b, n, l, c, caps):
        case = _random_case(seed, p, b, n, l, c)
        if caps == "all 1":
            case["approx"][:] = True
        ops = _port_fitness_operands(case, device=cuda_device)
        shift, thr, cap = _to(cuda_device, *_port_chromosome_operands(case))
        launches = t_fit.fitness_correct_counts.launches
        got = t_fit.fitness_correct_counts(ops, shift, thr, cap)
        torch.cuda.synchronize()
        assert t_fit.fitness_correct_counts.launches == launches + 1
        expect = t_fit.fitness_correct_counts_plain(ops, shift, thr, cap)
        assert torch.equal(got, expect)

    def test_fitness_kernel_refuses_other_operands(self, cuda_device):
        """A CUDA tensor the kernel cannot take raises; nothing falls
        back to the plain version."""
        case = _random_case(8, 2, 40, 20, 21, 3)
        ops = _port_fitness_operands(case, device=cuda_device)
        shift, thr, cap = _to(cuda_device, *_port_chromosome_operands(case))
        with pytest.raises(ValueError):
            t_fit.fitness_correct_counts(ops, shift[:, :19].contiguous(),
                                         thr[:, :19].contiguous(), cap)
        with pytest.raises(ValueError):
            t_fit.fitness_correct_counts(ops, shift, thr, cap.to(torch.int64))

    @pytest.mark.parametrize("pi,pj", [(1024, 1024), (256, 1024), (33, 7)])
    def test_domination_kernel(self, cuda_device, pi, pj):
        rng = np.random.default_rng(pi + pj)
        oi = torch.as_tensor((rng.integers(0, 9, (pi, 2)) / 8)
                             .astype(np.float32), device=cuda_device)
        oj = torch.as_tensor((rng.integers(0, 9, (pj, 2)) / 8)
                             .astype(np.float32), device=cuda_device)
        got = t_dom.domination_block(oi, oj)
        torch.cuda.synchronize()
        assert torch.equal(got, t_dom.domination_block_plain(oi, oj))

    @pytest.mark.parametrize("seed,p,b,n,l,c", [(0, 3, 37, 20, 45, 4),
                                                (1, 1, 1, 588, 589, 6),
                                                (2, 8, 1100, 225, 226, 10)])
    def test_tree_infer_kernel(self, cuda_device, seed, p, b, n, l, c):
        case = _random_case(seed, p, b, n, l, c)
        ops = t_ops.prepare_operands(
            case["feature"], case["path"], case["target"],
            np.zeros(l, np.int32), case["leaf_class"], c, case["n_features"],
            device=cuda_device)
        shift, thr, _ = _to(cuda_device, *_port_chromosome_operands(case))
        x8 = torch.as_tensor(case["x8"], device=cuda_device)
        got = t_ti.tree_infer_scores(x8, ops, shift, thr)
        torch.cuda.synchronize()
        assert torch.equal(got, t_ti.tree_infer_scores_plain(x8, ops, shift,
                                                             thr))

    def test_kernels_build_for_sm90a(self, cuda_device):
        _build.build()
        for name in _build.SOURCES:
            assert _build.library_path(name).exists()
