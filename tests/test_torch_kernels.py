"""The port's three tree kernels and the non-dominated sort: plain versions
held to `repro.kernels.ref` and `repro.core.nsga2` on the CPU, and (on a
CUDA machine) each Hopper kernel held to its plain version. Tolerance:
exact equality (every quantity is an integer).

The JAX package is imported by a fixture, not at the top: the machine with
the card has no JAX, and runs this file's card tests alone with
``python -m pytest -m torch_cuda tests/test_torch_kernels.py``.
"""
from __future__ import annotations

import functools
import re
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import nsga2 as t_nsga2
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
    launches = kernels.launched(t_fit.fitness_correct_counts)
    errors = t_ops.fitness_errors(ops, shift, thr_t, cap_t)
    assert kernels.launched(t_fit.fitness_correct_counts) == launches
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
    assert ops.path.shape[1] == k_pad
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
    assert const("kMaxChunk") == t_fit.MAX_CHUNK
    assert "return kc + 16;" in src
    assert (16 * const("kWarps") * const("kRowTiles")
            == t_fit.BLOCK_ROWS)
    # no comparator cap: the kernel walks each tile's span in chunks
    assert t_fit.k_padded(2049) == 2080 and t_fit.k_padded(40000) == 40000
    # the C entry point's arguments, in the order the wrapper passes them:
    # ten pointers, then the problem count and seven sizes, then the stream
    sig = re.search(r'extern "C" int repro_fitness_correct_counts\((.*?)\)',
                    src, re.S)
    assert sig is not None
    args = [a.split()[-1].lstrip("*") for a in sig.group(1).split(",")]
    assert args == ["x_sel", "shift", "thr", "path", "spans", "target",
                    "leaf_class", "y", "vote_cap", "correct", "n_prob",
                    "n_pop", "batch", "n_comp", "k_pad", "l_pad",
                    "n_classes", "kc", "stream"]
    assert "n_prob > 65535" in src and "blockIdx.z" in src
    wrapper = (_build.CSRC.parent / "kernels" / "fitness.py").read_text()
    assert ('_build.function("fitness", "repro_fitness_correct_counts", '
            '10, 8)') in wrapper


@pytest.mark.parametrize("widths", [((20, 21), (33, 34), (5, 6)),
                                    ((70, 71), (70, 71))])
def test_stacked_fitness_operands_layout(widths):
    """A bucket's operands: each member padded to the shared shape keeps
    its own spans, the stack shares the widest member's chunk, a member
    reads back as its single-problem operands, and the plain counts of the
    stack equal each member's alone."""
    n = max(w[0] for w in widths) + 3        # one padded comparator count
    l = max(w[1] for w in widths) + 1
    singles, cases = [], []
    for seed, (n_i, l_i) in enumerate(widths):
        case = _random_case(seed, 4, 50, n_i, l_i, 3, n_features=n + 3)
        path = np.zeros((l, n), np.int8)
        path[:l_i, :n_i] = case["path"]
        target = np.full(l, 1, np.int32)     # padded leaves never satisfy
        target[:l_i] = case["target"]
        cls = np.zeros(l, np.int32)
        cls[:l_i] = case["leaf_class"]
        feature = np.zeros(n, np.int32)
        feature[:n_i] = case["feature"]
        singles.append(t_ops.prepare_fitness_operands(
            torch.as_tensor(case["x8"][:, feature]), case["y"], path, target,
            np.zeros(l, np.int32), cls, 3))
        cases.append(case)
    stacked = t_fit.stack_operands(singles)
    k = len(widths)
    assert stacked.stacked and stacked.x_sel.shape == (k, 50, t_fit.k_padded(n))
    assert stacked.path.shape[0] == k and stacked.spans.shape[0] == k
    assert stacked.chunk == max(m.chunk for m in singles)
    assert stacked.n_valid == tuple(m.n_valid for m in singles)
    for i, single in enumerate(singles):
        member = stacked.member(i)
        for f in ("x_sel", "y", "path", "spans", "target", "leaf_class"):
            assert torch.equal(getattr(member, f), getattr(single, f)), f
        # a member's spans cover only its own comparators
        assert int(single.spans[:, 1].max()) <= t_fit.k_padded(widths[i][0])
    shift = torch.stack([torch.as_tensor(
        np.pad(8 - c["bits"], ((0, 0), (0, n - c["bits"].shape[1])),
               constant_values=8)) for c in cases]).to(torch.int32)
    thr = torch.stack([torch.as_tensor(
        np.pad(c["thr"], ((0, 0), (0, n - c["thr"].shape[1])))) for c in cases]
    ).to(torch.int32)
    cap = torch.stack([torch.as_tensor(np.where(
        c["approx"], 1, t_quant.NO_VOTE_CAP).astype(np.int32)) for c in cases])
    both = t_fit.fitness_correct_counts(stacked, shift, thr, cap)
    assert both.shape == (k, 4)
    for i, single in enumerate(singles):
        assert torch.equal(both[i], t_fit.fitness_correct_counts_plain(
            single, shift[i], thr[i], cap[i]))
    with pytest.raises(ValueError, match="one shape"):
        t_fit.stack_operands([singles[0], t_ops.prepare_fitness_operands(
            torch.zeros((50, 4), dtype=torch.int32), np.zeros(50),
            np.zeros((3, 4), np.int8), np.ones(3), np.zeros(3), np.zeros(3),
            3)])


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


def _tree_like(case, seed, depth=8, exact_share=0.75):
    """The case with leaves of a tree's shape: ``depth`` comparators a path,
    most targets the path's number of +1 entries (as every leaf of a real
    tree has: the kernel tests those without a popcount), the rest any
    score (the popcount test)."""
    rng = np.random.default_rng(seed + 100)
    n_leaves, n = case["path"].shape
    path = np.zeros((n_leaves, n), np.int8)
    for i in range(n_leaves):
        cols = rng.choice(n, min(depth, n), replace=False)
        path[i, cols] = rng.choice(np.array([-1, 1], np.int8), len(cols))
    target = (path == 1).sum(1).astype(np.int32)
    other = rng.random(n_leaves) >= exact_share
    target[other] = rng.integers(-depth, depth + 1, int(other.sum()))
    return dict(case, path=path, target=target)


@pytest.mark.parametrize("seed,p,b,n,l,c", [(0, 2, 40, 20, 45, 4),
                                            (1, 1, 33, 588, 589, 6)])
def test_tree_infer_plain_matches_ref_on_tree_like_leaves(jref, seed, p, b, n,
                                                          l, c):
    jnp, j_ops, j_ref = jref.jnp, jref.ops, jref.ref
    case = _tree_like(_random_case(seed, p, b, n, l, c), seed, depth=3)
    sel, path_t, target, cls1h = j_ops.prepare_operands(
        case["feature"], case["path"], case["target"], np.zeros(l, np.int32),
        case["leaf_class"], c, case["n_features"])
    x8f = _pad(jref, case["x8"].astype(np.float32), 128, 1)[:, :sel.shape[0]]
    scale, thr = _ref_chromosome_operands(jref, case, sel.shape[1])
    expect = np.asarray(j_ref.tree_infer_scores(
        jnp.asarray(x8f), sel, jnp.asarray(scale), jnp.asarray(thr), path_t,
        target, cls1h))[:, :, :c]
    assert expect.sum() > 0            # some samples reach some leaves
    ops = t_ops.prepare_operands(
        case["feature"], case["path"], case["target"], np.zeros(l, np.int32),
        case["leaf_class"], c, case["n_features"])
    shift, thr_t, _ = _port_chromosome_operands(case)
    got = t_ti.tree_infer_scores(torch.as_tensor(case["x8"]), ops, shift,
                                 thr_t)
    np.testing.assert_array_equal(got.numpy(), expect.astype(np.int32))


@pytest.mark.parametrize("seed,words", [(0, 1), (1, 4), (2, 20), (3, 64)])
def test_exact_leaf_test_equals_the_score_test(seed, words):
    """`csrc/tree_infer.cu` tests a leaf whose target is its number of +1
    entries with no popcount: it is satisfied iff ``(~d & pos) | (d & neg)``
    is 0 in every word. For any decisions d that equals score == target."""
    rng = np.random.default_rng(seed)
    k, n = 3000, 32 * words
    path = rng.choice(np.array([-1, 0, 0, 0, 0, 0, 1], np.int8), (k, n))
    d = rng.random((k, n)) < 0.5
    hit = rng.random(k) < 0.5              # make half the rows satisfy
    d[hit] = np.where(path[hit] == 1, True,
                      np.where(path[hit] == -1, False, d[hit]))
    flip = rng.random(k) < 0.25            # then spoil a quarter by a bit
    col = rng.integers(0, n, k)
    d[flip, col[flip]] ^= True
    score = (d * path).sum(1)
    n_pos = (path == 1).sum(1)

    def pack(bits):
        return np.packbits(bits.reshape(k, words, 32), axis=-1,
                           bitorder="little").view(np.uint32)[..., 0]

    dw, pw, nw = pack(d), pack(path == 1), pack(path == -1)
    miss = ((~dw & pw) | (dw & nw)).any(1)
    np.testing.assert_array_equal(~miss, score == n_pos)
    assert 0 < int((~miss).sum()) < k


def _sort_case(name):
    """Objectives (P, M) float32 for the non-dominated sort's cases."""
    rng = np.random.default_rng(len(name))
    if name == "chain 300":    # each point dominates the next: 300 fronts
        v = rng.permutation(300).astype(np.float32)
        return np.stack([v, v / 7], 1)
    p, m, levels = {"ties 96": (96, 2, 4), "ragged 45": (45, 2, 9),
                    "ragged 100 M=3": (100, 3, 6),
                    "pool 1500": (1500, 2, 40)}[name]
    objs = (rng.integers(0, levels, (p, m)) / (levels - 1)).astype(np.float32)
    objs[1::5] = objs[::5][:len(objs[1::5])]   # duplicate points
    return objs


SORT_CASES = ["ties 96", "chain 300", "ragged 45", "ragged 100 M=3",
              "pool 1500"]


@pytest.mark.parametrize("name", SORT_CASES)
def test_domination_bits_plain_matches_ref(name):
    """The packed relation's plain version holds the bits of
    `repro.core.nsga2.domination_matrix`, column j's word w at [w, j]."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import nsga2 as j_nsga2
    objs = _sort_case(name)
    p = objs.shape[0]
    dom = np.asarray(j_nsga2.domination_matrix(jnp.asarray(objs)))
    rel, counts = t_dom.domination_bits(torch.as_tensor(objs))
    words = t_dom.relation_words(p)
    assert rel.dtype == counts.dtype == torch.int32
    assert tuple(rel.shape) == (words, p)
    u = rel.numpy().view(np.uint32)
    rows = np.arange(32 * words)
    bits = (u[rows // 32] >> (rows % 32)[:, None].astype(np.uint32)) & 1
    assert not bits[p:].any()
    np.testing.assert_array_equal(bits[:p].astype(bool), dom)
    np.testing.assert_array_equal(counts.numpy(), dom.sum(0))


def _peel_packed(rel, counts):
    """`csrc/domination.cu`'s peel in numpy on the packed relation: the
    front is the unranked columns with no dominator left, and every
    unranked column j drops popc(rel[w, j] & front[w]) dominators."""
    words, p = rel.shape
    rel = rel.view(np.uint32)
    counts = counts.astype(np.int64)
    rank = np.full(p, -1, np.int32)
    for r in range(p):
        front = (rank < 0) & (counts == 0)
        rank[front] = r
        if (rank >= 0).all():
            break
        padded = np.zeros(32 * words, bool)
        padded[:p] = front
        fw = np.packbits(padded.reshape(words, 32), axis=-1,
                         bitorder="little").view(np.uint32)[:, 0]
        dec = np.bitwise_count(rel & fw[:, None]).sum(0)
        counts = np.where(rank < 0, counts - dec, counts)
    return rank


@pytest.mark.parametrize("name", SORT_CASES)
def test_packed_peel_matches_ref(name):
    """Peeling the packed relation as the card does gives the ranks of
    `repro.core.nsga2.non_dominated_sort`, and so does the CPU sort."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import nsga2 as j_nsga2
    objs = _sort_case(name)
    want = np.asarray(j_nsga2.non_dominated_sort(jnp.asarray(objs)))
    rel, counts = t_dom.domination_bits_plain(torch.as_tensor(objs))
    np.testing.assert_array_equal(_peel_packed(rel.numpy(), counts.numpy()),
                                  want)
    got = t_dom.non_dominated_rank(torch.as_tensor(objs))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if name == "chain 300":
        assert want.max() == 299


def _unpack(packed, n_comp):
    """(pos, neg) bool (L, N) from a `PackedPath`, each leaf's masks placed
    at its word offset."""
    n_leaves, width = packed.pos.shape
    full_words = max(packed.d_words, -(-n_comp // 32))
    out = []
    for masks in (packed.pos, packed.neg):
        words = np.zeros((n_leaves, full_words), np.uint32)
        u = masks.numpy().view(np.uint32)
        for i, off in enumerate(packed.word_off.tolist()):
            words[i, off:off + width] = u[i]
        bits = np.arange(32 * full_words)
        out.append(((words[:, bits // 32] >> (bits % 32).astype(np.uint32))
                    & 1).astype(bool))
    return out


@pytest.mark.parametrize("n_comp", [1, 31, 32, 33, 129, 588, 2048, 2049,
                                    4100])
def test_pack_path_bits(n_comp):
    rng = np.random.default_rng(n_comp)
    path = rng.choice(np.array([-1, 0, 1], np.int8), (5, n_comp))
    packed = t_ti.pack_path(torch.as_tensor(path))
    need = -(-n_comp // 32)
    assert packed.nwp in t_ti.NWP_CHOICES and packed.d_words % 4 == 0
    assert packed.pos.shape == packed.neg.shape == (5, packed.n_seg
                                                    * packed.nwp)
    assert packed.n_seg == (1 if need <= 64 else -(-need // 64))
    assert (packed.word_off % 4 == 0).all()
    assert (packed.word_off + packed.n_seg * packed.nwp
            <= packed.d_words).all()
    pos, neg = _unpack(packed, n_comp)
    assert not pos[:, n_comp:].any() and not neg[:, n_comp:].any()
    np.testing.assert_array_equal(pos[:, :n_comp], path == 1)
    np.testing.assert_array_equal(neg[:, :n_comp], path == -1)


def _forest_path(seed, widths, n_features=40, n_classes=4):
    """The block-diagonal super-tree of random trees of ``widths``
    comparators (`core.tree.concatenate_ptrees`)."""
    from repro_torch.core import tree as t_tree
    rng = np.random.default_rng(seed)
    trees = [t_tree.to_parallel(t_tree.random_tree(rng, w, n_features,
                                                   n_classes))
             for w in widths]
    return t_tree.concatenate_ptrees(trees)


# (seed, tree widths): a five-tree forest of har's trees' widths, a single
# tree past the old 2048-comparator cap, and a forest with a one-leaf tree
WIDE_LAYOUTS = [(0, (473, 414, 482, 431, 427)), (1, (4096,)),
                (2, (30, 0, 45, 2500))]


@pytest.mark.parametrize("seed,widths", WIDE_LAYOUTS)
def test_forest_masks_follow_the_widest_tree(seed, widths):
    """A leaf's masks start at its own tree's words, so the instantiated
    width follows the widest leaf span, not N; the packed layout's scores
    (what `tree_infer_kernel` computes, segment by segment) equal
    ``d @ PATH^T`` for random decisions."""
    arrays = _forest_path(seed, widths)
    path = arrays["path"]
    n_leaves, n = path.shape
    packed = t_ti.pack_path(torch.as_tensor(path))
    widest = max(widths)
    assert packed.n_seg * packed.nwp * 32 <= max(32 * 64, widest + 4 * 32
                                                 + 64 * 32)
    if widest <= 1900:
        assert packed.n_seg == 1 and packed.nwp < -(-n // 32) + 4
    pos, neg = _unpack(packed, n)
    np.testing.assert_array_equal(pos[:, :n], path == 1)
    np.testing.assert_array_equal(neg[:, :n], path == -1)
    rng = np.random.default_rng(seed + 10)
    d = rng.random((7, 32 * packed.d_words)) < 0.5
    d[:, n:] = False
    dw = np.packbits(d.reshape(7, packed.d_words, 32), axis=-1,
                     bitorder="little").view(np.uint32)[..., 0]
    pw = packed.pos.numpy().view(np.uint32)
    nw = packed.neg.numpy().view(np.uint32)
    popc = np.vectorize(lambda v: bin(int(v)).count("1"))
    score = np.zeros((7, n_leaves), np.int64)
    for l, off in enumerate(packed.word_off.tolist()):
        for seg in range(packed.n_seg):
            lo = off + seg * packed.nwp
            win = dw[:, lo:lo + packed.nwp]
            m = slice(seg * packed.nwp, (seg + 1) * packed.nwp)
            score[:, l] += (popc(win & pw[l, m]).sum(1)
                            - popc(win & nw[l, m]).sum(1))
    np.testing.assert_array_equal(score, d[:, :n].astype(np.int64)
                                  @ path.T.astype(np.int64))


@pytest.mark.parametrize("seed,widths", WIDE_LAYOUTS)
def test_fitness_spans_cover_every_path_entry(seed, widths):
    """`fitness.tile_spans`: a leaf tile's span holds every nonzero column
    of its rows, in multiples of 32 within K_pad, and the kernel's work
    list (each span in chunks of at most `chunk`) gives the full product
    ``D @ PATH^T``. A forest's tiles span about one tree, so the work is
    near the sum of the trees' products."""
    arrays = _forest_path(seed, widths)
    n_leaves, n = arrays["path"].shape
    rng = np.random.default_rng(seed)
    x_sel = torch.as_tensor(rng.integers(0, 256, (6, n)))
    ops = t_ops.prepare_fitness_operands(
        x_sel, np.zeros(6), arrays["path"], arrays["path_len"],
        arrays["n_neg"], arrays["leaf_class"], 4)
    spans = ops.spans.numpy()
    k_pad, tile = ops.path.shape[1], t_fit.LEAF_TILE
    assert spans.shape == (ops.path.shape[0] // tile, 2)
    assert (spans % 32 == 0).all() and (spans[:, 0] < spans[:, 1]).all()
    assert spans.min() >= 0 and spans.max() <= k_pad
    assert ops.chunk % 32 == 0 and 32 <= ops.chunk <= t_fit.MAX_CHUNK
    assert ops.chunk == min(t_fit.MAX_CHUNK, int((spans[:, 1]
                                                  - spans[:, 0]).max()))
    path = ops.path.numpy().astype(np.int64)
    d = (rng.random((6, k_pad)) < 0.5).astype(np.int64)
    got = np.zeros((6, path.shape[0]), np.int64)
    for t, (lo, hi) in enumerate(spans):
        rows = slice(t * tile, (t + 1) * tile)
        for c0 in range(lo, hi, ops.chunk):
            c1 = min(c0 + ops.chunk, hi)
            got[:, rows] += d[:, c0:c1] @ path[rows, c0:c1].T
    np.testing.assert_array_equal(got, d @ path.T)
    work = int(((spans[:, 1] - spans[:, 0]) * tile).sum())
    dense = k_pad * path.shape[0]
    if len(widths) > 1:
        per_tree = sum((w + 64) * (w + 1 + 2 * tile) for w in widths)
        assert work <= per_tree < dense


def test_mask_widths_match_the_cuda_instantiations():
    """`NWP_CHOICES` and the widths `csrc/tree_infer.cu` instantiates the
    kernels for (`REPRO_NWP_CASES`) are one list: a width missing on the
    CUDA side would only show as a failed launch."""
    source = (_build.CSRC / "tree_infer.cu").read_text()
    macro = re.search(r"#define REPRO_NWP_CASES\(X\)((?:.*\\\n)*.*)", source)
    assert macro is not None
    widths = tuple(int(w) for w in re.findall(r"X\((\d+)\)", macro.group(1)))
    assert widths == t_ti.NWP_CHOICES


def test_mask_words_limit_and_device_routing():
    # no mask-width limit: a leaf wider than 64 words takes segments of 64
    path = np.zeros((2, 5000), np.int8)
    path[0, [0, 4999]] = [1, -1]
    path[1, 100] = 1
    packed = t_ti.pack_path(torch.as_tensor(path))
    assert (packed.nwp, packed.n_seg) == (64, 3)
    assert packed.word_off.tolist() == [0, 0]
    # neither a CPU nor a CUDA tensor: the wrappers refuse, never fall back
    meta = torch.empty((2, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        t_dom.domination_block(meta, meta)


def _seeds_problem(device):
    from repro_torch import search
    from repro_torch.core import train, tree
    from repro_torch.datasets import load_dataset

    ds = load_dataset("seeds")
    pt = tree.to_parallel(train.train_tree(ds.x_train, ds.y_train,
                                           ds.n_classes))
    return search.build_problem(pt, ds.x_test, ds.y_test, device=device)


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
        (7, 5, 80, 20, 21, 3),
        (16, 3, 300, 4096, 600, 4),       # dense spans: four chunks a tile
        (17, 2, 70, 33000, 64, 3)])       # 33 chunks a tile
    @pytest.mark.parametrize("caps", ["mixed", "all 1"])
    def test_fitness_kernel(self, cuda_device, seed, p, b, n, l, c, caps):
        case = _random_case(seed, p, b, n, l, c)
        if caps == "all 1":
            case["approx"][:] = True
        ops = _port_fitness_operands(case, device=cuda_device)
        shift, thr, cap = _to(cuda_device, *_port_chromosome_operands(case))
        launches = kernels.launched(t_fit.fitness_correct_counts)
        got = t_fit.fitness_correct_counts(ops, shift, thr, cap)
        torch.cuda.synchronize()
        assert kernels.launched(t_fit.fitness_correct_counts) == launches + 1
        expect = t_fit.fitness_correct_counts_plain(ops, shift, thr, cap)
        assert torch.equal(got, expect)

    # (seed, tree widths, P, B, C): a five-tree forest of har's widths (N =
    # 2227) at har's rows, and single trees of 4096 and 9000 comparators
    @pytest.mark.parametrize("seed,widths,p,b,c", [
        (0, (473, 414, 482, 431, 427), 16, 3090, 6),
        (1, (4096,), 8, 3090, 6), (2, (9000,), 2, 700, 4)])
    def test_wide_kernels_equal_their_plain_versions(self, cuda_device, seed,
                                                     widths, p, b, c):
        """Both kernels past the old 2048-comparator cap, on a forest's
        block-diagonal super-tree and on single wide trees."""
        arrays = _forest_path(seed, widths, n_features=561, n_classes=c)
        n_leaves, n = arrays["path"].shape
        rng = np.random.default_rng(seed)
        x8 = torch.as_tensor(rng.integers(0, 256, (b, 561)), dtype=torch.int32,
                             device=cuda_device)
        y = rng.integers(0, c, b)
        bits = rng.integers(1, 9, (p, n))
        shift = torch.as_tensor(8 - bits, dtype=torch.int32,
                                device=cuda_device)
        thr = torch.as_tensor(rng.integers(0, 256, (p, n)) % (1 << bits),
                              dtype=torch.int32, device=cuda_device)
        cap = torch.as_tensor(np.where(rng.random(p) < 0.5, 1,
                                       t_quant.NO_VOTE_CAP),
                              dtype=torch.int32, device=cuda_device)
        fit_ops = t_ops.prepare_fitness_operands(
            x8[:, torch.as_tensor(arrays["feature"]).long().to(cuda_device)],
            y, arrays["path"], arrays["path_len"], arrays["n_neg"],
            arrays["leaf_class"], c)
        got = t_fit.fitness_correct_counts(fit_ops, shift, thr, cap)
        torch.cuda.synchronize()
        want = t_fit.fitness_correct_counts_plain(fit_ops, shift, thr, cap)
        assert torch.equal(got, want) and int(want.sum()) > 0
        ops = t_ops.prepare_operands(
            arrays["feature"], arrays["path"], arrays["path_len"],
            arrays["n_neg"], arrays["leaf_class"], c, 561, device=cuda_device)
        got = t_ti.tree_infer_scores(x8[:300], ops, shift[:2], thr[:2])
        torch.cuda.synchronize()
        want = t_ti.tree_infer_scores_plain(x8[:300], ops, shift[:2], thr[:2])
        assert torch.equal(got, want)

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

    # (seed, P, B, N, L, C): the har tree's serving buckets, its verify leg
    # and population slab, and the widest masks (N = 2048)
    @pytest.mark.parametrize("seed,p,b,n,l,c", [
        (10, 1, 1, 588, 589, 6), (11, 1, 37, 588, 589, 6),
        (12, 1, 1024, 588, 589, 6), (13, 1, 3090, 588, 589, 6),
        (14, 8, 3090, 588, 589, 6), (15, 3, 300, 2048, 2049, 4),
        (18, 2, 300, 4100, 300, 4),       # three mask segments a leaf
        (19, 1, 40, 120000, 64, 3)])      # decisions in global scratch
    @pytest.mark.parametrize("leaves", ["tree-like", "random"])
    def test_tree_infer_kernel_at_main_path_shapes(self, cuda_device, seed, p,
                                                   b, n, l, c, leaves):
        case = _random_case(seed, p, b, n, l, c, n_features=561)
        if leaves == "tree-like":
            case = _tree_like(case, seed)
        ops = t_ops.prepare_operands(
            case["feature"], case["path"], case["target"],
            np.zeros(l, np.int32), case["leaf_class"], c, case["n_features"],
            device=cuda_device)
        shift, thr, _ = _to(cuda_device, *_port_chromosome_operands(case))
        x8 = torch.as_tensor(case["x8"], device=cuda_device)
        launches = kernels.launched(t_ti.tree_infer_scores)
        got = t_ti.tree_infer_scores(x8, ops, shift, thr)
        torch.cuda.synchronize()
        assert kernels.launched(t_ti.tree_infer_scores) == launches + 1
        want = t_ti.tree_infer_scores_plain(x8, ops, shift, thr)
        assert torch.equal(got, want)
        if leaves == "tree-like":
            assert int(want.sum()) > 0

    @pytest.mark.parametrize("p", [33, 256, 1024, 1500, 4096])
    def test_domination_bits_kernel(self, cuda_device, p):
        rng = np.random.default_rng(p)
        objs = torch.as_tensor((rng.integers(0, 64, (p, 2)) / 63)
                               .astype(np.float32), device=cuda_device)
        rel, counts = t_dom.domination_bits(objs)
        torch.cuda.synchronize()
        want_rel, want_counts = t_dom.domination_bits_plain(objs)
        assert torch.equal(rel, want_rel) and torch.equal(counts, want_counts)

    @pytest.mark.parametrize("name", SORT_CASES + ["pool 256", "pool 1024",
                                                   "pool 4096"])
    def test_sort_kernel(self, cuda_device, name):
        """Two launches, no host sync, the host loop's ranks."""
        if name.startswith("pool ") and name != "pool 1500":
            p = int(name.split()[1])
            rng = np.random.default_rng(p)
            objs = (rng.integers(0, 64, (p, 2)) / 63).astype(np.float32)
        else:
            objs = _sort_case(name)
        objs = torch.as_tensor(objs, device=cuda_device)
        t_dom.domination_bits(objs)          # build and load first
        before = (kernels.launched(t_dom.domination_bits),
                  kernels.launched(t_dom.non_dominated_rank))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = t_dom.non_dominated_rank(objs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert (kernels.launched(t_dom.domination_bits),
                kernels.launched(t_dom.non_dominated_rank)) == (before[0] + 1,
                                                       before[1] + 1)
        want = t_dom.non_dominated_rank_plain(objs)
        assert torch.equal(got, want)
        if name == "chain 300":
            assert int(got.max()) == 299

    def test_survivors_and_step_equal_the_host_loop(self, cuda_device,
                                                    monkeypatch):
        """`survivors` and `make_step` on the card's sort equal them on the
        host loop, fed the same pool and draws."""
        rng = np.random.default_rng(0)
        p, g = 256, 7
        genes = torch.as_tensor(rng.random((p, g), dtype=np.float32),
                                device=cuda_device)
        objs = torch.as_tensor((rng.integers(0, 32, (2 * p, 2)) / 31)
                               .astype(np.float32), device=cuda_device)

        def fitness(x):
            return torch.stack([x[:, 0].round(decimals=1),
                                x[:, 1:].mean(1).round(decimals=1)], 1)

        gen = torch.Generator(device=cuda_device).manual_seed(0)
        draws = t_nsga2.draw_step(gen, p, g, cuda_device)
        cfg = t_nsga2.NSGA2Config(pop_size=p)
        fit0 = fitness(genes)
        rank0 = t_nsga2.non_dominated_sort(fit0)
        state = t_nsga2.NSGA2State(genes, fit0, rank0,
                                   t_nsga2.crowding_distance(fit0, rank0), 0)
        card = (t_nsga2.survivors(objs, p),
                t_nsga2.make_step(fitness, cfg)(state, draws))
        monkeypatch.setattr(t_nsga2, "non_dominated_sort",
                            t_dom.non_dominated_rank_plain)
        host = (t_nsga2.survivors(objs, p),
                t_nsga2.make_step(fitness, cfg)(state, draws))
        for a, b in zip(card[0], host[0]):
            assert torch.equal(a, b)
        for f in ("genes", "objs", "rank", "crowd"):
            assert torch.equal(getattr(card[1], f), getattr(host[1], f))

    @pytest.mark.parametrize("lengths", [(5,), (2, 3)])
    def test_captured_chunk_equals_eager_loop(self, cuda_device, lengths):
        """`make_chunk` on the card (one CUDA graph a chunk length) equals
        the eager per-generation loop on the seeds tree's kernel fitness,
        generator state included, and counts each replayed launch."""
        from repro_torch import kernels
        from repro_torch.search import make_kernel_fitness

        problem = _seeds_problem(cuda_device)
        fitness = make_kernel_fitness(problem)
        p, g = 64, problem.n_genes

        def start():
            gen = torch.Generator(device=cuda_device).manual_seed(4)
            return gen, t_nsga2.init_state(fitness, cfg, t_nsga2.draw_init(
                gen, p, g, 1, cuda_device), seed_genes=problem.exact_genes())

        cfg = t_nsga2.NSGA2Config(pop_size=p)
        step = t_nsga2.make_step(fitness, cfg)
        gen, eager = start()
        for _ in range(sum(lengths)):
            eager = step(eager, t_nsga2.draw_step(gen, p, g, cuda_device))
        gen2, chunked = start()
        captures = t_nsga2.make_chunk.captures
        chunks = {n: t_nsga2.make_chunk(fitness, cfg, n) for n in lengths}
        kernels.reset_launch_counts()
        for n in lengths:
            chunked = chunks[n](chunked, gen2)
        counts = kernels.launch_counts()
        for f in ("genes", "objs", "rank", "crowd"):
            assert torch.equal(getattr(eager, f), getattr(chunked, f)), f
        assert chunked.generation == sum(lengths)
        assert torch.equal(gen.get_state(), gen2.get_state())
        assert t_nsga2.make_chunk.captures == captures + len(set(lengths))
        # each chunk's warm-up step, then every replayed generation
        assert counts["fitness_errors"] == len(set(lengths)) + sum(lengths)

    def test_run_search_chunked_equals_one_chunk(self, cuda_device,
                                                 tmp_path):
        """Chunks of 4 and 2 with saves, one chunk of 6, and a resume from
        the save at 4 give one state; the MLP family's chunks too."""
        import shutil

        from repro_torch import search
        from repro_torch.families import printed_mlp

        problem = _seeds_problem(cuda_device)
        mlp = printed_mlp.build_problem("seeds", n_hidden=4, n_steps=30,
                                        device=cuda_device)
        for prob in (problem, mlp):
            run = functools.partial(search.run_search, prob,
                                    backend="kernel", pop_size=32,
                                    n_generations=6, seed=3)
            a = run(out_dir=str(tmp_path / "a"), checkpoint_every=4)
            b = run()
            assert (a.n_dispatches, b.n_dispatches) == (3, 2)
            shutil.rmtree(tmp_path / "a" / "ckpt" / "ckpt_00000006")
            c = run(out_dir=str(tmp_path / "a"), checkpoint_every=4,
                    resume=True)
            shutil.rmtree(tmp_path / "a")
            for f in ("genes", "objs", "rank", "crowd"):
                assert torch.equal(getattr(a.state, f), getattr(b.state, f))
                assert torch.equal(getattr(a.state, f), getattr(c.state, f))

    def test_kernels_build_for_sm90a(self, cuda_device):
        _build.build()
        for name in _build.SOURCES:
            assert _build.library_path(name).exists()
