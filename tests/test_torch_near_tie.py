"""The near-tie rule of the bf16 kernels' checked products
(``stnerf_tpu_torch/kernels/csrc/tc_blocks.cuh``: ``WideRule``, applied by
``dense_checked`` in K1's training forward, K3's forward and the backward's
recompute, ``tc_bwd.cuh``'s ``Ctx::dense``) against a NumPy model of how a Hopper
``wgmma`` k-step sums, as ``tc_blocks.cuh`` describes it (and
``tools/torch_wgmma_rounding.py`` measured it): the products of a k-step
of 16 inputs and the accumulator are aligned to the largest exponent among
them, each kept to 25 bits by truncation toward zero, summed, and the sum
truncated toward zero to a float32. The plain version's rounding is the
k-order chain: float32 ``acc + w_k x_k``, one input at a time (a bf16 x
bf16 product is exact in float32, so each step is an FMA).

Every output whose two sums round to different bf16 activations (bias,
ReLU, bf16), or lie on different sides of the ReLU, must be flagged by the
rule, which the kernel then recomputes in k order. The rule's constants
are read from the header's source, and the sources are held to one rule
for both directions. NumPy only: neither torch nor JAX is imported, so the
tests run in the pytest process itself.
"""

import pathlib
import re

import numpy as np
import pytest

CSRC = pathlib.Path(__file__).resolve().parents[1] / "stnerf_tpu_torch" / "kernels" / "csrc"
HEADER = CSRC / "tc_blocks.cuh"
N_INIT = 2000     # outputs at the init scale's biases
N_SMALL = 2000    # outputs whose bias cancels the sum to near zero


def _checked_ks(trunk: int, head: int, motion: int) -> set:
    """The K (inputs, padded to 16 as pack_field and the kernels pad them)
    of every checked product at these widths: the motion net's first layer
    (its 84-row encoding, 96) and the rest (motion), the trunk's first layer
    (the 63-row position encoding, 64), the rest of the trunk, the skip
    layer over [trunk | position encoding] and the rgb head's first layer
    over [trunk | dir (32) | time (32)] (both trunk + 64), that layer
    without time (trunk + 32), the deep rgb head's hidden layers (head)."""
    return {96, motion, 64, trunk, trunk + 64, trunk + 32, head}


# the taekwondo widths and the narrow 64/32/32, then the wide trunks' K
FORWARD_KS = sorted(_checked_ks(256, 128, 128) | _checked_ks(64, 32, 32) | {512, 1024})


def _constant(name: str) -> int:
    m = re.search(rf"constexpr (?:unsigned|int) {name} = (\d+);", HEADER.read_text())
    assert m, f"{name} not found in {HEADER.name}"
    return int(m.group(1))


def _bf16(a):
    """float32 -> the nearest bf16 (ties to even), as float32."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return r.astype(np.uint32).view(np.float32)


def _trunc(v, unit):
    return np.trunc(v / unit) * unit


def _exponent(a):
    """floor(log2 |a|), 0 where a is 0."""
    a = np.abs(a)
    return np.floor(np.log2(np.where(a > 0, a, 1.0)))


def _wgmma_chain(w, x):
    """The tensor cores' sum of w (K, N) * x (K, N) over K, 16 at a step,
    as float32 (the model in the module docstring)."""
    k_total, n = w.shape
    acc = np.zeros(n, np.float64)
    prod = w.astype(np.float64) * x.astype(np.float64)  # exact
    for k0 in range(0, k_total, 16):
        terms = prod[k0:k0 + 16]
        top = np.maximum(np.abs(acc), np.abs(terms).max(0))
        unit = np.exp2(_exponent(top) - 24)  # 25 bits below the largest
        total = _trunc(acc, unit) + _trunc(terms, unit).sum(0)  # exact in float64
        acc = np.where(top > 0, _trunc(total, np.exp2(_exponent(total) - 23)), 0.0)
    return acc.astype(np.float32)


def _k_order(w, x):
    acc = np.zeros(w.shape[1], np.float32)
    for k in range(w.shape[0]):
        acc = (acc + w[k] * x[k]).astype(np.float32)
    return acc


def _wide_rule(y, w, x, near, near_ks, abs_ks):
    """WideRule::make applied to y (float32) of w (K, N) * x (K, N), as the
    header's (a padded unit's exact zeros aside: no output here is one):
    the window ABS_KS x 2^-24 a k-step of S = |w_r| |x_c| / sqrt(K)."""
    k_total = w.shape[0]
    ks = k_total // 16
    near = max(near, near_ks * ks)
    scale = np.sqrt((w.astype(np.float64) ** 2).sum(0) * (x.astype(np.float64) ** 2).sum(0)
                    / k_total)
    win = (abs_ks * ks / 2.0**24 * scale).astype(np.float32)
    u = y.view(np.uint32)
    d = np.abs((u & 0xFFFF).astype(np.int64) - 0x8000)  # ulps to the tie
    binade = (u & 0x7F800000).view(np.float32)
    dist = d.astype(np.float32) * binade / np.float32(2.0**23)
    return (np.abs(y) < win) | ((y > 0) & ((d < near) | (dist < win)))


@pytest.mark.parametrize("k", FORWARD_KS)
def test_wide_rule_flags_every_flip(k):
    """At the K of every checked layer at the taekwondo widths and at
    64/32/32 (32 to 320 inputs), and at 512 and 1024 (a wide trunk), on seeded
    bf16 layers at the init scale (weights U(-1/sqrt(K), 1/sqrt(K)),
    inputs ReLU'd normals; half of them scaled by 40, as a position
    encoding's raw coordinates scale a first layer), half of the outputs
    with an init-scale bias and half with a bias that cancels the sum to
    within 1e-3 x the inputs' scale of zero (where a truncated chain's
    error is largest against the output), every output whose truncated and
    k-order sums round to different bf16 activations or fall on different
    sides of the ReLU is flagged by the backward's rule. The flagged share
    of the init-scale outputs stays small."""
    near, near_ks, abs_ks = _constant("NEAR"), _constant("NEAR_KS"), _constant("ABS_KS")
    rng = np.random.default_rng(k)
    n = N_INIT + N_SMALL
    big = np.where(np.arange(n) % 2, 40.0, 1.0)  # every other output's inputs
    w = _bf16(rng.uniform(-1.0, 1.0, (k, n)) / np.sqrt(k))
    x = _bf16(np.maximum(rng.normal(0.0, 0.5, (k, n)), 0.0) * big)
    exact = (w.astype(np.float64) * x).sum(0)
    bias = np.concatenate([rng.uniform(-1.0, 1.0, N_INIT) / np.sqrt(k),
                           rng.uniform(-1e-3, 1e-3, N_SMALL)]) * big
    bias = (bias - np.where(np.arange(n) < N_INIT, 0.0, exact)).astype(np.float32)
    y_tc = (_wgmma_chain(w, x) + bias).astype(np.float32)
    y_k = (_k_order(w, x) + bias).astype(np.float32)
    flip = ((_bf16(np.maximum(y_tc, 0.0)) != _bf16(np.maximum(y_k, 0.0)))
            | ((y_tc > 0) != (y_k > 0)))
    flagged = _wide_rule(y_tc, w, x, near, near_ks, abs_ks)
    assert flip.sum() > 0  # the model does flip outputs
    missed = np.flatnonzero(flip & ~flagged)
    assert missed.size == 0, (f"{missed.size} of {flip.sum()} flips not flagged, e.g. "
                              f"y_tc {y_tc[missed[:4]]}, y_k {y_k[missed[:4]]}")
    assert flagged[:N_INIT].mean() < 0.05


def _strip_comments(src: str) -> str:
    return re.sub(r"//[^\n]*", "", src)


def test_one_rule_serves_both_directions():
    """One near-tie rule in the tree: ``tc_blocks.cuh`` defines a single
    rule, ``WideRule``; ``dense_checked`` takes it typed, with no rule
    template parameter, and every call of it, forward or backward, passes
    the layer's rule (``wide_rule``, or the backward's ``WideRule::make``,
    on the same row norms of one kernel, ``row_norms_kernel``), so every
    checked product flags by it; the forwards' former ``TieRule`` /
    ``near_tie`` appear nowhere. The checked products are K1's training
    forward (``fused_field_tc.cu``), K3's forward (``spacenet_tc.cu``) and
    the backward's recompute (``tc_bwd.cuh`` ``Ctx::dense``); only K1's
    render route takes the unchecked ``tc_dense``."""
    sources = {p.name: _strip_comments(p.read_text())
               for p in sorted(CSRC.glob("*.cu*"))}
    for name, src in sources.items():
        assert "TieRule" not in src and "near_tie" not in src, name
    blocks = sources["tc_blocks.cuh"]
    assert re.findall(r"struct (\w*Rule)\b", blocks) == ["WideRule"]
    definition = re.search(r"template <([^>]*)>\s*__device__ void dense_checked\(([^)]*)\)",
                           blocks)
    assert definition, "dense_checked's definition not found"
    assert definition.group(1).replace(" ", "") == "intTB,boolFULL,intLN"
    assert "const WideRule rule" in definition.group(2)
    maker = re.search(r"__device__ WideRule wide_rule\(", blocks)
    assert maker, "wide_rule's definition not found"
    body = blocks[maker.end():blocks.index("return WideRule::make(", maker.end())]
    assert "s += segs[i].rn[r]" in body and "input_norms<TB>(" in body
    calls = {name: re.findall(r"\bdense_checked<[^;]*;", src) for name, src in sources.items()}
    assert {k: len(v) for k, v in calls.items() if v} == {
        "fused_field_tc.cu": 1, "spacenet_tc.cu": 1, "tc_bwd.cuh": 1}, calls
    assert all("wide_rule<" in call or "WideRule::make(" in call
               for v in calls.values() for call in v), calls
    # the forwards' checked segments carry the pack's row norms; the
    # backward reads the same norms from its own pre-pass of the same kernel
    for name in ("fused_field_tc.cu", "spacenet_tc.cu"):
        assert re.search(r"norms \+ p\.n_off\[slot\]", sources[name]), name
    assert "norms[p.n_off[slots[i]] + r]" in sources["tc_bwd.cuh"]
    assert [n for n, src in sources.items() if "__global__ void row_norms_kernel" in src] == [
        "tc_blocks.cuh"]
    users = {name for name, src in sources.items() if re.search(r"\btc_dense<", src)}
    assert users == {"fused_field_tc.cu"}
