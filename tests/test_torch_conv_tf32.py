"""The arithmetic and the statistics layout of the port's conv kernel
(paddle_tpu_torch/kernels/csrc/conv_block.cu, rows 11 and 12), emulated
in plain PyTorch on the CPU and held against the JAX package's Pallas
kernels in interpret mode and against a float64 conv.

The kernel multiplies on the tensor cores in 3xTF32: each f32 operand v
is split into big = tf32(v), rounded to 10 mantissa bits, to nearest with
ties away from zero (the bits of PTX ``cvt.rna.tf32.f32``), and small = v
- big, of which the tensor core reads the top 10 mantissa bits (cut, not
rounded); the conv is small*big + big*small + big*big accumulated in
f32.  ``tf32_rna`` and ``tf32_cut`` below are the two roundings by bit
operations; each TF32 product is exact in f32, so three f32 convs of the
split operands are the kernel's arithmetic up to summation order.  The
tensor core also cuts (rounds toward zero) the sums it accumulates; the
kernel sums each K slice of 32 there and adds the slices in f32
registers (``test_truncating_accumulator_needs_slice_partials``).

Tolerances: against the reference's kernels and a float64 conv, 1e-5
absolute (outputs ~1 summing up to 576 products at these shapes; f32
summation order alone moves them ~2e-6).  Against chip_smoke.CONV_ATOL
(1e-4, the card's kernel vs cuDNN): at K >= 1152, 3xTF32 stays ~50x
inside it and 1xTF32 (big*big alone) lands ~10x outside.  Row 12's
channel sums to 1e-5 of their largest value (CONV_STATS_RTOL).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke as cs
from paddle_tpu.pallas_kernels import conv_block as jcb
from paddle_tpu_torch.kernels import conv_block as tcb

ATOL = 1e-5


def tf32_rna(t):
    """f32 -> the nearest TF32 value (low 13 mantissa bits zero), ties away
    from zero: add half a TF32 ulp to the magnitude bits, then cut."""
    u = t.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def tf32_cut(t):
    """f32 -> TF32 by cutting the low 13 mantissa bits (toward zero)."""
    return (t.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split_tf32(t):
    big = tf32_rna(t)
    return big, tf32_cut(t - big)


def conv_3xtf32(x, w, stride, pad):
    """small*big and big*small first, then big*big, in f32."""
    (xb, xs), (wb, ws) = split_tf32(x), split_tf32(w)
    y = F.conv2d(xs, wb, stride=stride, padding=pad) \
        + F.conv2d(xb, ws, stride=stride, padding=pad)
    return y + F.conv2d(xb, wb, stride=stride, padding=pad)


def conv_1xtf32(x, w, stride, pad):
    return F.conv2d(tf32_rna(x), tf32_rna(w), stride=stride, padding=pad)


def _case(seed, n, c, h, co, k):
    """x ~ N(0, 1), w at the layers' init N(0, 2 / fan_in), as the card
    checks take them (chip_smoke.conv_case)."""
    rng = np.random.RandomState(seed)
    return (rng.randn(n, c, h, h).astype(np.float32),
            (rng.randn(co, c, k, k) * np.sqrt(2.0 / (c * k * k)))
            .astype(np.float32), rng)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_tf32_rna_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10  # TF32 ulp at [1, 2)
    vals = np.array([1.0, 1 + ulp / 2, 1 + ulp / 2 - 2 ** -23,
                     1 + ulp / 4, -(1 + ulp / 2), 1.5 + 3 * ulp / 2, 0.0,
                     3.0e-39], np.float32)
    want = np.array([1.0, 1 + ulp, 1.0, 1.0, -(1 + ulp), 1.5 + 2 * ulp,
                     0.0, 3.0e-39], np.float64)
    got = tf32_rna(_t(vals)).numpy()
    np.testing.assert_array_equal(got[:7], want[:7].astype(np.float32))
    # a subnormal keeps 10 bits below the top of the f32 significand
    assert got[7].view(np.int32) & 0x1fff == 0
    rng = np.random.RandomState(0)
    v = _t(rng.randn(4096).astype(np.float32) * 10)
    big, small = split_tf32(v)
    assert not (big.view(torch.int32) & 0x1fff).any()
    assert not (small.view(torch.int32) & 0x1fff).any()
    assert float(((v - big).abs() / v.abs()).max()) <= 2.0 ** -11
    # big + small keeps 21 of f32's 24 bits
    assert float(((big.double() + small.double() - v.double()).abs()
                  / v.double().abs()).max()) <= 2.0 ** -20
    np.testing.assert_array_equal(
        tf32_cut(_t(np.float32([1 + 2 ** -10 + 2 ** -11, -1.9999999])))
        .numpy(), np.float32([1 + 2 ** -10, -(2 - 2 ** -10)]))


# (N, C, H, C_out, k, stride, pad): ResNet-like, small
SHAPES = [
    (2, 3, 16, 16, 7, 2, 3),     # the stem's 7x7 stride 2 on RGB
    (2, 64, 8, 32, 3, 1, 1),     # a 3x3, K = 576
    (2, 32, 8, 64, 1, 2, 0),     # a 1x1 stride-2 shortcut
    (3, 64, 7, 32, 1, 1, 0),     # a 1x1 at OH OW = 49
]


@pytest.mark.parametrize("n,c,h,co,k,stride,pad", SHAPES)
def test_3xtf32_row11_matches_reference_kernel(monkeypatch, n, c, h, co, k,
                                               stride, pad):
    """relu(conv * a + b), a and b folded from running statistics: the
    3xTF32 conv against the reference's inference kernel and float64."""
    monkeypatch.setenv("PADDLE_PALLAS_INTERPRET", "1")
    x, w, rng = _case(0, n, c, h, co, k)
    scale, bias, mean = (rng.randn(co).astype(np.float32) for _ in range(3))
    var = rng.uniform(0.5, 2.0, co).astype(np.float32)
    want = np.asarray(jcb.conv_bn_relu_inference(
        *(jnp.asarray(v) for v in (x, w, scale, bias, mean, var)), 1e-5,
        stride, pad, True))
    a, b = tcb.fold_affine(_t(scale), _t(bias), _t(mean), _t(var), 1e-5)
    got = tcb.affine_act_reference(conv_3xtf32(_t(x), _t(w), stride, pad),
                                   a, b)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    exact = tcb.conv_bn_act_reference(_t(x).double(), _t(w).double(),
                                      a.double(), b.double(), stride, pad)
    np.testing.assert_allclose(got.double().numpy(), exact.numpy(), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("n,c,h,co,k,stride,pad", SHAPES)
def test_3xtf32_row12_matches_reference_kernel(monkeypatch, n, c, h, co, k,
                                               stride, pad):
    """The conv and its per-image channel sums against the reference's
    training conv kernel and float64."""
    monkeypatch.setenv("PADDLE_PALLAS_INTERPRET", "1")
    x, w, _rng = _case(1, n, c, h, co, k)
    jconv, js, jss = (np.asarray(v) for v in jcb._train_pallas(
        jnp.asarray(x), jnp.asarray(w), stride, pad))
    conv = conv_3xtf32(_t(x), _t(w), stride, pad)
    np.testing.assert_allclose(conv.numpy(), jconv, rtol=0, atol=ATOL)
    exact = F.conv2d(_t(x).double(), _t(w).double(), stride=stride,
                     padding=pad)
    np.testing.assert_allclose(conv.double().numpy(), exact.numpy(), rtol=0,
                               atol=ATOL)
    for got, want in ((conv.sum(dim=(2, 3)), js),
                      ((conv * conv).sum(dim=(2, 3)), jss)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=cs.CONV_STATS_RTOL
                                   * np.abs(want).max())


@pytest.mark.parametrize("n,c,h,co,k", [
    (1, 128, 6, 32, 3),     # K = 1152
    (2, 256, 6, 32, 3),     # K = 2304, the stage-3 3x3's
    (1, 1152, 4, 32, 1),    # K = 1152 as a 1x1
])
def test_1xtf32_misses_conv_atol_where_3xtf32_holds(n, c, h, co, k):
    """Why the kernel pays three products: one TF32 product misses the
    card's f32 contract at ResNet's K, three keep it."""
    x, w, _rng = _case(2, n, c, h, co, k)
    pad = (k - 1) // 2
    exact = F.conv2d(_t(x).double(), _t(w).double(), padding=pad)
    err3 = float((conv_3xtf32(_t(x), _t(w), 1, pad).double() - exact)
                 .abs().max())
    err1 = float((conv_1xtf32(_t(x), _t(w), 1, pad).double() - exact)
                 .abs().max())
    assert err3 < cs.CONV_ATOL / 10, err3
    assert err1 > cs.CONV_ATOL * 5, err1


def segmented_stats(conv, bn):
    """Row 12's statistics as the kernel forms them: pixels flattened over
    the batch in tiles of bn; each tile sums its columns of each image
    into partials [tile, slot, channel] (slot = image - the tile's first
    image), the segment's j-th column into lane j % 4 of four running
    sums, then (lane 0 + lane 1) + (lane 2 + lane 3); then each (image,
    channel) sums the partials of the tiles covering it in tile order.
    All in f32; unwritten partials are NaN, so reading one shows."""
    n, co, oh, ow = conv.shape
    p = oh * ow
    flat = conv.transpose(1, 0, 2, 3).reshape(co, n * p)
    tiles, slots = tcb.stats_layout(n, p, bn)
    part = np.full((2, tiles, slots, co), np.nan, np.float32)
    widest = 0
    for t in range(tiles):
        p0, end = t * bn, min(t * bn + bn, n * p)
        images = range(p0 // p, (end - 1) // p + 1)
        widest = max(widest, len(images))
        assert len(images) <= slots
        for sl, img in enumerate(images):
            acc = np.zeros((4, 2, co), np.float32)
            c0 = max(p0, img * p)
            for col in range(c0, min(end, (img + 1) * p)):
                v = flat[:, col]
                acc[(col - c0) % 4, 0] += v
                acc[(col - c0) % 4, 1] += v * v
            part[:, t, sl] = (acc[0] + acc[1]) + (acc[2] + acc[3])
    out = np.zeros((2, n, co), np.float32)
    for img in range(n):
        for t in range(img * p // bn, ((img + 1) * p - 1) // bn + 1):
            out[:, img] += part[:, t, img - t * bn // p]
    return out[0], out[1], widest


@pytest.mark.parametrize("n,c,h,co,k,stride,pad,bn,span", [
    (5, 8, 7, 16, 3, 1, 1, 64, 2),    # OH OW = 49, tiles of 64
    (5, 8, 7, 16, 3, 1, 1, 128, 3),   # OH OW = 49, tiles wider than an image
    (9, 8, 5, 16, 3, 2, 1, 64, 8),    # OH OW = 9: a tile spans 8 images
    (9, 8, 5, 16, 3, 2, 1, 128, 9),   # one tile holds the whole batch
])
def test_segmented_partials_match_reference_stats(monkeypatch, n, c, h, co,
                                                  k, stride, pad, bn, span):
    """Partials of pixel tiles that span images, reduced in order, give the
    reference kernel's per-image s and ss to 1e-5 of their largest."""
    monkeypatch.setenv("PADDLE_PALLAS_INTERPRET", "1")
    x, w, _rng = _case(3, n, c, h, co, k)
    jconv, js, jss = (np.asarray(v) for v in jcb._train_pallas(
        jnp.asarray(x), jnp.asarray(w), stride, pad))
    s, ss, widest = segmented_stats(jconv, bn)
    assert widest == span
    for got, want in ((s, js), (ss, jss)):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=cs.CONV_STATS_RTOL
                                   * np.abs(want).max())


def test_stats_layout_slots_cover_every_tile():
    """stats_layout's tiles cover the pixels and its slots bound the images
    any tile touches, over image sizes and tile widths around the
    boundaries."""
    for p in (1, 3, 9, 16, 49, 63, 64, 65, 127, 196, 3136):
        for bn in (64, 128):
            for n in (1, 2, 7, 33):
                tiles, slots = tcb.stats_layout(n, p, bn)
                assert tiles * bn >= n * p > (tiles - 1) * bn
                most = 0
                for t in range(tiles):
                    end = min(t * bn + bn, n * p)
                    most = max(most, (end - 1) // p - t * bn // p + 1)
                assert most <= slots


def test_conv_tile_fills_the_card_at_resnet50_shapes():
    """At every ResNet-50 conv at batch 32 the chosen tile's grid has at
    least one CTA per SM, and the wide tile two waves of its two resident
    CTAs an SM."""
    shapes = cs.trunk_conv_shapes(32)
    assert len(shapes) == 23 and sum(c for _, c in shapes) == 53
    picks = set()
    for (xs, ws, stride, pad), _count in shapes:
        co, k = ws[0], ws[2]
        npix = xs[0] * tcb.out_size(xs[2], k, stride, pad) ** 2
        ctas = [-(-co // bm) * -(-npix // bn) for bm, bn in tcb.TILES]
        i = tcb.conv_tile(co, npix)
        assert i == (0 if ctas[0] >= tcb.WIDE_MIN_CTAS else 1)
        assert ctas[i] >= 132
        picks.add(i)
    assert picks == {0, 1}


def _truncating_dot(a, b, groups):
    """sum_k a[:, k] * b[k] as a tensor core accumulates it: the products
    (exact: TF32 operands) summed in groups of 8 into the running f32 sum,
    each group's result cut toward zero.  ``groups``: the number of 8-term
    groups between roundings into a float32 total (the slice length; 0
    for one running sum over all of K)."""
    prods = a.astype(np.float64) * b.astype(np.float64)
    k = prods.shape[1]
    total = np.zeros(prods.shape[0], np.float32)
    acc = np.zeros(prods.shape[0], np.float32)
    for g in range(0, k, 8):
        exact = acc.astype(np.float64) + prods[:, g:g + 8].sum(axis=1)
        r = exact.astype(np.float32)
        away = np.abs(r.astype(np.float64)) > np.abs(exact)
        acc = np.where(away, np.nextafter(r, np.float32(0)), r)
        if groups and (g // 8 + 1) % groups == 0:
            total = total + acc
            acc = np.zeros_like(acc)
    return total + acc


def test_truncating_accumulator_needs_slice_partials():
    """The kernel's three products of K = 2304 (6912 TF32 products an
    output) accumulated as one running sum by truncation drift toward zero
    to near CONV_ATOL; summing each 32-deep slice there (4 groups of 8 per
    product term, 12 groups) and adding the slices with rounding, as the
    kernel does, stays at f32 accuracy.  w at the layers' init; 512
    outputs of ~1."""
    rng = np.random.RandomState(4)
    k = 2304
    x = _t(rng.randn(512, k).astype(np.float32))
    w = _t((rng.randn(k) * np.sqrt(2.0 / k)).astype(np.float32))
    (xb, xs), (wb, ws) = split_tf32(x), split_tf32(w)
    # per slice of 32: the small*big, big*small and big*big groups
    a = torch.stack([xs, xb, xb], 1).reshape(512, 3, k // 32, 32)
    b = torch.stack([wb, ws, wb], 0).reshape(3, k // 32, 32)
    a = a.permute(0, 2, 1, 3).reshape(512, 3 * k).numpy()
    b = b.permute(1, 0, 2).reshape(3 * k).numpy()
    exact = x.double().numpy() @ w.double().numpy()
    drift = np.abs(_truncating_dot(a, b, 0) - exact).max()
    sliced = np.abs(_truncating_dot(a, b, 12) - exact).max()
    assert drift > cs.CONV_ATOL / 2, drift
    assert sliced < cs.CONV_ATOL / 20, sliced
