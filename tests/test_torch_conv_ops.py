"""The conv-net ops of the PyTorch port (paddle_tpu_torch/ops/nn.py
``conv2d``, ``pool2d``, ``batch_norm``/``batch_norm_grad``,
``conv2d_bn_relu``; ops/math.py ``fc``, ``fused_elemwise_activation``;
ops/creation.py ``gaussian_random``) held against the JAX package's
lowerings on the CPU, from the same numpy-seeded inputs.

Tolerances, all f32: forward outputs to 1e-5 (sums of up to a few hundred
products in another order); gradients to 2e-5, and sums over whole
batches (dFilter, dScale, dBias) to 1e-5 of their largest value; pooling
is exact where it selects or sums few values (max: 0; avg: 1e-6).
Gradients are the port's explicit grad lowerings against ``jax.vjp`` of
the reference's forward lowering, which is how the reference
differentiates those ops.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import registry as jreg
from paddle_tpu.core.lowering import LowerCtx as JCtx
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.lowering import LowerCtx as TCtx

ATOL = 1e-5
ATOL_GRAD = 2e-5
SUM_RTOL = 1e-5


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _jax(op_type, args, attrs):
    fn = jreg.get_op_def(op_type).lower
    out = fn(JCtx(rng_key=jax.random.key(0), mode="eager"),
             *[None if a is None else jnp.asarray(a) for a in args], **attrs)
    out = out if isinstance(out, tuple) else (out,)
    return [None if o is None else np.asarray(o) for o in out]


def _port(op_type, args, attrs):
    fn = treg.get_op_def(op_type).lower
    out = fn(TCtx(torch.device("cpu")),
             *[None if a is None else torch.from_numpy(np.array(a))
               for a in args], **attrs)
    out = out if isinstance(out, tuple) else (out,)
    return [None if o is None else o.numpy() for o in out]


def _jax_vjp(op_type, args, attrs, diff, cot):
    """Gradients of the reference lowering's first output w.r.t. the args
    at indices ``diff``, cotangent ``cot``."""
    fn = jreg.get_op_def(op_type).lower

    def f(*d):
        full = [jnp.asarray(a) if a is not None else None for a in args]
        for i, v in zip(diff, d):
            full[i] = v
        out = fn(JCtx(rng_key=jax.random.key(0), mode="eager"), *full,
                 **attrs)
        return out[0] if isinstance(out, tuple) else out

    _, vjp = jax.vjp(f, *[jnp.asarray(args[i]) for i in diff])
    return [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _port_grad(op_type, args, outs, cot, attrs):
    """The port's ``<op>_grad`` lowering: forward inputs, then (output,
    output grad) per forward output (the grad only for the first)."""
    fn = treg.get_op_def(op_type + "_grad").lower
    t = [None if a is None else torch.from_numpy(np.array(a)) for a in args]
    pairs = []
    for i, o in enumerate(outs):
        pairs += [None if o is None else torch.from_numpy(np.array(o)),
                  torch.from_numpy(np.array(cot)) if i == 0 else None]
    out = fn(TCtx(torch.device("cpu")), *t, *pairs, **attrs)
    out = out if isinstance(out, tuple) else (out,)
    return [None if g is None else g.numpy() for g in out]


def _close_sum(got, want):
    """A sum over a batch: to SUM_RTOL of its largest value."""
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=SUM_RTOL * max(np.abs(want).max(), 1.0))


# -- conv2d ------------------------------------------------------------------

CONV_CASES = [
    # (x shape, w shape, attrs)
    ((2, 3, 11, 11), (8, 3, 7, 7), {"strides": [2, 2], "paddings": [3, 3]}),
    ((2, 8, 9, 9), (16, 8, 3, 3), {"strides": [1, 1], "paddings": [1, 1]}),
    ((2, 8, 8, 8), (16, 8, 1, 1), {"strides": [2, 2], "paddings": [0, 0]}),
    ((1, 4, 10, 7), (6, 4, 3, 2), {"strides": [1, 2],
                                   "paddings": [1, 0, 2, 1]}),
    ((2, 6, 9, 9), (6, 3, 3, 3), {"strides": [2, 2], "paddings": [1, 1],
                                  "groups": 2, "dilations": [2, 2]}),
    ((2, 4, 9, 8), (5, 4, 3, 3), {"strides": [2, 2],
                                  "padding_algorithm": "SAME"}),
    ((2, 4, 9, 8), (5, 4, 3, 3), {"padding_algorithm": "VALID"}),
]


@pytest.mark.parametrize("xs,ws,attrs", CONV_CASES,
                         ids=["stem", "3x3", "1x1s2", "asym", "group-dil",
                              "same", "valid"])
def test_conv2d_and_grad(xs, ws, attrs):
    rng = np.random.RandomState(0)
    x, w = _rand(rng, *xs), _rand(rng, *ws, scale=0.3)
    want, = _jax("conv2d", [x, w], attrs)
    got, = _port("conv2d", [x, w], attrs)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    cot = _rand(rng, *want.shape)
    jdx, jdw = _jax_vjp("conv2d", [x, w], attrs, [0, 1], cot)
    dx, dw = _port_grad("conv2d", [x, w], [got], cot, attrs)
    np.testing.assert_allclose(dx, jdx, rtol=0, atol=ATOL_GRAD)
    _close_sum(dw, jdw)


# -- pool2d ------------------------------------------------------------------

POOL_CASES = [
    ("max 3x3 s2 p1 (ResNet's)", (2, 3, 9, 9),
     {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
      "paddings": [1, 1]}),
    ("max ceil_mode, odd", (2, 3, 8, 7),
     {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
      "paddings": [0, 0], "ceil_mode": True}),
    ("max ceil_mode, padded, a window starting in the padding", (1, 2, 6, 6),
     {"pooling_type": "max", "ksize": [2, 2], "strides": [3, 3],
      "paddings": [1, 1], "ceil_mode": True}),
    ("avg exclusive, padded", (2, 3, 9, 7),
     {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
      "paddings": [1, 1], "exclusive": True}),
    ("avg inclusive, padded", (2, 3, 9, 7),
     {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
      "paddings": [1, 1], "exclusive": False}),
    ("avg exclusive ceil_mode, odd", (2, 3, 8, 7),
     {"pooling_type": "avg", "ksize": [3, 2], "strides": [2, 2],
      "paddings": [0, 1], "ceil_mode": True}),
    ("global avg", (2, 5, 7, 7),
     {"pooling_type": "avg", "global_pooling": True}),
    ("global max", (2, 5, 7, 7),
     {"pooling_type": "max", "global_pooling": True}),
    ("adaptive avg, divisible", (2, 3, 8, 6),
     {"pooling_type": "avg", "adaptive": True, "ksize": [4, 3]}),
    ("adaptive max, uneven bins", (2, 3, 7, 5),
     {"pooling_type": "max", "adaptive": True, "ksize": [3, 2]}),
    ("adaptive avg, uneven bins", (2, 3, 7, 5),
     {"pooling_type": "avg", "adaptive": True, "ksize": [3, 2]}),
]


@pytest.mark.parametrize("what,xs,attrs", POOL_CASES,
                         ids=[c[0] for c in POOL_CASES])
def test_pool2d_and_grad(what, xs, attrs):
    rng = np.random.RandomState(1)
    x = _rand(rng, *xs)
    want, = _jax("pool2d", [x], attrs)
    got, = _port("pool2d", [x], attrs)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=0 if attrs["pooling_type"] == "max"
                               else 1e-6)
    cot = _rand(rng, *want.shape)
    jdx, = _jax_vjp("pool2d", [x], attrs, [0], cot)
    dx, = _port_grad("pool2d", [x], [got], cot, attrs)
    np.testing.assert_allclose(dx, jdx, rtol=0, atol=1e-6)


def test_max_pool_grad_ties_go_to_the_first_maximum():
    """After a relu, windows of zeros tie: the gradient goes to each
    window's first maximum in both packages."""
    rng = np.random.RandomState(2)
    x = np.maximum(_rand(rng, 1, 2, 8, 8), 0).astype(np.float32)
    x[:, :, :4, :4] = 0.0
    attrs = {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
             "paddings": [1, 1]}
    out, = _port("pool2d", [x], attrs)
    cot = np.ones_like(out)
    jdx, = _jax_vjp("pool2d", [x], attrs, [0], cot)
    dx, = _port_grad("pool2d", [x], [out], cot, attrs)
    np.testing.assert_array_equal(dx, jdx)


# -- batch_norm --------------------------------------------------------------

def _bn_inputs(rng, n=4, c=6, hw=5):
    return [_rand(rng, n, c, hw, hw, scale=2.0) + 0.5,
            rng.uniform(0.5, 1.5, c).astype(np.float32),
            _rand(rng, c, scale=0.1),
            _rand(rng, c, scale=0.2),
            rng.uniform(0.5, 2.0, c).astype(np.float32)]


@pytest.mark.parametrize("is_test", [False, True])
def test_batch_norm(is_test):
    """Y, the blended running statistics, SavedMean and SavedVariance (the
    inverse std) equal the reference's (E[x^2] - m^2 statistics)."""
    rng = np.random.RandomState(3)
    args = _bn_inputs(rng)
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "is_test": is_test}
    want = _jax("batch_norm", args, attrs)
    got = _port("batch_norm", args, attrs)
    assert got[5] is None and want[5] is None     # ReserveSpace
    for name, g, w in zip(("Y", "MeanOut", "VarianceOut", "SavedMean",
                           "SavedVariance"), got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("is_test", [False, True])
def test_batch_norm_grad(is_test):
    """batch_norm_grad from the forward's SavedMean / SavedVariance equals
    the reference's grad op and jax.vjp of its forward."""
    rng = np.random.RandomState(4)
    x, scale, bias, mean, var = _bn_inputs(rng)
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "is_test": is_test}
    fwd = _port("batch_norm", [x, scale, bias, mean, var], attrs)
    dy = _rand(rng, *x.shape)
    args = [x, scale, bias, fwd[3], fwd[4], dy]
    want = _jax("batch_norm_grad", args, attrs)
    got = _port("batch_norm_grad", args, attrs)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ATOL_GRAD)
    for g, w in zip(got[1:], want[1:]):
        _close_sum(g, w)
    jdx, jds, jdb = _jax_vjp("batch_norm", [x, scale, bias, mean, var],
                             attrs, [0, 1, 2], dy)
    np.testing.assert_allclose(got[0], jdx, rtol=0, atol=ATOL_GRAD)
    _close_sum(got[1], jds)
    _close_sum(got[2], jdb)


# -- conv2d_bn_relu (the composed route; the kernel route is in
#    test_torch_conv_block.py) --------------------------------------------

@pytest.mark.parametrize("is_test", [False, True])
@pytest.mark.parametrize("relu", [True, False])
def test_conv2d_bn_relu_composed_route(is_test, relu):
    """Flag off: the exact conv2d + _bn_impl (+ relu) composition, all
    five outputs; its grad lowering gives jax.vjp of the reference's."""
    rng = np.random.RandomState(5)
    x = _rand(rng, 2, 8, 9, 9)
    w = _rand(rng, 16, 8, 3, 3, scale=0.2)
    _xx, scale, bias, mean, var = _bn_inputs(rng, c=16)
    args = [x, w, scale, bias, mean, var]
    attrs = {"strides": [2, 2], "paddings": [1, 1], "is_test": is_test,
             "with_relu": relu, "momentum": 0.9, "epsilon": 1e-5}
    want = _jax("conv2d_bn_relu", args, attrs)
    got = _port("conv2d_bn_relu", args, attrs)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, w_, rtol=1e-6, atol=ATOL)
    cot = _rand(rng, *want[0].shape)
    jg = _jax_vjp("conv2d_bn_relu", args, attrs, [0, 1, 2, 3], cot)
    tg = _port_grad("conv2d_bn_relu", args, got, cot, attrs)
    assert tg[4] is None and tg[5] is None
    np.testing.assert_allclose(tg[0], jg[0], rtol=0, atol=ATOL_GRAD)
    for g, w_ in zip(tg[1:4], jg[1:4]):
        _close_sum(g, w_)


# -- the ops the predictor's passes emit --------------------------------------

@pytest.mark.parametrize("act", ["", "relu"])
def test_fc_op(act):
    rng = np.random.RandomState(6)
    x, w, b = _rand(rng, 3, 4, 5), _rand(rng, 20, 6), _rand(rng, 6)
    attrs = {"in_num_col_dims": 1, "activation_type": act}
    np.testing.assert_allclose(_port("fc", [x, w, b], attrs)[0],
                               _jax("fc", [x, w, b], attrs)[0], rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("functors,axis,ys", [
    (["relu", "elementwise_add"], 1, (6,)),
    (["relu", "elementwise_add"], -1, (2, 6, 5, 5)),
    (["tanh", "elementwise_add"], -1, (5,)),
    (["elementwise_add", "relu"], -1, (2, 6, 5, 5)),
])
def test_fused_elemwise_activation(functors, axis, ys):
    rng = np.random.RandomState(7)
    x, y = _rand(rng, 2, 6, 5, 5), _rand(rng, *ys)
    attrs = {"functor_list": functors, "axis": axis,
             "save_intermediate_out": True}
    for g, w in zip(_port("fused_elemwise_activation", [x, y], attrs),
                    _jax("fused_elemwise_activation", [x, y], attrs)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_gaussian_random_draws_the_normal_distribution():
    """The Normal initializer's op: N(mean, std^2) from a seeded
    torch.Generator (the values are not the reference's JAX draw), the
    same seed giving the same tensor."""
    attrs = {"shape": [64, 32, 3, 3], "mean": 0.5, "std": 0.25, "seed": 7,
             "dtype": 5}
    a, = _port("gaussian_random", [None, None], attrs)
    b, = _port("gaussian_random", [None, None], attrs)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (64, 32, 3, 3) and a.dtype == np.float32
    n = a.size
    # mean and std within 5 standard errors
    assert abs(a.mean() - 0.5) < 5 * 0.25 / np.sqrt(n)
    assert abs(a.std() - 0.25) < 5 * 0.25 / np.sqrt(2 * n)


def test_relu_grad():
    """The explicit relu grad: jax.vjp of the reference's relu (0 at 0)."""
    rng = np.random.RandomState(8)
    x = _rand(rng, 3, 4, 5)
    x[0, 0, :2] = 0.0
    out, = _port("relu", [x], {})
    cot = _rand(rng, *x.shape)
    jdx, = _jax_vjp("relu", [x], {}, [0], cot)
    dx, = _port_grad("relu", [x], [out], cot, {})
    np.testing.assert_array_equal(dx, jdx)
