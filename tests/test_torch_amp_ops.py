"""The port's op lowerings under the bf16 AMP policy, each held against the
JAX package's on the CPU, on the same numpy-seeded inputs.

Each op runs in both packages with a context whose ``amp_bf16()`` is
true (the flag ``contrib.mixed_precision.decorate`` sets on a program),
forward and grad.  A grad op is the reference's own: its explicit grad
op where it has one, else its vjp replay of the forward; the port runs
its explicit grad or its replay.  Every output must have the reference's
dtype, and:

* values to one bf16 ulp: both rounded to bf16 (exact for a bf16
  output), at most one step apart on the bf16 grid.  The products keep
  f32 sums in both packages and round once (checked for this policy: at
  K = 64 and 768 both equal the correctly rounded product), so a larger
  gap is a fault;
* the dropout op and cast bitwise, the dropout under one mask shared by
  both packages (``test_torch_bert_dropout.patch_masks``);
* one exception, stated: the reduction a broadcast ``elementwise_add``
  grad makes for its smaller operand.  The reference's vjp transposes
  the broadcast of a bf16 cotangent into a sum that XLA:CPU accumulates
  in bf16 (1.5 ulps off the exact sum at 4096 rows, measured); the port
  sums in f32 and rounds once, as PyTorch does on either device.  There
  the port is held to one ulp of the exact (float64) sum, and the
  reference to no more than its own distance from it plus one ulp.

``isfinite`` is checked on finite, inf and nan groups.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.registry import get_op_def as jdef
import paddle_tpu_torch.framework as tfw
from paddle_tpu_torch.core.lowering import LowerCtx
from paddle_tpu_torch.core.registry import get_op_def as tdef
import test_torch_bert_dropout as tbd

BF16 = jnp.bfloat16
CPU = torch.device("cpu")


class JCtx:
    """The reference lowerings' context: no op (every grad wanted), the
    AMP flag, a fixed key."""

    op = None
    block = None

    def __init__(self, amp=True):
        self._amp = amp

    def amp_bf16(self):
        return self._amp

    def rng(self):
        return jax.random.key(7)


class TCtx(LowerCtx):
    """The port's: no op (every grad wanted), the AMP flag."""

    def __init__(self, amp=True, seed=None):
        super().__init__(CPU, None, seed)
        self._amp = amp

    def amp_bf16(self):
        return self._amp


def pair(a, dtype="float32"):
    """One numpy array as (jnp, torch) of ``dtype``; the bf16 rounding is
    round-to-nearest-even in both."""
    a = np.ascontiguousarray(a)
    j = jnp.asarray(a)
    t = torch.from_numpy(a.copy())
    if dtype == "bfloat16":
        return j.astype(BF16), t.to(torch.bfloat16)
    return j, t


def rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def dtype_name(x):
    return str(x.dtype).replace("torch.", "")


def bf16_keys(a):
    """float32 numpy -> the ordered integer of its bf16 rounding (adjacent
    bf16 values differ by 1; +0 and -0 are both 0)."""
    bits = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().astype(np.int32) & 0xFFFF
    mag = bits & 0x7FFF
    return np.where(bits & 0x8000, -mag, mag)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = jnp.asarray(x)
    return np.asarray(x.astype(jnp.float32)) \
        if jnp.issubdtype(x.dtype, jnp.floating) else np.asarray(x)


def assert_ulp(got, want, what):
    """``got`` (torch) has ``want``'s (jnp) dtype and is within one bf16
    ulp of it, elementwise."""
    assert dtype_name(got) == str(want.dtype), (what, got.dtype, want.dtype)
    g, w = as_np(got), as_np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    assert np.isfinite(g).all(), what
    d = np.abs(bf16_keys(g) - bf16_keys(w))
    assert d.max() <= 1, "%s: %d bf16 ulps apart (at %s)" % (
        what, d.max(), np.unravel_index(d.argmax(), d.shape))


def assert_bitwise(got, want, what):
    assert dtype_name(got) == str(want.dtype), (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(as_np(got), as_np(want), err_msg=what)


def run(op, jargs, targs, attrs=None, amp=True, tseed=None):
    """One op in both packages -> (jax outputs, torch outputs) as
    tuples."""
    attrs = dict(attrs or {})
    jo = jdef(op).lower(JCtx(amp), *jargs, **attrs)
    to = tdef(op).lower(TCtx(amp, tseed), *targs, **attrs)
    if not isinstance(jo, tuple):
        jo, to = (jo,), (to,)
    return jo, to


def check_all(op, jouts, touts, names=None, skip=()):
    for i, (j, t) in enumerate(zip(jouts, touts)):
        if j is None or i in skip:
            continue
        assert t is not None, (op, i)
        assert_ulp(t, j, "%s output %s" % (op, names[i] if names else i))


# -- products -----------------------------------------------------------------

@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_mul_and_grad(x_dtype):
    """A carried weight is bf16, an f32 one is cast inside; the product is
    bf16 either way, and so is the grad of a bf16 operand."""
    rng = np.random.RandomState(0)
    for w_dtype in ("float32", "bfloat16"):
        jx, tx = pair(rand(rng, 2, 6, 64), x_dtype)
        jw, tw = pair(rand(rng, 64, 24, scale=0.2), w_dtype)
        attrs = {"x_num_col_dims": 2, "y_num_col_dims": 1}
        jo, to = run("mul", (jx, jw), (tx, tw), attrs)
        check_all("mul", jo, to)
        assert to[0].dtype == torch.bfloat16
        # the output grad arrives in f32 (a fused LayerNorm's dY) and is
        # taken in the output's dtype first, as the reference's replay
        jd, td = pair(rand(rng, 2, 6, 24))
        jg = jdef("mul_grad").lower(JCtx(), jx, jw, jo[0], jd, **attrs)
        tg = tdef("mul_grad").lower(TCtx(), tx, tw, to[0], td, **attrs)
        check_all("mul_grad", jg, tg, ("dX", "dY"))


def test_mul_without_amp_stays_f32():
    rng = np.random.RandomState(1)
    jx, tx = pair(rand(rng, 6, 64))
    jw, tw = pair(rand(rng, 64, 24))
    jo, to = run("mul", (jx, jw), (tx, tw), amp=False)
    assert to[0].dtype == torch.float32 and jo[0].dtype == jnp.float32
    np.testing.assert_allclose(as_np(to[0]), as_np(jo[0]), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("trans", [(False, True), (False, False)])
def test_matmul_and_grad(trans):
    """The attention's products: q k^T with alpha (alpha in bf16, as the
    reference's jnp.asarray(alpha, out.dtype)), then probs v."""
    rng = np.random.RandomState(2)
    jq, tq = pair(rand(rng, 2, 3, 8, 16), "bfloat16")
    jk, tk = pair(rand(rng, 2, 3, 8, 16), "bfloat16")
    attrs = {"transpose_X": trans[0], "transpose_Y": trans[1],
             "alpha": 0.3 if trans[1] else 1.0}
    if not trans[1]:
        jq, tq = pair(rand(rng, 2, 3, 8, 8))       # f32 probs
    jo, to = run("matmul", (jq, jk), (tq, tk), attrs)
    check_all("matmul", jo, to)
    jd, td = pair(rand(rng, *to[0].shape), "bfloat16")
    jg = jdef("matmul_grad").lower(JCtx(), jq, jk, jo[0], jd, **attrs)
    tg = tdef("matmul_grad").lower(TCtx(), tq, tk, to[0], td, **attrs)
    check_all("matmul_grad", jg, tg, ("dX", "dY"))


def test_fc_promotes_as_the_reference():
    """The reference's fc (the inference passes' op) reads no AMP flag: a
    bf16 input with f32 weights computes in f32, as jnp promotes."""
    rng = np.random.RandomState(3)
    jx, tx = pair(rand(rng, 6, 40), "bfloat16")
    jw, tw = pair(rand(rng, 40, 24))
    jb, tb = pair(rand(rng, 24))
    for act in ("", "relu"):
        attrs = {"in_num_col_dims": 1, "activation_type": act}
        jo, to = run("fc", (jx, jw, jb), (tx, tw, tb), attrs)
        assert to[0].dtype == torch.float32
        check_all("fc", jo, to)


# -- elementwise --------------------------------------------------------------

def assert_reduction(got, want, cot, dims, what):
    """A broadcast grad's sum: ``got`` within one ulp of the exact sum of
    the cotangent ``cot`` over ``dims``; ``want`` (the reference's bf16
    accumulation) no further from it than its own error plus one ulp."""
    assert dtype_name(got) == str(want.dtype), what
    exact = as_np(cot).astype(np.float64).sum(axis=dims).reshape(
        as_np(want).shape).astype(np.float32)
    g, w = as_np(got), as_np(want)
    dg = np.abs(bf16_keys(g) - bf16_keys(exact))
    dw = np.abs(bf16_keys(w) - bf16_keys(exact))
    assert dg.max() <= 1, "%s: %d ulps off the exact sum" % (what, dg.max())
    assert (np.abs(bf16_keys(g) - bf16_keys(w)) <= dw + 1).all(), what


def test_elementwise_add_mixed_pair_and_grad():
    """bf16 activation + f32 bias computes in bf16 (jnp would lift it to
    f32); the grads come in the operands' dtypes."""
    rng = np.random.RandomState(4)
    jx, tx = pair(rand(rng, 4, 8, 24), "bfloat16")
    jy, ty = pair(rand(rng, 24))
    jo, to = run("elementwise_add", (jx, jy), (tx, ty), {"axis": -1})
    check_all("elementwise_add", jo, to)
    assert to[0].dtype == torch.bfloat16
    jd, td = pair(rand(rng, 4, 8, 24))             # an f32 output grad
    jg = jdef("elementwise_add_grad").lower(JCtx(), jx, jy, jo[0], jd,
                                            axis=-1)
    tg = tdef("elementwise_add_grad").lower(TCtx(), tx, ty, to[0], td,
                                            axis=-1)
    assert_ulp(tg[0], jg[0], "elementwise_add_grad dX")
    assert_reduction(tg[1], jg[1], jd.astype(BF16), (0, 1),
                     "elementwise_add_grad dY")


@pytest.mark.parametrize("op", ["elementwise_mul", "elementwise_div",
                                "elementwise_sub"])
def test_other_elementwise_mixed_pairs(op):
    rng = np.random.RandomState(5)
    jx, tx = pair(rand(rng, 4, 24), "bfloat16")
    jy, ty = pair(np.abs(rand(rng, 4, 24)) + 0.5)
    jo, to = run(op, (jx, jy), (tx, ty), {"axis": -1})
    check_all(op, jo, to)
    jo, to = run(op, (jy, jy * 2), (ty, ty * 2), {"axis": -1})
    assert to[0].dtype == torch.float32       # an f32 pair stays f32
    check_all(op, jo, to)


def test_scale_of_bf16_takes_its_scalars_in_bf16():
    """The attention bias 1e4 m - 1e4 on a bf16 mask product: 1e4 is 9984
    in bf16, so a real token's bias is exactly 0, as in the reference
    (not 10000 rounded after the product: -16)."""
    jm, tm = pair(np.array([[0.0, 1.0, 1.0]], np.float32), "bfloat16")
    jo, to = run("scale", (jm, None), (tm, None),
                 {"scale": 1e4, "bias": -1e4})
    assert_bitwise(to[0], jo[0], "scale")
    assert as_np(to[0]).tolist() == [[-9984.0, 0.0, 0.0]]


# -- activations --------------------------------------------------------------

@pytest.mark.parametrize("op,attrs", [("softmax", {"axis": -1}),
                                      ("gelu", {"approximate": False}),
                                      ("relu", {})])
def test_activation_and_grad(op, attrs):
    """f32 inside, the bf16 dtype out (gelu, softmax); grads in bf16 from
    an f32 output grad."""
    rng = np.random.RandomState(6)
    jx, tx = pair(rand(rng, 2, 3, 8, 8, scale=2.0), "bfloat16")
    jo, to = run(op, (jx,), (tx,), attrs)
    check_all(op, jo, to)
    jd, td = pair(rand(rng, 2, 3, 8, 8))
    jg = jdef(op + "_grad").lower(JCtx(), jx, jo[0], jd, **attrs)
    tg = tdef(op + "_grad").lower(TCtx(), tx, to[0], td, **attrs)
    check_all(op + "_grad", jg, tg)


# -- normalisation ------------------------------------------------------------

@pytest.mark.parametrize("dy_dtype", ["float32", "bfloat16"])
def test_layer_norm_and_grad(dy_dtype):
    """The MLM head's LayerNorm on a bf16 activation: f32 statistics, Y,
    Mean and Variance in X's dtype; the grad from statistics recomputed
    in f32 (the forward's are bf16-rounded), dX bf16, dScale and dBias
    f32."""
    rng = np.random.RandomState(7)
    jx, tx = pair(rand(rng, 12, 64, scale=3.0) + 1.0, "bfloat16")
    js, ts = pair(rand(rng, 64) + 1.0)
    jb, tb = pair(rand(rng, 64))
    attrs = {"epsilon": 1e-5, "begin_norm_axis": 1}
    jo, to = run("layer_norm", (jx, js, jb), (tx, ts, tb), attrs)
    check_all("layer_norm", jo, to, ("Y", "Mean", "Variance"))
    jd, td = pair(rand(rng, 12, 64), dy_dtype)
    args_j = (jx, js, jb, jo[0], jd, jo[1], None, jo[2], None)
    args_t = (tx, ts, tb, to[0], td, to[1], None, to[2], None)
    jg = jdef("layer_norm_grad").lower(JCtx(), *args_j, **attrs)
    tg = tdef("layer_norm_grad").lower(TCtx(), *args_t, **attrs)
    check_all("layer_norm_grad", jg, tg, ("dX", "dScale", "dBias"))


@pytest.mark.parametrize("is_test", [False, True])
def test_batch_norm_and_grad(is_test):
    """A bf16 conv output: f32 statistics, Y in bf16 (the folded affine
    applied in bf16), statistics outputs f32."""
    rng = np.random.RandomState(8)
    jx, tx = pair(rand(rng, 4, 6, 5, 5, scale=2.0) + 0.5, "bfloat16")
    params = [pair(v) for v in (rand(rng, 6) + 1.0, rand(rng, 6),
                                rand(rng, 6), np.abs(rand(rng, 6)) + 0.5)]
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "is_test": is_test}
    jo, to = run("batch_norm", (jx,) + tuple(p[0] for p in params),
                 (tx,) + tuple(p[1] for p in params), attrs)
    check_all("batch_norm", jo, to, ("Y", "MeanOut", "VarianceOut",
                                     "SavedMean", "SavedVariance"),
              skip=(5,))
    jd, td = pair(rand(rng, 4, 6, 5, 5), "bfloat16")
    (js, ts), (jb, tb) = params[:2]
    jg = jdef("batch_norm_grad").lower(JCtx(), jx, js, jb, jo[3], jo[4], jd,
                                       **attrs)
    tg = tdef("batch_norm_grad").lower(TCtx(), tx, ts, tb, to[3], to[4], td,
                                       **attrs)
    check_all("batch_norm_grad", jg, tg, ("dX", "dScale", "dBias"))


@pytest.mark.parametrize("attrs", [
    {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
     "paddings": [1, 1]},
    {"pooling_type": "avg", "global_pooling": True},
], ids=["max3x3s2", "global_avg"])
def test_pool2d_and_grad(attrs):
    """ResNet's two pools on bf16: max (-inf padding), global average
    (f32 sums, bf16 out)."""
    rng = np.random.RandomState(9)
    jx, tx = pair(rand(rng, 2, 4, 9, 9), "bfloat16")
    jo, to = run("pool2d", (jx,), (tx,), attrs)
    check_all("pool2d", jo, to)
    jd, td = pair(rand(rng, *to[0].shape))
    jg = jdef("pool2d_grad").lower(JCtx(), jx, jo[0], jd, **attrs)
    tg = tdef("pool2d_grad").lower(TCtx(), tx, to[0], td, **attrs)
    check_all("pool2d_grad", jg, tg)


@pytest.mark.parametrize("attrs", [
    {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]},
    {"ksize": [3, 3], "strides": [2, 2], "paddings": [0, 0],
     "ceil_mode": True},
    {"ksize": [2, 3], "strides": [1, 2], "paddings": [1, 0]},
], ids=["stem", "ceil", "stride1"])
def test_max_pool2d_grad_on_bf16_adds_in_window_order(attrs):
    """Where overlapping windows send several grads to one bf16 element,
    the port adds them one at a time in the windows' row-major order,
    rounding after each add, bitwise the CPU's bf16 autograd (the card's
    autograd rounds their f32 sum once: this input tells the two apart)."""
    import torch.nn.functional as F

    attrs = dict(attrs, pooling_type="max")
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rand(rng, 2, 8, 33, 32)).relu().to(torch.bfloat16)
    out = tdef("pool2d").lower(TCtx(), x, **attrs)
    out = out[0] if isinstance(out, tuple) else out
    d = torch.from_numpy(rand(rng, *out.shape)).to(torch.bfloat16)
    got, = tdef("pool2d_grad").lower(TCtx(), x, out, d, **attrs)

    def autograd(dtype):
        xg = x.to(dtype).requires_grad_()
        y = tdef("pool2d").lower(TCtx(), xg, **attrs)
        y = y[0] if isinstance(y, tuple) else y
        return torch.autograd.grad(y, xg, d.to(dtype))[0]

    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.equal(got, autograd(torch.bfloat16))
    assert not torch.equal(got, autograd(torch.float32).to(torch.bfloat16))


# -- conv ---------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    ("float32", (2, 3, 9, 9), (4, 3, 3, 3), 1, 1),
    ("bfloat16", (2, 4, 8, 8), (6, 4, 3, 3), 2, 1),
    ("bfloat16", (2, 8, 6, 6), (4, 8, 1, 1), 1, 0),
], ids=["f32-in-3x3", "bf16-3x3-s2", "bf16-1x1"])
def test_conv2d_and_grad(case):
    """bf16 operands, a bf16 result (f32 sums); the grads in the inputs'
    dtypes (an f32 filter's grad f32 of bf16 values)."""
    x_dtype, xs, ws, stride, pad = case
    rng = np.random.RandomState(10)
    jx, tx = pair(rand(rng, *xs), x_dtype)
    jw, tw = pair(rand(rng, *ws, scale=0.3))
    attrs = {"strides": [stride, stride], "paddings": [pad, pad],
             "dilations": [1, 1], "groups": 1}
    jo, to = run("conv2d", (jx, jw), (tx, tw), attrs)
    check_all("conv2d", jo, to)
    assert to[0].dtype == torch.bfloat16
    jd, td = pair(rand(rng, *to[0].shape), "bfloat16")
    jg = jdef("conv2d_grad").lower(JCtx(), jx, jw, jo[0], jd, **attrs)
    tg = tdef("conv2d_grad").lower(TCtx(), tx, tw, to[0], td, **attrs)
    check_all("conv2d_grad", jg, tg, ("dInput", "dFilter"))


# -- the fused epilogue -------------------------------------------------------

@pytest.mark.parametrize("p", [0.0, 0.1])
def test_fused_dropout_add_ln_casts_y_to_x(monkeypatch, p):
    """A bf16 Y (an AMP product) on the f32 residual X: Y is cast to X's
    dtype first, so the epilogue and its grad run in f32, as the
    reference's."""
    tbd.patch_masks(monkeypatch)
    rng = np.random.RandomState(11)
    jx, tx = pair(rand(rng, 4, 8, 32))
    jy, ty = pair(rand(rng, 4, 8, 32), "bfloat16")
    js, ts = pair(rand(rng, 32) + 1.0)
    jb, tb = pair(rand(rng, 32))
    attrs = {"dropout_prob": p, "is_test": False, "epsilon": 1e-5,
             "begin_norm_axis": 2, "fix_seed": True, "seed": 3}
    jo, to = run("fused_dropout_add_ln", (jx, jy, js, jb),
                 (tx, ty, ts, tb), attrs)
    check_all("fused_dropout_add_ln", jo, to,
              ("Out", "R", "Mean", "Variance"), skip=(4,))
    jd, td = pair(rand(rng, 4, 8, 32))
    jg = jdef("fused_dropout_add_ln_grad").lower(
        JCtx(), jo[1], js, jo[4], jo[2], jo[3], jd, **attrs)
    tg = tdef("fused_dropout_add_ln_grad").lower(
        TCtx(), to[1], ts, to[4], to[2], to[3], td, **attrs)
    check_all("fused_dropout_add_ln_grad", jg, tg,
              ("dX", "dY", "dScale", "dBias"))


# -- bitwise: dropout and cast -------------------------------------------------

@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
def test_dropout_bf16_bitwise_under_one_mask(monkeypatch, impl):
    """The attention probabilities' dropout on bf16: the reference's
    where(keep, x / q, 0) and the port's plain version, bitwise under one
    mask; its grad too."""
    tbd.patch_masks(monkeypatch)
    rng = np.random.RandomState(12)
    jx, tx = pair(np.abs(rand(rng, 2, 3, 8, 8)), "bfloat16")
    attrs = {"dropout_prob": 0.1, "is_test": False,
             "dropout_implementation": impl}
    jo, to = run("dropout", (jx,), (tx,), attrs, tseed=99)
    assert_bitwise(to[0], jo[0], "dropout Out")
    assert_bitwise(to[1], jo[1], "dropout Mask")
    assert 0 < int(as_np(to[1]).sum()) < to[1].numel()
    jd, td = pair(rand(rng, 2, 3, 8, 8), "bfloat16")
    jg = jdef("dropout_grad").lower(JCtx(), jo[1], jd, **attrs)
    tg = tdef("dropout_grad").lower(TCtx(), to[1], td, **attrs)
    assert_bitwise(tg, jg, "dropout_grad")


@pytest.mark.parametrize("src,dst", [("float32", "bfloat16"),
                                     ("bfloat16", "float32"),
                                     ("bool", "float32"),
                                     ("float32", "int64")])
def test_cast_bitwise(src, dst):
    from paddle_tpu.ops.common import dtype_enum
    rng = np.random.RandomState(13)
    a = rand(rng, 5, 7, scale=100.0)
    if src == "bool":
        ja, ta = jnp.asarray(a > 0), torch.from_numpy(a > 0)
    else:
        ja, ta = pair(a, src)
    attrs = {"in_dtype": dtype_enum(src), "out_dtype": dtype_enum(dst)}
    jo, to = run("cast", (ja,), (ta,), attrs)
    want = jo[0]
    if dst == "int64":      # the reference's jax runs without x64
        want = want.astype(jnp.int32)
        assert to[0].dtype == torch.int64
        np.testing.assert_array_equal(as_np(to[0]), as_np(want))
        return
    assert_bitwise(to[0], want, "cast %s -> %s" % (src, dst))


@pytest.mark.parametrize("bad", [None, "inf", "nan", "-inf"])
def test_isfinite_over_groups(bad):
    """One flag over every input (the dynamic loss scaling's check)."""
    rng = np.random.RandomState(14)
    arrs = [rand(rng, 3, 4), rand(rng, 7), rand(rng, 2, 2, 2)]
    if bad is not None:
        arrs[1][3] = float(bad)
    js = [jnp.asarray(a) for a in arrs]
    ts = [torch.from_numpy(a.copy()) for a in arrs]
    ts[2] = ts[2].to(torch.bfloat16)
    js[2] = js[2].astype(BF16)
    jo = jdef("isfinite").lower(JCtx(), js)
    to = tdef("isfinite").lower(TCtx(), ts)
    assert_bitwise(to, jo, "isfinite")
    assert bool(to.item()) is (bad is None)


def test_compare_ops_match():
    rng = np.random.RandomState(15)
    ja, ta = pair(rand(rng, 6))
    jb, tb = pair(np.round(rand(rng, 6)))
    for op in ("greater_equal", "greater_than", "less_than", "less_equal",
               "equal", "not_equal"):
        jo, to = run(op, (ja, jb), (ta, tb))
        assert_bitwise(to[0], jo[0], op)


def test_every_op_registered_for_the_policy():
    """The ops the decorator's loss scaling and the math operators emit
    exist in the port with the reference's slots and attrs."""
    for op in ("cast", "isfinite", "greater_equal", "less_than",
               "elementwise_mul", "elementwise_div", "elementwise_sub",
               "elementwise_pow", "elementwise_mod", "elementwise_floordiv",
               "elementwise_max", "elementwise_min", "assign", "scale"):
        j, t = jdef(op), tdef(op)
        assert (j.input_slots, j.output_slots, j.default_attrs,
                j.duplicable_inputs) == (t.input_slots, t.output_slots,
                                         t.default_attrs,
                                         t.duplicable_inputs), op
    assert tfw.Program()._amp_bf16 is False


# -- the bf16 kernels' plain versions against the reference's forms ----------

class _Interpret:
    """``pl`` with every pallas_call in interpret mode (the CPU runs the
    reference's kernel body)."""

    def __getattr__(self, name):
        import jax.experimental.pallas as pl

        return getattr(pl, name)

    @staticmethod
    def pallas_call(*a, **kw):
        import jax.experimental.pallas as pl

        return pl.pallas_call(*a, interpret=True, **kw)


@pytest.mark.parametrize("rows,cols", [(64, 768), (16, 1024), (8, 128)])
def test_row_14_bf16_plain_version_against_the_pallas_kernel(monkeypatch,
                                                             rows, cols):
    """Row 14's plain version on bf16 x with f32 gamma and beta (the MLM
    head's LayerNorm under AMP) against the reference's Pallas kernel in
    interpret mode: y (bf16) to one bf16 ulp, the f32 statistics to f32
    rounding (1e-6 of their scale)."""
    from paddle_tpu.pallas_kernels import layer_norm as jln
    from paddle_tpu_torch.kernels import layer_norm as tln

    monkeypatch.setattr(jln, "pl", _Interpret())
    rng = np.random.RandomState(cols)
    jx, tx = pair(rand(rng, rows, cols, scale=3.0) - 1.0, "bfloat16")
    jg, tg = pair(rand(rng, cols) + 1.0)
    jb, tb = pair(rand(rng, cols))
    want = jln.layer_norm_2d(jx, jg, jb, 1e-5)
    got = tln.layer_norm_2d(tx, tg, tb, 1e-5)      # the plain version
    assert_ulp(got[0], want[0], "layer_norm_2d y")
    for name, g, w in zip(("mean", "var"), got[1:], want[1:]):
        assert dtype_name(g) == str(w.dtype) == "float32", name
        np.testing.assert_allclose(as_np(g), as_np(w), rtol=0,
                                   atol=1e-6 * np.abs(as_np(w)).max(),
                                   err_msg=name)


def test_dropout_bf16_plain_version_against_the_jnp_form():
    """The dropout kernel's plain version on bf16 x: bitwise the
    reference's ``jnp.where(keep, x / q, 0)`` under the same keep bytes
    (the port's Philox stream), q = round(0.9 256) / 256 exact in bf16."""
    from paddle_tpu_torch.kernels import dropout as tdk
    from paddle_tpu_torch.kernels import philox
    from paddle_tpu_torch.ops.common import (byte_threshold,
                                             realized_keep_prob)

    rng = np.random.RandomState(16)
    jx, tx = pair(rand(rng, 2, 3, 16, 16), "bfloat16")
    thr, q = byte_threshold(0.9), realized_keep_prob(0.9)
    seed = (0x5EED, 0xC0DE)
    out, mask = tdk.dropout(tx, seed, thr, q, True)
    keep = philox.keep_bytes(seed, thr, tuple(tx.shape)).numpy()
    want = jnp.where(jnp.asarray(keep), jx / q, 0)
    assert_bitwise(out, want, "dropout bf16")
    np.testing.assert_array_equal(mask.numpy(), keep.astype(np.uint8))
    assert float(jnp.asarray(q, BF16)) == q      # q exact in bf16


def test_kernel_dtype_gates():
    """A CUDA tensor reaches a kernel only in a dtype it has an
    instantiation for: bf16 where one exists (the dropout kernel, row 14's
    x), f32 only elsewhere; anything else raises."""
    from paddle_tpu_torch.kernels._checks import check_cuda, check_cuda_f32

    cuda = torch.device("cuda")

    class Fake:     # a dense tensor on the card, without a card
        device = cuda

        def __init__(self, dtype):
            self.dtype = dtype

        def is_contiguous(self):
            return True

    both = (torch.float32, torch.bfloat16)
    check_cuda("dropout", cuda, both, x=Fake(torch.bfloat16))
    check_cuda_f32("fused_ln", cuda, x=Fake(torch.float32))
    with pytest.raises(ValueError, match="wants float32 or bfloat16"):
        check_cuda("dropout", cuda, both, x=Fake(torch.float16))
    with pytest.raises(ValueError, match="wants float32"):
        check_cuda_f32("fused_ln", cuda, x=Fake(torch.bfloat16))
