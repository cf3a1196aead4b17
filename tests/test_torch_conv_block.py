"""The conv-block kernels' module of the PyTorch port
(paddle_tpu_torch/kernels/conv_block.py: the routing predicate, the plain
versions of rows 11, 12 and 13 and of the batch-statistics fold between
rows 12 and 13) and the ``conv2d_bn_relu`` op's kernel route, held
against the JAX package's Pallas kernels run in interpret mode on the
CPU, as tests/test_pallas_blocks.py runs them
(``PADDLE_PALLAS_INTERPRET=1``, the flag on, ``adoption.reset()``).

On the CPU each wrapper runs its plain version (F.conv2d and f32
elementwise ops); the CUDA kernels are held against the same plain
versions on the card by chip_smoke.py.  Tolerances, f32: conv outputs to
1e-5 (the reference's kernel sums kh kw shifted matmuls, the plain
version one conv: another order), the channel sums to 1e-5 of their
largest value, the affine pass exactly up to one rounding (1e-6), the
fold's batch mean and variance to 1e-5 of their largest value (they sum
the channel sums of two convs that round differently), the op's outputs
as ``test_conv2d_bn_relu_kernel_route`` holds them (rtol 1e-5, atol
1e-5).  The affine kernel's index arithmetic (a multiply-high division,
then a walk by compares across plane edges) is emulated in Python and
held exactly to integer division; so are the C entries' ctypes types.
"""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.lowering import LowerCtx as JCtx
from paddle_tpu.pallas_kernels import adoption
from paddle_tpu.pallas_kernels import conv_block as jcb
import paddle_tpu_torch.framework as tfw
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.core import Executor, Scope, scope_guard
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.lowering import LowerCtx as TCtx
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import conv_block as tcb

ATOL = 1e-5
ATOL_GRAD = 2e-5
SUM_RTOL = 1e-5
FLAG = "FLAGS_use_pallas_conv_block"


@pytest.fixture
def kernel_route(monkeypatch):
    """Both packages' conv-block flag on, the reference's kernels in
    interpret mode; flags and adoption state restored after."""
    monkeypatch.setenv("PADDLE_PALLAS_INTERPRET", "1")
    saved_j = fluid.get_flags([FLAG])
    saved_t = tflags.get_flags([FLAG])
    adoption.reset()
    fluid.set_flags({FLAG: True})
    tflags.set_flags({FLAG: True})
    yield
    fluid.set_flags(saved_j)
    tflags.set_flags(saved_t)
    adoption.reset()


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_sum(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=SUM_RTOL * max(np.abs(want).max(), 1.0))


# -- routing predicate 

CHECK_CASES = [
    ((2, 8, 8, 8), (8, 8, 3, 3), [1, 1], [1, 1], {}),
    ((2, 3, 32, 32), (64, 3, 7, 7), [2, 2], [3, 3], {}),
    ((2, 8, 8, 8), (8, 4, 3, 3), [1, 1], [1, 1], {"groups": 2}),
    ((2, 8, 8, 8), (8, 8, 3, 3), [1, 1], [1, 1], {"dilations": (2, 2)}),
    ((2, 8, 8, 8), (8, 8, 3, 3), [1, 1], [1, 1], {"data_format": "NHWC"}),
    ((2, 8, 8, 8), (8, 8, 3, 3), [3, 3], [1, 1], {}),
    ((2, 8, 8, 8), (8, 8, 3, 3), [1, 2], [1, 1], {}),
    ((2, 8, 8, 8), (8, 8, 3, 3), [1, 1], [1, 0], {}),
    ((2, 8, 8, 8), (8, 8, 2, 2), [1, 1], [0, 0], {}),
    ((2, 6, 8, 8), (8, 6, 3, 3), [1, 1], [1, 1], {}),
    ((2, 8, 8, 8), (12, 8, 3, 3), [1, 1], [1, 1], {}),
    ((2, 8, 2, 2), (8, 8, 5, 5), [1, 1], [0, 0], {}),
    ((2, 4, 5, 5), (16, 4, 5, 5), [2, 2], [2, 2], {}),
]


@pytest.mark.parametrize("xs,ws,strides,pads,kw", CHECK_CASES)
def test_conv_block_checks_match_the_reference(monkeypatch, xs, ws, strides,
                                               pads, kw):
    """The port's predicate is the reference's without its TPU-only checks
    (``no_pallas``, ``backend``, ``vmem``): the same reasons in the same
    order, each with the reference's verdict."""
    monkeypatch.setenv("PADDLE_PALLAS_INTERPRET", "1")
    want = [(r, ok) for r, ok in jcb.conv_block_checks(xs, ws, strides, pads,
                                                       **kw)
            if r not in ("no_pallas", "backend", "vmem")]
    assert tcb.conv_block_checks(xs, ws, strides, pads, **kw) == want
    assert tcb.conv_block_ok(xs, ws, strides, pads, **kw) \
        == all(ok for _, ok in want)


# -- the plain versions against the reference's kernels 

KERNEL_CASES = [
    # (N, C, H, C_out, k, stride, pad)
    (2, 3, 16, 8, 7, 2, 3),
    (2, 8, 9, 16, 3, 1, 1),
    (2, 16, 8, 8, 1, 2, 0),
    (1, 4, 7, 8, 5, 1, 2),
]


def _case(seed, n, c, h, co, k):
    rng = np.random.RandomState(seed)
    return (rng, _rand(rng, n, c, h, h), _rand(rng, co, c, k, k, scale=0.2),
            rng.uniform(0.5, 1.5, co).astype(np.float32),
            _rand(rng, co, scale=0.1))


@pytest.mark.parametrize("n,c,h,co,k,stride,pad", KERNEL_CASES)
@pytest.mark.parametrize("relu", [True, False])
def test_row11_conv_bn_act(monkeypatch, n, c, h, co, k, stride, pad, relu):
    monkeypatch.setenv("PADDLE_PALLAS_INTERPRET", "1")
    _rng, x, w, a, b = _case(0, n, c, h, co, k)
    want = np.asarray(jcb._infer_pallas(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(a), jnp.asarray(b),
                                        stride, pad, relu))
    got = tcb.conv_bn_act(_t(x), _t(w), _t(a), _t(b), stride, pad, relu)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n,c,h,co,k,stride,pad", KERNEL_CASES)
def test_row12_conv_stats_and_row13_affine(monkeypatch, n, c, h, co, k,
                                           stride, pad):
    monkeypatch.setenv("PADDLE_PALLAS_INTERPRET", "1")
    _rng, x, w, a, b = _case(1, n, c, h, co, k)
    jconv, js, jss = jcb._train_pallas(jnp.asarray(x), jnp.asarray(w),
                                       stride, pad)
    conv, s, ss = tcb.conv_stats(_t(x), _t(w), stride, pad)
    np.testing.assert_allclose(conv.numpy(), np.asarray(jconv), rtol=0,
                               atol=ATOL)
    assert s.shape == ss.shape == (n, co)
    _close_sum(s.numpy(), np.asarray(js))
    _close_sum(ss.numpy(), np.asarray(jss))
    for relu in (True, False):
        want = jcb._affine_pallas(jconv, jnp.asarray(a), jnp.asarray(b),
                                  relu, jnp.float32)
        got = tcb.affine_act(_t(jconv), _t(a), _t(b), relu)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


def test_fold_affine_matches_the_reference():
    rng = np.random.RandomState(2)
    scale, bias, mean = (_rand(rng, 16) for _ in range(3))
    var = rng.uniform(0.1, 2.0, 16).astype(np.float32)
    ja, jb = jcb._fold_affine(*(jnp.asarray(v) for v in (scale, bias, mean,
                                                         var)), 1e-5)
    ta, tb = tcb.fold_affine(_t(scale), _t(bias), _t(mean), _t(var), 1e-5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-7)


def test_meta_tensors_take_the_plain_versions():
    """Shape inference runs the op on meta tensors: each wrapper returns
    meta outputs of the kernel's shapes."""
    x = torch.empty((2, 8, 9, 9), device="meta")
    w = torch.empty((16, 8, 3, 3), device="meta")
    a = b = torch.empty(16, device="meta")
    assert tcb.conv_bn_act(x, w, a, b, 2, 1).shape == (2, 16, 5, 5)
    conv, s, ss = tcb.conv_stats(x, w, 2, 1)
    assert conv.shape == (2, 16, 5, 5) and s.shape == ss.shape == (2, 16)
    assert tcb.affine_act(conv, a, b).device.type == "meta"
    fold = tcb.bn_fold(s, ss, a, b, a, b, 50, 0.9, 1e-5)
    assert len(fold) == 6 and all(t.shape == (16,) and t.device.type
                                  == "meta" for t in fold)


# -- the batch-statistics fold between rows 12 and 13 

@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("hw", [7, 8])   # planes of 49 and of 64 pixels
def test_bn_fold_reference_matches_the_reference(kernel_route, n, hw):
    """From row 12's sums, the plain fold gives the reference's batch mean
    and variance (``_train_fwd_impl``; at momentum 0 the running outputs
    are the batch statistics themselves) and, with row 13 after it, the
    reference op's five outputs at momentum 0.9."""
    rng = np.random.RandomState(8 + n + hw)
    x, w = _rand(rng, n, 8, hw, hw), _rand(rng, 16, 8, 3, 3, scale=0.2)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    bias, mean = _rand(rng, 16, scale=0.1), _rand(rng, 16, scale=0.2)
    var = rng.uniform(0.5, 2.0, 16).astype(np.float32)
    _y, jm, jv = jcb._train_fwd_impl(*(jnp.asarray(a) for a in
                                       (x, w, scale, bias)), 1e-5, 1, 1,
                                     True)
    conv, s, ss = tcb.conv_stats(_t(x), _t(w), 1, 1)
    cnt = n * hw * hw
    _a, _b, mo, vo, sm, sv = tcb.bn_fold_reference(
        s, ss, _t(scale), _t(bias), _t(mean), _t(var), cnt, 0.0, 1e-5)
    for got in (mo, sm):
        _close_sum(got.numpy(), np.asarray(jm))
    _close_sum(vo.numpy(), np.asarray(jv))
    np.testing.assert_allclose(sv.numpy(), 1 / np.sqrt(np.asarray(jv)
                                                        + 1e-5), rtol=1e-5)
    attrs = {"strides": [1, 1], "paddings": [1, 1], "is_test": False,
             "with_relu": True, "momentum": 0.9, "epsilon": 1e-5}
    want = _jax_op([x, w, scale, bias, mean, var], attrs)
    a, b, mo, vo, sm, sv = tcb.bn_fold_reference(
        s, ss, _t(scale), _t(bias), _t(mean), _t(var), cnt, 0.9, 1e-5)
    got = [tcb.affine_act_reference(conv, a, b, True), mo, vo, sm, sv]
    for name, g, wv in zip(("Output", "MeanOut", "VarianceOut", "SavedMean",
                            "SavedVariance"), got, want):
        np.testing.assert_allclose(g.numpy(), wv, rtol=1e-5, atol=ATOL,
                                   err_msg=name)


def test_bn_fold_adds_the_images_in_order():
    """The plain fold's sums are the images added one after the other (the
    kernel's order), not ``sum(dim=0)``'s, and divided by the count as a
    product with its f32 reciprocal (the kernel's arithmetic): bitwise."""
    rng = np.random.RandomState(12)
    s = _t(_rand(rng, 5, 24, scale=100.0))
    ss = _t(np.abs(_rand(rng, 5, 24, scale=1e4)))
    one, zero = torch.ones(24), torch.zeros(24)
    _a, _b, mo, vo, m, _inv = tcb.bn_fold_reference(s, ss, one, zero, zero,
                                                    one, 49 * 5, 0.0, 1e-5)
    acc, acc2 = s[0].clone(), ss[0].clone()
    for i in range(1, 5):
        acc, acc2 = acc + s[i], acc2 + ss[i]
    rcnt = np.float32(1.0) / np.float32(49 * 5)
    assert torch.equal(m, acc * float(rcnt)) and torch.equal(mo, m)
    assert torch.equal(vo, acc2 * float(rcnt) - m * m)


# -- row 13's index arithmetic, emulated 

def _fast_div(d):
    """csrc/conv_block.cu ``fast_div``: (mul, shr) with l = ceil(log2 d)
    and mul = ceil(2^(31 + l) / d)."""
    if d == 1:
        return 0, 0
    lg = 0
    while (1 << lg) < d:
        lg += 1
    return -(-(1 << (31 + lg)) // d), lg - 1


def _div(q, d, magic):
    mul, shr = magic
    return q if d == 1 else ((q * mul) >> 32) >> shr


# ResNet-50's planes (112^2 .. 7^2) and channel counts, small planes that
# a float4 crosses more than once, and divisors near 2^31
DIVISORS = [12544, 3136, 784, 196, 49, 64, 128, 256, 512, 1024, 2048, 1, 2,
            3, 5, 7, 24, 777, 65535, 65537, (1 << 30) + 1, (1 << 31) - 1]


@pytest.mark.parametrize("d", DIVISORS)
def test_fast_division_is_exact_below_2_31(d):
    magic = _fast_div(d)
    assert 0 <= magic[0] < 1 << 32
    rng = np.random.RandomState(d % 1000)
    qs = np.concatenate([np.arange(0, 4096), rng.randint(0, 1 << 31, 20000),
                         (1 << 31) - 1 - np.arange(4096),
                         np.arange(1, 4097) * d - 1, np.arange(4096) * d])
    qs = qs[(qs >= 0) & (qs < 1 << 31)].astype(object)
    assert all(_div(int(q), d, magic) == int(q) // d for q in qs)


@pytest.mark.parametrize("n,co,plane", [(32, 512, 49), (2, 8, 196),
                                        (2, 8, 1), (2, 8, 3), (3, 5, 7),
                                        (1, 3, 5)])
def test_affine_pass_finds_every_elements_channel(n, co, plane):
    """The kernel's walk: a float4 at flat index 4 q takes the channel of
    its first element by two divisions; where plane % 4 != 0 each later
    element steps its position and, at the plane's end, the channel (back
    to 0 after the last).  Every element gets (i // plane) % co."""
    total = n * co * plane
    pm, cm = _fast_div(plane), _fast_div(co)
    got = np.empty(total, np.int64)
    for q in range(total // 4):
        i0 = 4 * q
        pl = _div(i0, plane, pm)
        off, c = i0 - pl * plane, pl - _div(pl, co, cm) * co
        for k in range(4):
            if plane % 4 and k > 0:
                off += 1
                if off == plane:
                    off, c = 0, (0 if c + 1 == co else c + 1)
            got[i0 + k] = c
    for i in range(total // 4 * 4, total):     # the ragged tail
        pl = _div(i, plane, pm)
        got[i] = pl - _div(pl, co, cm) * co
    assert np.array_equal(got, (np.arange(total) // plane) % co)


@pytest.mark.parametrize("getter,symbol", [("_affine_kernel",
                                            "affine_act_f32"),
                                           ("_fold_kernel", "bn_fold_f32")])
def test_wrappers_type_every_argument_of_the_c_entry(monkeypatch, getter,
                                                     symbol):
    """The ctypes types of the row 13 and fold entries are the C
    parameters, one for one."""
    src = (_build.CSRC / "conv_block.cu").read_text()
    decl = re.search(r'extern "C" cudaError_t %s\((.*?)\)' % symbol, src,
                     re.S).group(1)
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float,
             "long long": ctypes.c_longlong}
    want = [ctypes.c_void_p if "*" in p or "cudaStream_t" in p
            else kinds[" ".join(p.split()[:-1])] for p in decl.split(",")]

    class _Lib:
        pass

    setattr(_Lib, symbol, ctypes.CFUNCTYPE(ctypes.c_int)(lambda: 0))
    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "load", lambda name: _Lib())
    assert list(getattr(tcb, getter)().argtypes) == want


# -- the conv2d_bn_relu op on the kernel route 

def _cbr_args(seed, n=2, c=8, h=9, co=16, k=3):
    rng = np.random.RandomState(seed)
    return rng, [_rand(rng, n, c, h, h), _rand(rng, co, c, k, k, scale=0.2),
                 rng.uniform(0.5, 1.5, co).astype(np.float32),
                 _rand(rng, co, scale=0.1), _rand(rng, co, scale=0.2),
                 rng.uniform(0.5, 2.0, co).astype(np.float32)]


def _jax_op(args, attrs):
    out = jreg.get_op_def("conv2d_bn_relu").lower(
        JCtx(rng_key=jax.random.key(0), mode="eager"),
        *[jnp.asarray(a) for a in args], **attrs)
    return [np.asarray(o) for o in out]


def _port_op(args, attrs):
    out = treg.get_op_def("conv2d_bn_relu").lower(
        TCtx(torch.device("cpu")), *[_t(a) for a in args], **attrs)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("is_test", [True, False])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_bn_relu_kernel_route(kernel_route, monkeypatch, is_test,
                                     stride):
    """Flag on, an eligible shape: the port takes its kernel wrappers (row
    11 at is_test; in training row 12, the fold and row 13) and gives the
    reference's kernel route, all five outputs."""
    called = []
    for name in ("conv_bn_act", "conv_stats", "bn_fold", "affine_act"):
        fn = getattr(tcb, name)
        monkeypatch.setattr(
            "paddle_tpu_torch.ops.nn." + name,
            lambda *a, _fn=fn, _n=name, **k: (called.append(_n),
                                              _fn(*a, **k))[1])
    _rng, args = _cbr_args(3)
    attrs = {"strides": [stride, stride], "paddings": [1, 1],
             "is_test": is_test, "with_relu": True, "momentum": 0.9,
             "epsilon": 1e-5}
    want = _jax_op(args, attrs)
    got = _port_op(args, attrs)
    assert called == (["conv_bn_act"] if is_test
                      else ["conv_stats", "bn_fold", "affine_act"])
    assert "conv_block" in adoption.active_kernels()
    for name, g, w in zip(("Output", "MeanOut", "VarianceOut", "SavedMean",
                           "SavedVariance"), got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=ATOL, err_msg=name)


def test_conv2d_bn_relu_ineligible_shapes_take_the_composition(
        kernel_route, monkeypatch):
    """Flag on but groups = 2 (or C_out % 8 != 0): no wrapper is called."""
    for name in ("conv_bn_act", "conv_stats", "bn_fold", "affine_act"):
        monkeypatch.setattr("paddle_tpu_torch.ops.nn." + name,
                            lambda *a, **k: pytest.fail("kernel route"))
    rng = np.random.RandomState(4)
    args = [_rand(rng, 2, 8, 9, 9), _rand(rng, 16, 4, 3, 3, scale=0.2),
            np.ones(16, np.float32), np.zeros(16, np.float32),
            np.zeros(16, np.float32), np.ones(16, np.float32)]
    attrs = {"paddings": [1, 1], "groups": 2}
    for g, w in zip(_port_op(args, attrs), _jax_op(args, attrs)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=ATOL)
    _rng, args = _cbr_args(5, co=12)
    for g, w in zip(_port_op(args, {"paddings": [1, 1]}),
                    _jax_op(args, {"paddings": [1, 1]})):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=ATOL)


@pytest.mark.parametrize("is_test", [True, False])
def test_conv2d_bn_relu_grad_kernel_route(kernel_route, is_test):
    """The grad op on the kernel route: the composition replayed under
    autograd gives jax.vjp through the reference's custom VJP."""
    rng, args = _cbr_args(6)
    attrs = {"strides": [1, 1], "paddings": [1, 1], "is_test": is_test,
             "with_relu": True, "momentum": 0.9, "epsilon": 1e-5}
    outs = _port_op(args, attrs)
    cot = _rand(rng, *outs[0].shape)
    fn = jreg.get_op_def("conv2d_bn_relu").lower

    def f(x, w, s, b):
        return fn(JCtx(rng_key=jax.random.key(0), mode="eager"), x, w, s, b,
                  jnp.asarray(args[4]), jnp.asarray(args[5]), **attrs)[0]

    _, vjp = jax.vjp(f, *[jnp.asarray(a) for a in args[:4]])
    want = [np.asarray(g) for g in vjp(jnp.asarray(cot))]
    pairs = []
    for i, o in enumerate(outs):
        pairs += [_t(o), _t(cot) if i == 0 else None]
    got = treg.get_op_def("conv2d_bn_relu_grad").lower(
        TCtx(torch.device("cpu")), *[_t(a) for a in args], *pairs, **attrs)
    assert got[4] is None and got[5] is None
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0,
                               atol=ATOL_GRAD)
    for g, w in zip(got[1:4], want[1:4]):
        _close_sum(g.numpy(), w)


def test_layer_through_the_executor_flag_off_then_on():
    """layers.conv2d_bn_relu through the port's Executor, one program and
    scope: the flag's two routes give the same output (the reference's
    test_program_level_layer)."""
    rng = np.random.RandomState(7)
    xv = rng.randn(2, 8, 8, 8).astype(np.float32)
    main, startup = tfw.Program(), tfw.Program()
    startup.random_seed = 3
    with tfw.program_guard(main, startup):
        x = tlayers.data("x", shape=[8, 8, 8], dtype="float32")
        out = tlayers.conv2d_bn_relu(x, num_filters=8, filter_size=3,
                                     padding=1)
    exe = Executor(tfw.CPUPlace())
    saved = tflags.get_flags([FLAG])
    try:
        with scope_guard(Scope()):
            exe.run(startup)
            tflags.set_flags({FLAG: False})
            ref, = exe.run(main, feed={"x": xv}, fetch_list=[out])
            tflags.set_flags({FLAG: True})
            got, = exe.run(main, feed={"x": xv}, fetch_list=[out])
    finally:
        tflags.set_flags(saved)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
