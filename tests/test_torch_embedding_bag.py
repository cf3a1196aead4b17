"""The embedding bag in the PyTorch port (paddle_tpu_torch/kernels/
embedding_bag.py, ops/manip.py ``embedding_bag`` and its grad) held
against the JAX package on the CPU.

* The plain version against the reference's Pallas kernel run in
  interpret mode (``PADDLE_PALLAS_INTERPRET=1``) at B 8, K 5, D 128, full,
  ragged and all-pad: bitwise, since both add the rows in k order with
  +0.0 for a pad.
* The op's gradient (an explicit lowering: index_add over the valid ids)
  against ``jax.vjp`` through the reference's ``embedding_bag`` (its
  custom VJP, the fallback's scatter-add): within 1e-6 of the largest
  gradient element (f32, repeated ids summed in another order).
* Routing: the flag off or a failed check takes the masked gather + sum
  (equal to the kernel's plain version to f32 rounding), the flag on
  with every check takes the kernel wrapper, ``mode`` other than "sum"
  raises; ``bag_checks`` gives the reference's reasons.
* The CUDA branch builds or raises and never falls back."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.pallas_kernels import adoption
from paddle_tpu.pallas_kernels import embedding_bag as jbag
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.lowering import LowerCtx
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import embedding_bag as tbag
from paddle_tpu_torch.ops import manip as tmanip

FLAG = "FLAGS_use_pallas_embedding_bag"
B, K, D, U = 8, 5, 128, 12
GRAD_RTOL = 1e-6


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_PALLAS_INTERPRET", "1")
    saved_j, saved_t = fluid.get_flags([FLAG]), tflags.get_flags([FLAG])
    adoption.reset()
    yield
    fluid.set_flags(saved_j)
    tflags.set_flags(saved_t)
    adoption.reset()


def _case(kind, seed=0, d=D):
    """rows [U, d] and ids [B, K] (repeats inside a bag allowed): "full",
    "ragged" (each bag's tail -1-padded to a random length, one bag
    empty) or "all-pad"."""
    rng = np.random.RandomState(seed)
    rows = rng.randn(U, d).astype(np.float32)
    ids = rng.randint(0, U, (B, K)).astype(np.int64)
    if kind == "ragged":
        lengths = rng.randint(0, K + 1, B)
        lengths[0] = 0
        ids[np.arange(K)[None, :] >= lengths[:, None]] = -1
    elif kind == "all-pad":
        ids[:] = -1
    return rows, ids


@pytest.mark.parametrize("kind", ["full", "ragged", "all-pad"])
def test_plain_version_bitwise_equals_reference_kernel(kind):
    rows, ids = _case(kind)
    want = np.asarray(jbag.embedding_bag(jnp.asarray(rows),
                                         jnp.asarray(ids)))
    got = tbag.embedding_bag_reference(torch.from_numpy(rows),
                                       torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        tbag.embedding_bag(torch.from_numpy(rows),
                           torch.from_numpy(ids)).numpy(), want)


def _op(type_):
    return treg.get_op_def(type_)


@pytest.mark.parametrize("kind", ["full", "ragged", "all-pad"])
def test_grad_matches_reference_vjp(kind):
    rows, ids = _case(kind, seed=1)
    dout = np.random.RandomState(2).randn(B, D).astype(np.float32)
    _out, vjp = jax.vjp(lambda r: jbag.embedding_bag(r, jnp.asarray(ids)),
                        jnp.asarray(rows))
    want = np.asarray(vjp(jnp.asarray(dout))[0])
    ctx = LowerCtx(torch.device("cpu"))
    got, ids_grad = _op("embedding_bag_grad").lower(
        ctx, torch.from_numpy(rows), torch.from_numpy(ids), None,
        torch.from_numpy(dout), mode="sum")
    assert ids_grad is None and tuple(got.shape) == (U, D)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=GRAD_RTOL * scale)
    if kind == "all-pad":
        assert not got.numpy().any()


def _routed(monkeypatch, rows, ids, flag):
    """Run the op lowering with the flag set -> (output, kernel wrapper
    calls)."""
    calls = []

    def spy(w, i):
        calls.append(tuple(w.shape))
        return tbag.embedding_bag(w, i)

    monkeypatch.setattr(tmanip, "bag_kernel", spy)
    tflags.set_flags({FLAG: flag})
    out = _op("embedding_bag").lower(LowerCtx(torch.device("cpu")),
                                     torch.from_numpy(rows),
                                     torch.from_numpy(ids), mode="sum")
    return out.numpy(), calls


def test_routing(monkeypatch):
    rows, ids = _case("ragged", seed=3)
    want = tbag.embedding_bag_reference(torch.from_numpy(rows),
                                        torch.from_numpy(ids)).numpy()
    got, calls = _routed(monkeypatch, rows, ids, False)
    assert calls == []
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    got, calls = _routed(monkeypatch, rows, ids, True)
    assert calls == [(U, D)]
    np.testing.assert_array_equal(got, want)
    # a failed check (row width 100) takes the composition under the flag
    narrow = np.ascontiguousarray(rows[:, :100])
    got, calls = _routed(monkeypatch, narrow, ids, True)
    assert calls == []
    np.testing.assert_allclose(
        got, tbag.embedding_bag_reference(torch.from_numpy(narrow),
                                          torch.from_numpy(ids)).numpy(),
        rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="mode='sum'"):
        _op("embedding_bag").lower(LowerCtx(torch.device("cpu")),
                                   torch.from_numpy(rows),
                                   torch.from_numpy(ids), mode="mean")


@pytest.mark.parametrize("rows_shape, ids_shape, dtype, failing", [
    ((32, 128), (4, 6), "float32", None),
    ((32, 100), (4, 6), "float32", "row_width"),
    ((32, 128), (24,), "float32", "rank"),
    ((32, 128), (4, 6), "int32", "dtype"),
    ((0, 128), (4, 6), "float32", "empty"),
    ((32, 256), (4, 1), "float32", None),
])
def test_bag_checks_reasons_match_reference(rows_shape, ids_shape, dtype,
                                            failing):
    want = dict(jbag.bag_checks(rows_shape, ids_shape, jnp.dtype(dtype)))
    got = dict(tbag.bag_checks(rows_shape, ids_shape,
                               getattr(torch, dtype)))
    # the reference's TPU-only checks are the two the port drops
    assert set(want) - set(got) == {"no_pallas", "backend"}
    assert {k: bool(v) for k, v in got.items()} == \
        {k: bool(want[k]) for k in got}
    assert [k for k, ok in got.items() if not ok][:1] == \
        ([failing] if failing else [])


# -- the CUDA branch

def _meta():
    return (torch.empty(U, D, device="meta"),
            torch.empty(B, K, dtype=torch.int64, device="meta"))


def test_cuda_branch_propagates_build_failure(monkeypatch):
    def broken(name):
        raise RuntimeError("nvcc failed (1) building %s" % name)

    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "load", broken)
    before = tbag.embedding_bag.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tbag._bag_cuda(*_meta())
    assert tbag.embedding_bag.launches == before


def test_kernel_wrapper_refuses_non_cuda_tensors(monkeypatch):
    class _Lib:
        embedding_bag_f32 = staticmethod(lambda *a: 0)

    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "load", lambda name: _Lib())
    with pytest.raises(ValueError, match="not a CUDA device"):
        tbag._bag_cuda(*_meta())
    assert tuple(tbag.embedding_bag(*_meta()).shape) == (B, D)
