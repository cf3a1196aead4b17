"""Paged decode attention in the PyTorch port
(paddle_tpu_torch/kernels/paged_attention.py) held against the JAX
reference (paddle_tpu/pallas_kernels/paged_attention.py) on the CPU.

The plain versions must agree with the reference's to 1e-6 (f32, same
arithmetic, different libraries' summation order); the port's dispatching
``paged_attention`` (plain path on CPU tensors) must agree with the
reference's Pallas kernel run in interpret mode to 1e-5 (online vs
one-shot softmax, as the reference's own interpret test allows).  The
CUDA branch is held to its contract without a card: it builds or raises,
and never falls back to the plain version."""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.pallas_kernels import adoption
from paddle_tpu.pallas_kernels import paged_attention as jpa
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import paged_attention as tpa

ATOL_PLAIN = 1e-6     # same f32 arithmetic, another library's sum order
ATOL_KERNEL = 1e-5    # online softmax (Pallas) vs one-shot softmax


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _paged_fixture(rng, bb=2, blocks=4, bs=8, h=1, d=128, maxb=2):
    """The reference test's fixture (tests/test_decode_serving.py)."""
    q = rng.randn(bb, h, d).astype(np.float32)
    k = rng.randn(blocks, bs, h, d).astype(np.float32)
    v = rng.randn(blocks, bs, h, d).astype(np.float32)
    tables = np.array([[1, 3], [2, -1]], np.int32)
    lens = np.array([12, 5], np.int32)
    return q, k, v, tables, lens


def _ragged(rng, bb=4, h=3, d=16, bs=4, maxb=5, nb=12,
            lens=(0, 1, 9, 20)):
    """Shuffled, non-contiguous block ids, -1 slots past each lane's
    blocks, an idle lane (lens 0) and a full lane."""
    q = rng.randn(bb, h, d).astype(np.float32)
    k = rng.randn(nb, bs, h, d).astype(np.float32)
    v = rng.randn(nb, bs, h, d).astype(np.float32)
    perm = rng.permutation(np.arange(1, nb)).astype(np.int32)
    tables = np.full((bb, maxb), -1, np.int32)
    at = 0
    for b, n in enumerate(lens):
        need = -(-n // bs)
        tables[b, :need] = perm[at:at + need]
        at += need
    return q, k, v, tables, np.asarray(lens, np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masked_attention_matches_reference(seed):
    rng = np.random.RandomState(seed)
    bb, s, h, d = 3, 11, 2, 8
    q = rng.randn(bb, h, d).astype(np.float32)
    k = rng.randn(bb, s, h, d).astype(np.float32)
    v = rng.randn(bb, s, h, d).astype(np.float32)
    lens = np.array([0, 4, 11], np.int32)
    want = np.asarray(jpa.masked_attention(q, k, v, lens))
    got = tpa.masked_attention(*_t(q, k, v, lens)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_PLAIN)
    # a lane with context_lens 0 softmaxes the finite -1e30 mask to a
    # uniform average over every position, in both packages
    np.testing.assert_allclose(got[0], v[0].mean(axis=0), rtol=0,
                               atol=ATOL_PLAIN)


@pytest.mark.parametrize("seed", [0, 1])
def test_paged_reference_matches_reference_with_clamped_slots(seed):
    q, k, v, tables, lens = _ragged(np.random.RandomState(seed))
    want = np.asarray(jpa.paged_attention_reference(q, k, v, tables, lens))
    got = tpa.paged_attention_reference(*_t(q, k, v, tables, lens)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_PLAIN)
    # -1 slots clamp to block 0: the idle lane (table all -1) averages
    # block 0's V over every gathered position
    maxb = tables.shape[1]
    idle = np.concatenate([v[0]] * maxb, axis=0).mean(axis=0)
    np.testing.assert_allclose(got[0], idle, rtol=0, atol=ATOL_PLAIN)


def test_port_dispatch_matches_pallas_kernel_in_interpret_mode(monkeypatch):
    monkeypatch.setenv("PADDLE_PALLAS_INTERPRET", "1")
    adoption.reset()
    try:
        fluid.set_flags({"FLAGS_use_pallas_paged_attention": True})
        args = _paged_fixture(np.random.RandomState(0))
        want = np.asarray(jpa.paged_attention(*args))
        assert "paged_attention" in adoption.active_kernels()
    finally:
        fluid.set_flags({"FLAGS_use_pallas_paged_attention": False})
        adoption.reset()
    n0 = tpa.paged_attention.launches
    got = tpa.paged_attention(*_t(*args)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_KERNEL)
    assert tpa.paged_attention.launches == n0    # CPU: no kernel launch


def test_cpu_tensors_take_the_plain_path_without_building(monkeypatch):
    def no_build(name):
        raise AssertionError("the CPU path must not build a kernel")

    monkeypatch.setattr(_build, "load", no_build)
    args = _t(*_ragged(np.random.RandomState(3)))
    got = tpa.paged_attention(*args)
    assert torch.equal(got, tpa.paged_attention_reference(*args))


def _meta(*arrays):
    return [torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                        device="meta") for a in arrays]


def test_non_cpu_branch_propagates_build_failure(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel: a failed build
    surfaces as the error, with no fallback to the plain version."""
    def broken(name):
        raise RuntimeError("nvcc failed building %s" % name)

    monkeypatch.setattr(_build, "load", broken)
    n0 = tpa.paged_attention.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tpa.paged_attention(*_meta(*_paged_fixture(
            np.random.RandomState(0))))
    assert tpa.paged_attention.launches == n0


def test_kernel_wrapper_refuses_non_cuda_tensors(monkeypatch):
    class _Lib:
        paged_attention_f32 = staticmethod(lambda *a: 0)

    monkeypatch.setattr(_build, "load", lambda name: _Lib())
    n0 = tpa.paged_attention.launches
    with pytest.raises(ValueError, match="not a CUDA device"):
        tpa.paged_attention(*_meta(*_paged_fixture(
            np.random.RandomState(0))))
    assert tpa.paged_attention.launches == n0


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_kernel_source_names_what_it_replaces_and_its_bound():
    src = (_build.CSRC / "paged_attention.cu").read_text()
    assert "_paged_kernel" in src and "memory-bound" in src
    assert 'extern "C" cudaError_t paged_attention_f32' in src
