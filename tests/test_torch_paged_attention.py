"""Paged decode attention in the PyTorch port
(paddle_tpu_torch/kernels/paged_attention.py) held against the JAX
reference (paddle_tpu/pallas_kernels/paged_attention.py) on the CPU.

The plain versions must agree with the reference's to 1e-6 (f32, same
arithmetic, different libraries' summation order); the port's dispatching
``paged_attention`` (plain path on CPU tensors) must agree with the
reference's Pallas kernel run in interpret mode to 1e-5 (online vs
one-shot softmax, as the reference's own interpret test allows).  The
CUDA kernel's split-context algorithm (per-chunk softmax state, empty
chunks, the merge in split order) is emulated in torch and held to the
same references, and its host geometry to the table width and the SM
count alone.  The CUDA branch is held to its contract without a card: it
builds or raises, and never falls back to the plain version."""

import ctypes
import math
import re

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
    # the split grid, the merge by the last CTA in split order, float4 loads
    assert "const dim3 grid(H, B, splits)" in src
    assert "atomicAdd(&count[bh], 1) == n_live - 1" in src
    assert "count[bh] = 0" in src and "float4" in src


# -- the split-context kernel, emulated ---------------------------------------

def split_context_attention(q, k, v, lens, chunk, with_empty=False):
    """The kernel's algorithm over contiguous K/V [B, S, H, D]: each lane's
    context cut into chunks of ``chunk`` positions, one softmax state
    (m, l, acc) a chunk, the states merged in chunk order; a lane whose
    context fits one chunk is normalised from its state directly, an idle
    lane (lens <= 0) is zeros.  ``with_empty`` also merges the chunks at or
    past the lane's length, as (m, l, acc) = (-1e30, 0, 0)."""
    bb, s_len, h, d = k.shape
    scale = 1.0 / math.sqrt(d)
    out = torch.zeros_like(q)
    for b in range(bb):
        n = min(int(lens[b]), s_len)
        if n <= 0:
            continue
        n_live = -(-n // chunk)
        states = []
        for j in range(-(-s_len // chunk) if with_empty else n_live):
            lo, hi = j * chunk, min(n, (j + 1) * chunk)
            if lo >= hi:
                states.append((torch.full((h,), tpa._MASK),
                               torch.zeros(h), torch.zeros(h, d)))
                continue
            sc = torch.einsum("hd,shd->hs", q[b], k[b, lo:hi]) * scale
            m = sc.max(dim=1).values
            p = torch.exp(sc - m[:, None])
            states.append((m, p.sum(dim=1),
                           torch.einsum("hs,shd->hd", p, v[b, lo:hi])))
        if n_live == 1 and not with_empty:
            m, l, acc = states[0]
            out[b] = acc / l[:, None]
            continue
        mg = torch.stack([st[0] for st in states]).max(dim=0).values
        lg = torch.zeros(h)
        acc = torch.zeros(h, d)
        for m, l, a in states:             # in split order
            w = torch.exp(m - mg)
            lg = lg + l * w
            acc = acc + a * w[:, None]
        out[b] = acc / lg[:, None]
    return out


def _boundary_fixture(seed, chunk=tpa.CHUNK, bs=16, maxb=10, h=2, d=128):
    """lens 0, 1, chunk - 1, chunk, chunk + 1 and MAXB x bs over a
    shuffled pool; D = 128 and bs % 8 == 0, as the Pallas kernel takes."""
    lens = (0, 1, chunk - 1, chunk, chunk + 1, maxb * bs)
    nb = 1 + len(lens) * maxb
    return _ragged(np.random.RandomState(seed), bb=len(lens), h=h, d=d,
                   bs=bs, maxb=maxb, nb=nb, lens=lens)


def _gathered(q, k, v, tables, lens):
    bb, maxb = tables.shape
    bs, h, d = k.shape[1:]
    idx = torch.from_numpy(tables).long().clamp(min=0)
    kt, vt = _t(k, v)
    return (torch.from_numpy(q), kt[idx].reshape(bb, maxb * bs, h, d),
            vt[idx].reshape(bb, maxb * bs, h, d), torch.from_numpy(lens))


@pytest.mark.parametrize("seed", [0, 1])
def test_split_context_algorithm_matches_masked_attention(seed):
    args = _boundary_fixture(seed)
    q, k, v, lens = _gathered(*args)
    live = lens > 0
    chunk, splits = tpa.context_splits(k.shape[1], 132)
    assert (chunk, splits) == (tpa.CHUNK, 2)
    got = split_context_attention(q, k, v, lens, chunk)
    want = tpa.masked_attention(q, k, v, lens)
    np.testing.assert_allclose(got[live].numpy(), want[live].numpy(),
                               rtol=0, atol=ATOL_PLAIN)
    assert float(got[~live].abs().max()) == 0.0     # idle lane: zeros


def test_empty_chunks_weigh_nothing():
    """Merging the chunks past a lane's length as (-1e30, 0, 0) gives the
    same bits as leaving them out, which is why the kernel's CTAs of such
    chunks exit without writing a partial."""
    q, k, v, lens = _gathered(*_boundary_fixture(2))
    chunk = 32                       # five chunks, up to four empty
    a = split_context_attention(q, k, v, lens, chunk)
    b = split_context_attention(q, k, v, lens, chunk, with_empty=True)
    multi = lens > chunk             # lanes merged in both
    assert torch.equal(a[multi], b[multi])


def test_split_context_algorithm_matches_pallas_kernel_in_interpret_mode(
        monkeypatch):
    monkeypatch.setenv("PADDLE_PALLAS_INTERPRET", "1")
    args = _boundary_fixture(3)
    adoption.reset()
    try:
        fluid.set_flags({"FLAGS_use_pallas_paged_attention": True})
        want = np.asarray(jpa.paged_attention(*args))
        assert "paged_attention" in adoption.active_kernels()
    finally:
        fluid.set_flags({"FLAGS_use_pallas_paged_attention": False})
        adoption.reset()
    q, k, v, lens = _gathered(*args)
    live = (lens > 0).numpy()
    got = split_context_attention(q, k, v, lens, tpa.CHUNK).numpy()
    np.testing.assert_allclose(got[live], want[live], rtol=0,
                               atol=ATOL_KERNEL)


@pytest.mark.parametrize("width", [1, 35, 127, 128, 129, 1024, 8192 * 16,
                                   8192 * 1024])
@pytest.mark.parametrize("sms", [1, 114, 132])
def test_context_splits_cover_the_table_in_fixed_chunks(width, sms):
    chunk, splits = tpa.context_splits(width, sms)
    assert chunk % tpa.CHUNK == 0 and 1 <= splits <= max(1, sms)
    assert (splits - 1) * chunk < width <= splits * chunk
    if -(-width // tpa.CHUNK) <= sms:
        assert chunk == tpa.CHUNK          # the fixed chunk, S from width
    if width <= tpa.CHUNK:
        assert splits == 1                 # written out directly


class _Stream:
    cuda_stream = 0


def _launch_args(monkeypatch, bb, h, d, nb, bs, maxb, sms=132):
    """The arguments the wrapper hands the C entry for tensors of these
    shapes on the meta device (no values: the host reads no length)."""
    calls = []

    def fake(*a):
        calls.append(a)
        return 0

    monkeypatch.setattr(tpa, "_kernel", lambda: fake)
    monkeypatch.setattr(tpa, "_check", lambda *a: None)
    monkeypatch.setattr(tpa, "_sm_count", lambda device: sms)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    m = lambda *s, dt=torch.float32: torch.empty(  # noqa: E731
        *s, dtype=dt, device="meta")
    tpa._paged_cuda(m(bb, h, d), m(nb, bs, h, d), m(nb, bs, h, d),
                    m(bb, maxb, dt=torch.int32), m(bb, dt=torch.int32))
    return calls[0]


def test_host_split_count_depends_on_table_width_and_sms_only(monkeypatch):
    n0 = tpa.paged_attention.launches
    got = {}
    for bb, h, d, nb, bs, maxb in ((8, 12, 64, 520, 16, 64),
                                   (1, 1, 128, 9, 16, 64),
                                   (3, 2, 30, 100, 64, 16),
                                   (8, 12, 64, 520, 8, 128)):
        a = _launch_args(monkeypatch, bb, h, d, nb, bs, maxb)
        chunk, splits = a[14], a[15]
        assert (chunk, splits) == tpa.context_splits(maxb * bs, 132)
        got[maxb * bs] = (chunk, splits)
        # scratch and counters exactly when the lane's context is split
        assert (a[6] is not None) == (a[7] is not None) == (splits > 1)
    assert got == {1024: (tpa.CHUNK, 8)}
    a = _launch_args(monkeypatch, 8, 12, 64, 520, 16, 64, sms=4)
    assert (a[14], a[15]) == (2 * tpa.CHUNK, 4)
    a = _launch_args(monkeypatch, 8, 12, 64, 520, 16, 8)
    assert (a[14], a[15]) == (tpa.CHUNK, 1) and a[6] is None
    assert tpa.paged_attention.launches == n0 + 6


def test_wrapper_types_every_argument_of_the_c_entry(monkeypatch):
    """The ctypes types of ``paged_attention_f32`` are the C entry's
    parameters, one for one: eight pointers, eight ints, the float scale,
    the stream."""
    src = (_build.CSRC / "paged_attention.cu").read_text()
    decl = re.search(r'extern "C" cudaError_t paged_attention_f32\((.*?)\)',
                     src, re.S).group(1)
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    want = [ctypes.c_void_p if "*" in p or "cudaStream_t" in p
            else kinds[p.split()[-2]] for p in decl.split(",")]

    class _Lib:
        paged_attention_f32 = ctypes.CFUNCTYPE(ctypes.c_int)(lambda: 0)

    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "load", lambda name: _Lib())
    assert len(want) == 18
    assert list(tpa._kernel().argtypes) == want
