"""The fused momentum kernel's plan (paddle_tpu_torch/kernels/
fused_momentum.py: ``plan_launches``, ``cta_ranges``) and a CTA's split of
its elements (``vector_split`` below, csrc/fused_momentum.cu's rule),
held on the CPU to what the kernel assumes of them:

* every element of every member is covered exactly once, by the CTAs'
  scalar heads, float4 bodies and scalar tails, at any alignment of the
  members' pointers;
* a member is never split across launches, and a split falls at the
  parameter block's capacity;
* one-member groups, size-1 and empty members behave, and an empty group
  raises;
* a numpy emulation of the kernel's index mapping (a CTA's threads, each
  with its float4 vectors, its head or tail element) over 3 steps of a
  5-member group at misaligned offsets reproduces the plain version
  ``fused_momentum_reference`` bitwise, and the JAX package's
  ``fused_momentum`` lowering within 2 ulps of each member's largest
  value (the bound of tests/test_torch_momentum.py: XLA:CPU may contract
  mu * v + g into an FMA)."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import optimizer_ops as jopt
from paddle_tpu_torch.kernels import fused_momentum as tfm

# the kernel's layout (csrc/fused_momentum.cu: 128 threads, 4 float4 of
# each tensor a thread, 2048 elements a CTA, 128 members a launch) and a
# small one that gives many CTAs at test sizes
KERNEL = (128, 4, 128)
SMALL = (8, 2, 3)
SHAPES = [(37, 5), (1000,), (3, 3, 3), (129,), (2048, 17)]
STEPS = 3
ULPS = 2
EPS32 = float(np.finfo(np.float32).eps)
MU = 0.9


def vector_split(count, p, v, g, bf=0):
    """How a CTA of csrc/fused_momentum.cu splits its ``count`` elements,
    from the byte addresses of its first element of p, v, g (and of the
    bf16 copy, 0 for none) -> (head, vectors, tail): elements [0, head)
    one by one, then ``vectors`` float4 (16-byte aligned in all of p, v
    and g, 8-byte in the copy), then ``tail`` elements one by one.
    Pointers that disagree in their 16-byte phase give (count, 0, 0)."""
    ph = (p >> 2) & 3
    if p & 3 or (p ^ v) & 15 or (p ^ g) & 15 or (bf and (bf >> 1) & 3 != ph):
        return count, 0, 0
    head = min((4 - ph) & 3, count)
    vectors = (count - head) >> 2
    return head, vectors, count - head - 4 * vectors


def _per_block(threads, vecs):
    return threads * 4 * vecs


def _cta_elements(count, addrs, threads, vecs):
    """The elements (offsets into the CTA's range) in the order the
    kernel's threads take them: a CTA whose pointers agree in their
    16-byte phase runs the float4 vectors k = t + j threads of thread t,
    then the head element t (t < head) or the tail element (the next
    threads); one whose pointers disagree runs element t + j threads of
    thread t for each j."""
    head, nvec, tail = vector_split(count, *addrs)
    if (head, nvec, tail) == (count, 0, 0):  # a head-only CTA: the same
        return [t + j * threads for t in range(threads)
                for j in range(4 * vecs) if t + j * threads < count]
    out = []
    for t in range(threads):
        for j in range(vecs):
            k = t + j * threads
            if k < nvec:
                out += [head + 4 * k + lane for lane in range(4)]
    body_end = head + 4 * nvec
    for t in range(threads):
        if t < head:
            out.append(t)
        elif t < head + count - body_end:
            out.append(body_end + t - head)
    return out


def _layout(sizes, gap=3, base=4):
    """Offsets (in floats) of members packed into one buffer at odd
    distances, the first at ``base`` floats."""
    offs, o = [], base
    for s in sizes:
        offs.append(o)
        o += s + gap
    return offs, o


def _visits(sizes, offs, g_shift, layout, bf=False):
    """How often the emulated kernel touches each float of the buffer, p
    and v at ``offs``, g at ``offs`` + ``g_shift`` floats."""
    threads, vecs, capacity = layout
    per_block = _per_block(threads, vecs)
    total = (offs[-1] + sizes[-1] if sizes else 0) + 8
    seen = np.zeros(total, np.int64)
    for launch in tfm.plan_launches(sizes, per_block, capacity):
        part = sizes[launch.first:launch.first + launch.count]
        for m, first, count in zip(*tfm.cta_ranges(launch.starts, part,
                                                    per_block)):
            o = offs[launch.first + m] + int(first)
            addrs = (4 * o, 4 * o, 4 * (o + g_shift)) + ((2 * o,) if bf
                                                          else ())
            idx = _cta_elements(int(count), addrs, threads, vecs)
            np.add.at(seen, o + np.asarray(idx, np.int64), 1)
    return seen


@pytest.mark.parametrize("layout", [KERNEL, SMALL])
@pytest.mark.parametrize("g_shift", [0, 1])
@pytest.mark.parametrize("base", [4, 5, 6, 7])
def test_every_element_covered_once(layout, g_shift, base):
    sizes = [185, 1000, 27, 129, 4097, 1, 2048, 2049, 0, 3, 64]
    offs, _ = _layout(sizes, base=base)
    seen = _visits(sizes, offs, g_shift, layout, bf=True)
    want = np.zeros_like(seen)
    for o, s in zip(offs, sizes):
        want[o:o + s] = 1
    np.testing.assert_array_equal(seen, want)


@pytest.mark.parametrize("n,capacity", [(1, 128), (127, 128), (128, 128),
                                        (129, 128), (300, 128), (10, 3),
                                        (9, 3), (7, 1)])
def test_splits_fall_at_the_capacity(n, capacity):
    rng = np.random.RandomState(n)
    sizes = [int(s) for s in rng.randint(0, 5000, n)]
    launches = tfm.plan_launches(sizes, 2048, capacity)
    assert len(launches) == -(-n // capacity)
    firsts = [L.first for L in launches]
    assert firsts == list(range(0, n, capacity))
    # whole members, in order, each in exactly one launch
    assert sum(L.count for L in launches) == n
    assert all(L.count == capacity for L in launches[:-1])
    for L in launches:
        assert L.starts.dtype == np.int32 and L.starts[0] == 0
        assert len(L.starts) == L.count + 1
        blocks = np.diff(L.starts.astype(np.int64))
        part = np.asarray(sizes[L.first:L.first + L.count])
        np.testing.assert_array_equal(blocks,
                                      np.maximum(1, -(-part // 2048)))


def test_cta_ranges_map_each_cta_into_its_member():
    sizes = [5000, 1, 0, 2048, 2049]
    starts = tfm.plan_launches(sizes, 2048, 128)[0].starts
    member, first, count = tfm.cta_ranges(starts, sizes, 2048)
    assert member.tolist() == [0, 0, 0, 1, 2, 3, 4, 4]
    assert first.tolist() == [0, 2048, 4096, 0, 0, 0, 0, 2048]
    assert count.tolist() == [2048, 2048, 904, 1, 0, 2048, 2048, 1]


@pytest.mark.parametrize("sizes", [[1], [7], [2048 * 3 + 5], [0]])
def test_one_member_groups(sizes):
    (launch,) = tfm.plan_launches(sizes, 2048, 128)
    assert launch.first == 0 and launch.count == 1
    _m, _f, count = tfm.cta_ranges(launch.starts, sizes, 2048)
    assert int(count.sum()) == sizes[0]
    offs, _ = _layout(sizes, base=5)
    seen = _visits(sizes, offs, 0, SMALL)
    assert int(seen.sum()) == sizes[0] and seen.max() <= 1


def test_empty_group_raises():
    with pytest.raises(ValueError, match="empty group"):
        tfm.plan_launches([], 2048, 128)


@pytest.mark.parametrize("addrs,want", [
    ((0, 0, 0), (0, 25, 0)),           # all 16-byte aligned
    ((4, 20, 36), (3, 24, 1)),         # one phase, a head of 3
    ((8, 8, 8, 4), (2, 24, 2)),        # the bf16 copy in phase
    ((8, 8, 8, 2), (100, 0, 0)),       # the bf16 copy out of phase
    ((0, 0, 4), (100, 0, 0)),          # g out of phase
    ((12, 12, 12), (1, 24, 3)),
])
def test_vector_split(addrs, want):
    assert vector_split(100, *addrs) == want


def test_vector_split_short_ctas():
    assert vector_split(2, 4, 4, 4) == (2, 0, 0)
    assert vector_split(0, 4, 4, 4) == (0, 0, 0)
    assert vector_split(5, 0, 0, 0) == (0, 1, 1)


def test_grad_checks_name_the_first_bad_grad(monkeypatch):
    """The per-step grad checks (one C-level compare against the group's
    specs, then the per-grad checks to name a failure) refuse what the
    per-grad checks refuse: count, dtype, shape, density; the device
    check is held here to equality with the params' device."""
    def check(kernel, device, contiguous=True, **tensors):
        for name, t in tensors.items():
            if t.device != device or t.dtype != torch.float32 \
                    or not t.is_contiguous():
                raise ValueError("%s kernel: %s refused" % (kernel, name))

    monkeypatch.setattr(tfm, "check_cuda_f32", check)
    params = [torch.zeros(4), torch.zeros(2, 3), torch.zeros(1)]
    grp = types.SimpleNamespace(grad_specs=[
        (torch.device("cpu"), torch.float32, p.shape) for p in params])
    lr = torch.ones(1)
    ok = [torch.ones(4), torch.ones(2, 3), torch.ones(1)]
    tfm._check_grads(grp, params, ok, lr)
    bad = [("2 grads for 3 params", ok[:2]),
           ("grad refused", [ok[0], ok[1].double(), ok[2]]),
           (r"grad 1 is \(3, 2\)", [ok[0], torch.ones(3, 2), ok[2]]),
           ("grad refused", [ok[0], torch.ones(3, 2).t(), ok[2]])]
    for msg, grads in bad:
        with pytest.raises(ValueError, match=msg):
            tfm._check_grads(grp, params, grads, lr)
    with pytest.raises(ValueError, match="lr"):
        tfm._check_grads(grp, params, ok, torch.ones(2))


# -- the emulation against the plain version and the reference -------------

def _group(seed=0):
    rng = np.random.RandomState(seed)
    f = np.float32
    params = [rng.randn(*s).astype(f) for s in SHAPES]
    vels = [(rng.randn(*s) * 1e-2).astype(f) for s in SHAPES]
    grads = [[(rng.randn(*s) * 1e-2).astype(f) for s in SHAPES]
             for _ in range(STEPS)]
    return params, vels, grads, np.array([0.1], f)


def _emulate(params, vels, grads, lr, nesterov, layout, g_shift):
    """The kernel's steps in numpy f32, each element updated where the
    emulated index mapping visits it, members at odd float offsets of one
    buffer."""
    threads, vecs, capacity = layout
    per_block = _per_block(threads, vecs)
    sizes = [p.size for p in params]
    offs, total = _layout(sizes, base=5)
    P = np.zeros(total, np.float32)
    V = np.zeros(total, np.float32)
    for o, p, v in zip(offs, params, vels):
        P[o:o + p.size], V[o:o + v.size] = p.ravel(), v.ravel()
    mu, lr_ = np.float32(MU), np.float32(lr[0])
    for step in grads:
        G = np.zeros(total + 1, np.float32)
        for o, g in zip(offs, step):
            G[o + g_shift:o + g_shift + g.size] = g.ravel()
        seen = np.zeros(total, np.int64)
        for launch in tfm.plan_launches(sizes, per_block, capacity):
            part = sizes[launch.first:launch.first + launch.count]
            for m, first, count in zip(*tfm.cta_ranges(
                    launch.starts, part, per_block)):
                o = offs[launch.first + m] + int(first)
                i = o + np.asarray(_cta_elements(
                    int(count), (4 * o, 4 * o, 4 * (o + g_shift)), threads,
                    vecs), np.int64)
                g = G[i + g_shift]
                v = mu * V[i] + g
                P[i] = P[i] - (g + mu * v) * lr_ if nesterov \
                    else P[i] - lr_ * v
                V[i] = v
                np.add.at(seen, i, 1)
        for o, s in zip(offs, sizes):
            assert (seen[o:o + s] == 1).all()
    shape = lambda B: [B[o:o + p.size].reshape(p.shape)  # noqa: E731
                       for o, p in zip(offs, params)]
    return shape(P), shape(V)


def _close(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        tol = ULPS * EPS32 * float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= tol, (what, i)


@pytest.mark.parametrize("layout", [KERNEL, SMALL])
@pytest.mark.parametrize("g_shift", [0, 1])
@pytest.mark.parametrize("nesterov", [False, True])
def test_emulated_kernel_matches_plain_and_reference(layout, g_shift,
                                                     nesterov):
    params, vels, grads, lr = _group(7)
    got = _emulate(params, vels, grads, lr, nesterov, layout, g_shift)
    # the plain version, step by step, bitwise
    p = [torch.from_numpy(x.copy()) for x in params]
    v = [torch.from_numpy(x.copy()) for x in vels]
    for step in grads:
        p, v, _bf = tfm.fused_momentum_reference(
            p, [torch.from_numpy(g) for g in step], v, torch.from_numpy(lr),
            MU, nesterov)
    for name, gs, ws in zip(("param", "velocity"), got, (p, v)):
        for i, (a, b) in enumerate(zip(gs, ws)):
            np.testing.assert_array_equal(a, b.numpy(), err_msg=(name, i))
    # the JAX package's fused_momentum lowering
    jp, jv = params, vels
    for step in grads:
        jp, jv = jopt.fused_momentum(None, jp, step, jv, jnp.asarray(lr),
                                     mu=MU, use_nesterov=nesterov)
    for name, gs, ws in zip(("param", "velocity"), got, (jp, jv)):
        _close(gs, ws, name)
