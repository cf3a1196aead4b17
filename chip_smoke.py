#!/usr/bin/env python3
"""Drive the PyTorch port (``paddle_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (nonzero exit, no result line):

1. the card: name and power limit from nvidia-smi;
2. the build: every CUDA source of the port compiled with nvcc for
   sm_90a (all started together), with seconds and ptxas usage;
3. the kernels: each kernel against its plain PyTorch version on the card
   at its main-path shape and others (the fused Adam and the fused
   momentum bitwise, with and without their bf16 copy; the conv-block
   kernels at ResNet-50's shapes and odd ones, the affine pass bitwise;
   the embedding bag bitwise at DLRM's largest bag and ragged, all-pad
   and D = 256 cases; the channel statistics against float64 sums; the
   flash forward at each of its CTA shapes; the fused flash backward's
   and the small backward's dQ bitwise over two runs at two key tiles;
   the dropout kernel's mask bytes bitwise, its keep fraction within 5
   sigma; the dropout paths at p = 0.1, where one flipped keep bit
   would move an output by about prob / q), then timed
   (CUDA events, L2 flushed before every launch, as the serving and
   training loops find it) beside its plain version, a one-call PyTorch
   yardstick and its bound;
4. decode serving: a GPT-2-small-width decoder (seeded random weights) in
   the port's DecodeEngine answers a dozen requests; every reply must be
   ok, every decode step must have gone through the paged-attention
   kernel, and every request's tokens must equal the port's plain unpaged
   loop on the card up to near-ties of the logits;
5. encoder serving: BERT-base (seeded random weights, seq 128) built with
   the port's Program front end, initialised on the card, saved with
   save_inference_model and served by ServingEngine over three buckets to
   a few client threads; every reply must be ok, the batches must have
   launched the flash-attention, fused-LayerNorm and LayerNorm kernels
   12, 24 and 1 times each, and sampled replies must equal the same
   directory run by the plain predictor on the CPU;
6. BERT-base pretraining (seeded random weights, seq 128, batch 32)
   built with the port's ``build_pretrain`` and trained 5 steps on one
   batch through ``Executor.run``, in three emissions, one after the
   other: dropout 0 (flash attention and its backward), BERT's dropout
   0.1 in the default emission (the dropout op on the embeddings and the
   attention probabilities, the fused LayerNorms at p = 0.1), and
   dropout 0.1 with ``BERT_FUSED_ATTN=1`` and
   ``FLAGS_fused_small_attention`` (the small-sequence attention
   kernels).  Every step must launch each kernel as often as the
   emission's program dictates (``STEP_LAUNCHES``), the last loss must be
   below the first, and 3 steps at batch 2 from the same initial state
   must give the losses and Adam moments of the port's plain path on the
   CPU (the two devices draw the same masks: the key words come from the
   executor's per-op seed, on the host);
7. ResNet-50 serving (v1.5, 224x224, 1000 classes, seeded random
   weights): the bundled ``resnet(is_test=True)`` and the same
   architecture as ``conv2d_bn_relu`` ops under
   ``FLAGS_use_pallas_conv_block``, each saved and served by
   ServingEngine over buckets 1, 8, 32 to a few client threads through
   the predictor's passes; every reply ok, the trunk's batches launching
   the folded conv + BN + relu kernel 53 times each (the bundled one
   none), sampled replies equal to the plain predictor on the CPU;
8. ResNet-50 training, both programs, Momentum (0.9) with L2Decay(1e-4)
   at batch 32 for 5 steps on one batch: the fused momentum kernel once
   a step, the trunk's conv-with-statistics and affine + relu kernels 53
   times a step each, the last loss below the first, and 3 steps at
   batch 2, each from one state on the card and on the CPU's plain path,
   with the same losses and velocities;
9. DLRM training (the Criteo Terabyte configuration: 26 tables of
   width 128 in 2 host-resident shards each, MLPerf's multi-hot bag
   sizes, seeded random weights and ids) through the port's sparse-table
   path under ``FLAGS_use_pallas_embedding_bag``, SGD for 5 steps on one
   batch of 2048: the embedding-bag kernel 26 times a step, one
   fused_sgd group, the last loss below the first, and 3 steps at batch
   8, each from one state (dense parameters and table shards) on the
   card and on the CPU's plain path, with the same losses, pushed row
   gradients and parameters;
10. the channel statistics' microbenchmark
    (``tools/torch_bench_reduce.py``) once at a few passes, launching
    rows 16 and 17's kernels;
11. the script's own wall time, a JSON line of the kernels, then the
    result line.

Needs one CUDA card; exits nonzero without one, and outside a checkout of
the repository.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet rates (dense): device memory, f32 outside the
# tensor cores, and TF32 on them
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12

# kernel vs plain version, f32: the two sum in different orders only
KERNEL_ATOL = 2e-5
# A paged (kernel) token may differ from the unpaged (plain) one only where
# the plain loop's top-2 logit gap at that step is below this: the two
# paths' logits differ by summation order (~1e-5 at this width), so a gap
# under 1e-3 is a near-tie that either path may break either way.
LOGIT_TIE_TOL = 1e-3
# BERT-base sequence output (LayerNorm-normalised, |values| ~ 1) on the
# card's kernels vs the plain path on the CPU after 12 layers, both f32
# with TF32 off: they differ by summation order only
ENCODER_ATOL = 1e-3
# flash backward vs its plain version: each gradient sums up to S
# products of ~1 in another order (S = 2048 in the causal case)
FLASH_BWD_ATOL = 1e-4
# fused-LN backward: dx to KERNEL_ATOL; dgamma / dbeta are sums over all
# N rows (4096), held relative to their largest value
LN_BWD_SUM_RTOL = 2e-6
# the dropout kernel's keep fraction: within this many binomial standard
# deviations of the realized keep probability
KEEP_SIGMAS = 5.0
# BERT-base pretraining, 3 Adam steps at batch 2 from one initial state,
# card vs the plain path on the CPU, both f32 with TF32 off, so the two
# differ by summation order only.  Losses (~10.4 = ln 30522) are held
# absolutely; each Adam moment tensor is held relative to its largest
# element (moments follow the gradients smoothly, unlike the parameters,
# where Adam turns a rounding difference on a near-zero gradient into a
# sign flip of its ~lr step), with a floor (``moment_gap``).
# tools/torch_train_faults.py reads both gaps sound and with faults
# planted on the card (an H100; PERF.md): sound 9.5e-07 (loss) and
# 2.5e-04 (moments); the faults' smallest 1.5e-04 (loss, dK zeroed) and
# 1.0 (moments), so each limit sits 10x or more above the sound reading
# and 10x or more below the nearest fault's.
TRAIN_LOSS_ATOL = 1e-5
TRAIN_MOMENT_RTOL = 1e-2
MOMENT_FLOOR = 1e-4

KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


def fail(msg):
    print("FAIL: " + msg, file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


# -- timing ------------------------------------------------------------------

def time_cold(fn, flush, iters=50, sleep_cycles=1_000_000):
    """Mean device ms of ``fn`` with L2 flushed before each call.  The
    flush (a 256 MB write) and a device-side sleep (~0.5 ms by default)
    keep the card busy while the host enqueues ``fn``, so the events
    bracket device work, not the wrapper's host time before its first
    launch; a wrapper with more host work before its launch than the
    sleep covers needs a longer one."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(sleep_cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def bound(nbytes, flops, tf32_flops=0):
    """(bound_ms, bound_by) of work moving ``nbytes``, doing ``flops`` f32
    operations on the SIMT pipes and ``tf32_flops`` TF32 operations on the
    tensor cores (the two units run at once)."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = max(flops / F32_FLOPS, tf32_flops / TF32_FLOPS) * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def timed_row(name, kernel, plain, library, nbytes, flops, flush, worst,
              what, sleep_cycles=1_000_000, tf32_flops=0):
    """Time kernel, plain version and library call; print and return the
    kernel's row (launches filled in after the serving phase)."""
    kernel_ms = time_cold(kernel, flush, sleep_cycles=sleep_cycles)
    plain_ms = time_cold(plain, flush, sleep_cycles=sleep_cycles)
    library_ms = time_cold(library, flush, sleep_cycles=sleep_cycles) \
        if library is not None else None
    bound_ms, bound_by = bound(nbytes, flops, tf32_flops)
    print("kernel %s %s: kernel_ms %.6f plain_ms %.6f library_ms %s "
          "bound_ms %.6f (%s; %d bytes over 3.35 TB/s, %d flops over "
          "67 TF/s%s)" % (name, what, kernel_ms, plain_ms,
                          "%.6f" % library_ms if library_ms is not None
                          else "none", bound_ms, bound_by, nbytes, flops,
                          ", %d TF32 flops over 495 TF/s" % tf32_flops
                          if tf32_flops else ""),
          flush=True)
    return {"name": name, "route": "cuda", "max_abs_err": worst,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def check(name, what, got, want, atol=KERNEL_ATOL):
    """Max abs error of each output pair; fails above ``atol`` or on a
    non-finite output."""
    torch.cuda.synchronize()
    err = 0.0
    for g, w in zip(got, want):
        if not torch.isfinite(g).all():
            fail("%s output not finite at %s" % (name, what))
        err = max(err, float((g.float() - w.float()).abs().max()))
    print("kernel %s %s: max_abs_err %.3g (atol %g)" % (name, what, err,
                                                         atol), flush=True)
    if not err <= atol:
        fail("%s disagrees with its plain version at %s" % (name, what))
    return err


# -- phase 3: kernels --------------------------------------------------------

def paged_case(rng, bb, h, d, bs, maxb, lens, dev):
    """Random q/K/V, a pool with shuffled non-contiguous block ids (unused
    table slots -1), int32 tables and lens, all on ``dev``."""
    lens = np.asarray(lens, np.int32)
    need = [max(1, -(-int(n) // bs)) for n in lens]
    nb = 1 + sum(need) + 7                    # block 0 is scratch
    perm = rng.permutation(np.arange(1, nb)).astype(np.int32)
    tables = np.full((bb, maxb), -1, np.int32)
    at = 0
    for b, k in enumerate(need):
        tables[b, :k] = perm[at:at + k]
        at += k
    f = np.float32
    t = {"q": rng.randn(bb, h, d).astype(f),
         "k": rng.randn(nb, bs, h, d).astype(f),
         "v": rng.randn(nb, bs, h, d).astype(f),
         "tables": tables, "lens": lens}
    return {n: torch.from_numpy(a).to(dev) for n, a in t.items()}


def paged_kernel_phase(pa, dev, flush):
    rng = np.random.RandomState(0)
    cases = {
        "decode B=8 H=12 D=64 bs=16 MAXB=64": paged_case(
            rng, 8, 12, 64, 16, 64,
            rng.permutation([1, 15, 16, 17, 300, 511, 1023, 1024]), dev),
        "B=4 H=8 D=128 bs=16 MAXB=32": paged_case(
            rng, 4, 8, 128, 16, 32, [1, 77, 256, 512], dev),
        "odd B=4 H=3 D=40 bs=5 MAXB=7 with an idle lane": paged_case(
            rng, 4, 3, 40, 5, 7, [1, 7, 33, 0], dev),
    }
    worst = 0.0
    for name, c in cases.items():
        args = (c["q"], c["k"], c["v"], c["tables"], c["lens"])
        out = pa.paged_attention(*args)
        ref = pa.paged_attention_reference(*args)
        live = c["lens"] > 0
        worst = max(worst, check("paged_attention", name, [out[live]],
                                 [ref[live]]))
        if (~live).any() and float(out[~live].abs().max()) != 0.0:
            fail("paged_attention idle lane not zero at %s" % name)

    c = cases["decode B=8 H=12 D=64 bs=16 MAXB=64"]
    args = (c["q"], c["k"], c["v"], c["tables"], c["lens"])
    bb, h, d = c["q"].shape
    bs = c["k"].shape[1]
    lens = c["lens"].cpu().numpy().astype(np.int64)
    # yardstick: SDPA over K/V gathered beforehand into contiguous
    # [B, H, S, D] with the length mask; the gather is NOT timed
    s = int(lens.max())
    idx = c["tables"].long().clamp(min=0)
    kg = c["k"][idx].reshape(bb, -1, h, d)[:, :s].permute(0, 2, 1, 3) \
        .contiguous()
    vg = c["v"][idx].reshape(bb, -1, h, d)[:, :s].permute(0, 2, 1, 3) \
        .contiguous()
    mask = (torch.arange(s, device=dev)[None, :]
            < c["lens"][:, None].long())[:, None, None, :]
    qg = c["q"][:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    tok = int(lens.sum())
    nbytes = (2 * tok * h * d * 4            # live K and V rows
              + 2 * bb * h * d * 4           # q in, out
              + 4 * bb                       # lens
              + 4 * int(sum(-(-n // bs) for n in lens)))   # live table
    row = timed_row(
        "paged_attention", lambda: pa.paged_attention(*args),
        lambda: pa.paged_attention_reference(*args),
        lambda: sdpa(qg, kg, vg, attn_mask=mask), nbytes,
        tok * h * (4 * d + 5), flush, worst,
        "decode shape (SDPA on pre-gathered K/V)")
    row.update(source="paddle_tpu_torch/kernels/csrc/paged_attention.cu",
               replaces="paddle_tpu/pallas_kernels/paged_attention.py:105")
    return row


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def flash_kernel_phase(fa, dev, flush):
    rng = np.random.RandomState(1)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa

    def pad_bias(bb, s):
        m = (rng.rand(bb, 1, 1, s) > 0.25).astype(np.float32)
        m[:, :, :, 0] = 1.0
        return np.broadcast_to((1.0 - m) * -1e4, (bb, 1, s, s))

    def head_split(bb, h, s, d):
        # as the main path hands q, k, v over: an fc output [B, S, H*D]
        # reshaped to [B, S, H, D] and permuted to a strided [B, H, S, D]
        x = t(_rand(rng, bb, s, h * d))
        return x.view(bb, s, h, d).permute(0, 2, 1, 3)

    odd_bias = np.zeros((2, 1, 77, 77), np.float32)
    odd_bias[:, :, 5, :] = -1e30              # one fully masked row
    # (what, shape, bias, causal, q/k/v as the main path's strided views)
    cases = [
        ("BERT B=8 H=12 S=128 D=64 padding bias [B,1,S,S]",
         (8, 12, 128, 64), pad_bias(8, 128), False, False),
        ("main path B=32 H=12 S=128 D=64 strided head split, padding bias",
         (32, 12, 128, 64), pad_bias(32, 128), False, True),
        ("long causal B=1 H=12 S=2048 D=64", (1, 12, 2048, 64), None, True,
         False),
        ("odd B=2 H=3 S=77 D=40 head-shared bias, a fully masked row",
         (2, 3, 77, 40), odd_bias, False, False),
    ]
    worst = 0.0
    tensors = {}
    for what, (bb, h, s, d), bias, causal, strided in cases:
        if strided:
            q, k, v = (head_split(bb, h, s, d) for _ in range(3))
            if q.is_contiguous():
                fail("flash_attention strided case built a dense q")
        else:
            q, k, v = (t(_rand(rng, bb, h, s, d)) for _ in range(3))
        bias = t(bias) if bias is not None else None
        tensors[what] = (q, k, v, bias, causal)
        want = fa.flash_attention_reference(q, k, v, bias, causal)
        got = fa.flash_attention(q, k, v, bias, causal)
        worst = max(worst, check(
            "flash_attention", "%s, %d warps" % (
                what, fa.FWD_DEFAULT_WARPS), got, want))
        # every other CTA shape
        if what.startswith(("BERT", "odd")):
            for w in fa.FWD_WARPS:
                if w != fa.FWD_DEFAULT_WARPS:
                    got = fa.flash_attention(q, k, v, bias, causal, warps=w)
                    worst = max(worst, check("flash_attention", "%s, %d "
                                             "warps" % (what, w), got, want))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for what in (cases[0][0], cases[1][0]):
        q, k, v, bias, _c = tensors[what]
        bb, h, s, d = q.shape
        lib_err = float((sdpa(q, k, v, attn_mask=bias)
                         - fa.flash_attention_reference(q, k, v, bias)[0])
                        .abs().max())
        flops = 4 * bb * h * s * s * d
        # the bound of the 3xTF32 design: three TF32 products per f32
        # product on the tensor cores, ~5 flops a score (scale, bias, max,
        # exp, sum) on the SIMT pipes
        row = timed_row(
            "flash_attention", lambda: fa.flash_attention(q, k, v, bias),
            lambda: fa.flash_attention_reference(q, k, v, bias),
            lambda: sdpa(q, k, v, attn_mask=bias),
            4 * (4 * bb * h * s * d + bb * s * s + bb * h * s),
            5 * bb * h * s * s, flush, worst,
            "%s (SDPA with the same attn_mask, err vs plain %.3g)"
            % (what, lib_err), tf32_flops=3 * flops)
        w = fa.FWD_DEFAULT_WARPS
        print("kernel flash_attention %s: %.1f TF/s (SDPA %.1f); %d warps, "
              "%d CTAs, %d an SM; %.1f%% of the 3xTF32 bound; the products "
              "on the f32 SIMT pipes %.6f ms (%d flops over 67 TF/s)"
              % (what.split(" D=")[0], flops / row["ms"] / 1e9,
                 flops / row["library_ms"] / 1e9, w,
                 bb * h * -(-s // (16 * w)),
                 fa.flash_attention_fwd_ctas_per_sm(d, w),
                 100 * row["bound_ms"] / row["ms"], flops / F32_FLOPS * 1e3,
                 flops), flush=True)
        rows.append(row)
    # the kernels line carries B = 8 (an encoder bucket); B = 32 prints
    row = rows[0]
    row.update(source="paddle_tpu_torch/kernels/csrc/flash_attention.cu",
               replaces="paddle_tpu/pallas_kernels/flash_attention.py:49")
    return row


# key words of the kernel phases' dropout stream
WORDS = (0x5EED, 0xC0DE)


def ln_kernel_phase(fl, ln, philox, dev, flush):
    """Rows 7 and 14: fused_ln at p = 0 and p = 0.1, LayerNorm.  The
    kernels line takes fused_ln at p = 0.1 over the training step's
    [4096, 768] rows; its p = 0 times print beside it."""
    rng = np.random.RandomState(2)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    ln_f = torch.nn.functional.layer_norm
    drop_f = torch.nn.functional.dropout
    worst_f = worst_l = 0.0
    shapes = {(1024, 768): "BERT rows [1024, 768]",
              (4096, 768): "training rows [4096, 768]",
              (37, 200): "odd [37, 200]"}
    tensors = {}
    seed_t = torch.empty(2, dtype=torch.int32, device=dev)
    for (n, hd), what in shapes.items():
        x, y, g, b = (t(_rand(rng, *s)) for s in ((n, hd), (n, hd), (hd,),
                                                  (hd,)))
        tensors[n, hd] = (x, y, g, b)
        worst_f = max(worst_f, check(
            "fused_ln", what + " p=0",
            fl.fused_ln_fwd(x, y, g, b, 0.0, None, 1e-5),
            fl.fused_ln_reference(x, y, g, b, 1e-5)))
        worst_f = max(worst_f, check(
            "fused_ln", what + " p=0.1",
            fl.fused_ln_fwd(x, y, g, b, 0.1, WORDS, 1e-5, seed_out=seed_t),
            fl.fused_ln_reference(x, y, g, b, 1e-5, 0.1, WORDS)))
        if philox.seed_words(seed_t) != WORDS:
            fail("fused_ln stored seed words %s, want %s"
                 % (philox.seed_words(seed_t), WORDS))
        worst_l = max(worst_l, check(
            "layer_norm", what, ln.layer_norm_2d(x, g, b, 1e-5),
            ln.layer_norm_2d_reference(x, g, b, 1e-5)))
    rows = []
    for n_rows in (1024, 4096):         # p = 0: printed beside the row
        x, y, g, b = tensors[n_rows, 768]
        n, hd = x.shape
        timed_row(
            "fused_ln", lambda: fl.fused_ln_fwd(x, y, g, b, 0.0, None, 1e-5),
            lambda: fl.fused_ln_reference(x, y, g, b, 1e-5),
            lambda: ln_f(x + y, (hd,), g, b, 1e-5),
            4 * (4 * n * hd + 2 * hd + 2 * n), 9 * n * hd, flush, worst_f,
            "p=0 rows [%d, 768] (F.layer_norm(x + y))" % n)
    x, y, g, b = tensors[4096, 768]
    n, hd = x.shape
    row = timed_row(
        "fused_ln",
        lambda: fl.fused_ln_fwd(x, y, g, b, 0.1, WORDS, 1e-5,
                                seed_out=seed_t),
        lambda: fl.fused_ln_reference(x, y, g, b, 1e-5, 0.1, WORDS),
        lambda: ln_f(x + drop_f(y, 0.1), (hd,), g, b, 1e-5),
        4 * (4 * n * hd + 2 * hd + 2 * n) + 8, 10 * n * hd, flush, worst_f,
        "p=0.1 training rows [4096, 768] (F.layer_norm(x + F.dropout(y)))")
    row.update(source="paddle_tpu_torch/kernels/csrc/fused_ln.cu",
               replaces="paddle_tpu/pallas_kernels/fused_ln.py:106")
    rows.append(row)
    x, y, g, b = tensors[1024, 768]
    n, hd = x.shape
    row = timed_row(
        "layer_norm", lambda: ln.layer_norm_2d(x, g, b, 1e-5),
        lambda: ln.layer_norm_2d_reference(x, g, b, 1e-5),
        lambda: ln_f(x, (hd,), g, b, 1e-5),
        4 * (2 * n * hd + 2 * hd + 2 * n), 8 * n * hd, flush, worst_l,
        "BERT rows [1024, 768] (F.layer_norm)")
    row.update(source="paddle_tpu_torch/kernels/csrc/layer_norm.cu",
               replaces="paddle_tpu/pallas_kernels/layer_norm.py:29")
    rows.append(row)
    return rows


def dropout_kernel_phase(dk, philox, dev, flush):
    """The dropout op's kernel: mask bytes and outputs bitwise equal to the
    plain stream's at p = 0.1, both implementations, the keep fraction
    within KEEP_SIGMAS of the realized probability; timed at the
    attention probabilities' shape (12 of its 13 launches a step in the
    default emission)."""
    from paddle_tpu_torch.ops.common import (byte_threshold,
                                             realized_keep_prob,
                                             realized_prob)

    rng = np.random.RandomState(6)
    thr, q = byte_threshold(0.9), realized_keep_prob(0.9)
    cases = {"embeddings [32, 128, 768]": (32, 128, 768),
             "attention probs [32, 12, 128, 128]": (32, 12, 128, 128),
             "odd 1001 elements at an unaligned offset": (1001,)}
    tensors = {}
    for what, shape in cases.items():
        n = int(np.prod(shape))
        x = torch.from_numpy(_rand(rng, n + 1)).to(dev)[1:].reshape(shape) \
            if n == 1001 else torch.from_numpy(_rand(rng, *shape)).to(dev)
        tensors[what] = x
        for upscale in (True, False):
            out, mask = dk.dropout(x, WORDS, thr, q, upscale)
            wout, wmask = dk.dropout_reference(x, WORDS, thr, q, upscale)
            torch.cuda.synchronize()
            if not torch.equal(mask, wmask):
                fail("dropout mask bytes differ from the plain stream at %s"
                     % what)
            if not torch.equal(out, wout):
                fail("dropout output differs from the plain version at %s "
                     "(%s)" % (what, "upscale" if upscale else "downgrade"))
        frac, qr = float(mask.float().mean()), realized_prob(0.9)
        sigma = (qr * (1 - qr) / n) ** 0.5
        print("kernel dropout %s: mask and out bitwise equal to the plain "
              "version; keep fraction %.6f, realized q %.6f (%.2f sigma)"
              % (what, frac, qr, abs(frac - qr) / sigma), flush=True)
        if abs(frac - qr) > KEEP_SIGMAS * sigma:
            fail("dropout keep fraction %.6f is %.1f sigma from %.6f"
                 % (frac, abs(frac - qr) / sigma, qr))
    x = tensors["attention probs [32, 12, 128, 128]"]
    n = x.numel()
    row = timed_row(
        "dropout", lambda: dk.dropout(x, WORDS, thr, q, True),
        lambda: dk.dropout_reference(x, WORDS, thr, q, True),
        lambda: torch.nn.functional.dropout(x, 0.1), 9 * n, n, flush, 0.0,
        "attention probs [32, 12, 128, 128] at p = 0.1 (F.dropout)")
    row.update(source="paddle_tpu_torch/kernels/csrc/dropout.cu",
               replaces="paddle_tpu/ops/nn.py:602")
    return row


def small_attention_kernel_phase(fa, philox, dev, flush):
    """Rows 5 and 6: the small-sequence attention forward and backward at
    the BERT-base shape and over the rest of the routed domain, with
    dropout p = 0.1 (and p = 0 once)."""
    rng = np.random.RandomState(7)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa

    def head_split(bb, h, s, d):
        return t(_rand(rng, bb, s, h * d)).view(bb, s, h, d) \
            .permute(0, 2, 1, 3)

    def pad_bias(bb, s):
        m = (rng.rand(bb, 1, 1, s) > 0.25).astype(np.float32)
        m[:, :, :, 0] = 1.0
        return np.broadcast_to((1.0 - m) * -1e4, (bb, 1, s, s))

    cases = [
        ("main path B=32 H=12 S=128 D=64 strided head split, padding bias "
         "[B,1,S,S], p=0.1", (32, 12, 128, 64), pad_bias(32, 128), 0.1),
        ("B=2 H=3 S=128 D=128, head-shared bias, p=0.1", (2, 3, 128, 128),
         _rand(rng, 2, 1, 128, 128), 0.1),
        ("B=2 H=3 S=256 D=64, per-head bias, p=0.1", (2, 3, 256, 64),
         _rand(rng, 2, 3, 256, 256), 0.1),
        ("B=2 H=3 S=256 D=128, head-shared bias, p=0.1", (2, 3, 256, 128),
         _rand(rng, 2, 1, 256, 256), 0.1),
        ("B=2 H=3 S=128 D=64, head-shared bias, p=0", (2, 3, 128, 64),
         _rand(rng, 2, 1, 128, 128), 0.0),
    ]
    worst_f = worst_b = 0.0
    kept = None
    for what, (bb, h, s, d), bias, p in cases:
        q, k, v, do = (head_split(bb, h, s, d) for _ in range(4))
        bias = t(bias)
        scale = d ** -0.5
        seed_t = torch.empty(2, dtype=torch.int32, device=dev)
        out, lse = fa.small_attention_fwd(q, k, v, bias, scale, p, WORDS,
                                          seed_out=seed_t)
        worst_f = max(worst_f, check(
            "small_attention_fwd", what, [out, lse],
            fa.small_attention_fwd_reference(q, k, v, bias, scale, p,
                                             WORDS)))
        if philox.seed_words(seed_t) != WORDS:
            fail("small_attention_fwd stored seed words %s, want %s"
                 % (philox.seed_words(seed_t), WORDS))
        worst_b = max(worst_b, check(
            "small_attention_bwd", what,
            fa.small_attention_bwd(q, k, v, bias, scale, p, seed_t, out,
                                   lse, do),
            fa.small_attention_bwd_reference(q, k, v, bias, scale, p, WORDS,
                                             out, lse, do),
            FLASH_BWD_ATOL))
        if kept is None:
            kept = (what, q, k, v, do, bias, scale, seed_t, out, lse)
    what, q, k, v, do, bias, scale, seed_t, out, lse = kept
    bb, h, s, d = q.shape
    # two key tiles: each dQ element is 0 + a + b, in either order
    dq1 = fa.small_attention_bwd(q, k, v, bias, scale, 0.1, seed_t, out, lse,
                                 do)[0]
    dq2 = fa.small_attention_bwd(q, k, v, bias, scale, 0.1, seed_t, out, lse,
                                 do)[0]
    if not torch.equal(dq1, dq2):
        fail("small_attention_bwd: dQ differs between two runs at %s (max "
             "%.3g)" % (what, float((dq1 - dq2).abs().max())))
    print("kernel small_attention_bwd %s: dQ bitwise equal over two runs; "
          "%d CTAs an SM at D=%d" % (
              what, fa.small_attention_bwd_ctas_per_sm(d), d), flush=True)
    n = bb * h * s * d
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    row = timed_row(
        "small_attention_fwd",
        lambda: fa.small_attention_fwd(q, k, v, bias, scale, 0.1, WORDS,
                                       seed_out=seed_t),
        lambda: fa.small_attention_fwd_reference(q, k, v, bias, scale, 0.1,
                                                 WORDS),
        lambda: sdpa(q, k, v, attn_mask=bias, dropout_p=0.1),
        4 * (4 * n + bb * s * s + bb * h * s) + 8, 4 * bb * h * s * s * d,
        flush, worst_f, "%s (SDPA with dropout_p=0.1 and the same mask)"
        % what)
    row.update(source="paddle_tpu_torch/kernels/csrc/small_attention.cu",
               replaces="paddle_tpu/pallas_kernels/flash_attention.py:534")
    rows.append(row)
    # yardstick: SDPA's backward with dropout, its graph built once
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    o = sdpa(*leaves, attn_mask=bias, dropout_p=0.1)

    def sdpa_bwd():
        return torch.autograd.grad(o, leaves, do, retain_graph=True)

    # read q, k, v, out, dO, the bias, lse and the seed; write dq, dk, dv;
    # the least work: the scores again, dO v^T, dQ, dK, dV (five
    # multiply-adds per (i, j, d), the fused kernel's), and delta
    row = timed_row(
        "small_attention_bwd",
        lambda: fa.small_attention_bwd(q, k, v, bias, scale, 0.1, seed_t,
                                       out, lse, do),
        lambda: fa.small_attention_bwd_reference(q, k, v, bias, scale, 0.1,
                                                 WORDS, out, lse, do),
        sdpa_bwd, 4 * (8 * n + bb * s * s + bb * h * s) + 8,
        10 * bb * h * s * s * d + 2 * n, flush, worst_b,
        "%s (library: SDPA's backward with dropout)" % what)
    row.update(source="paddle_tpu_torch/kernels/csrc/small_attention_bwd.cu",
               replaces="paddle_tpu/pallas_kernels/flash_attention.py:563")
    # the row times the op's call, delta = rowsum(dO . O) included, as
    # SDPA's backward computes its own; the kernel alone beside it
    delta = fa.attention_delta(out, do)
    fused_ms = time_cold(
        lambda: fa.small_attention_bwd_fused(q, k, v, bias, scale, 0.1,
                                             seed_t, do, lse, delta), flush)
    print("kernel small_attention_bwd %s: the kernel alone (dQ's zero fill "
          "included, delta given) %.6f ms" % (what, fused_ms), flush=True)
    rows.append(row)
    return rows


def flash_bwd_kernel_phase(fa, dev, flush):
    """Rows 3 and 4: the fused backward kernel's dQ, dK and dV against the
    plain versions, from the forward kernel's out and lse; its dQ bitwise
    equal across two runs at the main shape (two key tiles)."""
    rng = np.random.RandomState(3)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa

    def head_split(bb, h, s, d):
        x = t(_rand(rng, bb, s, h * d))
        return x.view(bb, s, h, d).permute(0, 2, 1, 3)

    m = (rng.rand(32, 1, 1, 128) > 0.25).astype(np.float32)
    m[:, :, :, 0] = 1.0
    pad = np.broadcast_to((1.0 - m) * -1e4, (32, 1, 128, 128))
    odd_bias = np.zeros((2, 1, 77, 77), np.float32)
    odd_bias[:, :, 5, :] = -1e30              # one fully masked row
    cases = [
        ("main path B=32 H=12 S=128 D=64 strided head split, padding bias",
         (32, 12, 128, 64), pad, False, True),
        ("long causal B=1 H=12 S=2048 D=64", (1, 12, 2048, 64), None, True,
         False),
        ("odd B=2 H=3 S=77 D=40 head-shared bias, a fully masked row",
         (2, 3, 77, 40), odd_bias, False, False),
        ("B=2 H=3 S=200 D=64 per-head bias (four key tiles, the last 8 "
         "rows)", (2, 3, 200, 64), _rand(rng, 2, 3, 200, 200), False,
         False),
    ]
    worst = 0.0
    tensors = {}
    for what, (bb, h, s, d), bias, causal, strided in cases:
        if strided:   # q, k, v and dO as the main path hands them over
            q, k, v, do = (head_split(bb, h, s, d) for _ in range(4))
        else:
            q, k, v, do = (t(_rand(rng, bb, h, s, d)) for _ in range(4))
        bias = t(bias) if bias is not None else None
        out, lse = fa.flash_attention(q, k, v, bias, causal)
        delta = fa.attention_delta(out, do)
        args = (q, k, v, bias, do, lse, delta, causal)
        tensors[what] = args
        want = [fa.flash_attention_bwd_dq_reference(*args),
                *fa.flash_attention_bwd_dkv_reference(*args)]
        worst = max(worst, check("flash_attention_bwd_fused", what,
                                 fa.flash_attention_bwd_fused(*args), want,
                                 FLASH_BWD_ATOL))
    what = cases[0][0]
    args = tensors[what]
    q, k, v, bias, do, lse, delta, _c = args
    dq1 = fa.flash_attention_bwd_fused(*args)[0]
    dq2 = fa.flash_attention_bwd_fused(*args)[0]
    if not torch.equal(dq1, dq2):
        fail("flash_attention_bwd_fused: dQ differs between two runs at %s "
             "(max %.3g)" % (what, float((dq1 - dq2).abs().max())))
    print("kernel flash_attention_bwd_fused %s: dQ bitwise equal over two "
          "runs; %d CTAs an SM at D=%d" % (
              what, fa.flash_attention_bwd_ctas_per_sm(q.shape[3]),
              q.shape[3]), flush=True)
    bb, h, s, d = q.shape
    # yardstick: the whole SDPA backward (dQ, dK and dV) with the same
    # mask, its forward graph built once and not timed
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    o = torch.nn.functional.scaled_dot_product_attention(*leaves,
                                                         attn_mask=bias)

    def sdpa_bwd():
        return torch.autograd.grad(o, leaves, do, retain_graph=True)

    def plain():
        return (fa.flash_attention_bwd_dq_reference(*args),
                fa.flash_attention_bwd_dkv_reference(*args))

    n = bb * h * s * d
    # read once: q, k, v, dO, the bias, lse and delta; write dQ, dK, dV.
    # Five multiply-adds per (i, j, d): s, dO v^T, dV, dK, dQ
    row = timed_row(
        "flash_attention_bwd_fused",
        lambda: fa.flash_attention_bwd_fused(*args), plain, sdpa_bwd,
        4 * (7 * n + bb * s * s + 2 * bb * h * s), 10 * bb * h * s * s * d,
        flush, worst, "%s (library: the whole SDPA backward)" % what)
    row.update(source="paddle_tpu_torch/kernels/csrc/flash_attention_bwd.cu",
               replaces="paddle_tpu/pallas_kernels/flash_attention.py:112, "
                        "paddle_tpu/pallas_kernels/flash_attention.py:157")
    return row


def ln_bwd_kernel_phase(fl, dev, flush):
    """Row 8: the fused-LN backward from the forward kernel's r, mean, var
    (and Seed, at p = 0.1).  The kernels line takes p = 0.1; the p = 0
    time prints beside it."""
    rng = np.random.RandomState(4)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    worst = 0.0
    tensors = {}
    for (n, hd), what in (((4096, 768), "BERT rows [4096, 768]"),
                          ((37, 200), "odd [37, 200]")):
        x, y, dz = (t(_rand(rng, n, hd)) for _ in range(3))
        g, b = t(_rand(rng, hd) + 1.0), t(_rand(rng, hd))
        _z, r, mean, var = fl.fused_ln_fwd(x, y, g, b, 0.0, None, 1e-5)
        dx, dy, dg, db = fl.fused_ln_bwd(r, g, mean, var, dz)
        wdx, _wdy, wdg, wdb = fl.fused_ln_bwd_reference(r, g, mean, var,
                                                         dz)
        if dy.data_ptr() != dx.data_ptr():
            fail("fused_ln_bwd: dy is not dx at dropout 0")
        worst = max(worst, check("fused_ln_bwd", what + " p=0 dx", [dx],
                                 [wdx]))
        sums = check("fused_ln_bwd", what + " p=0 dgamma, dbeta", [dg, db],
                     [wdg, wdb], LN_BWD_SUM_RTOL * float(max(
                         wdg.abs().max(), wdb.abs().max())))
        worst = max(worst, sums)
        seed_t = torch.empty(2, dtype=torch.int32, device=dev)
        _z, r1, mean1, var1 = fl.fused_ln_fwd(x, y, g, b, 0.1, WORDS, 1e-5,
                                              seed_out=seed_t)
        tensors[n, hd] = (x, y, g, b, r, mean, var, dz, r1, mean1, var1,
                          seed_t)
        got = fl.fused_ln_bwd(r1, g, mean1, var1, dz, 0.1, seed_t)
        want = fl.fused_ln_bwd_reference(r1, g, mean1, var1, dz, 1e-5, 0.1,
                                          seed_t)
        worst = max(worst, check("fused_ln_bwd", what + " p=0.1 dx, dy",
                                 got[:2], want[:2]))
        worst = max(worst, check(
            "fused_ln_bwd", what + " p=0.1 dgamma, dbeta", got[2:],
            want[2:], LN_BWD_SUM_RTOL * float(max(want[2].abs().max(),
                                                  want[3].abs().max()))))
    x, y, g, b, r, mean, var, dz, r1, mean1, var1, seed_t = \
        tensors[4096, 768]
    n, hd = x.shape
    ln_f = torch.nn.functional.layer_norm
    drop_f = torch.nn.functional.dropout
    leaves = [a.detach().requires_grad_() for a in (x, y, g, b)]
    z0 = ln_f(leaves[0] + leaves[1], (hd,), leaves[2], leaves[3], 1e-5)
    z1 = ln_f(leaves[0] + drop_f(leaves[1], 0.1), (hd,), leaves[2],
              leaves[3], 1e-5)

    def ln_autograd(z):
        return lambda: torch.autograd.grad(z, leaves, dz, retain_graph=True)

    timed_row(
        "fused_ln_bwd", lambda: fl.fused_ln_bwd(r, g, mean, var, dz),
        lambda: fl.fused_ln_bwd_reference(r, g, mean, var, dz),
        ln_autograd(z0), 4 * (3 * n * hd + 2 * n + 3 * hd), 11 * n * hd,
        flush, worst,
        "p=0 BERT rows [4096, 768] (autograd of F.layer_norm(x + y))")
    # p = 0.1: dy written besides dx, the seed read
    row = timed_row(
        "fused_ln_bwd",
        lambda: fl.fused_ln_bwd(r1, g, mean1, var1, dz, 0.1, seed_t),
        lambda: fl.fused_ln_bwd_reference(r1, g, mean1, var1, dz, 1e-5, 0.1,
                                          WORDS),
        ln_autograd(z1), 4 * (4 * n * hd + 2 * n + 3 * hd) + 8,
        12 * n * hd, flush, worst,
        "p=0.1 BERT rows [4096, 768] (autograd of F.layer_norm(x + "
        "F.dropout(y)))")
    row.update(source="paddle_tpu_torch/kernels/csrc/fused_ln_bwd.cu",
               replaces="paddle_tpu/pallas_kernels/fused_ln.py:130")
    return row


def bert_param_shapes(cfg):
    """Parameter shapes of build_pretrain(cfg): embeddings and their
    LayerNorm, 12 encoder layers, the masked-LM head."""
    h, f, v = cfg.hidden, cfg.ffn, cfg.vocab_size
    shapes = [(v, h), (cfg.max_pos, h), (cfg.type_vocab, h), (h,), (h,)]
    for _ in range(cfg.layers):
        shapes += [(h, h), (h,)] * 4 + [(h, f), (f,), (f, h), (h,)] \
            + [(h,)] * 4
    return shapes + [(h, h), (h,), (h,), (h,), (h, v), (v,)]


def adam_kernel_phase(fad, dev, flush, cfg):
    """Row 9: the fused Adam over BERT-base's parameter group and an odd
    5-member group, bitwise equal to its plain version, with and without
    the bf16 copy; members' beta pows diverged."""
    rng = np.random.RandomState(5)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa

    def group(shapes):
        f = np.float32
        return ([t(rng.randn(*s).astype(f)) for s in shapes],
                [t((rng.randn(*s) * 1e-3).astype(f)) for s in shapes],
                [t((rng.randn(*s) * 1e-3).astype(f)) for s in shapes],
                [t((rng.rand(*s) * 1e-6).astype(f)) for s in shapes],
                t(np.array([1e-4], f)),
                [t(np.array([0.9 ** (1 + i % 3)], f))
                 for i in range(len(shapes))],
                [t(np.array([0.999 ** (1 + i % 5)], f))
                 for i in range(len(shapes))])

    def clones(grp):
        p, g, m1, m2, lr, b1, b2 = grp
        c = lambda ts: [x.clone() for x in ts]  # noqa: E731
        return c(p), g, c(m1), c(m2), lr, c(b1), c(b2)

    bert = bert_param_shapes(cfg)
    groups = {"BERT-base group, %d members, %d elements" % (
        len(bert), sum(int(np.prod(s)) for s in bert)): bert,
        "odd 5-member group": [(37, 5), (1000,), (3, 3, 3), (129,),
                               (2048, 17)]}
    kept = None
    for what, shapes in groups.items():
        grp = group(shapes)
        want = fad.fused_adam_reference(*grp, bf16_out=True)
        for carry in (False, True):
            bf = [torch.empty(p.shape, dtype=torch.bfloat16, device=dev)
                  for p in grp[0]] if carry else None
            got = fad.fused_adam_step(*clones(grp), bf16_out=bf)
            torch.cuda.synchronize()
            names = ("param", "moment1", "moment2", "beta1_pow", "beta2_pow")
            names += ("bf16 copy",) if carry else ()
            for name, gs, ws in zip(names, got, want):
                if not all(torch.equal(a, b) for a, b in zip(gs, ws)):
                    fail("fused_adam %s not bitwise equal to the plain "
                         "version at %s" % (name, what))
            print("kernel fused_adam %s%s: bitwise equal to the plain "
                  "version" % (what, ", with the bf16 copy" if carry
                               else ""), flush=True)
        del want
        if kept is None:
            kept = grp
    grp = kept
    run = clones(grp)             # the timed kernel steps update these
    lib_params = [p.clone().requires_grad_() for p in grp[0]]
    for p, g in zip(lib_params, grp[1]):
        p.grad = g
    lib = torch.optim.Adam(lib_params, lr=1e-4, fused=True)
    nel = sum(p.numel() for p in grp[0])
    row = timed_row(
        "fused_adam", lambda: fad.fused_adam_step(*run),
        lambda: fad.fused_adam_reference(*grp), lib.step, 28 * nel,
        12 * nel, flush, 0.0,
        "BERT-base group of %d members (torch.optim.Adam(fused=True), "
        "another eps placement: same bytes, not the same function)"
        % len(grp[0]))
    row.update(source="paddle_tpu_torch/kernels/csrc/fused_adam.cu",
               replaces="paddle_tpu/pallas_kernels/fused_opt.py:96")
    return row


# the conv kernels (rows 11, 12) vs their plain versions (cuDNN, TF32 off):
# each output sums K = C kh kw products (up to 4608 at ResNet-50's widths,
# outputs ~1) in another order; measured against this by the phase
CONV_ATOL = 1e-4
# row 12's per-image channel sums over up to 12544 pixels, held relative
# to each output's largest value
CONV_STATS_RTOL = 1e-5


def resnet50_fused_group():
    """Shapes of ResNet-50's fused momentum group, as the port's
    ``FuseOptimizerOpsPass`` forms it: every parameter of rank <= 2 (the
    53 batch norms' scales and biases, the fc weight and bias)."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.models.resnet import build_train

    main_p, startup = framework.Program(), framework.Program()
    with framework.program_guard(main_p, startup):
        build_train(depth=50)
    return [tuple(v.shape) for v in main_p.list_vars()
            if isinstance(v, framework.Parameter) and len(v.shape) <= 2]


def conv_case(rng, n, c, hw, co, k, dev):
    """x [n, c, hw, hw] ~ N(0, 1), w [co, c, k, k] ~ N(0, 2 / fan_in) (the
    layers' init), a ~ U(0.5, 1.5), b ~ N(0, 0.1^2), on ``dev``."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    f = np.float32
    return (t(rng.randn(n, c, hw, hw).astype(f)),
            t((rng.randn(co, c, k, k) * np.sqrt(2.0 / (c * k * k)))
              .astype(f)),
            t(rng.uniform(0.5, 1.5, co).astype(f)),
            t((rng.randn(co) * 0.1).astype(f)))


# (what, N, C, H = W, C_out, k, stride, pad, relu): ResNet-50 at batch 32
# (the stem, a stage-3 3x3, a stage-4 1x1 stride-2 shortcut, a stage-5 3x3
# at OH OW = 49, a stage-1 1x1 reduce through the 16-byte 1x1 loader and
# the wide tile, a stage-4 1x1 reduce at OH OW = 49, where the 1x1 loader
# does not apply),
# then odd shapes the routing predicate accepts (the last with pixel
# tiles spanning four images and C_out a multiple of no tile)
CONV_CASES = [
    ("stem x [32, 3, 224, 224] w [64, 3, 7, 7] s2 p3", 32, 3, 224, 64, 7,
     2, 3, True),
    ("stage-3 3x3 x [32, 256, 14, 14] w [256, 256, 3, 3] s1 p1", 32, 256,
     14, 256, 3, 1, 1, True),
    ("shortcut 1x1 s2 x [32, 512, 28, 28] w [1024, 512, 1, 1]", 32, 512, 28,
     1024, 1, 2, 0, False),
    ("stage-5 3x3 OH OW = 49 x [32, 512, 7, 7] w [512, 512, 3, 3] s1 p1",
     32, 512, 7, 512, 3, 1, 1, True),
    ("stage-1 1x1 x [32, 256, 56, 56] w [64, 256, 1, 1]", 32, 256, 56, 64,
     1, 1, 0, True),
    ("stage-4 1x1 OH OW = 49 x [32, 2048, 7, 7] w [512, 2048, 1, 1]", 32,
     2048, 7, 512, 1, 1, 0, True),
    ("odd x [3, 4, 13, 13] w [24, 4, 5, 5] s2 p2, no relu", 3, 4, 13, 24, 5,
     2, 2, False),
    ("odd x [2, 8, 9, 9] w [72, 8, 3, 3] s1 p0", 2, 8, 9, 72, 3, 1, 0, True),
    ("odd x [6, 8, 7, 7] w [40, 8, 3, 3] s2 p1, OH OW = 16", 6, 8, 7, 40, 3,
     2, 1, True),
]
# every tile of conv_block.TILES through each input loader (the gather,
# the 16-byte 1x1 slice, tap-major), each at a shape ragged in C_out and
# pixels
TILE_CASES = [
    ("3x3 x [5, 24, 10, 10] w [136, 24, 3, 3] s1 p1", 5, 24, 10, 136, 3, 1,
     1, True),
    ("1x1 x [3, 40, 12, 12] w [72, 40, 1, 1]", 3, 40, 12, 72, 1, 1, 0,
     True),
    ("3x3 x [3, 64, 9, 9] w [72, 64, 3, 3] s2 p1", 3, 64, 9, 72, 3, 2, 1,
     True),
]

def conv_pair(cb, x, w, a, b, stride, pad, relu, what, worst, tile=None):
    """Rows 11 and 12 against their plain versions at one shape; row 12
    twice, bitwise."""
    got = cb._conv_bn_act(x, w, a, b, stride, pad, relu, tile)
    want = cb.conv_bn_act_reference(x, w, a, b, stride, pad, relu)
    worst["conv_bn_act"] = max(worst["conv_bn_act"], check(
        "conv_bn_act", what, [got], [want], CONV_ATOL))
    first = cb._conv_stats(x, w, stride, pad, tile)
    again = cb._conv_stats(x, w, stride, pad, tile)
    pconv, ps, pss = cb.conv_stats_reference(x, w, stride, pad)
    worst["conv_stats"] = max(worst["conv_stats"], check(
        "conv_stats", what + " (conv)", [first[0]], [pconv], CONV_ATOL))
    for name, g, wv in (("sum", first[1], ps),
                        ("sum of squares", first[2], pss)):
        check("conv_stats", "%s (%s, relative)" % (what, name),
              [g / wv.abs().max()], [wv / wv.abs().max()], CONV_STATS_RTOL)
    if not all(torch.equal(g, h) for g, h in zip(first, again)):
        fail("conv_stats not bitwise equal over two runs at %s" % what)
    return first[0]


def conv_kernel_phase(cb, dev, flush):
    """Rows 11, 12, 13 against their plain versions at CONV_CASES (row 12
    bitwise over two runs; row 13 bitwise: one rounded product and sum, as
    the plain version) and at every tile (TILE_CASES), then timed at the
    stem and the stage-3 3x3 (the rows carry the 3x3)."""
    rng = np.random.RandomState(11)
    worst = {"conv_bn_act": 0.0, "conv_stats": 0.0, "affine_act": 0.0}
    kept = {}
    for what, n, c, hw, co, k, stride, pad, relu in CONV_CASES:
        x, w, a, b = conv_case(rng, n, c, hw, co, k, dev)
        tile = cb.conv_tile(co, n * cb.out_size(hw, k, stride, pad) ** 2)
        conv = conv_pair(cb, x, w, a, b, stride, pad, relu,
                         "%s, tile %dx%d" % ((what,) + cb.TILES[tile]),
                         worst)
        y = cb.affine_act(conv, a, b, relu)
        torch.cuda.synchronize()
        if not torch.equal(y, cb.affine_act_reference(conv, a, b, relu)):
            fail("affine_act not bitwise equal to the plain version at %s"
                 % what)
        print("kernel affine_act %s: bitwise equal to the plain version"
              % what, flush=True)
        if what.startswith(("stem", "stage-3")):
            kept[what] = (x, w, a, b, stride, pad, relu)
        del x, w, conv, y
    for what, n, c, hw, co, k, stride, pad, relu in TILE_CASES:
        x, w, a, b = conv_case(rng, n, c, hw, co, k, dev)
        for tile, (bm, bn) in enumerate(cb.TILES):
            conv_pair(cb, x, w, a, b, stride, pad, relu,
                      "%s, tile %dx%d" % (what, bm, bn), worst, tile)
    rows = {}
    for what, (x, w, a, b, stride, pad, relu) in kept.items():
        n, c, hw, _ = x.shape
        co, k = w.shape[0], w.shape[2]
        oh = cb.out_size(hw, k, stride, pad)
        out_el = n * co * oh * oh
        flops = 2 * out_el * c * k * k
        io = 4 * (x.numel() + w.numel() + out_el)
        wa = (w * a.reshape(-1, 1, 1, 1)).contiguous()
        f = torch.nn.functional
        # the bound of the kernels' 3xTF32 design: three TF32 products per
        # f32 product on the tensor cores, the epilogue's 3 flops an output
        # on the SIMT pipes
        rows["conv_bn_act"] = timed_row(
            "conv_bn_act", lambda: cb.conv_bn_act(x, w, a, b, stride, pad),
            lambda: cb.conv_bn_act_reference(x, w, a, b, stride, pad),
            lambda: f.relu(f.conv2d(x, wa, b, stride=stride, padding=pad)),
            io + 8 * co, 3 * out_el, flush, worst["conv_bn_act"],
            "%s (cuDNN F.relu(F.conv2d(x, w a, b)), TF32 off)" % what,
            tf32_flops=3 * flops)

        def lib_stats():
            cv = f.conv2d(x, w, stride=stride, padding=pad)
            return cv, cv.sum(dim=(2, 3)), (cv * cv).sum(dim=(2, 3))

        rows["conv_stats"] = timed_row(
            "conv_stats", lambda: cb.conv_stats(x, w, stride, pad),
            lambda: cb.conv_stats_reference(x, w, stride, pad), lib_stats,
            io + 8 * n * co, 3 * out_el, flush, worst["conv_stats"],
            "%s (cuDNN F.conv2d + the two sums)" % what,
            tf32_flops=3 * flops)
        bm, bn = cb.TILES[cb.conv_tile(co, n * oh * oh)]
        for name in ("conv_bn_act", "conv_stats"):
            row = rows[name]
            print("kernel %s %s: %.1f TF/s (cuDNN %.1f); tile %dx%d, %d "
                  "CTAs; %.1f%% of the 3xTF32 bound; the same products on "
                  "the f32 SIMT pipes %.6f ms (%d flops over 67 TF/s)"
                  % (name, what.split(" x ")[0], flops / row["ms"] / 1e9,
                     flops / row["library_ms"] / 1e9, bm, bn,
                     -(-co // bm) * -(-(n * oh * oh) // bn),
                     100 * row["bound_ms"] / row["ms"],
                     flops / F32_FLOPS * 1e3, flops), flush=True)
        conv = cb.conv_stats(x, w, stride, pad)[0]
        rows["affine_act"] = timed_row(
            "affine_act", lambda: cb.affine_act(conv, a, b),
            lambda: cb.affine_act_reference(conv, a, b),
            lambda: f.relu(torch.addcmul(b.reshape(1, -1, 1, 1), conv,
                                         a.reshape(1, -1, 1, 1))),
            4 * (2 * out_el + 2 * co), 3 * out_el, flush, 0.0,
            "[%d, %d, %d, %d] of the %s (F.relu(torch.addcmul(b, conv, a)))"
            % (n, co, oh, oh, what.split(" x ")[0]))
    sources = {"conv_bn_act": 133, "conv_stats": 143, "affine_act": 155}
    for name, row in rows.items():
        row.update(source="paddle_tpu_torch/kernels/csrc/conv_block.cu",
                   replaces="paddle_tpu/pallas_kernels/conv_block.py:%d"
                   % sources[name])
    return [rows["conv_bn_act"], rows["conv_stats"], rows["affine_act"]]


def momentum_kernel_phase(fm, dev, flush):
    """Row 10: the fused momentum over ResNet-50's fused group and an odd
    5-member group, plain and Nesterov, bitwise equal to its plain version
    with and without the bf16 copy; timed over ResNet-50's group."""
    rng = np.random.RandomState(6)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    f = np.float32

    def group(shapes):
        return ([t(rng.randn(*s).astype(f)) for s in shapes],
                [t((rng.randn(*s) * 1e-2).astype(f)) for s in shapes],
                [t((rng.randn(*s) * 1e-2).astype(f)) for s in shapes],
                t(np.array([0.1], f)))

    resnet = resnet50_fused_group()
    groups = {"ResNet-50 group, %d members, %d elements" % (
        len(resnet), sum(int(np.prod(s)) for s in resnet)): resnet,
        "odd 5-member group": [(37, 5), (1000,), (3, 3, 3), (129,),
                               (2048, 17)]}
    kept = None
    for what, shapes in groups.items():
        p, g, v, lr = group(shapes)
        for nesterov in (False, True):
            want = fm.fused_momentum_reference(p, g, v, lr, 0.9, nesterov,
                                               bf16_out=True)
            for carry in (False, True):
                bf = [torch.empty(x.shape, dtype=torch.bfloat16, device=dev)
                      for x in p] if carry else None
                got = fm.fused_momentum_step(
                    [x.clone() for x in p], g, [x.clone() for x in v], lr,
                    0.9, nesterov, bf16_out=bf)
                torch.cuda.synchronize()
                names = ("param", "velocity") + (("bf16 copy",) if carry
                                                 else ())
                for name, gs, ws in zip(names, got, want):
                    if not all(torch.equal(x, y) for x, y in zip(gs, ws)):
                        fail("fused_momentum %s not bitwise equal to the "
                             "plain version at %s" % (name, what))
                print("kernel fused_momentum %s%s%s: bitwise equal to the "
                      "plain version" % (what, ", Nesterov" if nesterov
                                         else "", ", with the bf16 copy"
                                         if carry else ""), flush=True)
        if kept is None:
            kept = (p, g, v, lr)
    p, g, v, lr = kept
    run = ([x.clone() for x in p], g, [x.clone() for x in v], lr)
    lib_params = [x.clone().requires_grad_() for x in p]
    for x, gx in zip(lib_params, g):
        x.grad = gx
    lib = torch.optim.SGD(lib_params, lr=0.1, momentum=0.9, fused=True)
    nel = sum(x.numel() for x in p)
    # the wrapper's host work before its ~0.03 ms launch (108 members'
    # grads checked, their pointers copied to the card) can outlast the
    # default sleep on a busy host: a ~5 ms sleep hides it
    row = timed_row(
        "fused_momentum", lambda: fm.fused_momentum_step(*run, mu=0.9),
        lambda: fm.fused_momentum_reference(p, g, v, lr, 0.9), lib.step,
        20 * nel, 3 * nel, flush, 0.0,
        "ResNet-50 group of %d members (torch.optim.SGD(momentum=0.9, "
        "fused=True), the same recurrence)" % len(p),
        sleep_cycles=10_000_000)
    row.update(source="paddle_tpu_torch/kernels/csrc/fused_momentum.cu",
               replaces="paddle_tpu/pallas_kernels/fused_opt.py:112")
    return row


# -- phase 4: decode serving -------------------------------------------------

def gpt2_small():
    from paddle_tpu_torch.serving import DecoderConfig
    # OpenAI GPT-2 small: n_vocab 50257, n_layer 12, n_head 12, n_embd 768,
    # n_ctx 1024
    return DecoderConfig(vocab=50257, layers=12, heads=12, head_dim=64,
                         ffn=3072, max_seq=1024)


def prompts(vocab):
    rng = np.random.RandomState(1)
    lens = [16, 384, 40, 200, 96, 300, 24, 128, 256, 64, 160]
    out = [rng.randint(0, vocab, n).tolist() for n in lens]
    # the late request shares request 4's first 64 tokens (4 full blocks)
    late = out[4][:64] + rng.randint(0, vocab, 56).tolist()
    return out, late


def decode_phase(pa):
    from paddle_tpu_torch.serving import DecodeEngine, init_decoder_params

    cfg = gpt2_small()
    t0 = time.perf_counter()
    params = init_decoder_params(cfg, seed=0)
    eng = DecodeEngine(buckets="4,8", block_size=16, deadline_ms=600000.0)
    m = eng.add_model("gpt2-small", (cfg, params), kv_blocks=520)
    del params
    torch.cuda.synchronize()
    print("decode: GPT-2-small width (vocab %d, %d layers, %d heads x %d, "
          "ffn %d, max_seq %d), %d KV blocks of 16 (%.1f MB), set up in "
          "%.1f s" % (cfg.vocab, cfg.layers, cfg.heads, cfg.head_dim,
                      cfg.ffn, cfg.max_seq, m.kv_config.num_blocks,
                      m.cache.nbytes / 1e6, time.perf_counter() - t0),
          flush=True)
    first, late = prompts(cfg.vocab)
    eng.start()
    try:
        # the count starts at 0 just before the main path runs
        pa.paged_attention.launches = 0
        steps0 = eng.steps
        t0 = time.perf_counter()
        reqs = [eng.submit("gpt2-small", p, max_new_tokens=32)
                for p in first]
        replies = [r.wait(timeout=900) for r in reqs]
        late_reply = eng.submit("gpt2-small", late, max_new_tokens=32) \
            .wait(timeout=900)
        wall = time.perf_counter() - t0
        launches = pa.paged_attention.launches
        steps = eng.steps - steps0
    finally:
        eng.stop()
    replies.append(late_reply)
    allp = first + [late]
    for i, r in enumerate(replies):
        if r is None or r.status != "ok":
            fail("decode request %d: %s" % (i, None if r is None
                                            else (r.status, r.error)))
    if late_reply.phases["cached_tokens"] != 64:
        fail("shared-prefix request cached %d tokens, want 64"
             % late_reply.phases["cached_tokens"])
    print("decode: %d replies ok, kernel launches %d, decode steps %d, "
          "layers x steps %d, prefix-cache hit %d tokens"
          % (len(replies), launches, steps, cfg.layers * steps,
             late_reply.phases["cached_tokens"]), flush=True)
    if launches != cfg.layers * steps or steps == 0:
        fail("paged_attention launched %d times over %d steps of %d layers"
             % (launches, steps, cfg.layers))

    ntok = sum(len(r.outputs["tokens"]) for r in replies)
    ttft = [r.phases["ttft_ms"] for r in replies]
    step_ms = list(m.step_ms_samples)[-steps:]
    print("decode: %d tokens in %.3f s = %.2f tokens/s; step_ms p50 %.3f; "
          "ttft_ms p50 %.3f" % (ntok, wall, ntok / wall,
                                float(np.percentile(step_ms, 50)),
                                float(np.percentile(ttft, 50))), flush=True)

    ties = 0
    for i, (p, r) in enumerate(zip(allp, replies)):
        got = [int(t) for t in r.outputs["tokens"]]
        want, logits = m.decoder.unpaged_generate(
            p, 32, pad_len=m.maxb * m.kv_config.block_size,
            return_logits=True)
        if got == want:
            continue
        j = next(k for k in range(min(len(got), len(want)))
                 if got[k] != want[k])
        top2 = np.sort(logits[j])[-2:]
        gap = float(top2[1] - top2[0])
        print("decode: request %d (prompt %d) diverges at token %d: "
              "paged %d, unpaged %d, unpaged top-2 gap %.3g"
              % (i, len(p), j, got[j], want[j], gap), flush=True)
        if gap >= LOGIT_TIE_TOL:
            fail("request %d diverges from the unpaged loop where the "
                 "top-2 logit gap %.3g >= %g" % (i, gap, LOGIT_TIE_TOL))
        ties += 1
    print("decode: tokens equal the unpaged plain loop for %d of %d "
          "requests; %d near-tie divergences (gap < %g)"
          % (len(replies) - ties, len(replies), ties, LOGIT_TIE_TOL),
          flush=True)
    return launches


# -- phase 5: encoder serving ------------------------------------------------

SEQ = 128
BUCKETS = "1,8,32"


def encoder_requests(cfg, n=24):
    """``n`` requests of 1 to 8 rows; each row's input_mask keeps a real
    length between 16 and SEQ and pads the rest."""
    rng = np.random.RandomState(5)
    out = []
    for _ in range(n):
        rows = int(rng.randint(1, 9))
        lens = rng.randint(16, SEQ + 1, rows)
        mask = (np.arange(SEQ)[None, :] < lens[:, None]).astype(np.float32)
        out.append({
            "src_ids": rng.randint(0, cfg.vocab_size, (rows, SEQ, 1))
            .astype(np.int64),
            "pos_ids": np.tile(np.arange(SEQ).reshape(1, SEQ, 1),
                               (rows, 1, 1)).astype(np.int64),
            "sent_ids": rng.randint(0, cfg.type_vocab, (rows, SEQ, 1))
            .astype(np.int64),
            "input_mask": mask[:, :, None]})
    return out


def build_bert_dir(dirname, cfg):
    """BERT at seq SEQ through the port's entry points: program, startup
    on the card from a seeded generator, save_inference_model."""
    from paddle_tpu_torch import framework, io
    from paddle_tpu_torch.core import Executor, Scope, scope_guard
    from paddle_tpu_torch.models.bert import bert_encoder

    main, startup = framework.Program(), framework.Program()
    startup.random_seed = 7
    with framework.program_guard(main, startup):
        inputs, seq_out = bert_encoder(cfg, SEQ, is_test=True)
    exe = Executor()                  # the card
    with scope_guard(Scope()):
        exe.run(startup)
        io.save_inference_model(dirname, [v.name for v in inputs],
                                [seq_out], exe, main_program=main)
    return main


def encoder_phase(kmods, cfg=None, clients=3):
    from paddle_tpu_torch.inference import AnalysisConfig, AnalysisPredictor
    from paddle_tpu_torch.models.bert import BERT_BASE
    from paddle_tpu_torch.serving import ServingEngine

    cfg = cfg or BERT_BASE
    fa, fl, ln = kmods
    with tempfile.TemporaryDirectory() as tmp:
        dirname = os.path.join(tmp, "bert")
        t0 = time.perf_counter()
        main = build_bert_dir(dirname, cfg)
        n_params = sum(int(np.prod(v.shape)) for v in main.list_vars()
                       if v.persistable and not v.is_data)
        print("encoder: BERT (vocab %d, hidden %d, %d layers, %d heads, ffn "
              "%d, max_pos %d, type_vocab %d), seq %d, %d f32 parameters "
              "(%.1f MB), %d ops; built, initialised on the card and saved "
              "in %.1f s" % (cfg.vocab_size, cfg.hidden, cfg.layers,
                             cfg.heads, cfg.ffn, cfg.max_pos,
                             cfg.type_vocab, SEQ, n_params,
                             n_params * 4 / 1e6,
                             len(main.global_block().ops),
                             time.perf_counter() - t0), flush=True)
        eng = ServingEngine(buckets=BUCKETS, batch_window_ms=5.0,
                            deadline_ms=600000.0)
        eng.add_model("bert", dirname)
        t0 = time.perf_counter()
        manifest = eng.prewarm()
        print("encoder: prewarm %s in %.1f s"
              % (json.dumps(manifest["bert"]), time.perf_counter() - t0),
              flush=True)
        reqs = encoder_requests(cfg)
        replies = [None] * len(reqs)
        eng.start()
        try:
            # the counts start at 0 just before the main path runs
            fa.flash_attention.launches = 0
            fl.fused_ln_fwd.launches = 0
            ln.layer_norm_2d.launches = 0
            batches0 = len(eng.batch_log)
            t0 = time.perf_counter()

            def client(k):
                for i in range(k, len(reqs), clients):
                    replies[i] = eng.infer("bert", reqs[i],
                                           deadline_ms=600000.0)

            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(clients)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(900)
            wall = time.perf_counter() - t0
            launches = {"flash_attention": fa.flash_attention.launches,
                        "fused_ln": fl.fused_ln_fwd.launches,
                        "layer_norm": ln.layer_norm_2d.launches}
            batches = list(eng.batch_log)[batches0:]
        finally:
            eng.stop()
        for i, (q, r) in enumerate(zip(reqs, replies)):
            rows = q["src_ids"].shape[0]
            if r is None or r.status != "ok":
                fail("encoder request %d: %s" % (
                    i, None if r is None else (r.status, r.error)))
            out, = r.outputs.values()
            if out.shape != (rows, SEQ, cfg.hidden) \
                    or not np.isfinite(out).all():
                fail("encoder request %d: output %s, want finite [%d, %d, "
                     "%d]" % (i, out.shape, rows, SEQ, cfg.hidden))
        nb = len(batches)
        print("encoder: %d replies ok (%d rows) in %.3f s = %.2f requests/s "
              "from %d client threads; %d batches; launches %s"
              % (len(reqs), sum(q["src_ids"].shape[0] for q in reqs), wall,
                 len(reqs) / wall, clients, nb, json.dumps(launches)),
              flush=True)
        want = {"flash_attention": cfg.layers * nb,
                "fused_ln": 2 * cfg.layers * nb, "layer_norm": nb}
        if nb == 0 or launches != want:
            fail("encoder launches %s over %d batches, want %s"
                 % (launches, nb, want))
        for b in sorted({x["bucket"] for x in batches}):
            sel = [x for x in batches if x["bucket"] == b]
            print("encoder: bucket %d: %d batches, execute_ms p50 %.3f, "
                  "rows filled %s (mean fill %.3f)"
                  % (b, len(sel), float(np.percentile(
                      [x["execute_ms"] for x in sel], 50)),
                     [x["rows"] for x in sel],
                     float(np.mean([x["rows"] / b for x in sel]))),
                  flush=True)

        # the same directory on the CPU is the plain path by construction
        cpu_cfg = AnalysisConfig(dirname)
        cpu_cfg.disable_gpu()
        plain = AnalysisPredictor(cpu_cfg)
        worst = 0.0
        for i in (0, len(reqs) // 2, len(reqs) - 1):
            want_out, = plain.run_feed(reqs[i]).values()
            got, = replies[i].outputs.values()
            worst = max(worst, float(np.abs(got - want_out).max()))
        print("encoder: 3 requests vs the plain predictor on the CPU: "
              "max_abs_err %.3g (atol %g)" % (worst, ENCODER_ATOL),
              flush=True)
        if not worst <= ENCODER_ATOL:
            fail("encoder output disagrees with the plain CPU predictor")
    return launches


# -- phase 6: BERT-base pretraining -----------------------------------------

TRAIN_BATCH = 32
TRAIN_STEPS = 5
CHECK_BATCH = 2
CHECK_STEPS = 3
# the training emissions, in the order the phase runs them
DROPOUT0, COMPOSED, SMALL = ("dropout 0", "dropout 0.1",
                             "dropout 0.1, small attention")
# kernel launches per training step of BERT-base (12 layers), by emission;
# every kernel not named launches 0 times.  In all three: 2 x 12
# epilogues forward and backward (fused_ln, fused_ln_bwd), one fused
# Adam, LayerNorm on the embeddings and on the head.  Dropout 0: 12 flash
# forwards and 12 fused backwards (the grad reads the saved Out and Lse).
# Dropout 0.1: the dropout kernel on the embeddings and on each
# layer's attention probabilities (its grad reads the saved mask).
# Small attention: 12 small forwards and 12 small backwards (the grad
# reads the saved lse), the dropout kernel on the embeddings.
_COMMON = {"fused_ln": 24, "fused_ln_bwd": 24, "fused_adam": 1,
           "layer_norm": 2}
STEP_LAUNCHES = {
    DROPOUT0: dict(_COMMON, flash_attention=12, flash_attention_bwd_fused=12),
    COMPOSED: dict(_COMMON, dropout=13),
    SMALL: dict(_COMMON, small_attention_fwd=12, small_attention_bwd=12,
                dropout=1),
}


def check_steps(main_p, loss, init, feed, place):
    """CHECK_STEPS steps of ``main_p`` on ``feed`` from the persistables
    ``init`` on ``place`` (None: the card) -> (losses, {name: Adam moment
    after the steps})."""
    from paddle_tpu_torch.core import Executor, Scope, scope_from_numpy

    ex = Executor(place)
    sc = scope_from_numpy(Scope(), init, ex.device, program=main_p)
    t0 = time.perf_counter()
    losses = [float(ex.run(main_p, feed=feed, fetch_list=[loss],
                           scope=sc)[0].reshape(-1)[0])
              for _ in range(CHECK_STEPS)]
    sec = time.perf_counter() - t0
    moments = {n: sc.find_var(n).get_tensor().numpy() for n in init
               if "_moment1_" in n or "_moment2_" in n}
    print("train: %d steps at batch %d on the %s: losses %s (%.1f s)"
          % (CHECK_STEPS, len(feed["src_ids"]),
             "card" if place is None else "CPU", json.dumps(losses), sec),
          flush=True)
    return losses, moments


def card_vs_cpu(main_p, loss, init, feed):
    """The same steps on the card and on the CPU's plain path -> (max loss
    difference, the Adam moments' gap and the tensor where it is, as
    ``moment_gap`` reads them)."""
    from paddle_tpu_torch import framework

    card, m_card = check_steps(main_p, loss, init, feed, None)
    cpu, m_cpu = check_steps(main_p, loss, init, feed, framework.CPUPlace())
    loss_gap = max(abs(a - b) for a, b in zip(card, cpu))
    return (loss_gap,) + moment_gap(m_card, m_cpu)


def moment_gap(got, want):
    """(largest of max|got - want| / scale over the moment tensors, the
    tensor where it is).  A tensor's scale is its largest |want|, but at
    least MOMENT_FLOOR of the largest first moment (MOMENT_FLOOR squared
    of the largest second moment): a gradient that is zero but for rounding, as
    the key projection's bias has (softmax ignores a shift shared by a
    row's scores), leaves moments of rounding noise alone, which only
    the floor holds."""
    top = {k: max(float(np.abs(w).max()) for n, w in want.items() if k in n)
           for k in ("_moment1_", "_moment2_")}
    floor = {"_moment1_": MOMENT_FLOOR * top["_moment1_"],
             "_moment2_": MOMENT_FLOOR ** 2 * top["_moment2_"]}
    gap, worst = 0.0, None
    for n, w in want.items():
        kind = "_moment1_" if "_moment1_" in n else "_moment2_"
        scale = max(float(np.abs(w).max()), floor[kind])
        rel = float(np.abs(got[n] - w).max()) / scale
        if worst is None or rel > gap:
            gap, worst = rel, n
    return gap, worst


def counted():
    """{name: wrapper} of every kernel wrapper that counts launches on the
    training, conv, DLRM and reduction paths."""
    from paddle_tpu_torch.kernels import channel_stats as cst
    from paddle_tpu_torch.kernels import conv_block as cb
    from paddle_tpu_torch.kernels import dropout as dk
    from paddle_tpu_torch.kernels import embedding_bag as eb
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_adam as fad
    from paddle_tpu_torch.kernels import fused_ln as fl
    from paddle_tpu_torch.kernels import fused_momentum as fm
    from paddle_tpu_torch.kernels import layer_norm as ln

    return {"flash_attention": fa.flash_attention,
            "flash_attention_bwd_fused": fa.flash_attention_bwd_fused,
            "small_attention_fwd": fa.small_attention_fwd,
            "small_attention_bwd": fa.small_attention_bwd,
            "dropout": dk.dropout,
            "fused_ln": fl.fused_ln_fwd,
            "fused_ln_bwd": fl.fused_ln_bwd,
            "fused_adam": fad.fused_adam_step,
            "layer_norm": ln.layer_norm_2d,
            "conv_bn_act": cb.conv_bn_act,
            "conv_stats": cb.conv_stats,
            "affine_act": cb.affine_act,
            "fused_momentum": fm.fused_momentum_step,
            "embedding_bag": eb.embedding_bag,
            "channel_stats": cst.stats,
            "affine_stats": cst.affine_stats}


def launch_counts():
    return {k: f.launches for k, f in counted().items()}


def zero_counts():
    for f in counted().values():
        f.launches = 0


@contextlib.contextmanager
def emission(name):
    """The environment of a training emission: ``BERT_FUSED_ATTN=1`` (read
    when the program is built) and ``FLAGS_fused_small_attention`` (read
    when it runs) for the small-attention one; restored after."""
    from paddle_tpu_torch import get_flags, set_flags

    env = os.environ.get("BERT_FUSED_ATTN")
    flag = get_flags("FLAGS_fused_small_attention")
    if name == SMALL:
        os.environ["BERT_FUSED_ATTN"] = "1"
        set_flags({"FLAGS_fused_small_attention": True})
    else:
        os.environ.pop("BERT_FUSED_ATTN", None)
    try:
        yield
    finally:
        if env is None:
            os.environ.pop("BERT_FUSED_ATTN", None)
        else:
            os.environ["BERT_FUSED_ATTN"] = env
        set_flags(flag)


def train_phase(cfg, name):
    """BERT pretraining in the emission ``name`` (set up by ``emission``)
    -> the launch counts of its TRAIN_STEPS steps."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.core import (Executor, Scope, scope_guard,
                                       scope_to_numpy)
    from paddle_tpu_torch.models.bert import (MASK_FRAC, build_pretrain,
                                              pretrain_feed)

    t0 = time.perf_counter()
    main_p, startup = framework.Program(), framework.Program()
    startup.random_seed = 11
    with framework.program_guard(main_p, startup):
        _inputs, loss = build_pretrain(cfg, SEQ, lr=1e-4)
    params = [v for v in main_p.list_vars()
              if isinstance(v, framework.Parameter)]
    n_params = sum(int(np.prod(v.shape)) for v in params)
    want_n = sum(int(np.prod(s)) for s in bert_param_shapes(cfg))
    if n_params != want_n:
        fail("build_pretrain made %d parameters, want %d" % (n_params,
                                                            want_n))
    print("train [%s]: BERT (vocab %d, hidden %d, %d layers, %d heads, ffn "
          "%d, max_pos %d, type_vocab %d, dropout %g), seq %d, batch %d, %d "
          "masked positions; %d parameters in %d tensors (%.1f MB f32), %d "
          "ops in the main program; built in %.1f s"
          % (name, cfg.vocab_size, cfg.hidden, cfg.layers, cfg.heads, cfg.ffn,
             cfg.max_pos, cfg.type_vocab, cfg.dropout, SEQ, TRAIN_BATCH,
             int(TRAIN_BATCH * SEQ * MASK_FRAC), n_params, len(params),
             n_params * 4 / 1e6, len(main_p.global_block().ops),
             time.perf_counter() - t0), flush=True)
    exe = Executor()                  # the card
    scope = Scope()
    with scope_guard(scope):
        exe.run(startup)
        init = scope_to_numpy(scope, main_p)
        feed = pretrain_feed(np.random.RandomState(3), cfg, TRAIN_BATCH,
                             SEQ)
        torch.cuda.synchronize()
        # the counts start at 0 just before the main path runs
        zero_counts()
        losses, step_ms = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            out, = exe.run(main_p, feed=feed, fetch_list=[loss])
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(out.reshape(-1)[0]))
        launches = launch_counts()
    del scope
    n_fused = sum(op.type == "fused_adam" for op in main_p.global_block().ops)
    print("train [%s]: %d steps, losses %s; step_ms %s, p50 %.3f (the "
          "first fuses the optimizer ops and plans); %d fused_adam op(s) "
          "over %d params; launches %s" % (
              name, TRAIN_STEPS, json.dumps(losses),
              json.dumps([round(x, 3) for x in step_ms]),
              float(np.percentile(step_ms, 50)), n_fused, len(params),
              json.dumps(launches)), flush=True)
    want = {k: STEP_LAUNCHES[name].get(k, 0) * TRAIN_STEPS
            for k in launches}
    if launches != want:
        fail("training launches %s over %d steps, want %s"
             % (launches, TRAIN_STEPS, want))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail("training losses %s: not finite, or the last is not below the "
             "first" % losses)

    # the same initial state and feeds on the card and on the CPU's plain
    # path, at a batch the CPU runs in seconds
    feed2 = pretrain_feed(np.random.RandomState(4), cfg, CHECK_BATCH, SEQ)
    loss_gap, moment_gap, worst = card_vs_cpu(main_p, loss, init, feed2)
    print("train [%s]: card vs CPU plain path, max loss difference %.3g "
          "(limit %.3g); Adam moments' gap %.3g (limit %.3g, worst %s)"
          % (name, loss_gap, TRAIN_LOSS_ATOL, moment_gap, TRAIN_MOMENT_RTOL,
             worst), flush=True)
    if not (loss_gap <= TRAIN_LOSS_ATOL and moment_gap <= TRAIN_MOMENT_RTOL):
        fail("training on the card disagrees with the CPU plain path")
    return launches


# -- phases 7 and 8: ResNet-50 serving and training --------------------------

# ResNet-50 v1.5 (He et al. 2016; the bundled models/resnet.py), 224x224
# RGB, 1000 classes, NCHW f32; every one of its 53 conv + batch-norm pairs
# is a row-11 launch per batch in the trunk at is_test and a row-12 plus a
# row-13 launch per training step of the trunk
RESNET_DEPTH = 50
IMAGE = 224
CLASSES = 1000
CONV_BN_PAIRS = 53
RESNET_BUCKETS = "1,8,32"
# Momentum's learning rate: the published ImageNet recipe's 0.1 per 256
# images (He et al.; Goyal et al.'s linear scaling), at batch 32.  At
# build_train's own 0.1, five steps from a random start on one batch
# overshoot from the third step on (the plain path on the CPU at 112x112,
# batch 16: losses 7.15, 3.41, 11.85, 20.29, 15.02;
# tools/torch_resnet_sensitivity.py lr)
RESNET_LR = 0.0125
# served logits, card vs the plain predictor on the CPU, held relative to
# the largest |logit| of the reply: 53 convs in a chain, each summing up
# to 4608 products in another order (random weights, running statistics
# at their initial 0 and 1, so activations grow along the residual
# stream and only a relative limit is scale-free)
SERVE_RTOL = 1e-4
# ResNet-50 training, 3 Momentum steps at batch 2, each from one state on
# the card and on the plain path on the CPU (f32, TF32 off): losses
# absolutely; each velocity tensor (the L2-decayed gradients' running
# sum) by the norm of its difference relative to its own norm.  At a
# batch of 2 a randomly initialised ResNet-50 is f32-sensitive: two CPU
# conv algorithms (oneDNN on and off) from one state differ by up to
# 2.0e-5 in a loss (losses 0.7 to 8) and by 0.028 norm-wise in a
# velocity (tools/torch_resnet_sensitivity.py algorithms; PERF.md §6);
# the limits sit ~4x above the card's own first reading (1.7e-5, 0.053),
# and a fault (a gradient zeroed, a kernel mis-routed) moves both by ~1.
RESNET_LOSS_ATOL = 1e-4
RESNET_VELOCITY_RTOL = 0.2


def resnet_trunk(layers, img, depth=RESNET_DEPTH, class_dim=CLASSES,
                 is_test=False):
    """The bundled ResNet's architecture (``models/resnet.py``
    ``resnet``) with every conv + batch-norm pair one
    ``layers.conv2d_bn_relu``: only public layers, so the reference can
    build the same program."""
    from paddle_tpu_torch.models.resnet import DEPTH_CFG

    def cbr(x, f, k, s, act="relu"):
        return layers.conv2d_bn_relu(x, f, k, stride=s,
                                     padding=(k - 1) // 2, act=act,
                                     is_test=is_test)

    def basic(x, f, s):
        y = cbr(cbr(x, f, 3, s), f, 3, 1, act=None)
        short = cbr(x, f, 1, s, act=None) if s != 1 or x.shape[1] != f \
            else x
        return layers.relu(layers.elementwise_add(y, short))

    def bottleneck(x, f, s):
        y = cbr(cbr(cbr(x, f, 1, 1), f, 3, s), f * 4, 1, 1, act=None)
        short = cbr(x, f * 4, 1, s, act=None) \
            if s != 1 or x.shape[1] != f * 4 else x
        return layers.relu(layers.elementwise_add(y, short))

    kind, counts = DEPTH_CFG[depth]
    block = basic if kind == "basic" else bottleneck
    x = cbr(img, 64, 7, 2)
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1)
    for stage, n in enumerate(counts):
        for i in range(n):
            x = block(x, 64 * 2 ** stage,
                      2 if (i == 0 and stage > 0) else 1)
    x = layers.pool2d(x, pool_type="avg", global_pooling=True)
    return layers.fc(x, class_dim)


def resnet_program(which, is_test):
    """(main, startup, img, label, output): ``which`` is "bundled" (the
    port's models.resnet) or "trunk"; the output is the logits at
    is_test, else the loss, Momentum(0.1, 0.9, L2Decay(1e-4)) appended as
    ``build_train`` appends it."""
    from paddle_tpu_torch import framework, layers
    from paddle_tpu_torch.models import resnet

    main_p, startup = framework.Program(), framework.Program()
    startup.random_seed = 13
    with framework.program_guard(main_p, startup):
        if which == "bundled" and not is_test:
            img, label, out, _acc = resnet.build_train(
                depth=RESNET_DEPTH, class_dim=CLASSES, image_size=IMAGE,
                lr=RESNET_LR)
            return main_p, startup, img, label, out
        img = layers.data("img", shape=[3, IMAGE, IMAGE])
        label = layers.data("label", shape=[1], dtype="int64")
        if which == "bundled":
            out = resnet.resnet(img, CLASSES, RESNET_DEPTH, is_test=True)
        else:
            out = resnet_trunk(layers, img, is_test=is_test)
        if not is_test:
            from paddle_tpu_torch.optimizer import Momentum
            from paddle_tpu_torch.regularizer import L2Decay

            out = layers.mean(layers.softmax_with_cross_entropy(out, label))
            Momentum(learning_rate=RESNET_LR, momentum=0.9,
                     regularization=L2Decay(1e-4)).minimize(out)
    return main_p, startup, img, label, out


@contextlib.contextmanager
def flag_set(name, on):
    """The port's flag ``name`` set for a phase, restored after."""
    from paddle_tpu_torch import get_flags, set_flags

    saved = get_flags(name)
    set_flags({name: on})
    try:
        yield
    finally:
        set_flags(saved)


def image_requests(n=24, sampled=(0, 12, 23)):
    """``n`` requests of 1 to 6 images (the ``sampled`` ones, which the
    CPU re-runs, of 1 or 2)."""
    rng = np.random.RandomState(8)
    out = []
    for i in range(n):
        rows = 1 + i % 2 if i in sampled else int(rng.randint(1, 7))
        out.append({"img": rng.randn(rows, 3, IMAGE, IMAGE)
                    .astype(np.float32)})
    return out


def conv_serve_phase(which, clients=3):
    """ResNet-50 ``which`` ("bundled" or "trunk", the trunk under the
    flag) saved and served by ServingEngine at buckets 1, 8, 32 -> the
    kernel launches of the served batches."""
    from paddle_tpu_torch import io
    from paddle_tpu_torch.core import Executor, Scope, scope_guard
    from paddle_tpu_torch.inference import AnalysisConfig, AnalysisPredictor
    from paddle_tpu_torch.serving import ServingEngine

    trunk = which == "trunk"
    with flag_set("FLAGS_use_pallas_conv_block", trunk), \
            tempfile.TemporaryDirectory() as tmp:
        dirname = os.path.join(tmp, which)
        t0 = time.perf_counter()
        main_p, startup, img, _label, logits = resnet_program(which, True)
        exe = Executor()                          # the card
        with scope_guard(Scope()):
            exe.run(startup)
            io.save_inference_model(dirname, [img.name], [logits], exe,
                                    main_program=main_p)
        eng = ServingEngine(buckets=RESNET_BUCKETS, batch_window_ms=5.0,
                            deadline_ms=600000.0)
        pred = eng.add_model("resnet", dirname)
        types = [op.type for op in pred.program().global_block().ops]
        print("serve [%s]: ResNet-50 (%d ops after the predictor's passes: "
              "%d conv2d, %d conv2d_bn_relu, %d batch_norm, %d "
              "fused_elemwise_activation, %d fc), built on the card and "
              "saved in %.1f s" % (
                  which, len(types), types.count("conv2d"),
                  types.count("conv2d_bn_relu"), types.count("batch_norm"),
                  types.count("fused_elemwise_activation"),
                  types.count("fc"), time.perf_counter() - t0), flush=True)
        t0 = time.perf_counter()
        manifest = eng.prewarm()
        print("serve [%s]: prewarm %s in %.1f s"
              % (which, json.dumps(manifest["resnet"]),
                 time.perf_counter() - t0), flush=True)
        reqs = image_requests()
        replies = [None] * len(reqs)
        eng.start()
        try:
            torch.cuda.synchronize()
            zero_counts()   # just before the main path runs
            batches0 = len(eng.batch_log)
            t0 = time.perf_counter()

            def client(k):
                for i in range(k, len(reqs), clients):
                    replies[i] = eng.infer("resnet", reqs[i],
                                           deadline_ms=600000.0)

            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(clients)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(900)
            wall = time.perf_counter() - t0
            launches = launch_counts()
            batches = list(eng.batch_log)[batches0:]
        finally:
            eng.stop()
        for i, (q, r) in enumerate(zip(reqs, replies)):
            rows = q["img"].shape[0]
            if r is None or r.status != "ok":
                fail("serve [%s] request %d: %s" % (
                    which, i, None if r is None else (r.status, r.error)))
            out, = r.outputs.values()
            if out.shape != (rows, CLASSES) or not np.isfinite(out).all():
                fail("serve [%s] request %d: output %s, want finite [%d, %d]"
                     % (which, i, out.shape, rows, CLASSES))
        nb = len(batches)
        print("serve [%s]: %d replies ok (%d images) in %.3f s = %.2f "
              "images/s from %d client threads; %d batches; launches %s"
              % (which, len(reqs), sum(q["img"].shape[0] for q in reqs),
                 wall, sum(q["img"].shape[0] for q in reqs) / wall, clients,
                 nb, json.dumps({k: v for k, v in launches.items() if v})),
              flush=True)
        want = {k: 0 for k in launches}
        if trunk:
            want["conv_bn_act"] = CONV_BN_PAIRS * nb
        if nb == 0 or launches != want:
            fail("serve [%s] launches %s over %d batches, want %s"
                 % (which, launches, nb, want))
        for b in sorted({x["bucket"] for x in batches}):
            sel = [x for x in batches if x["bucket"] == b]
            print("serve [%s]: bucket %d: %d batches, execute_ms p50 %.3f, "
                  "rows filled %s" % (which, b, len(sel), float(np.percentile(
                      [x["execute_ms"] for x in sel], 50)),
                                      [x["rows"] for x in sel]), flush=True)
        cpu_cfg = AnalysisConfig(dirname)
        cpu_cfg.disable_gpu()
        plain = AnalysisPredictor(cpu_cfg)
        worst = 0.0
        for i in (0, len(reqs) // 2, len(reqs) - 1):
            want_out, = plain.run_feed(reqs[i]).values()
            got, = replies[i].outputs.values()
            worst = max(worst, float(np.abs(got - want_out).max())
                        / float(np.abs(want_out).max()))
        print("serve [%s]: 3 requests vs the plain predictor on the CPU: "
              "max |diff| / max |logit| %.3g (limit %g)"
              % (which, worst, SERVE_RTOL), flush=True)
        if not worst <= SERVE_RTOL:
            fail("serve [%s] output disagrees with the plain CPU predictor"
                 % which)
    return {k: v for k, v in launches.items() if v}


def resnet_feed(rng, batch):
    return {"img": rng.randn(batch, 3, IMAGE, IMAGE).astype(np.float32),
            "label": rng.randint(0, CLASSES, (batch, 1)).astype(np.int64)}


def resnet_card_vs_cpu(main_p, loss, init, feed):
    """CHECK_STEPS steps on the card from the persistables ``init``, each
    replayed on the CPU's plain path from the card's state before it ->
    (largest loss difference, the velocities' largest norm-wise relative
    difference and the tensor where it is).  Each step starts both
    devices from one state, so the gaps are one step's f32 rounding:
    chained steps of a randomly initialised ResNet-50 part by far more
    (PERF.md §6)."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.core import (Executor, Scope, scope_from_numpy,
                                       scope_to_numpy)

    card, cpu = Executor(), Executor(framework.CPUPlace())
    sc = scope_from_numpy(Scope(), init, card.device, program=main_p)
    loss_gap, vel_gap, worst, losses = 0.0, 0.0, None, []
    t0 = time.perf_counter()
    for _ in range(CHECK_STEPS):
        state = scope_to_numpy(sc, main_p)
        got = float(card.run(main_p, feed=feed, fetch_list=[loss],
                             scope=sc)[0].reshape(-1)[0])
        sp = scope_from_numpy(Scope(), state, "cpu", program=main_p)
        want = float(cpu.run(main_p, feed=feed, fetch_list=[loss],
                             scope=sp)[0].reshape(-1)[0])
        losses.append((got, want))
        loss_gap = max(loss_gap, abs(got - want))
        for n in state:
            if "_velocity_" not in n:
                continue
            v = sp.find_var(n).get_tensor().numpy()
            rel = float(np.linalg.norm(sc.find_var(n).get_tensor().numpy()
                                       - v)) / max(float(np.linalg.norm(v)),
                                                   1e-30)
            if worst is None or rel > vel_gap:
                vel_gap, worst = rel, n
    print("train resnet: %d steps at batch %d, (card, CPU) losses %s (%.1f "
          "s)" % (CHECK_STEPS, len(feed["img"]), json.dumps(losses),
                  time.perf_counter() - t0), flush=True)
    return loss_gap, vel_gap, worst


def conv_train_phase(which):
    """ResNet-50 ``which`` trained TRAIN_STEPS Momentum steps at batch 32
    on one batch (the trunk under the flag) -> the launch counts."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.core import (Executor, Scope, scope_guard,
                                       scope_to_numpy)

    trunk = which == "trunk"
    with flag_set("FLAGS_use_pallas_conv_block", trunk):
        t0 = time.perf_counter()
        main_p, startup, _img, _label, loss = resnet_program(which, False)
        params = [v for v in main_p.list_vars()
                  if isinstance(v, framework.Parameter)]
        n_params = sum(int(np.prod(v.shape)) for v in params)
        print("train resnet [%s]: ResNet-50 v1.5, %dx%d, %d classes, batch "
              "%d; %d parameters in %d tensors; %d ops; built in %.1f s"
              % (which, IMAGE, IMAGE, CLASSES, TRAIN_BATCH, n_params,
                 len(params), len(main_p.global_block().ops),
                 time.perf_counter() - t0), flush=True)
        exe, scope = Executor(), Scope()
        with scope_guard(scope):
            exe.run(startup)
            init = scope_to_numpy(scope, main_p)
            feed = resnet_feed(np.random.RandomState(3), TRAIN_BATCH)
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            zero_counts()   # just before the main path runs
            losses, step_ms = [], []
            for _ in range(TRAIN_STEPS):
                t0 = time.perf_counter()
                out, = exe.run(main_p, feed=feed, fetch_list=[loss])
                step_ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(out.reshape(-1)[0]))
            launches = launch_counts()
        del scope
        ops = main_p.global_block().ops
        print("train resnet [%s]: %d steps, losses %s; step_ms %s, p50 %.3f "
              "(the first fuses the optimizer ops and plans); %d momentum + "
              "%d fused_momentum ops; peak %.2f GB; launches %s" % (
                  which, TRAIN_STEPS, json.dumps(losses),
                  json.dumps([round(x, 3) for x in step_ms]),
                  float(np.percentile(step_ms, 50)),
                  sum(op.type == "momentum" for op in ops),
                  sum(op.type == "fused_momentum" for op in ops),
                  torch.cuda.max_memory_allocated() / 1e9,
                  json.dumps({k: v for k, v in launches.items() if v})),
              flush=True)
        want = {k: 0 for k in launches}
        want["fused_momentum"] = TRAIN_STEPS
        if trunk:
            want["conv_stats"] = want["affine_act"] = \
                CONV_BN_PAIRS * TRAIN_STEPS
        if launches != want:
            fail("train resnet [%s] launches %s over %d steps, want %s"
                 % (which, launches, TRAIN_STEPS, want))
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            fail("train resnet [%s] losses %s: not finite, or the last is "
                 "not below the first" % (which, losses))
        feed2 = resnet_feed(np.random.RandomState(4), CHECK_BATCH)
        loss_gap, vel_gap, worst = resnet_card_vs_cpu(main_p, loss, init,
                                                      feed2)
    print("train resnet [%s]: card vs CPU plain path, each step from one "
          "state: max loss difference %.3g (limit %.3g); velocities' "
          "norm-wise gap %.3g (limit %.3g, worst %s)"
          % (which, loss_gap, RESNET_LOSS_ATOL, vel_gap,
             RESNET_VELOCITY_RTOL, worst), flush=True)
    if not (loss_gap <= RESNET_LOSS_ATOL
            and vel_gap <= RESNET_VELOCITY_RTOL):
        fail("train resnet [%s] on the card disagrees with the CPU plain "
             "path" % which)
    return {k: v for k, v in launches.items() if v}


# -- phases 9 and 10: DLRM training, the channel statistics -------------------

# DLRM (Naumov et al. 2019), the Criteo Terabyte configuration of
# facebookresearch/dlrm bench/run_and_time.sh: 26 categorical tables of
# width 128 (--arch-sparse-feature-size=128, rows capped at 40,000,000 as
# MLPerf caps Criteo 1TB), bottom MLP 13-512-256-128, top MLP
# 1024-1024-512-256-1, dot interaction without self pairs, BCE loss, SGD
# at lr 1.0; the bags take the multi-hot sizes of MLPerf Training's
# DLRM-DCNv2 Criteo multi-hot dataset (214 ids a sample).  Width 128 is
# exactly the embedding-bag kernel's eligibility (row 15: D % 128 == 0).
class DlrmConfig:
    def __init__(self, rows, bags, bottom, top, dim=128, dense=13,
                 shards=2):
        self.rows, self.bags = tuple(rows), tuple(bags)
        self.bottom, self.top = tuple(bottom), tuple(top)
        self.dim, self.dense, self.shards = dim, dense, shards


DLRM = DlrmConfig(
    rows=(40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 40000000,
          3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14, 40000000,
          40000000, 40000000, 590152, 12973, 108, 36),
    bags=(3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100,
          27, 10, 3, 1, 1),
    bottom=(512, 256, 128), top=(1024, 1024, 512, 256))
# the CPU tests' DLRM: 3 tables (one smaller than a batch's ids), narrow
# MLPs
DLRM_TINY = DlrmConfig(rows=(40, 7, 1000), bags=(3, 1, 5), bottom=(32, 128),
                       top=(64,))
DLRM_LR = 1.0
DLRM_BATCH = 2048
DLRM_CHECK_BATCH = 8
# DLRM, 3 SGD steps at batch 8, each from one state (dense parameters and
# table shards) on the card and on the plain path on the CPU, f32 with
# TF32 off: they differ by summation order (and the card's atomic
# scatter-add of the row gradients) only.  Losses (~0.69) absolutely; the
# pushed row gradients and the dense parameters after the step relative
# to each tensor's largest element.
DLRM_LOSS_ATOL = 1e-5
DLRM_RTOL = 1e-5
# rows 16 and 17's column sums against float64 sums of the same f32
# terms, held relative to the sum of the terms' magnitudes (the
# condition of the sum): f32 partials over a few thousand rows each
CHANNEL_STATS_RTOL = 1e-5


def tool(name):
    """The module of ``tools/<name>.py``, loaded from its path."""
    import importlib.util

    mod = sys.modules.get("_tool_" + name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            "_tool_" + name, os.path.join(HERE, "tools", name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules["_tool_" + name] = mod
    return mod


def dlrm_pairs(n):
    """Flat indices i n + j of the strictly lower pairs (i > j) of an
    n x n interaction, in DLRM's order (i, then j)."""
    return np.array([i * n + j for i in range(n) for j in range(i)],
                    np.int64)


def build_dlrm(pkg, emb_cls, clients, batch, cfg=DLRM, lr=DLRM_LR):
    """DLRM trained by SGD(lr) under the current ``program_guard``, in
    ``pkg`` (the module ``paddle_tpu`` or ``paddle_tpu_torch``) with its
    ``emb_cls`` (``DistributedEmbedding``), table t pulling through
    ``clients[t]`` -> (loss, the tables' embeddings).  Only public layers,
    so both packages build the same program.  Feeds: ``dense`` [B, 13],
    ``label`` [B, 1] f32, ``pairs`` (``dlrm_pairs``) and each table's
    rows and local ids (``prepare_feed_bags``)."""
    import importlib

    L = importlib.import_module(pkg.__name__ + ".layers")
    ParamAttr = importlib.import_module(pkg.__name__ + ".param_attr") \
        .ParamAttr
    Normal = importlib.import_module(pkg.__name__ + ".initializer").Normal
    SGD = importlib.import_module(pkg.__name__ + ".optimizer").SGD

    def mlp(x, n, sizes, last_relu):
        # DLRM's init: weights N(0, 2 / (m + n)), biases N(0, 1 / m)
        for i, m in enumerate(sizes):
            x = L.fc(x, m, act="relu" if last_relu or i < len(sizes) - 1
                     else None,
                     param_attr=ParamAttr(initializer=Normal(
                         0.0, float(np.sqrt(2.0 / (m + n))))),
                     bias_attr=ParamAttr(initializer=Normal(
                         0.0, float(np.sqrt(1.0 / m)))))
            n = m
        return x

    n_vec = 1 + len(cfg.rows)
    n_pairs = n_vec * (n_vec - 1) // 2
    dense = L.data("dense", shape=[batch, cfg.dense],
                   append_batch_size=False)
    label = L.data("label", shape=[batch, 1], append_batch_size=False)
    pairs = L.data("pairs", shape=[n_pairs], dtype="int64",
                   append_batch_size=False)
    x = mlp(dense, cfg.dense, cfg.bottom, True)
    embs, bags = [], []
    for t, (rows, k) in enumerate(zip(cfg.rows, cfg.bags)):
        emb = emb_cls("dlrm_t%d" % t, cfg.dim, client=clients[t])
        bags.append(emb.lookup_bag(batch, k, min(batch * k, rows)))
        embs.append(emb)
    t_ = L.reshape(L.concat([x] + bags, axis=1), [-1, n_vec, cfg.dim])
    z = L.reshape(L.matmul(t_, t_, transpose_y=True), [-1, n_vec * n_vec])
    z = L.transpose(L.gather(L.transpose(z, [1, 0]), pairs), [1, 0])
    logit = mlp(L.concat([x, z], axis=1), cfg.dim + n_pairs,
                cfg.top + (1,), False)
    loss = L.mean(L.sigmoid_cross_entropy_with_logits(logit, label))
    SGD(learning_rate=lr).minimize(loss)
    return loss, embs


def dlrm_tables(cfg=DLRM, lr=DLRM_LR, seed=0):
    """The port's in-process clients, table t in ``cfg.shards`` SGD
    shards with DLRM's uniform init range sqrt(1 / rows_t)."""
    from paddle_tpu_torch.distributed import (SparseTableClient,
                                              SparseTableShard)

    return [SparseTableClient("dlrm_t%d" % t, [
        SparseTableShard(cfg.dim, "sgd", lr, float(np.sqrt(1.0 / rows)),
                         seed=seed + cfg.shards * t + s)
        for s in range(cfg.shards)]) for t, rows in enumerate(cfg.rows)]


def dlrm_batch(rng, batch, cfg=DLRM):
    """(dense [B, 13] f32, label [B, 1] f32, per table [B, K_t] global
    ids drawn uniformly, repeats allowed)."""
    dense = rng.rand(batch, cfg.dense).astype(np.float32)
    label = rng.randint(0, 2, (batch, 1)).astype(np.float32)
    ids = [rng.randint(0, rows, (batch, k)).astype(np.int64)
           for rows, k in zip(cfg.rows, cfg.bags)]
    return dense, label, ids


def dlrm_step(exe, main_p, loss, embs, data, scope=None):
    """One step: pull every table's rows, run, push the row gradients ->
    (loss, the fetched row gradients, the pushed counts, (pull, run, push)
    host seconds)."""
    dense, label, ids = data
    t0 = time.perf_counter()
    feed = {"dense": dense, "label": label,
            "pairs": dlrm_pairs(len(embs) + 1)}
    infos = []
    for emb, bags in zip(embs, ids):
        f, info = emb.prepare_feed_bags(bags)
        feed.update(f)
        infos.append(info)
    t1 = time.perf_counter()
    outs = exe.run(main_p, feed=feed, scope=scope, fetch_list=[loss] + [
        emb.grad_var(main_p) for emb in embs])
    t2 = time.perf_counter()
    for emb, info, g in zip(embs, infos, outs[1:]):
        emb.push_grads(info, g)
    return (float(outs[0].reshape(-1)[0]), outs[1:],
            [info["n"] for info in infos],
            (t1 - t0, t2 - t1, time.perf_counter() - t2))


def dlrm_program(batch, cfg=DLRM, lr=DLRM_LR, seed=0):
    """(main, startup, loss, embeddings) of the port's DLRM at ``batch``
    over fresh tables."""
    import paddle_tpu_torch
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.distributed import DistributedEmbedding

    main_p, startup = framework.Program(), framework.Program()
    startup.random_seed = 17
    with framework.program_guard(main_p, startup):
        loss, embs = build_dlrm(paddle_tpu_torch, DistributedEmbedding,
                                dlrm_tables(cfg, lr, seed), batch, cfg, lr)
    return main_p, startup, loss, embs


def dlrm_card_vs_cpu(data):
    """CHECK_STEPS steps of DLRM at DLRM_CHECK_BATCH on the card, each
    replayed on the CPU's plain path from the card's state before it
    (dense persistables and every table shard) -> (largest loss gap,
    largest relative gap of the pushed row gradients and of the dense
    parameters, and where it is)."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.core import (Executor, Scope, scope_from_numpy,
                                       scope_to_numpy)
    from paddle_tpu_torch.distributed import SparseTableShard

    main_p, startup, loss, embs = dlrm_program(DLRM_CHECK_BATCH)
    card, cpu = Executor(), Executor(framework.CPUPlace())
    sc = Scope()
    card.run(startup, scope=sc)
    params = [v.name for v in main_p.list_vars()
              if isinstance(v, framework.Parameter)]
    loss_gap, gap, worst, losses = 0.0, 0.0, None, []
    t0 = time.perf_counter()
    for _ in range(CHECK_STEPS):
        state = scope_to_numpy(sc, main_p)
        shards = [[s.state() for s in e.client.shards] for e in embs]
        got, g_card, _n, _t = dlrm_step(card, main_p, loss, embs, data, sc)
        sp = scope_from_numpy(Scope(), state, "cpu", program=main_p)
        live = [e.client.shards for e in embs]
        for e, st in zip(embs, shards):
            e.client.shards = [SparseTableShard.from_state(s) for s in st]
        want, g_cpu, _n, _t = dlrm_step(cpu, main_p, loss, embs, data, sp)
        for e, sh in zip(embs, live):
            e.client.shards = sh     # the card's tables go on
        losses.append((got, want))
        loss_gap = max(loss_gap, abs(got - want))
        pairs = [("%s@GRAD" % e.rows_name, a, b)
                 for e, a, b in zip(embs, g_card, g_cpu)]
        pairs += [(n, sc.find_var(n).get_tensor().numpy(),
                   sp.find_var(n).get_tensor().numpy()) for n in params]
        for n, a, b in pairs:
            rel = float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                                   1e-30)
            if worst is None or rel > gap:
                gap, worst = rel, n
    print("train dlrm: %d steps at batch %d, (card, CPU) losses %s (%.1f s)"
          % (CHECK_STEPS, DLRM_CHECK_BATCH, json.dumps(losses),
             time.perf_counter() - t0), flush=True)
    return loss_gap, gap, worst


def dlrm_phase():
    """DLRM trained TRAIN_STEPS SGD steps at DLRM_BATCH on one batch under
    FLAGS_use_pallas_embedding_bag -> the launch counts."""
    from paddle_tpu_torch.core import Executor, Scope

    with flag_set("FLAGS_use_pallas_embedding_bag", True):
        t0 = time.perf_counter()
        main_p, startup, loss, embs = dlrm_program(DLRM_BATCH)
        from paddle_tpu_torch import framework

        ops = main_p.global_block().ops
        n_params = sum(int(np.prod(v.shape)) for v in main_p.list_vars()
                       if isinstance(v, framework.Parameter))
        print("train dlrm: DLRM, %d tables of width %d in %d shards each, "
              "bags %s (%d ids a sample), bottom 13-%s, top %s-1; batch %d; "
              "%d ops; %d dense parameters; built in %.1f s" % (
                  len(embs), DLRM.dim, DLRM.shards, list(DLRM.bags),
                  sum(DLRM.bags), "-".join(map(str, DLRM.bottom)),
                  "-".join(map(str, DLRM.top)), DLRM_BATCH, len(ops),
                  n_params, time.perf_counter() - t0), flush=True)
        exe, scope = Executor(), Scope()
        exe.run(startup, scope=scope)
        data = dlrm_batch(np.random.RandomState(3), DLRM_BATCH)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        zero_counts()   # just before the main path runs
        losses, step_ms, host = [], [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            lo, _g, pushed, t = dlrm_step(exe, main_p, loss, embs, data,
                                          scope)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(lo)
            host.append(t)
        launches = launch_counts()
        ops = main_p.global_block().ops
        n_fused = sum(op.type == "fused_sgd" for op in ops)
        n_sgd = sum(op.type == "sgd" for op in ops)
        pull, run, push = (1e3 * np.array(x) for x in zip(*host))
        print("train dlrm: %d steps, losses %s; step_ms %s, p50 %.3f (the "
              "first draws the touched rows and plans); pull ms p50 %.3f, "
              "Executor.run ms p50 %.3f, push ms p50 %.3f; rows pulled a "
              "step %d of %d padded; %d fused_sgd op(s) over %d params, %d "
              "sgd ops; peak %.2f GB; launches %s" % (
                  TRAIN_STEPS, json.dumps(losses),
                  json.dumps([round(x, 3) for x in step_ms]),
                  float(np.percentile(step_ms, 50)),
                  float(np.percentile(pull, 50)),
                  float(np.percentile(run, 50)),
                  float(np.percentile(push, 50)), sum(pushed),
                  sum(e.max_rows for e in embs), n_fused,
                  sum(len(op.input("Param")) for op in ops
                      if op.type == "fused_sgd"), n_sgd,
                  torch.cuda.max_memory_allocated() / 1e9,
                  json.dumps({k: v for k, v in launches.items() if v})),
              flush=True)
        want = {k: 0 for k in launches}
        want["embedding_bag"] = len(embs) * TRAIN_STEPS
        if launches != want:
            fail("train dlrm launches %s over %d steps, want %s"
                 % (launches, TRAIN_STEPS, want))
        if n_fused != 1 or n_sgd:
            fail("train dlrm: %d fused_sgd and %d sgd ops, want one group"
                 % (n_fused, n_sgd))
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            fail("train dlrm losses %s: not finite, or the last is not "
                 "below the first" % losses)
        del scope
        loss_gap, gap, worst = dlrm_card_vs_cpu(
            dlrm_batch(np.random.RandomState(4), DLRM_CHECK_BATCH))
    print("train dlrm: card vs CPU plain path, each step from one state: "
          "max loss difference %.3g (limit %.3g); row gradients' and dense "
          "parameters' gap %.3g of their largest element (limit %.3g, "
          "worst %s)" % (loss_gap, DLRM_LOSS_ATOL, gap, DLRM_RTOL, worst),
          flush=True)
    if not (loss_gap <= DLRM_LOSS_ATOL and gap <= DLRM_RTOL):
        fail("train dlrm on the card disagrees with the CPU plain path")
    return {k: v for k, v in launches.items() if v}


def bag_case(rng, b, k, u, d, pad, dev):
    """rows [u, d] ~ N(0, 1) and ids [b, k] in [0, u), each bag's tail
    -1-padded to a random length with probability ``pad`` (1: all pads)."""
    rows = torch.from_numpy(rng.randn(u, d).astype(np.float32)).to(dev)
    ids = rng.randint(0, u, (b, k)).astype(np.int64)
    if pad:
        keep = np.where(rng.rand(b) < pad, rng.randint(0, k, b), k)
        ids[np.arange(k)[None, :] >= keep[:, None]] = -1
    return rows, torch.from_numpy(ids).to(dev)


# (what, B, K, U, D, pad): DLRM's largest bag (table 20, K 100, its
# batch_ids_max), then ragged, all-pad and D 256 cases
BAG_CASES = [
    ("DLRM's largest bag: B 2048, K 100, U 204800, D 128", 2048, 100,
     204800, 128, 0.0),
    ("ragged: B 37, K 13, U 500, D 128", 37, 13, 500, 128, 0.6),
    ("all pads: B 16, K 5, U 8, D 128", 16, 5, 8, 128, 1.0),
    ("D 256, ragged: B 300, K 7, U 1000", 300, 7, 1000, 256, 0.5),
]


def bag_kernel_phase(eb, dev, flush):
    """Row 15 bitwise equal to its plain version at BAG_CASES, then timed
    at DLRM's largest bag beside F.embedding_bag over the compacted ids
    (the compaction outside the timing) and the bytes bound."""
    rng = np.random.RandomState(15)
    kept = None
    for what, b, k, u, d, pad in BAG_CASES:
        rows, ids = bag_case(rng, b, k, u, d, pad, dev)
        got = eb.embedding_bag(rows, ids)
        torch.cuda.synchronize()
        if not torch.equal(got, eb.embedding_bag_reference(rows, ids)):
            fail("embedding_bag not bitwise equal to the plain version at %s"
                 % what)
        print("kernel embedding_bag %s: bitwise equal to the plain version"
              % what, flush=True)
        if kept is None:
            kept = (rows, ids)
    rows, ids = kept
    valid = ids >= 0
    flat = ids[valid]
    offsets = torch.cumsum(valid.sum(1), 0) - valid.sum(1)
    b, d = ids.shape[0], rows.shape[1]
    row = timed_row(
        "embedding_bag", lambda: eb.embedding_bag(rows, ids),
        lambda: eb.embedding_bag_reference(rows, ids),
        lambda: torch.nn.functional.embedding_bag(flat, rows, offsets,
                                                  mode="sum"),
        int(flat.numel()) * d * 4 + ids.numel() * 8 + b * d * 4, 0, flush,
        0.0, "%s (F.embedding_bag over the compacted ids, mode sum)"
        % BAG_CASES[0][0])
    row.update(source="paddle_tpu_torch/kernels/csrc/embedding_bag.cu",
               replaces="paddle_tpu/pallas_kernels/embedding_bag.py:75")
    return row


def channel_stats_kernel_phase(cst, dev, flush):
    """Rows 16 and 17 at the microbenchmark's two shapes against plain
    versions run in float64 (y of row 17 bitwise), then timed beside
    their plain versions, torch's own passes and the bytes bounds."""
    SHAPES = tool("torch_bench_reduce").SHAPES
    g = torch.Generator(device=dev)
    g.manual_seed(16)
    rows = {}
    for sname, (m, c) in SHAPES.items():
        x = torch.randn((m, c), generator=g, device=dev).to(torch.bfloat16)
        cv = torch.full((1, 1), 0.25, device=dev)
        a = 1.0 + 0.1 * torch.randn((1, c), generator=g, device=dev)
        b = 0.1 * torch.randn((1, c), generator=g, device=dev)
        what = "[%d, %d] bf16 (%s, %.0f MB)" % (m, c, sname, m * c * 2 / 1e6)
        s, ss = cst.stats(x, cv)
        xd = x.double() + cv.double().reshape(())
        err16 = max(float(((s - xd.sum(0)).abs() / xd.abs().sum(0)).max()),
                    float(((ss - (xd * xd).sum(0)).abs()
                           / (xd * xd).sum(0)).max()))
        abs16 = max(float((s - xd.sum(0)).abs().max()),
                    float((ss - (xd * xd).sum(0)).abs().max()))
        del xd
        y, s2, ss2 = cst.affine_stats(x, a, b)
        y32 = x.float() * a.reshape(-1) + b.reshape(-1)
        if not torch.equal(y, y32.to(torch.bfloat16)):
            fail("affine_stats y not bitwise the plain version's at %s"
                 % what)
        yd = y32.double()
        err17 = max(float(((s2 - yd.sum(0)).abs() / yd.abs().sum(0)).max()),
                    float(((ss2 - (yd * yd).sum(0)).abs()
                           / (yd * yd).sum(0)).max()))
        abs17 = max(float((s2 - yd.sum(0)).abs().max()),
                    float((ss2 - (yd * yd).sum(0)).abs().max()))
        del yd, y32
        print("kernel channel_stats %s: sums vs float64, max |err| %.3g, "
              "relative to the sum of |terms| %.3g (limit %g); "
              "affine_stats: y bitwise, sums max |err| %.3g, relative %.3g"
              % (what, abs16, err16, CHANNEL_STATS_RTOL, abs17, err17),
              flush=True)
        if not (err16 <= CHANNEL_STATS_RTOL and err17 <= CHANNEL_STATS_RTOL):
            fail("channel statistics disagree with float64 at %s" % what)
        nb = m * c * 2

        def lib16():
            xf = x.float().add(cv.reshape(()))
            return xf.sum(0), xf.square().sum(0)

        def lib17():
            yf = torch.addcmul(b, x.float(), a)
            return yf.to(torch.bfloat16), yf.sum(0), yf.square().sum(0)

        r16 = timed_row(
            "channel_stats", lambda: cst.stats(x, cv),
            lambda: cst.stats_reference(x, cv), lib16, nb + 8 * c + 4,
            4 * m * c, flush, abs16, "%s (torch: x.float().add(c), .sum(0) "
            "and .square().sum(0), several calls)" % what)
        r17 = timed_row(
            "affine_stats", lambda: cst.affine_stats(x, a, b),
            lambda: cst.affine_stats_reference(x, a, b), lib17,
            2 * nb + 16 * c, 6 * m * c, flush, abs17,
            "%s (torch: addcmul, the bf16 cast and the two sums, several "
            "calls)" % what)
        rows.setdefault("channel_stats", r16)
        rows.setdefault("affine_stats", r17)
        del x, y
    rows["channel_stats"].update(
        source="paddle_tpu_torch/kernels/csrc/channel_stats.cu",
        replaces="tools/bench_reduce_pallas.py:72")
    rows["affine_stats"].update(
        source="paddle_tpu_torch/kernels/csrc/channel_stats.cu",
        replaces="tools/bench_reduce_pallas.py:112")
    return [rows["channel_stats"], rows["affine_stats"]]


def reduce_tool_phase():
    """The port's counterpart of the reduction microbenchmark
    (tools/torch_bench_reduce.py), all variants at REP 4 (and the one
    warm-up pass each) -> the launch counts of rows 16 and 17."""
    torch_bench_reduce = tool("torch_bench_reduce")
    torch.cuda.synchronize()
    zero_counts()   # just before the tool runs
    torch_bench_reduce.run(rep=4)
    torch.cuda.synchronize()
    launches = launch_counts()
    want = {k: 0 for k in launches}
    want["channel_stats"] = want["affine_stats"] = \
        (4 + 1) * len(torch_bench_reduce.SHAPES)
    if launches != want:
        fail("the reduction tool launched %s, want %s" % (launches, want))
    return {k: v for k, v in launches.items() if v}


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs the port on the card")
    if not os.path.isdir(os.path.join(HERE, "paddle_tpu_torch")):
        fail("no paddle_tpu_torch/ beside chip_smoke.py: run it from a "
             "checkout of the repository")
    sys.path.insert(0, HERE)
    from paddle_tpu_torch import set_f32_numerics
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import channel_stats as cst
    from paddle_tpu_torch.kernels import conv_block as cb
    from paddle_tpu_torch.kernels import dropout as dk
    from paddle_tpu_torch.kernels import embedding_bag as eb
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_adam as fad
    from paddle_tpu_torch.kernels import fused_ln as fl
    from paddle_tpu_torch.kernels import fused_momentum as fm
    from paddle_tpu_torch.kernels import layer_norm as ln
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.kernels import philox
    from paddle_tpu_torch.models.bert import BertConfig

    dev = torch.device("cuda")
    set_f32_numerics()
    print(card_line(), flush=True)      # name, power limit
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)),
          flush=True)

    t0 = time.perf_counter()
    _build.build_all()
    print("build: %d CUDA sources for sm_90a in %.2f s"
          % (len(_build.SOURCES), time.perf_counter() - t0), flush=True)
    for name, info in _build.BUILD_INFO.items():
        usage = [line.strip() for line in info["ptxas"].splitlines()
                 if "registers" in line or "spill" in line
                 or "entry function" in line]
        print("build %s: %.2f s%s" % (name, info["seconds"],
                                      " (cached)" if info["cached"] else ""))
        for line in usage:
            print("  ptxas " + line)

    # BERT-base widths (Devlin et al. 2018) at its published dropout 0.1
    bert_cfg = BertConfig()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    rows = [paged_kernel_phase(pa, dev, flush),
            flash_kernel_phase(fa, dev, flush)]
    rows.append(flash_bwd_kernel_phase(fa, dev, flush))
    rows += small_attention_kernel_phase(fa, philox, dev, flush)
    rows += ln_kernel_phase(fl, ln, philox, dev, flush)
    rows.append(ln_bwd_kernel_phase(fl, dev, flush))
    rows.append(adam_kernel_phase(fad, dev, flush, bert_cfg))
    rows.append(dropout_kernel_phase(dk, philox, dev, flush))
    rows.append(momentum_kernel_phase(fm, dev, flush))
    rows += conv_kernel_phase(cb, dev, flush)
    rows.append(bag_kernel_phase(eb, dev, flush))
    rows += channel_stats_kernel_phase(cst, dev, flush)
    del flush
    torch.cuda.empty_cache()
    # each path is driven with the counts at 0 and read just after; a
    # kernel's row carries the newest path that launches it
    launches = {"paged_attention": decode_phase(pa)}
    launches.update(encoder_phase((fa, fl, ln)))
    for name, dropout in ((DROPOUT0, 0.0), (COMPOSED, 0.1), (SMALL, 0.1)):
        with emission(name):
            counts = train_phase(BertConfig(dropout=dropout), name)
        launches.update({k: v for k, v in counts.items() if v})
    for which in ("bundled", "trunk"):
        launches.update(conv_serve_phase(which))
    for which in ("bundled", "trunk"):
        launches.update(conv_train_phase(which))
    launches.update(dlrm_phase())
    launches.update(reduce_tool_phase())
    for row in rows:
        row["launches"] = launches[row["name"]]
    print("smoke: %.1f s from start to the result, the build included"
          % (time.perf_counter() - t_start), flush=True)
    print(json.dumps({"kernels": [{k: row[k] for k in KEYS}
                                  for row in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
