#!/usr/bin/env python3
"""Drive the PyTorch port (``paddle_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (nonzero exit, no result line):

1. the card: name and power limit from nvidia-smi;
2. the build: every CUDA source of the port compiled with nvcc for
   sm_90a (all started together), with seconds and ptxas usage;
3. the kernels: each kernel against its plain PyTorch version on the card
   at its main-path shape and others (the fused Adam and the fused
   momentum bitwise, with and without their bf16 copy, the momentum also
   over members at odd offsets of one buffer and over a group split into
   several launches, as many as planned; the conv-block
   kernels at ResNet-50's shapes and odd ones, the fold of the batch
   statistics and the affine pass bitwise, both timed at the trunk's 23
   conv shapes and added up over its 53 convs; the fused LayerNorm at
   encoder buckets 1, 8 and 32, an odd width and a misaligned x, its
   keep mask bitwise and re-drawn by the backward;
   the embedding bag bitwise at DLRM's largest bag and ragged, all-pad
   and D = 256 cases; the channel statistics against float64 sums; the
   flash forward at each of its CTA shapes; the fused flash backward's
   and the small backward's dQ bitwise over two runs at two key tiles;
   the dropout kernel's mask bytes bitwise, its keep fraction within 5
   sigma; the dropout paths at p = 0.1, where one flipped keep bit
   would move an output by about prob / q; the bf16 AMP policy's
   kernels: the dropout's bf16 instantiation bitwise, row 14's within
   one bf16 ulp of y of its plain version in the kernel's order, rows 9
   and 10's bf16 copies of the carried members bitwise the cast of the
   new params), then timed
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
5b. serving over the wire: the same decode and encoder engines behind one
   ServingServer, three client threads in process and then over the
   port's RPC transport (tracing off, a telemetry directory set and left
   empty), an abandoned stream's KV blocks returned, then the wire mix
   again with FLAGS_tracing on, its launches held and its rates printed
   beside the untraced ones;
5c. a serving fleet: two ``tools/torch_serve.py`` replicas on the card
   (GPT-2 small as a decoder bundle, BERT-base, and a BERT-base of another
   seed as ``bert@v2``), heartbeating over one endpoints file; the wire
   mix through ServingClients of the file (tokens, chunks, outputs and the
   replicas' summed ``__metrics__`` checked, the coordinator's
   ``__fleet__`` listing both), a canary rollout whose split must be
   exactly the route hash's and whose flip must reach both replicas
   within 2 s, the mix again with rank 1 SIGKILLed after four generates
   (nothing dropped, the file shrunk within the heartbeat timeout + 5 s),
   rank 1 relaunched (rejoining, its routes converged), and both retired,
   the survivor's LAUNCHES holding rows 1, 2, 7 and 14 in whole steps and
   batches; all of it traced: the killed replica's flight record must name
   a request in flight at the kill, and a generate's and an infer's
   trace ids must run from the client's root span to the replica's
   decode step, or batch, execute and executor step;
5d. faults and the autoscaler, two more replicas started together: one
   under FLAGS_fault_spec (the first two encoder batches fail with the
   reference's error, the client's injected RPC drops and reply losses
   are retried with nothing dropped, and the decode loop's kill point
   SIGKILLs it after step 20, its flight record naming the step and the
   request); and rank 0 of a two-slot fleet with --autoscale, where a
   burst of 16 client threads forks a standby into slot 1 on the card,
   the standby serves (its LAUNCHES equal to its batches) and is
   retired through a drain when the burst ends, nothing dropped;
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
6b. BERT-base under the bf16 AMP policy (``decorate(Adam(1e-4))``,
   dropout 0.1, the default emission, batch 32, 5 steps): 12 bf16
   dropouts, 1 bf16 LayerNorm and 1 fused Adam writing the 74 carried
   weights' copies a step, every copy bitwise its master's cast after
   each step, host ms and busy beside the f32 twin's from the same
   state, and 3 chained steps at batch 2 from one state within
   AMP_BERT_LOSS_ATOL of the CPU's plain path;
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
   a step, the trunk's conv-with-statistics, statistics-fold and affine +
   relu kernels 53 times a step each, the last loss below the first, and
   3 steps at
   batch 2, each from one state on the card and on the CPU's plain path,
   with the same losses and velocities;
8b. ResNet-50 under the policy: the bundled ``build_train(amp=True)`` at
   batch 32 for 5 steps (the fused momentum once a step; no weight
   carried, since L2Decay reads them all), beside its f32 twin; 3 steps
   at batch 32, each from one state on the card and on the CPU's plain
   path, losses within AMP_RESNET_LOSS_RTOL; one step op by op (the
   backward, the casts and the fused momentum included), each op on the
   card fed the CPU's inputs, every output in the CPU's dtype and within
   AMP_RESNET_OP_RTOL of its largest value, the max pool's grad
   bitwise; the same step replayed on the card, the backward on the card
   with the bf16 products' forward outputs and input grads taken from the
   CPU, every velocity within AMP_VELOCITY_RTOL of the CPU's, three
   planted faults (the decay dropped from one conv weight's grad,
   momentum 0.89, one grad scaled by 1 + 2^-7) each failing it; and the
   same net under
   Momentum without decay, 54 weights carried, row 10 writing the fc
   weight's copy once a step;
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
import socket
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

# the bf16 AMP policy: the bf16 dropout kernel bitwise its plain version;
# row 14 in bf16 to LN_BF16_Y_ULPS bf16 ulp of y of its plain version in
# the kernel's order (``layer_norm_2d_bf16_kernel_order``: the same lanes,
# folds, butterflies and fused multiply-adds, which the kernel spells out
# in round-to-nearest intrinsics), so only rsqrt and the final rounding
# may differ, at every element, a y that its final add cancels included;
# the plain version with gamma, (x - mean) rstd or beta rounded to bf16
# must miss that limit (453-473 bf16 ulps read on an H100, where the add
# cancels; the kernel read 0, bitwise, at all four shapes); and
# to LN_BF16_STATS_RTOL of the f32 statistics' largest value against the
# unordered plain version (two f32 summation orders); rows 9 and 10's bf16
# copies bitwise p_new.to(bfloat16).  Card vs CPU, both rounding every
# product to bf16 (f32 sums): BERT-base losses within AMP_BERT_LOSS_ATOL
# at each compared step; ResNet-50 at batch 32: CHECK_STEPS steps each
# from one state, losses within AMP_RESNET_LOSS_RTOL, and one step op by
# op, each op on the card fed the CPU's inputs, every output in the CPU's
# dtype (an op that left the policy shows) and within one bf16 ulp of its
# largest value (2^-7 of it: a bf16 rounding that flips moves an element
# by at most that much; 0.0058 read on an H100).
LN_BF16_Y_ULPS = 1
LN_BF16_STATS_RTOL = 1e-6
AMP_BERT_LOSS_ATOL = 1e-2
AMP_RESNET_LOSS_RTOL = 1e-2
AMP_RESNET_OP_RTOL = 2 ** -7
# ResNet-50 under AMP, the velocities after one step replayed on the card
# from one state (the card's after CHECK_STEPS - 1 steps, velocities not
# zero).  Chained steps part by near-tie bf16 roundings that the net's
# backward amplifies (1.13 norm-wise at a conv weight, 1.47 at a batch
# norm, the f32 twin's 1.38); with the bf16 products' forward outputs
# alone from the CPU (``AMP_REPLAYS["forward products"]``, printed and not
# held) they still read 0.0696 and 0.251, past what any planted fault
# adds.  So the held replay (``AMP_REPLAYS["held"]``) runs the backward on
# the card with each bf16 product pinned where the chain carries it on:
# the convs' and the fc's forward outputs and input grads from the CPU,
# their weight grads the card's own from the CPU's inputs; batch norms,
# relus, the max pool, adds, the loss, the decay and the momentum update
# chained on the card.  Then a weight's velocity reads the card's bf16
# weight grad (a rounding off at 0.002-0.48% of elements, 2^-8 of each:
# norm-wise 3e-4 at most) through the card's decay, cast and momentum; a
# batch norm's, f32 sums in another order over the CPU's cotangents (the
# max pool's grad adds in the CPU's order, bitwise: 1e-5 at most).  One
# limit, AMP_VELOCITY_RTOL, norm-wise relative to the CPU's, for every
# velocity: 6.7x the conv bound, 2.4x under the smallest planted fault.
# Planted faults must each fail it: the decay term dropped from one conv
# weight's gradient, momentum 0.89 for 0.9, and one conv weight's
# gradient scaled by 1 + 2^-7 (2^-7 of a gradient is 0.0078 of it, 0.01
# of a velocity 0.005-0.011 of the next; read 0.0101, 0.00873 and
# 0.00473 at the conv and fc weights with every product from the CPU).
# The probes' conv weight is the one whose decay term weighs most in its
# velocity.  Readings on an H100.
AMP_REPLAYS = {
    "held": {"conv2d": "cpu", "mul": "cpu",
             "conv2d_grad": {"X@Input": "cpu", "X@Filter": "isolated"},
             "mul_grad": {"X@X": "cpu", "X@Y": "isolated"}},
    "forward products": {"conv2d": "cpu", "mul": "cpu"},
}
AMP_VELOCITY_RTOL = 2e-3

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
    """Row 1 against its plain version: the timed decode shape, lens on
    each side of a chunk boundary of the split kernel, full tables, a
    table of one block, and the head widths of each load path (float4 at
    D = 40, 64, 128, 256; scalar at D = 30); two calls at the timed shape
    give the same bits."""
    rng = np.random.RandomState(0)
    ck = pa.CHUNK
    cases = {
        "decode B=8 H=12 D=64 bs=16 MAXB=64": paged_case(
            rng, 8, 12, 64, 16, 64,
            rng.permutation([1, 15, 16, 17, 300, 511, 1023, 1024]), dev),
        "B=4 H=8 D=128 bs=16 MAXB=32": paged_case(
            rng, 4, 8, 128, 16, 32, [1, 77, 256, 512], dev),
        "odd B=4 H=3 D=40 bs=5 MAXB=7 with an idle lane": paged_case(
            rng, 4, 3, 40, 5, 7, [1, 7, 33, 0], dev),
        "lens = MAXB x bs, B=8 H=12 D=64 bs=16 MAXB=64": paged_case(
            rng, 8, 12, 64, 16, 64, [1024] * 8, dev),
        "a table of one block, B=8 H=12 D=64 bs=16 MAXB=1": paged_case(
            rng, 8, 12, 64, 16, 1, [16, 1, 9, 16, 0, 3, 16, 2], dev),
        "scalar loads B=3 H=2 D=30 bs=7 MAXB=40": paged_case(
            rng, 3, 2, 30, 7, 40, [1, ck + 2, 280], dev),
        "B=2 H=4 D=256 bs=16 MAXB=16": paged_case(
            rng, 2, 4, 256, 16, 16, [200, 256], dev),
    }
    for n in (ck - 1, ck, ck + 1):
        cases["uniform lens %d (chunk %d), B=8 H=12 D=64 bs=16 MAXB=64"
              % (n, ck)] = paged_case(rng, 8, 12, 64, 16, 64, [n] * 8, dev)
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
    if not torch.equal(pa.paged_attention(*args), pa.paged_attention(*args)):
        fail("paged_attention: two calls at the decode shape differ")
    print("kernel paged_attention: two calls at the decode shape give the "
          "same bits", flush=True)
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


def ln_mask_check(fl, like, g, seed_t, what):
    """Row 7's keep mask at p = 0.1 bitwise the plain version's: at x = 0,
    y = 1 its r is inv_q where kept and 0 where dropped, in both (``like``
    gives the shape and the storage offset of x and y)."""
    zeros = torch.zeros_like(like) if like.data_ptr() % 16 == 0 else \
        torch.zeros(like.numel() + 1, device=like.device)[1:].view(
            like.shape)
    ones = zeros + 1.0
    b = torch.zeros_like(g)
    got = fl.fused_ln_fwd(zeros, ones, g, b, 0.1, WORDS, 1e-5,
                          seed_out=seed_t)[1]
    want = fl.fused_ln_reference(zeros, ones, g, b, 1e-5, 0.1, WORDS)[1]
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail("fused_ln keep mask differs from the plain version's at %s"
             % what)
    print("kernel fused_ln %s p=0.1: keep mask bitwise the plain "
          "version's (keep fraction %.6f)"
          % (what, float((got != 0).float().mean())), flush=True)


def ln_kernel_phase(fl, ln, philox, dev, flush):
    """Rows 7 and 14: fused_ln at p = 0 and p = 0.1 on its float4 path
    (encoder buckets 1 and 8, the training step's [4096, 768]), its
    scalar path ([37, 200]) and its fallback for a misaligned x; the keep
    mask bitwise the plain version's, and row 8 re-drawing it from the
    Seed the forward stored; LayerNorm.  The kernels line takes fused_ln
    at p = 0.1 over the training step's [4096, 768] rows; its p = 0 times
    print beside it."""
    rng = np.random.RandomState(2)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    ln_f = torch.nn.functional.layer_norm
    drop_f = torch.nn.functional.dropout
    worst_f = worst_l = 0.0
    shapes = {(128, 768): "encoder bucket 1 rows [128, 768]",
              (1024, 768): "BERT rows [1024, 768]",
              (4096, 768): "training rows [4096, 768]",
              (37, 200): "scalar path [37, 200]",
              (64, 768, 1): "misaligned x [64, 768] (the rows fallback)"}
    tensors = {}
    seed_t = torch.empty(2, dtype=torch.int32, device=dev)
    for key, what in shapes.items():
        n, hd = key[:2]
        x, y, g, b, dz = (t(_rand(rng, *s)) for s in (
            (n, hd), (n, hd), (hd,), (hd,), (n, hd)))
        if len(key) == 3:       # x one float past a 16-byte boundary
            x = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(n, hd)
        tensors[n, hd] = (x, y, g, b)
        worst_f = max(worst_f, check(
            "fused_ln", what + " p=0",
            fl.fused_ln_fwd(x, y, g, b, 0.0, None, 1e-5),
            fl.fused_ln_reference(x, y, g, b, 1e-5)))
        got = fl.fused_ln_fwd(x, y, g, b, 0.1, WORDS, 1e-5, seed_out=seed_t)
        worst_f = max(worst_f, check(
            "fused_ln", what + " p=0.1", got,
            fl.fused_ln_reference(x, y, g, b, 1e-5, 0.1, WORDS)))
        if philox.seed_words(seed_t) != WORDS:
            fail("fused_ln stored seed words %s, want %s"
                 % (philox.seed_words(seed_t), WORDS))
        ln_mask_check(fl, x, g, seed_t, what)
        # row 8 re-draws the forward's mask from the stored Seed
        ln_bwd_repeat_and_mask(fl, philox, got[1], g, got[2], got[3], dz,
                               seed_t)
        worst_l = max(worst_l, check(
            "layer_norm", what, ln.layer_norm_2d(x, g, b, 1e-5),
            ln.layer_norm_2d_reference(x, g, b, 1e-5)))
    rows = []
    for n_rows in (128, 1024, 4096):    # p = 0: printed beside the row
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
    # the kernels line takes [1024, 768] (an encoder batch of 8); [4096,
    # 768] (bucket 32, the training step's embeddings) prints beside it
    ln_timed = []
    for n_rows in (1024, 4096):
        x, y, g, b = tensors[n_rows, 768]
        n, hd = x.shape
        ln_timed.append(timed_row(
            "layer_norm", lambda: ln.layer_norm_2d(x, g, b, 1e-5),
            lambda: ln.layer_norm_2d_reference(x, g, b, 1e-5),
            lambda: ln_f(x, (hd,), g, b, 1e-5),
            4 * (2 * n * hd + 2 * hd + 2 * n), 8 * n * hd, flush, worst_l,
            "rows [%d, 768] (F.layer_norm)" % n))
    row = ln_timed[0]
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


def _ulp(t, bits):
    """The spacing of a float with ``bits`` stored mantissa bits at |t|."""
    return torch.exp2(torch.floor(torch.log2(t.clamp_min(2.0 ** -126)))
                      - bits)


def bf16_ulps(got, want):
    """The largest |got - want| of two bf16 tensors in bf16 ulps of the
    larger of the two at that element."""
    d = (got.float() - want.float()).abs()
    ulp_y = _ulp(torch.maximum(got.float().abs(), want.float().abs()), 7)
    return float((d / ulp_y).max())


def ln_bf16_faults(ln, x, g, b, eps, want):
    """Row 14's plain version with one operand rounded to bf16 (gamma,
    (x - mean) rstd, beta) -> each one's ``bf16_ulps`` from ``want``."""
    _y, mean, var = ln.layer_norm_2d_reference(x, g, b, eps)
    xf = x.float()
    c = xf - mean[:, None]
    r = torch.rsqrt(var[:, None] + eps)
    rb = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    faults = (c * r * rb(g) + b, rb(c * r) * g + b, c * r * g + rb(b))
    return [bf16_ulps(f.to(torch.bfloat16), want) for f in faults]


def amp_kernel_phase(dk, ln, fad, fm, dev, flush, cfg):
    """The bf16 AMP policy's kernels, each beside its f32 self in the same
    run: the dropout kernel's bf16 instantiation (bitwise its plain
    version, mask and out, at the attention probabilities' shape and an
    odd unaligned one); row 14's (LN_BF16_Y_ULPS of y from its plain
    version in the kernel's order, LN_BF16_STATS_RTOL of the statistics,
    at the MLM head's [614, 768], [4096, 768], [64, 200] and [16, 1200],
    the last on its scalar kernel); rows 9 and 10 writing the carry's bf16
    copies of the members the AMP paths carry (BERT-base's product
    weights; the fc weight of ResNet-50's fused group), bitwise
    ``p_new.to(bfloat16)``; each timed against its f32 launch, its plain
    version and the library call on the same tensors."""
    from paddle_tpu_torch.ops.common import (byte_threshold,
                                             realized_keep_prob,
                                             realized_prob)

    rows = []
    rng = np.random.RandomState(15)
    bf16 = torch.bfloat16
    thr, q = byte_threshold(0.9), realized_keep_prob(0.9)
    probs = torch.from_numpy(rng.rand(32, 12, 128, 128).astype(
        np.float32)).to(dev).to(bf16)
    odd = torch.from_numpy(_rand(rng, 1002)).to(dev).to(bf16)[1:]
    for what, x in (("attention probs [32, 12, 128, 128]", probs),
                    ("odd 1001 elements at an unaligned offset", odd)):
        for upscale in (True, False):
            out, mask = dk.dropout(x, WORDS, thr, q, upscale)
            wout, wmask = dk.dropout_reference(x, WORDS, thr, q, upscale)
            torch.cuda.synchronize()
            if out.dtype != bf16 or not torch.equal(mask, wmask) \
                    or not torch.equal(out, wout):
                fail("bf16 dropout not bitwise its plain version at %s"
                     % what)
        qr = realized_prob(0.9)
        frac = float(mask.float().mean())
        sigma = (qr * (1 - qr) / x.numel()) ** 0.5
        if abs(frac - qr) > KEEP_SIGMAS * sigma:
            fail("bf16 dropout keep fraction %.6f at %s" % (frac, what))
        print("kernel dropout (bf16) %s: mask and out bitwise equal to the "
              "plain version; keep fraction %.6f (%.2f sigma)"
              % (what, frac, abs(frac - qr) / sigma), flush=True)
    n = probs.numel()
    f32 = probs.float()
    f32_ms = time_cold(lambda: dk.dropout(f32, WORDS, thr, q, True), flush)
    row = timed_row(
        "dropout (bf16)", lambda: dk.dropout(probs, WORDS, thr, q, True),
        lambda: dk.dropout_reference(probs, WORDS, thr, q, True),
        lambda: torch.nn.functional.dropout(probs, 0.1), 5 * n, n, flush,
        0.0, "attention probs [32, 12, 128, 128] bf16 at p = 0.1 "
        "(F.dropout on the bf16 tensor; the f32 kernel in this run %.6f)"
        % f32_ms)
    row.update(source="paddle_tpu_torch/kernels/csrc/dropout.cu",
               replaces="paddle_tpu/ops/nn.py:602")
    rows.append(row)

    ln_f = torch.nn.functional.layer_norm
    worst = 0.0
    ln_timed = {}
    for n_rows, h in ((614, 768), (4096, 768), (64, 200), (16, 1200)):
        x = torch.from_numpy(_rand(rng, n_rows, h)).to(dev).to(bf16)
        g = torch.from_numpy(_rand(rng, h) + 1.0).to(dev)
        b = torch.from_numpy(_rand(rng, h)).to(dev)
        got = ln.layer_norm_2d(x, g, b, 1e-5)
        want = ln.layer_norm_2d_reference(x, g, b, 1e-5)
        order = ln.layer_norm_2d_bf16_kernel_order(x, g, b, 1e-5)
        torch.cuda.synchronize()
        ulps = bf16_ulps(got[0], order[0])
        loose = bf16_ulps(got[0], want[0])
        stats = max(float((gs - ws).abs().max())
                    / max(float(ws.abs().max()), 1e-30)
                    for gs, ws in zip(got[1:], want[1:]))
        worst = max(worst, float((got[0].float() - want[0].float())
                                 .abs().max()))
        print("kernel layer_norm (bf16) [%d, %d] (%s kernel): y %.3g bf16 "
              "ulps of y from the plain version in the kernel's order "
              "(limit %g), %d elements differ; %.3g from the unordered "
              "plain version; statistics %.3g of their largest value "
              "(limit %g)"
              % (n_rows, h, "16-byte" if ln.bf16_vec_ok(x, g, b)
                 else "scalar", ulps, LN_BF16_Y_ULPS,
                 int((got[0] != order[0]).sum()), loose, stats,
                 LN_BF16_STATS_RTOL), flush=True)
        if got[0].dtype != bf16 or not ulps <= LN_BF16_Y_ULPS \
                or stats > LN_BF16_STATS_RTOL \
                or not torch.isfinite(got[0].float()).all():
            fail("bf16 layer_norm disagrees with its plain version at "
                 "[%d, %d]" % (n_rows, h))
        if n_rows == 614:
            faults = ln_bf16_faults(ln, x, g, b, 1e-5, order[0])
            print("kernel layer_norm (bf16) [614, 768]: the plain version "
                  "with gamma, (x - mean) rstd or beta rounded to bf16 is "
                  "%s bf16 ulps of y from the plain version in the "
                  "kernel's order" % json.dumps(faults), flush=True)
            if min(faults) <= LN_BF16_Y_ULPS:
                fail("the bf16 layer_norm check does not see a rounded "
                     "operand")
        if h == 768:
            ln_timed[n_rows] = (x, g, b)
    for n_rows in (614, 4096):  # the head's rows in the line, 4096 beside
        x, g, b = ln_timed[n_rows]
        nx, hd = x.shape
        xf, gb, bb = x.float(), g.to(bf16), b.to(bf16)
        f32_ms = time_cold(lambda: ln.layer_norm_2d(xf, g, b, 1e-5), flush)
        r = timed_row(
            "layer_norm (bf16)", lambda: ln.layer_norm_2d(x, g, b, 1e-5),
            lambda: ln.layer_norm_2d_reference(x, g, b, 1e-5),
            lambda: ln_f(x, (hd,), gb, bb, 1e-5),
            2 * 2 * nx * hd + 4 * 2 * hd + 4 * 2 * nx, 8 * nx * hd, flush,
            worst, "rows [%d, 768] bf16 x, f32 gamma and beta "
            "(F.layer_norm on the bf16 x with bf16 gamma and beta; the f32 "
            "kernel in this run %.6f)" % (nx, f32_ms))
        if n_rows == 614:
            r.update(source="paddle_tpu_torch/kernels/csrc/layer_norm.cu",
                     replaces="paddle_tpu/pallas_kernels/layer_norm.py:29")
            rows.append(r)

    # rows 9 and 10 with the carry: the copies of the members the AMP
    # paths carry, bitwise, and timed beside the same group without them
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    f = np.float32
    shapes = bert_param_shapes(cfg)
    carried = [len(sh) == 2 and sh[0] not in (cfg.vocab_size, cfg.max_pos,
                                             cfg.type_vocab)
               for sh in shapes]
    grp = ([t(rng.randn(*sh).astype(f)) for sh in shapes],
           [t((rng.randn(*sh) * 1e-3).astype(f)) for sh in shapes],
           [t((rng.randn(*sh) * 1e-3).astype(f)) for sh in shapes],
           [t((rng.rand(*sh) * 1e-6).astype(f)) for sh in shapes],
           t(np.array([1e-4], f)),
           [t(np.array([0.9 ** 2], f)) for _ in shapes],
           [t(np.array([0.999 ** 2], f)) for _ in shapes])

    def adam_run():
        p, g, m1, m2, lr, b1, b2 = grp
        c = lambda ts: [x.clone() for x in ts]  # noqa: E731
        return c(p), g, c(m1), c(m2), lr, c(b1), c(b2)

    bfs = [torch.empty(p.shape, dtype=bf16, device=dev) if k else None
           for p, k in zip(grp[0], carried)]
    want = fad.fused_adam_reference(*grp, bf16_out=True)
    got = fad.fused_adam_step(*adam_run(), bf16_out=bfs)
    torch.cuda.synchronize()
    for i, k in enumerate(carried):
        if not torch.equal(got[0][i], want[0][i]) or (
                k and not torch.equal(got[5][i], want[0][i].to(bf16))):
            fail("fused_adam with the carry not bitwise at member %d" % i)
    nel = sum(p.numel() for p in grp[0])
    n_bf = sum(p.numel() for p, k in zip(grp[0], carried) if k)
    print("kernel fused_adam (carry): BERT-base group, %d members, %d of "
          "them (%d elements) with their bf16 copy: bitwise "
          "p_new.to(bfloat16)" % (len(shapes), sum(carried), n_bf),
          flush=True)
    run = adam_run()
    lib_params = [p.clone().requires_grad_() for p in grp[0]]
    for p, g in zip(lib_params, grp[1]):
        p.grad = g
    lib = torch.optim.Adam(lib_params, lr=1e-4, fused=True)
    plain_ms = time_cold(lambda: fad.fused_adam_step(*run), flush)
    row = timed_row(
        "fused_adam (carry)", lambda: fad.fused_adam_step(*run,
                                                          bf16_out=bfs),
        lambda: fad.fused_adam_reference(*grp, bf16_out=True), lib.step,
        28 * nel + 2 * n_bf, 12 * nel, flush, 0.0,
        "BERT-base group writing the %d carried members' copies "
        "(torch.optim.Adam(fused=True), no copy; the kernel without the "
        "copies in this run %.6f)" % (sum(carried), plain_ms))
    row.update(source="paddle_tpu_torch/kernels/csrc/fused_adam.cu",
               replaces="paddle_tpu/pallas_kernels/fused_opt.py:96")
    rows.append(row)
    del grp, run, want, got, lib, lib_params

    shapes = resnet50_fused_group()
    carried = [len(sh) == 2 for sh in shapes]       # the fc weight
    p = [t(rng.randn(*sh).astype(f)) for sh in shapes]
    g = [t((rng.randn(*sh) * 1e-2).astype(f)) for sh in shapes]
    v = [t((rng.randn(*sh) * 1e-2).astype(f)) for sh in shapes]
    lr = t(np.array([0.1], f))
    bfs = [torch.empty(x.shape, dtype=bf16, device=dev) if k else None
           for x, k in zip(p, carried)]
    want = fm.fused_momentum_reference(p, g, v, lr, 0.9, bf16_out=True)
    got = fm.fused_momentum_step([x.clone() for x in p], g,
                                 [x.clone() for x in v], lr, 0.9,
                                 bf16_out=bfs)
    torch.cuda.synchronize()
    for i, k in enumerate(carried):
        if not torch.equal(got[0][i], want[0][i]) or (
                k and not torch.equal(got[2][i], want[0][i].to(bf16))):
            fail("fused_momentum with the carry not bitwise at member %d"
                 % i)
    nel = sum(x.numel() for x in p)
    n_bf = sum(x.numel() for x, k in zip(p, carried) if k)
    print("kernel fused_momentum (carry): ResNet-50 group, %d members, %d "
          "of them (%d elements) with their bf16 copy: bitwise "
          "p_new.to(bfloat16)" % (len(p), sum(carried), n_bf), flush=True)
    run = ([x.clone() for x in p], g, [x.clone() for x in v], lr)
    lib_params = [x.clone().requires_grad_() for x in p]
    for x, gx in zip(lib_params, g):
        x.grad = gx
    lib = torch.optim.SGD(lib_params, lr=0.1, momentum=0.9, fused=True)
    plain_ms = time_cold(lambda: fm.fused_momentum_step(*run, mu=0.9), flush)
    row = timed_row(
        "fused_momentum (carry)",
        lambda: fm.fused_momentum_step(*run, mu=0.9, bf16_out=bfs),
        lambda: fm.fused_momentum_reference(p, g, v, lr, 0.9,
                                            bf16_out=True), lib.step,
        20 * nel + 2 * n_bf, 3 * nel, flush, 0.0,
        "ResNet-50 group writing the fc weight's copy "
        "(torch.optim.SGD(momentum=0.9, fused=True), no copy; the kernel "
        "without the copy in this run %.6f)" % plain_ms)
    row.update(source="paddle_tpu_torch/kernels/csrc/fused_momentum.cu",
               replaces="paddle_tpu/pallas_kernels/fused_opt.py:112")
    rows.append(row)
    return rows


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
    flops = 4 * bb * h * s * s * d
    # the bound of the 3xTF32 design (flash_fwd.cuh, row 2's core): three
    # TF32 products per f32 product on the tensor cores, ~6 flops a score
    # (scale, bias, max, exp, sum, the mask's select) on the SIMT pipes
    row = timed_row(
        "small_attention_fwd",
        lambda: fa.small_attention_fwd(q, k, v, bias, scale, 0.1, WORDS,
                                       seed_out=seed_t),
        lambda: fa.small_attention_fwd_reference(q, k, v, bias, scale, 0.1,
                                                 WORDS),
        lambda: sdpa(q, k, v, attn_mask=bias, dropout_p=0.1),
        4 * (4 * n + bb * s * s + bb * h * s) + 8, 6 * bb * h * s * s,
        flush, worst_f, "%s (SDPA with dropout_p=0.1 and the same mask)"
        % what, tf32_flops=3 * flops)
    print("kernel small_attention_fwd %s: %.1f TF/s (SDPA %.1f); %d CTAs, "
          "%d an SM at D=%d; %.1f%% of the 3xTF32 bound; the products on "
          "the f32 SIMT pipes %.6f ms (%d flops over 67 TF/s)"
          % (what.split(" D=")[0], flops / row["ms"] / 1e9,
             flops / row["library_ms"] / 1e9, bb * h * -(-s // 64),
             fa.small_attention_fwd_ctas_per_sm(d), d,
             100 * row["bound_ms"] / row["ms"], flops / F32_FLOPS * 1e3,
             flops), flush=True)
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


def ln_bwd_repeat_and_mask(fl, philox, r, g, mean, var, dz, seed_t):
    """Row 8 at p = 0.1: dx, dy, dgamma and dbeta are the same bits over
    two calls (the partials are added in a fixed order), and dy keeps
    exactly the elements the forward kernel kept under the same seed
    (its r at x = 0, y = 1 is inv_q where kept, 0 where dropped)."""
    got = fl.fused_ln_bwd(r, g, mean, var, dz, 0.1, seed_t)
    again = fl.fused_ln_bwd(r, g, mean, var, dz, 0.1, seed_t)
    for name, u, w in zip(("dx", "dy", "dgamma", "dbeta"), got, again):
        if not torch.equal(u, w):
            fail("fused_ln_bwd: two calls give different %s" % name)
    ones = torch.ones_like(r)
    _z, r_keep, _m, _v = fl.fused_ln_fwd(torch.zeros_like(r), ones, g, g,
                                         0.1, philox.seed_words(seed_t),
                                         1e-5)
    inv_q = torch.tensor(philox.inv_realized_q(philox.keep_threshold(0.1)),
                         dtype=torch.float32, device=r.device)
    want = torch.where(r_keep != 0, got[0] * inv_q, torch.zeros_like(r))
    if not torch.equal(got[1], want):
        fail("fused_ln_bwd: dy's keep pattern is not the forward's")
    print("kernel fused_ln_bwd p=0.1 [%d, %d]: dx, dy, dgamma, dbeta the "
          "same bits over two calls; dy = dx * inv_q exactly where the "
          "forward kept, 0 elsewhere" % tuple(r.shape), flush=True)


def ln_bwd_kernel_phase(fl, philox, dev, flush):
    """Row 8: the fused-LN backward from the forward kernel's r, mean, var
    (and Seed, at p = 0.1), on its float4 path (h % 4 == 0, h <= 1024)
    and its scalar one.  The kernels line takes p = 0.1; the p = 0 time
    prints beside it."""
    rng = np.random.RandomState(4)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    worst = 0.0
    tensors = {}
    for (n, hd), what in (((4096, 768), "BERT rows [4096, 768]"),
                          ((614, 768), "masked-LM rows [614, 768]"),
                          ((37, 200), "odd [37, 200]"),
                          ((37, 202), "scalar path [37, 202]"),
                          ((16, 1500), "wide scalar path [16, 1500]")):
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
    ln_bwd_repeat_and_mask(fl, philox, r1, g, mean1, var1, dz, seed_t)
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
    return first


def fold_and_affine_check(cb, conv, s, ss, scale, bias, relu, rng, what):
    """The fold bitwise its plain version from row 12's sums (running
    statistics drawn from ``rng``), then row 13 with the fold's a and b
    bitwise its plain version."""
    co = s.shape[1]
    mean = torch.from_numpy((rng.randn(co) * 0.1).astype(np.float32)).to(
        s.device)
    var = torch.from_numpy(rng.uniform(0.5, 2.0, co).astype(np.float32)).to(
        s.device)
    cnt = conv.shape[0] * conv.shape[2] * conv.shape[3]
    got = cb.bn_fold(s, ss, scale, bias, mean, var, cnt, 0.9, 1e-5)
    want = cb.bn_fold_reference(s, ss, scale, bias, mean, var, cnt, 0.9,
                                1e-5)
    torch.cuda.synchronize()
    for name, g, w in zip(("a", "b", "MeanOut", "VarianceOut", "SavedMean",
                           "SavedVariance"), got, want):
        if not torch.equal(g, w):
            fail("bn_fold %s not bitwise equal to the plain version at %s "
                 "(max abs err %.3g)" % (name, what,
                                         float((g - w).abs().max())))
    y = cb.affine_act(conv, got[0], got[1], relu)
    torch.cuda.synchronize()
    if not torch.equal(y, cb.affine_act_reference(conv, got[0], got[1],
                                                  relu)):
        fail("affine_act not bitwise equal to the plain version at %s"
             % what)
    print("kernel bn_fold, affine_act %s: the fold's six outputs and the "
          "affine pass bitwise equal to their plain versions" % what,
          flush=True)


def trunk_conv_shapes(batch):
    """[((x shape, w shape, stride, pad), count)] of the ResNet-50 trunk's
    conv2d_bn_relu ops (53 convs of 23 shapes), in program order."""
    import collections

    main_p = resnet_program("trunk", True)[0]
    blk = main_p.global_block()
    shapes = collections.Counter()
    for op in blk.ops:
        if op.type == "conv2d_bn_relu":
            x = blk.var(op.input("Input")[0]).shape
            w = blk.var(op.input("Filter")[0]).shape
            shapes[((batch,) + tuple(x[1:]), tuple(w),
                    int(op.attr("strides")[0]),
                    int(op.attr("paddings")[0]))] += 1
    return list(shapes.items())


def tail_rows(cb, dev, flush):
    """Row 13 and the fold timed at each of the trunk's 23 conv shapes at
    batch 32 and added up weighted by each shape's count: the rows of the
    kernels line are the 53 convs of one training step."""
    rng = np.random.RandomState(12)
    f = torch.nn.functional
    total = {name: dict.fromkeys(("ms", "plain_ms", "bound_ms",
                                  "library_ms"), 0.0)
             for name in ("affine_act", "bn_fold")}
    for (xs, ws, stride, pad), count in trunk_conv_shapes(32):
        n, co, k = xs[0], ws[0], ws[2]
        oh = cb.out_size(xs[2], k, stride, pad)
        conv = torch.randn((n, co, oh, oh), device=dev)
        s, ss = conv.sum(dim=(2, 3)), (conv * conv).sum(dim=(2, 3))
        scale, bias, mean = (torch.randn(co, device=dev) for _ in range(3))
        var = torch.rand(co, device=dev) + 0.5
        a, b = cb.bn_fold(s, ss, scale, bias, mean, var, n * oh * oh, 0.9,
                          1e-5)[:2]
        el = n * co * oh * oh
        what = "[%d, %d, %d, %d] x%d" % (n, co, oh, oh, count)
        rows = {"affine_act": timed_row(
            "affine_act", lambda: cb.affine_act(conv, a, b),
            lambda: cb.affine_act_reference(conv, a, b),
            lambda: f.relu(torch.addcmul(b.reshape(1, -1, 1, 1), conv,
                                         a.reshape(1, -1, 1, 1))),
            4 * (2 * el + 2 * co), 3 * el, flush, 0.0,
            "%s (F.relu(torch.addcmul(b, conv, a)))" % what),
            "bn_fold": timed_row(
            "bn_fold", lambda: cb.bn_fold(s, ss, scale, bias, mean, var,
                                          n * oh * oh, 0.9, 1e-5),
            lambda: cb.bn_fold_reference(s, ss, scale, bias, mean, var,
                                         n * oh * oh, 0.9, 1e-5),
            None, 4 * (2 * n * co + 10 * co), 2 * n * co + 14 * co, flush,
            0.0, "%s (no one-call equivalent)" % what,
            sleep_cycles=4_000_000)}
        for name, row in rows.items():
            for key in ("ms", "plain_ms", "bound_ms"):
                total[name][key] += count * row[key]
            if row["library_ms"] is not None:
                total[name]["library_ms"] += count * row["library_ms"]
        del conv, s, ss
    out = []
    for name, tot in total.items():
        lib = tot["library_ms"] if name == "affine_act" else None
        print("kernel %s over the trunk's 53 convs at batch 32 (a training "
              "step): kernel_ms %.6f plain_ms %.6f library_ms %s bound_ms "
              "%.6f (bytes)" % (name, tot["ms"], tot["plain_ms"],
                                "%.6f" % lib if lib is not None else "none",
                                tot["bound_ms"]), flush=True)
        out.append({"name": name, "route": "cuda", "max_abs_err": 0.0,
                    "ms": tot["ms"], "plain_ms": tot["plain_ms"],
                    "bound_ms": tot["bound_ms"], "bound_by": "bytes",
                    "library_ms": lib})
    return out


def conv_kernel_phase(cb, dev, flush):
    """Rows 11, 12, 13 and the fold against their plain versions at
    CONV_CASES (row 12 bitwise over two runs; the fold and row 13 bitwise:
    one rounded operation a step, as their plain versions) and at every
    tile (TILE_CASES), then rows 11 and 12 timed at the stem and the
    stage-3 3x3 (the rows carry the 3x3), row 13 and the fold at the
    trunk's 23 shapes (the rows carry the 53 convs' sum)."""
    rng = np.random.RandomState(11)
    worst = {"conv_bn_act": 0.0, "conv_stats": 0.0}
    kept = {}
    for what, n, c, hw, co, k, stride, pad, relu in CONV_CASES:
        x, w, a, b = conv_case(rng, n, c, hw, co, k, dev)
        tile = cb.conv_tile(co, n * cb.out_size(hw, k, stride, pad) ** 2)
        conv, s, ss = conv_pair(cb, x, w, a, b, stride, pad, relu,
                                "%s, tile %dx%d" % ((what,) + cb.TILES[tile]),
                                worst)
        fold_and_affine_check(cb, conv, s, ss, a, b, relu, rng, what)
        if what.startswith(("stem", "stage-3")):
            kept[what] = (x, w, a, b, stride, pad, relu)
        del x, w, conv
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
    del kept
    rows["affine_act"], rows["bn_fold"] = tail_rows(cb, dev, flush)
    sources = {"conv_bn_act": "paddle_tpu/pallas_kernels/conv_block.py:133",
               "conv_stats": "paddle_tpu/pallas_kernels/conv_block.py:143",
               "affine_act": "paddle_tpu/pallas_kernels/conv_block.py:155",
               # the jnp fold around the reference's Pallas calls
               "bn_fold": "paddle_tpu/pallas_kernels/conv_block.py:319"}
    for name, row in rows.items():
        row.update(source="paddle_tpu_torch/kernels/csrc/conv_block.cu",
                   replaces=sources[name])
    return [rows[name] for name in sources]


def momentum_kernel_phase(fm, dev, flush):
    """Row 10: the fused momentum over ResNet-50's fused group, an odd
    5-member group, members that are views at odd float offsets of one
    buffer each (sizes not a multiple of 4: the scalar head and tail; one
    member's grad out of phase: a CTA one element a thread) and a group of
    more members than one parameter block holds (the split launch), plain
    and Nesterov, bitwise equal to its plain version with and without the
    bf16 copy, every group launching as many times as planned, the views'
    buffers unchanged between the members; timed over ResNet-50's
    group."""
    rng = np.random.RandomState(6)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    f = np.float32
    bf16 = torch.bfloat16

    def dense(shapes):
        p = [t(rng.randn(*s).astype(f)) for s in shapes]
        g = [t((rng.randn(*s) * 1e-2).astype(f)) for s in shapes]
        v = [t((rng.randn(*s) * 1e-2).astype(f)) for s in shapes]

        def fresh():
            return ([x.clone() for x in p], [x.clone() for x in v],
                    [torch.empty(x.shape, dtype=bf16, device=dev)
                     for x in p], lambda: True)
        return p, g, v, fresh

    def views(sizes, g_shifted):
        offs, o = [], 1
        for s in sizes:
            offs.append(o)
            o += s + 3
        bufs = [t(rng.randn(o + 1).astype(f)),
                t((rng.randn(o + 1) * 1e-2).astype(f)),
                t((rng.randn(o + 1) * 1e-2).astype(f))]
        gaps = torch.ones(o + 1, dtype=torch.bool, device=dev)
        for a, s in zip(offs, sizes):
            gaps[a:a + s] = False

        def cut(buf, shift=()):
            return [buf[a + (i in shift):a + (i in shift) + s]
                    for i, (a, s) in enumerate(zip(offs, sizes))]

        def fresh():
            pb, vb = bufs[0].clone(), bufs[1].clone()
            bb = torch.zeros(o + 1, dtype=bf16, device=dev)
            return cut(pb), cut(vb), cut(bb), lambda: (
                torch.equal(pb[gaps], bufs[0][gaps])
                and torch.equal(vb[gaps], bufs[1][gaps])
                and not bb[gaps].any())
        return cut(bufs[0]), cut(bufs[2], g_shifted), cut(bufs[1]), fresh

    per_block, capacity = fm.kernel_layout()
    resnet = resnet50_fused_group()
    split = [(int(s),) for s in rng.randint(1, 3000, 2 * capacity + 44)]
    groups = {
        "ResNet-50 group, %d members, %d elements" % (
            len(resnet), sum(int(np.prod(s)) for s in resnet)):
            dense(resnet),
        "odd 5-member group": dense([(37, 5), (1000,), (3, 3, 3), (129,),
                                     (2048, 17)]),
        "views at odd float offsets, member 3's grad out of phase":
            views([4097, 3, 1, 5001, 2051, 130, 2, 999], (3,)),
        "%d members, more than one parameter block's %d" % (
            len(split), capacity): dense(split)}
    lr = t(np.array([0.1], f))
    kept = None
    for what, (p, g, v, fresh) in groups.items():
        planned = len(fm.plan_launches([x.numel() for x in p], per_block,
                                       capacity))
        if len(p) > capacity and planned < 2:
            fail("fused_momentum: %s planned as one launch" % what)
        for nesterov in (False, True):
            want = fm.fused_momentum_reference(p, g, v, lr, 0.9, nesterov,
                                               bf16_out=True)
            for carry in (False, True):
                ps, vs, bfs, untouched = fresh()
                before = fm.fused_momentum_step.launches
                got = fm.fused_momentum_step(ps, g, vs, lr, 0.9, nesterov,
                                             bf16_out=bfs if carry else None)
                torch.cuda.synchronize()
                launched = fm.fused_momentum_step.launches - before
                if launched != planned:
                    fail("fused_momentum launched %d times at %s, planned "
                         "%d" % (launched, what, planned))
                names = ("param", "velocity") + (("bf16 copy",) if carry
                                                 else ())
                for name, gs, ws in zip(names, got, want):
                    if not all(torch.equal(x, y) for x, y in zip(gs, ws)):
                        fail("fused_momentum %s not bitwise equal to the "
                             "plain version at %s" % (name, what))
                if not untouched():
                    fail("fused_momentum wrote between the members at %s"
                         % what)
                print("kernel fused_momentum %s%s%s: bitwise equal to the "
                      "plain version, %d launch(es)" % (
                          what, ", Nesterov" if nesterov else "",
                          ", with the bf16 copy" if carry else "",
                          launched), flush=True)
        if kept is None:
            kept = (p, g, v)
    p, g, v = kept
    run = ([x.clone() for x in p], g, [x.clone() for x in v], lr)
    lib_params = [x.clone().requires_grad_() for x in p]
    for x, gx in zip(lib_params, g):
        x.grad = gx
    lib = torch.optim.SGD(lib_params, lr=0.1, momentum=0.9, fused=True)
    nel = sum(x.numel() for x in p)
    # the wrapper's host work before its launch (108 grads checked, their
    # pointers written into the parameter block) fits in the default sleep
    row = timed_row(
        "fused_momentum", lambda: fm.fused_momentum_step(*run, mu=0.9),
        lambda: fm.fused_momentum_reference(p, g, v, lr, 0.9), lib.step,
        20 * nel, 3 * nel, flush, 0.0,
        "ResNet-50 group of %d members (torch.optim.SGD(momentum=0.9, "
        "fused=True), the same recurrence)" % len(p))
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


def check_decode_tokens(what, allp, replies, refs):
    """Each reply's tokens against the plain unpaged loop's (``refs``:
    (tokens, logits) per prompt); a divergence must sit at a near-tie of
    the plain loop's logits.  -> the number of near-tie divergences."""
    ties = 0
    for i, (p, r, (want, logits)) in enumerate(zip(allp, replies, refs)):
        got = [int(t) for t in r.outputs["tokens"]]
        if got == want:
            continue
        j = next((k for k in range(min(len(got), len(want)))
                  if got[k] != want[k]), min(len(got), len(want)))
        if j >= len(logits):
            fail("%s request %d: %d tokens, the plain loop %d"
                 % (what, i, len(got), len(want)))
        top2 = np.sort(logits[j])[-2:]
        gap = float(top2[1] - top2[0])
        print("%s: request %d (prompt %d) diverges at token %d: paged %d, "
              "unpaged %d, unpaged top-2 gap %.3g"
              % (what, i, len(p), j, got[j] if j < len(got) else -1,
                 want[j], gap), flush=True)
        if gap >= LOGIT_TIE_TOL:
            fail("%s request %d diverges from the unpaged loop where the "
                 "top-2 logit gap %.3g >= %g" % (what, i, gap,
                                                 LOGIT_TIE_TOL))
        ties += 1
    print("%s: tokens equal the unpaged plain loop for %d of %d requests; "
          "%d near-tie divergences (gap < %g)"
          % (what, len(replies) - ties, len(replies), ties, LOGIT_TIE_TOL),
          flush=True)
    return ties


def decode_phase(pa):
    """-> (paged_attention launches, the decoder's params, the plain
    unpaged loop's (tokens, logits) per prompt of ``prompts``)."""
    from paddle_tpu_torch.serving import DecodeEngine, init_decoder_params

    cfg = gpt2_small()
    t0 = time.perf_counter()
    params = init_decoder_params(cfg, seed=0)
    eng = DecodeEngine(buckets="4,8", block_size=16, deadline_ms=600000.0)
    m = eng.add_model("gpt2-small", (cfg, params), kv_blocks=520)
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

    refs = [m.decoder.unpaged_generate(
        p, 32, pad_len=m.maxb * m.kv_config.block_size, return_logits=True)
        for p in allp]
    check_decode_tokens("decode", allp, replies, refs)
    return launches, params, refs


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


def build_bert_dir(dirname, cfg, seed=7):
    """BERT at seq SEQ through the port's entry points: program, startup
    on the card from a generator seeded with ``seed``,
    save_inference_model."""
    from paddle_tpu_torch import framework, io
    from paddle_tpu_torch.core import Executor, Scope, scope_guard
    from paddle_tpu_torch.models.bert import bert_encoder

    main, startup = framework.Program(), framework.Program()
    startup.random_seed = seed
    with framework.program_guard(main, startup):
        inputs, seq_out = bert_encoder(cfg, SEQ, is_test=True)
    exe = Executor()                  # the card
    with scope_guard(Scope()):
        exe.run(startup)
        io.save_inference_model(dirname, [v.name for v in inputs],
                                [seq_out], exe, main_program=main)
    return main


ENCODER_SAMPLED = (0, 12, 23)


def encoder_phase(kmods, dirname, cfg=None, clients=3):
    """BERT built, initialised and saved into ``dirname``, then served ->
    (the kernels' launches, {request index: the plain CPU predictor's
    output} at ENCODER_SAMPLED)."""
    from paddle_tpu_torch.inference import AnalysisConfig, AnalysisPredictor
    from paddle_tpu_torch.models.bert import BERT_BASE
    from paddle_tpu_torch.serving import ServingEngine

    cfg = cfg or BERT_BASE
    fa, fl, ln = kmods
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
    worst, plain_outs = 0.0, {}
    for i in ENCODER_SAMPLED:
        want_out, = plain.run_feed(reqs[i]).values()
        plain_outs[i] = want_out
        got, = replies[i].outputs.values()
        worst = max(worst, float(np.abs(got - want_out).max()))
    print("encoder: 3 requests vs the plain predictor on the CPU: "
          "max_abs_err %.3g (atol %g)" % (worst, ENCODER_ATOL),
          flush=True)
    if not worst <= ENCODER_ATOL:
        fail("encoder output disagrees with the plain CPU predictor")
    return launches, plain_outs


# -- phase 5b: serving over the wire ----------------------------------------

WIRE_MODES = ("no stream", "stream", "generate_stream")


def wire_mode(i, clients=3):
    """The mode of request ``i``: a third each, every client thread (``i``
    mod ``clients``) taking each mode in turn."""
    return WIRE_MODES[(i + i // clients) % 3]


def client_gen(cli, p, mode, got):
    """One GPT-2-small generate of 32 tokens through a ServingClient in
    ``mode`` (WIRE_MODES), the streamed (index, token) pairs appended to
    ``got``."""
    if mode == "generate_stream":
        it = cli.generate_stream("gpt2-small", p, max_new_tokens=32)
        while True:
            try:
                got.append(next(it))
            except StopIteration as stop:
                return stop.value
    return cli.generate("gpt2-small", p, max_new_tokens=32,
                        stream=mode == "stream",
                        on_token=lambda j, t: got.append((j, t)))


def check_chunks(what, replies, chunks, clients):
    """Each streamed generate's chunks are indices 0..n-1, once each, and
    equal its reply's tokens; an unstreamed one got none."""
    for i, (r, got) in enumerate(zip(replies, chunks)):
        mode = wire_mode(i, clients)
        toks = [int(t) for t in r.outputs["tokens"]]
        if mode == "no stream":
            if got:
                fail("%s request %d streamed without the stream"
                     % (what, i))
        elif [j for j, _t in got] != list(range(len(toks))) \
                or [t for _j, t in got] != toks:
            fail("%s request %d (%s): chunks %s, the reply's %d tokens"
                 % (what, i, mode, [j for j, _t in got][:40], len(toks)))


def drive_mix(allp, enc, gen, infer, clients, what):
    """``clients`` threads: thread k sends prompts k, k + clients, ... by
    ``gen(k, i, prompt, mode, chunks)``, then its encoder requests by
    ``infer(k, i, feeds)`` -> (replies, encoder replies, streamed chunks,
    {"decode": wall s, "encoder": wall s})."""
    replies, enc_replies = [None] * len(allp), [None] * len(enc)
    chunks = [[] for _ in allp]
    walls = {}

    def run(part):
        def client(k):
            if part == "decode":
                for i in range(k, len(allp), clients):
                    replies[i] = gen(k, i, allp[i], wire_mode(i, clients),
                                     chunks[i])
            else:
                for i in range(k, len(enc), clients):
                    enc_replies[i] = infer(k, i, enc[i])
        ts = [threading.Thread(target=client, args=(k,))
              for k in range(clients)]
        t0 = time.perf_counter()
        for th in ts:
            th.start()
        for th in ts:
            th.join(900)
        walls[part] = time.perf_counter() - t0
        if any(th.is_alive() for th in ts):
            fail("%s: a %s client thread did not finish" % (what, part))

    run("decode")
    run("encoder")
    return replies, enc_replies, chunks, walls


def trace_files(dirname):
    """The tracing files under ``dirname`` (trace-<pid>.jsonl and
    flightrec-<pid>.json); none when it does not exist."""
    if not os.path.isdir(dirname):
        return []
    return sorted(n for n in os.listdir(dirname)
                  if n.startswith(("trace-", "flightrec-")))


def read_trace(path):
    """The records of one trace-<pid>.jsonl (a torn last line of a killed
    process skipped)."""
    out = []
    with open(path) as f:
        for line in f:
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out


def wire_phase(pa, kmods, params, refs, bert_dir, plain_outs, tmp, cfg=None,
               clients=3):
    """decode_phase's GPT-2-small engine (its buckets, 16-token blocks,
    520 KV blocks; no prefix cache, so both passes below do the same
    work) and encoder_phase's BERT-base directory (seq 128, buckets 1, 8,
    32) behind one ServingServer on 127.0.0.1.  ``clients`` threads send
    ``prompts`` (32 new tokens; a third each without the stream, with it,
    and through generate_stream), then ``encoder_requests`` through infer:
    first in process on the same engines (the yardstick), then over the
    wire, through a ServingClient each, with tracing off and a telemetry
    directory set (nothing may be written there).  Then one streamed
    generate is abandoned after its first token, and the wire mix runs
    again with ``FLAGS_tracing`` on (clients and server both in this
    process), its launches held the same way and its rates printed beside
    the untraced ones.  -> the untraced wire path's launches."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.models.bert import BERT_BASE
    from paddle_tpu_torch.native.rpc import RpcClient
    from paddle_tpu_torch.serving import (DecodeEngine, ServingClient,
                                          ServingEngine, ServingServer,
                                          codec)

    fa, fl, ln = kmods
    cfg = cfg or BERT_BASE
    dcfg = gpt2_small()
    t0 = time.perf_counter()
    deng = DecodeEngine(buckets="4,8", block_size=16, deadline_ms=600000.0,
                        prefix_cache=False)
    m = deng.add_model("gpt2-small", (dcfg, params), kv_blocks=520)
    eeng = ServingEngine(buckets=BUCKETS, batch_window_ms=5.0,
                         deadline_ms=600000.0)
    eeng.add_model("bert", bert_dir)
    eeng.prewarm()
    srv = ServingServer(eeng, port=0, decode_engine=deng)
    first, late = prompts(dcfg.vocab)
    allp = first + [late]
    enc = encoder_requests(cfg)
    torch.cuda.synchronize()
    print("wire: GPT-2-small decode engine and BERT-base encoder engine "
          "behind one ServingServer, set up in %.1f s"
          % (time.perf_counter() - t0), flush=True)

    def drive(gen, infer):
        return drive_mix(allp, enc, gen, infer, clients, "wire")

    def in_process_gen(k, i, p, mode, got):
        return deng.submit("gpt2-small", p, max_new_tokens=32).wait(900)

    srv.start()
    try:
        local = drive(in_process_gen, lambda k, i, f: eeng.infer(
            "bert", f, deadline_ms=600000.0))
        ep = "127.0.0.1:%d" % srv.port
        cli = [ServingClient(endpoints=[ep], deadline_ms=600000.0)
               for _ in range(clients)]

        def wire_gen(k, i, p, mode, got):
            return client_gen(cli[k], p, mode, got)

        def zero():
            pa.paged_attention.launches = 0
            fa.flash_attention.launches = 0
            fl.fused_ln_fwd.launches = 0
            ln.layer_norm_2d.launches = 0
            return deng.steps, len(eeng.batch_log)

        def counts():
            return {"paged_attention": pa.paged_attention.launches,
                    "flash_attention": fa.flash_attention.launches,
                    "fused_ln": fl.fused_ln_fwd.launches,
                    "layer_norm": ln.layer_norm_2d.launches}

        untraced_dir = os.path.join(tmp, "wire-untraced")
        traced_dir = os.path.join(tmp, "wire-traced")
        set_flags({"FLAGS_telemetry_dir": untraced_dir})
        # the counts start at 0 just before the wire path runs
        steps0, batches0 = zero()
        bytes0 = sum(srv.rpc.bytes_moved())
        wire = drive(wire_gen, lambda k, i, f: cli[k].infer("bert", f))
        wire_b = sum(srv.rpc.bytes_moved()) - bytes0
        # one streamed generate abandoned after its first token
        before = {k: v for k, v in m.cache.allocator.stats().items()
                  if k != "high_water"}
        c = RpcClient(ep, connect_timeout=10.0, rpc_deadline=120.0,
                      retry_times=0)
        try:
            c.send_var(codec.GEN_KEY + "abandoned", codec.pack(
                {"model": "gpt2-small", "max_new_tokens": 512,
                 "stream": True, "deadline_ms": 600000.0},
                [np.asarray(allp[1], np.int32)]))
            chunk0, _ = codec.unpack(c.get_var(codec.STREAM_KEY
                                               + "abandoned:0"))
            held = m.cache.allocator.stats()["in_use"]
            c.send_var(codec.ABORT_KEY + "abandoned",
                       codec.pack({"req_id": "abandoned"}))
            ab_reply, _ = codec.unpack(c.get_var(codec.REPLY_KEY
                                                 + "abandoned"))
        finally:
            c.close()
        t_end = time.perf_counter() + 30.0
        while True:
            after = {k: v for k, v in m.cache.allocator.stats().items()
                     if k != "high_water"}
            if after == before or time.perf_counter() > t_end:
                break
            time.sleep(0.01)
        launches = counts()
        steps = deng.steps - steps0
        batches = list(eeng.batch_log)[batches0:]
        # the same mix traced: spans, notes and the flight recorder's
        # write-through dump at every decode step and encoder batch
        steps0, batches0 = zero()
        set_flags({"FLAGS_tracing": True, "FLAGS_telemetry_dir": traced_dir})
        try:
            traced = drive(wire_gen, lambda k, i, f: cli[k].infer("bert", f))
        finally:
            set_flags({"FLAGS_tracing": False, "FLAGS_telemetry_dir": ""})
        t_launches = counts()
        t_steps = deng.steps - steps0
        t_batches = len(eeng.batch_log) - batches0
    finally:
        set_flags({"FLAGS_tracing": False, "FLAGS_telemetry_dir": ""})
        srv.shutdown()

    replies, enc_replies, chunks, walls = wire
    l_replies, l_enc, _c, l_walls = local
    for what, rs in (("in process", l_replies), ("wire", replies),
                     ("in process encoder", l_enc),
                     ("wire encoder", enc_replies)):
        for i, r in enumerate(rs):
            if r is None or r.status != "ok":
                fail("%s request %d: %s" % (what, i, None if r is None
                                             else (r.status, r.error)))
    check_decode_tokens("wire", allp, replies, refs)
    check_decode_tokens("wire in process", allp, l_replies, refs)
    check_chunks("wire", replies, chunks, clients)
    print("wire: %d generates ok (%s by mode); the streamed chunks are "
          "indices 0..n-1 each once and equal the final reply's tokens"
          % (len(replies), json.dumps({md: sum(
              wire_mode(i, clients) == md
              for i in range(len(allp))) for md in WIRE_MODES})),
          flush=True)
    if chunk0.get("token") is None or held == before["in_use"] \
            or ab_reply.get("status") != "aborted" or after != before:
        fail("wire: the abandoned request held %d blocks after its first "
             "token (%d before), its reply %s, the allocator %s after, %s "
             "before" % (held, before["in_use"], ab_reply.get("status"),
                         after, before))
    print("wire: a streamed generate abandoned after its first token held "
          "%d KV blocks (%d before it) and returned them all on its "
          "abort (reply %s); allocator %s"
          % (held, before["in_use"], ab_reply["status"],
             json.dumps(after)), flush=True)
    worst = check_encoder("wire encoder", enc_replies, enc, cfg, plain_outs,
                          {i: list(r.outputs.values())[0]
                           for i, r in enumerate(l_enc)})
    print("wire: %d encoder replies ok; against the plain CPU predictor at "
          "requests %s and the in-process replies: max_abs_err %.3g "
          "(atol %g)" % (len(enc_replies), list(plain_outs), worst,
                         ENCODER_ATOL), flush=True)
    nb = len(batches)
    want = serving_launches(dcfg, cfg, steps, nb)
    print("wire: launches %s over %d decode steps and %d encoder batches"
          % (json.dumps(launches), steps, nb), flush=True)
    if launches != want or steps == 0 or nb == 0:
        fail("wire launches %s, want %s" % (launches, want))

    card = card_line()
    ntok = sum(len(r.outputs["tokens"]) for r in replies)
    streamed = [r for i, r in enumerate(replies)
                if wire_mode(i, clients) != "no stream"]
    p50 = lambda xs: float(np.percentile(xs, 50))  # noqa: E731
    print("wire: %s; %d client threads; decode %d tokens: over the wire "
          "%.3f s = %.2f tokens/s, in process %.3f s = %.2f tokens/s; "
          "encoder %d requests: over the wire %.3f s = %.2f requests/s, in "
          "process %.3f s = %.2f requests/s"
          % (card, clients, ntok, walls["decode"], ntok / walls["decode"],
             l_walls["decode"], ntok / l_walls["decode"], len(enc),
             walls["encoder"], len(enc) / walls["encoder"],
             l_walls["encoder"], len(enc) / l_walls["encoder"]), flush=True)
    print("wire: %s; the %d streamed generates: client TTFT p50 %.3f ms "
          "against the engine's ttft_ms p50 %.3f; client ITL p50 %.3f ms "
          "against the engine's %.3f; wire_ms p50 %.3f"
          % (card, len(streamed),
             p50([r.phases["client_ttft_ms"] for r in streamed]),
             p50([r.phases["ttft_ms"] for r in streamed]),
             p50([x for r in streamed
                  for x in r.phases["client_itl_ms_samples"]]),
             p50([x for r in streamed for x in r.phases["itl_ms_samples"]]),
             p50([r.phases["wire_ms"] for r in replies])), flush=True)
    print("wire: %s; %d bytes on the wire for %d requests = %.1f a request "
          "(the server's sockets, both ways)"
          % (card, wire_b, len(allp) + len(enc),
             wire_b / (len(allp) + len(enc))), flush=True)

    # tracing off left nothing behind; tracing on served the same mix
    if trace_files(untraced_dir):
        fail("wire: with tracing off %s were written" %
             trace_files(untraced_dir))
    t_replies, t_enc, t_chunks, t_walls = traced
    for what, rs in (("wire traced", t_replies),
                     ("wire traced encoder", t_enc)):
        for i, r in enumerate(rs):
            if r is None or r.status != "ok":
                fail("%s request %d: %s" % (what, i, None if r is None
                                             else (r.status, r.error)))
    check_decode_tokens("wire traced", allp, t_replies, refs)
    check_chunks("wire traced", t_replies, t_chunks, clients)
    t_worst = check_encoder("wire traced encoder", t_enc, enc, cfg,
                            plain_outs)
    t_want = serving_launches(dcfg, cfg, t_steps, t_batches)
    if t_launches != t_want or t_steps == 0 or t_batches == 0:
        fail("wire traced launches %s, want %s" % (t_launches, t_want))
    mine = "trace-%d.jsonl" % os.getpid()
    files = trace_files(traced_dir)
    recs = read_trace(os.path.join(traced_dir, mine)) \
        if mine in files else []
    names = {r.get("name") for r in recs if r.get("t") == "span"}
    need = {"client.generate", "client.infer", "serving.admission",
            "serving.request", "serving.decode_step", "serving.batch",
            "serving.execute", "executor.step", "serving.reply_publish"}
    notes = sum(r.get("t") == "note" for r in recs)
    if not need <= names or "flightrec-%d.json" % os.getpid() not in files:
        fail("wire traced: files %s, spans missing %s"
             % (files, sorted(need - names)))
    t_ntok = sum(len(r.outputs["tokens"]) for r in t_replies)
    print("wire: tracing off wrote nothing under the telemetry dir; tracing "
          "on: %d records (%d spans, %d notes, each note dumping the "
          "flight ring), every reply ok, tokens equal the plain loop's, "
          "encoder within %.3g, launches %s over %d decode steps and %d "
          "encoder batches" % (len(recs), sum(r.get("t") == "span"
                                              for r in recs), notes,
                               t_worst, json.dumps(t_launches), t_steps,
                               t_batches), flush=True)
    print("wire: %s; tracing off: decode %.2f tokens/s, encoder %.2f "
          "requests/s; tracing on: decode %.2f tokens/s, encoder %.2f "
          "requests/s (%d client threads over the wire, same engines, "
          "off first)" % (card, ntok / walls["decode"],
                          len(enc) / walls["encoder"],
                          t_ntok / t_walls["decode"],
                          len(enc) / t_walls["encoder"], clients),
          flush=True)
    return launches


# -- phase 5c: a serving fleet ------------------------------------------------

# the replicas' environment: telemetry on (their __metrics__), heartbeats
# every 0.3 s, eviction after 3 s of silence
FLEET_ENV = {"FLAGS_telemetry": "1", "FLAGS_serving_hb_interval": "0.3",
             "FLAGS_serving_hb_timeout": "3.0"}
FLEET_HB_TIMEOUT = 3.0
FLEET_READY_S = 300.0       # a replica's start, its prewarm on the card
CANARY_FRACTION = 0.25
CONVERGE_S = 2.0            # a rollout change reaching every replica
FLEET_DEVICE = "cuda"       # the replicas' --device
REBROADCAST_S = 0.5         # the controller's re-broadcast interval


def free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


# every Replica started, so main() stops them all however a phase ends
REPLICAS = []


class Replica:
    """One ``tools/torch_serve.py`` child process; a reader thread keeps
    its output lines."""

    def __init__(self, argv, env):
        self.t_launch = time.perf_counter()
        self.proc = subprocess.Popen(argv, cwd=HERE, env=env,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        REPLICAS.append(self)
        self.lines = []
        self.stamps = []                    # perf_counter at each line
        self._ready = threading.Event()
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.stamps.append(time.perf_counter())
            self.lines.append(line.rstrip("\n"))
            if line.startswith("READY"):
                self._ready.set()
        self._ready.set()                   # the process ended

    def all(self, prefix):
        """[(perf_counter when read, the text after ``prefix``)] of every
        line that starts with it, in order (a forked standby writes to
        the same output)."""
        return [(t, ln[len(prefix):]) for t, ln in
                zip(list(self.stamps), list(self.lines))
                if ln.startswith(prefix)]

    def tail(self, n=30):
        return "\n".join(self.lines[-n:])

    def line(self, prefix):
        """The JSON after ``prefix`` on the first line that starts with
        it, or None."""
        for ln in list(self.lines):
            if ln.startswith(prefix):
                return json.loads(ln[len(prefix):])
        return None

    def ready(self, what):
        """Wait (bounded) for READY -> the PREWARM manifest."""
        self._ready.wait(FLEET_READY_S)
        if not any(ln.startswith("READY") for ln in list(self.lines)):
            fail("%s: no READY within %.0f s; its output ends:\n%s"
                 % (what, FLEET_READY_S, self.tail()))
        return self.line("PREWARM ")

    def wait(self, timeout):
        try:
            rc = self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            return None
        self._reader.join(10.0)
        return rc

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
        try:
            self.proc.wait(10)
        except subprocess.TimeoutExpired:
            pass


def endpoints_doc(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {"epoch": -1, "endpoints": []}


def wait_for(what, cond, timeout, step=0.01):
    """Poll ``cond`` until it holds -> the seconds it took; fail after
    ``timeout``."""
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            fail("fleet: %s did not happen within %.1f s" % (what, timeout))
        time.sleep(step)
    return time.perf_counter() - t0


def plain_rows(dirname, feeds):
    """The plain predictor on the CPU over ``feeds`` -> its one output."""
    from paddle_tpu_torch.inference import AnalysisConfig, AnalysisPredictor

    cfg = AnalysisConfig(dirname)
    cfg.disable_gpu()
    out, = AnalysisPredictor(cfg).run_feed(feeds).values()
    return out


def check_encoder(what, replies, reqs, cfg, *wants):
    """Every reply ok, finite and of its request's shape, and within
    ENCODER_ATOL of each reference in ``wants`` ({index: array}) that
    holds its index -> the largest error."""
    worst = 0.0
    for i, r in enumerate(replies):
        if r is None or r.status != "ok":
            fail("%s request %d: %s" % (what, i, None if r is None
                                         else (r.status, r.error)))
        out, = r.outputs.values()
        rows = reqs[i]["src_ids"].shape[0]
        if out.shape != (rows, SEQ, cfg.hidden) or not np.isfinite(out).all():
            fail("%s request %d: output %s" % (what, i, out.shape))
        for want in wants:
            if i in want:
                worst = max(worst, float(np.abs(out - want[i]).max()))
    if not worst <= ENCODER_ATOL:
        fail("%s: output %.3g from its reference (atol %g)"
             % (what, worst, ENCODER_ATOL))
    return worst


def serving_launches(dcfg, cfg, steps, batches):
    """The kernel launches of ``steps`` decode steps of the decoder
    ``dcfg`` and ``batches`` batches of the BERT encoder ``cfg``: one
    paged attention a layer a step; a flash attention, two fused_ln and,
    on the embeddings, one layer_norm a batch."""
    return {"paged_attention": dcfg.layers * steps,
            "flash_attention": cfg.layers * batches,
            "fused_ln": 2 * cfg.layers * batches, "layer_norm": batches}


def fleet_phase(params, refs, bert_dir, tmp, cfg=None, clients=3,
                start_next=None):
    """Two ``tools/torch_serve.py`` replicas on this card, as a fleet over
    one endpoints file: decode_phase's GPT-2-small weights saved as a
    decoder bundle, encoder_phase's BERT-base directory as "bert" and a
    BERT-base of another weight seed as "bert@v2".  wire_phase's mix
    through ServingClients of the endpoints file, then a canary rollout
    started and flipped, the mix again with rank 1 SIGKILLed once four
    generates are done and its flight recorder shows a decode step in
    progress, rank 1 relaunched, and both retired; each check fails the
    script.  The replicas and this process trace (FLAGS_tracing, one
    telemetry directory): the killed replica's flightrec-<pid>.json must
    name a request in flight at the kill, and one generate and one infer
    must each carry one trace id from the client's root span through the
    replica's admission and request spans to its decode step, or batch,
    execute and executor step.  The earlier phases' launch counts stay the
    rows'.  ``start_next(decoder bundle dir)``, when given, is called as
    rank 1 is relaunched, so the next phase's replicas start beside it.
    -> ({version: {request index: the plain CPU output}}, what
    ``start_next`` returned)."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.core import telemetry
    from paddle_tpu_torch.models.bert import BERT_BASE
    from paddle_tpu_torch.native.rpc import RpcClient
    from paddle_tpu_torch.serving import ServingClient, codec, save_decoder
    from paddle_tpu_torch.serving.engine import _route_hash
    from paddle_tpu_torch.serving.fleetmon import FLEET_RPC_KEY

    cfg = cfg or BERT_BASE
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    t_phase = time.perf_counter()
    dcfg = gpt2_small()
    dec_dir = save_decoder(os.path.join(tmp, "gpt2-small"), dcfg, params)
    bert2_dir = os.path.join(tmp, "bert2")
    build_bert_dir(bert2_dir, cfg, seed=11)
    eps_file = os.path.join(tmp, "endpoints.json")
    eps = ["127.0.0.1:%d" % p for p in free_ports(2)]

    def argv(rank):
        return [sys.executable, "-u", os.path.join(HERE, "tools",
                                                   "torch_serve.py"),
                "--model", "gpt2-small=" + dec_dir, "--model",
                "bert=" + bert_dir, "--model", "bert@v2=" + bert2_dir,
                "--buckets", BUCKETS, "--decode-buckets", "4,8",
                "--kv-blocks", "520", "--rank", str(rank), "--fleet",
                ",".join(eps), "--endpoints-file", eps_file,
                "--device", FLEET_DEVICE]

    tel = os.path.join(tmp, "fleet-trace")
    env = dict(os.environ, FLAGS_tracing="1", FLAGS_telemetry_dir=tel,
               **FLEET_ENV)
    set_flags({"FLAGS_tracing": True, "FLAGS_telemetry_dir": tel})
    reps = {}
    first, late = prompts(dcfg.vocab)
    allp = first + [late]
    enc = encoder_requests(cfg)
    # the canary's requests: the first row of each encoder request
    canary = [{k: v[:1] for k, v in q.items()} for q in enc]
    try:
        t0 = time.perf_counter()
        for r in (0, 1):
            reps[r] = Replica(argv(r), env)
        # the plain CPU outputs of every encoder request under both
        # versions, while the replicas start
        stacked = {k: np.concatenate([q[k] for q in enc]) for k in enc[0]}
        cuts = np.cumsum([q["src_ids"].shape[0] for q in enc])[:-1]
        plain_v = {v: dict(enumerate(np.split(plain_rows(d, stacked), cuts)))
                   for v, d in (("bert", bert_dir), ("bert@v2", bert2_dir))}
        for r in (0, 1):
            manifest = reps[r].ready("fleet replica %d" % r)
            if manifest is None or manifest.get("device") != kind:
                fail("fleet replica %d prewarmed on %r, not the card %r"
                     % (r, None if manifest is None
                        else manifest.get("device"), kind))
            print("fleet: replica %d PREWARM on %s: %s"
                  % (r, manifest["device"], json.dumps(
                      {m: sorted(v, key=int) for m, v in manifest.items()
                       if m != "device"})), flush=True)
        wait_for("the endpoints file listing both replicas",
                 lambda: endpoints_doc(eps_file)["endpoints"] == eps, 60.0)
        print("fleet: 2 replicas (GPT-2 small, BERT-base, BERT-base@v2) "
              "ready and published in %.1f s" % (time.perf_counter() - t0),
              flush=True)
        cli = [ServingClient(endpoints_file=eps_file, deadline_ms=600000.0)
               for _ in range(clients)]

        def gen(k, i, p, mode, got):
            return client_gen(cli[k], p, mode, got)

        # 1. healthy traffic
        replies, enc_replies, chunks, walls = drive_mix(
            allp, enc, gen, lambda k, i, f: cli[k].infer("bert", f),
            clients, "fleet")
        for i, r in enumerate(replies):
            if r is None or r.status != "ok":
                fail("fleet request %d: %s" % (i, None if r is None
                                               else (r.status, r.error)))
        check_decode_tokens("fleet", allp, replies, refs)
        check_chunks("fleet", replies, chunks, clients)
        worst = check_encoder("fleet encoder", enc_replies, enc, cfg,
                              plain_v["bert"])
        ntok = sum(len(r.outputs["tokens"]) for r in replies)

        def fleet_counts():
            snaps = [telemetry.scrape(ep, timeout=10.0) for ep in eps]
            return (sum(v for s in snaps for k, v in s["counters"].items()
                        if k.startswith("serving_requests_total{model=bert,")),
                    sum(v for s in snaps for k, v in s["counters"].items()
                        if k.startswith("serving_tokens_generated_total{")))

        counted = [None]

        def counts_match():
            counted[0] = fleet_counts()
            return counted[0] == (len(enc), ntok)

        t_c = time.perf_counter()
        while not counts_match():
            if time.perf_counter() - t_c > 15.0:
                fail("fleet: the replicas' __metrics__ count %s (bert "
                     "requests, tokens generated), the clients %s"
                     % (counted[0], (len(enc), ntok)))
            time.sleep(0.2)
        doc = [None]

        def fleet_doc_lists_both():
            doc[0] = telemetry.scrape(eps[0], timeout=10.0,
                                      key=FLEET_RPC_KEY)
            return doc[0]["replicas_up"] == 2 and [
                row["endpoint"] for row in doc[0]["replicas"]] == eps

        wait_for("the coordinator's __fleet__ document listing both",
                 fleet_doc_lists_both, 15.0, step=0.2)
        print("fleet: %d generates and %d encoder requests ok from %d "
              "client threads; tokens equal the plain loop's (near ties "
              "aside), streamed chunks 0..n-1 once each, every encoder "
              "reply within %.3g of the plain CPU predictor's (atol %g); "
              "the replicas' __metrics__ sum to "
              "%d bert requests and %d tokens; __fleet__ lists %d replicas"
              % (len(replies), len(enc), clients, worst, ENCODER_ATOL,
                 counted[0][0], counted[0][1], doc[0]["replicas_up"]),
              flush=True)
        print("fleet: %s; decode %d tokens in %.3f s = %.2f tokens/s; "
              "encoder %d requests in %.3f s = %.2f requests/s (2 replicas "
              "on one card, %d client threads, all traced)"
              % (card, ntok, walls["decode"], ntok / walls["decode"],
                 len(enc), walls["encoder"], len(enc) / walls["encoder"],
                 clients), flush=True)
        pids = {reps[r].proc.pid for r in (0, 1)}
        for root, chain in trace_chains(tel, pids):
            print("fleet: one trace %s: %s (replica %s)"
                  % (root["tid"], " -> ".join(chain),
                     root["attrs"].get("endpoint")), flush=True)

        # 2. a canary rollout, then the flip
        ctl = cli[0]
        epoch0 = endpoints_doc(eps_file)["epoch"]
        route = {"active": "bert", "canary": "bert@v2",
                 "fraction": CANARY_FRACTION, "state": "canary"}
        got = ctl.rollout({"op": "start", "model": "bert", "active": "bert",
                           "canary": "bert@v2",
                           "fraction": CANARY_FRACTION})
        if got.get("status") != "ok":
            fail("fleet: rollout start answered %s" % got)

        def converged(want):
            doc = endpoints_doc(eps_file)
            return doc.get("rollout") == want and doc["epoch"] > epoch0 \
                and all(ctl.rollout_state(ep) == want for ep in eps)

        start_s = wait_for("the canary route on both replicas and in the "
                           "endpoints file", lambda: converged(
                               {"models": {"bert": route}}), CONVERGE_S)
        ids = ["canary-%02d" % i for i in range(len(canary))]
        to_v2 = [_route_hash(rid) < CANARY_FRACTION for rid in ids]
        if all(to_v2) or not any(to_v2):
            fail("fleet: the canary ids split %d/%d" % (sum(to_v2),
                                                       len(ids)))
        cerr = 0.0
        for i, q in enumerate(canary):
            r = ctl.infer("bert", q, req_id=ids[i])
            want = "bert@v2" if to_v2[i] else "bert"
            if r.status != "ok" or r.phases.get("model") != want:
                fail("fleet canary request %s: %s on %s, the route hash "
                     "sends it to %s" % (ids[i], r.status,
                                         r.phases.get("model"), want))
            out, = r.outputs.values()
            cerr = max(cerr, float(np.abs(out - plain_v[want][i][:1])
                                   .max()))
        if not cerr <= ENCODER_ATOL:
            fail("fleet canary outputs %.3g from their versions' plain "
                 "outputs" % cerr)
        epoch0 = endpoints_doc(eps_file)["epoch"]
        if ctl.rollout({"op": "flip", "model": "bert"}).get("status") \
                != "ok":
            fail("fleet: the flip was refused")
        flipped = {"models": {"bert": {"active": "bert@v2", "canary": None,
                                       "fraction": 0.0,
                                       "state": "flipped"}}}
        flip_s = wait_for("the flip on both replicas and in the file",
                          lambda: converged(flipped), CONVERGE_S)
        for i in range(6):
            r = cli[i % clients].infer("bert", canary[i])
            out, = r.outputs.values()
            if r.status != "ok" or r.phases.get("model") != "bert@v2" or \
                    not float(np.abs(out - plain_v["bert@v2"][i][:1])
                              .max()) <= ENCODER_ATOL:
                fail("fleet: after the flip request %d went to %s (%s)"
                     % (i, r.phases.get("model"), r.status))
        print("fleet: canary %.2f started, on both replicas and in the "
              "file in %.3f s; %d of %d requests on bert@v2, each exactly "
              "where the route hash sends it, outputs max_abs_err %.3g "
              "from their versions' plain outputs; flipped in %.3f s, the "
              "next 6 requests all on bert@v2"
              % (CANARY_FRACTION, start_s, sum(to_v2), len(ids), cerr,
                 flip_s), flush=True)

        # 3. rank 1 SIGKILLed mid-traffic
        epoch0 = endpoints_doc(eps_file)["epoch"]
        lock = threading.Lock()
        kill = {"t": None, "shrink": None, "done": 0}
        spans = []

        def watch():
            while time.perf_counter() - kill["t"] < 60.0:
                if endpoints_doc(eps_file)["endpoints"] == [eps[0]]:
                    kill["shrink"] = time.perf_counter()
                    return
                time.sleep(0.005)

        watcher = threading.Thread(target=watch, daemon=True)

        def timed(fn):
            t0 = time.perf_counter()
            r = fn()
            spans.append((t0, time.perf_counter()))
            return r

        victim_rec = os.path.join(tel, "flightrec-%d.json"
                                  % reps[1].proc.pid)

        def killer():
            # kill while rank 1 is mid-decode: its newest note a decode
            # step dumped within the last 0.25 s (bounded wait)
            t_end = time.perf_counter() + 10.0
            while time.perf_counter() < t_end:
                last = last_work_note(victim_rec)
                if last is not None and last["kind"] == "decode_step" \
                        and time.time() - last["ts"] / 1e6 < 0.25:
                    break
                time.sleep(0.005)
            kill["wall"] = time.time()
            kill["t"] = time.perf_counter()
            reps[1].proc.kill()
            watcher.start()

        def gen3(k, i, p, mode, got):
            r = timed(lambda: client_gen(cli[k], p, mode, got))
            with lock:
                kill["done"] += 1
                if kill["done"] == 4:
                    kill["thread"] = threading.Thread(target=killer,
                                                      daemon=True)
                    kill["thread"].start()
            return r

        replies, enc_replies, chunks, walls = drive_mix(
            allp, enc, gen3,
            lambda k, i, f: timed(lambda: cli[k].infer("bert", f)),
            clients, "fleet kill")
        kill["thread"].join(60.0)
        rc = reps[1].wait(30.0)
        if rc != -9:
            fail("fleet: the SIGKILLed replica's wait() gave %r" % rc)
        watcher.join(60.0)
        for i, r in enumerate(replies):
            if r is None or r.status != "ok":
                fail("fleet kill request %d: %s" % (i, None if r is None
                                                    else (r.status,
                                                          r.error)))
        check_decode_tokens("fleet kill", allp, replies, refs)
        check_chunks("fleet kill", replies, chunks, clients)
        worst = check_encoder("fleet kill encoder", enc_replies, enc, cfg,
                              plain_v["bert@v2"])
        doc = endpoints_doc(eps_file)
        if kill["shrink"] is None or doc["epoch"] <= epoch0:
            fail("fleet: the file never shrank to the survivor: %s" % doc)
        shrink_s = kill["shrink"] - kill["t"]
        if shrink_s > FLEET_HB_TIMEOUT + 5.0:
            fail("fleet: the file shrank %.3f s after the kill, past %.1f"
                 % (shrink_s, FLEET_HB_TIMEOUT + 5.0))
        straddle = [(b - a) * 1e3 for a, b in spans
                    if a < kill["t"] < b]
        if not straddle:
            fail("fleet: no request was in flight at the kill")
        print("fleet: %s; rank 1 SIGKILLed after 4 generates (rc %d); "
              "%d generates and %d encoder requests all ok (every encoder "
              "reply within %.3g of bert@v2's plain output), %d client "
              "failovers; the file shrank to the survivor %.3f s after the "
              "kill (heartbeat timeout %.1f s), epoch %d; the %d requests "
              "in flight at the kill: client latency p50 %.1f ms, max %.1f "
              "ms" % (card, rc, len(replies), len(enc), worst,
                      sum(c.failovers for c in cli), shrink_s,
                      FLEET_HB_TIMEOUT, doc["epoch"], len(straddle),
                      float(np.percentile(straddle, 50)), max(straddle)),
              flush=True)
        postmortem("fleet", victim_rec, in_flight(tel, kill["wall"]),
                   kill["wall"], card)

        # 4. rank 1 relaunched
        nxt = start_next(dec_dir) if start_next is not None else None
        t0 = time.perf_counter()
        reps[1] = Replica(argv(1), env)
        reps[1].ready("relaunched fleet replica 1")
        rejoin_s = wait_for("the relaunched replica rejoining the file",
                            lambda: endpoints_doc(eps_file)["endpoints"]
                            == eps, 60.0)
        conv_s = wait_for("the flipped route on the relaunched replica",
                          lambda: ctl.rollout_state(eps[1]) == flipped,
                          4 * REBROADCAST_S)
        c1 = ServingClient(endpoints=[eps[1]], deadline_ms=600000.0)
        for i in range(2):
            r = c1.infer("bert", canary[i])
            out, = r.outputs.values()
            if r.status != "ok" or r.phases.get("model") != "bert@v2" or \
                    not float(np.abs(out - plain_v["bert@v2"][i][:1])
                              .max()) <= ENCODER_ATOL:
                fail("fleet: the relaunched replica's request %d: %s on %s"
                     % (i, r.status, r.phases.get("model")))
        r = c1.generate("gpt2-small", allp[0], max_new_tokens=32)
        if r.status != "ok":
            fail("fleet: the relaunched replica's generate: %s"
                 % ((r.status, r.error),))
        check_decode_tokens("fleet rejoin", allp[:1], [r], refs[:1])
        print("fleet: rank 1 relaunched, in the file %.3f s after its "
              "READY (%.1f s from the launch), its routes converged in "
              "%.3f s; 2 encoder requests and 1 generate on it ok"
              % (rejoin_s, time.perf_counter() - t0, conv_s), flush=True)

        # 5. retire both; each replica's launches since its READY
        launches, served = {}, {}
        for r in (1, 0):
            c = RpcClient(eps[r], connect_timeout=10.0, rpc_deadline=30.0,
                          retry_times=0)
            try:
                c.send_var(codec.RETIRE_KEY, codec.pack({}))
            finally:
                c.close()
            rc = reps[r].wait(120.0)
            launches[r] = reps[r].line("LAUNCHES ")
            served[r] = reps[r].line("SERVED ")
            if rc != 0 or launches[r] is None or served[r] is None:
                fail("fleet replica %d after __retire__: rc %r, LAUNCHES "
                     "%s, SERVED %s; output ends:\n%s"
                     % (r, rc, launches[r], served[r], reps[r].tail()))
        for r, what in ((0, "the survivor"), (1, "relaunched")):
            steps = served[r]["decode_steps"]
            nb = served[r]["encoder_batches"]
            want = serving_launches(dcfg, cfg, steps, nb)
            print("fleet: rank %d (%s) retired and exited 0; launches %s "
                  "over %d decode steps and %d encoder batches since its "
                  "READY" % (r, what, json.dumps(launches[r]), steps, nb),
                  flush=True)
            if launches[r] != want or steps == 0 or nb == 0:
                fail("fleet: rank %d launches %s, want %s"
                     % (r, launches[r], want))
    finally:
        set_flags({"FLAGS_tracing": False, "FLAGS_telemetry_dir": ""})
        for rep in reps.values():
            rep.kill()
    print("fleet: %s; phase wall %.1f s" % (card, time.perf_counter()
                                            - t_phase), flush=True)
    return plain_v, nxt


def last_work_note(path):
    """The newest ``batch_start`` or ``decode_step`` note of a flight
    record, or None (no file yet, or one being replaced)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    notes = [r for r in doc.get("records", [])
             if r.get("kind") in ("batch_start", "decode_step")]
    return notes[-1] if notes else None


def in_flight(tel, wall):
    """{req_id: root span name} of this process's client root spans (in
    ``tel``'s trace-<pid>.jsonl) open at the wall-clock time ``wall``."""
    us = wall * 1e6
    recs = read_trace(os.path.join(tel, "trace-%d.jsonl" % os.getpid()))
    return {r["attrs"]["req_id"]: r["name"] for r in recs
            if r.get("t") == "span" and r["name"].startswith("client.")
            and r["ts"] <= us <= r["ts"] + r["dur"]}


def postmortem(what, path, flying, wall, card):
    """The SIGKILLed replica's flight record: its newest batch_start or
    decode_step note must name a request of ``flying`` (open at the
    kill) -> that note."""
    note = last_work_note(path)
    if note is None:
        fail("%s: the SIGKILLed replica left no flight record with work "
             "(%s)" % (what, path))
    with open(path) as f:
        doc = json.load(f)
    named = [rid for rid in note.get("req_ids", []) if rid in flying]
    if not named:
        fail("%s: the postmortem's last %s names %s; in flight at the kill "
             "were %s" % (what, note["kind"], note.get("req_ids"),
                          sorted(flying)))
    where = "step %s" % note["step"] if "step" in note \
        else "bucket %s" % note.get("bucket")
    print("%s: %s; postmortem %s (reason %r, %d records, last dumped %.3f "
          "s before the kill): last %s, %s of %s, naming %s; in flight at "
          "the kill: %s" % (what, card, os.path.basename(path),
                            doc["reason"], len(doc["records"]),
                            wall - doc["dumped_at"] / 1e6, note["kind"],
                            where, note.get("model"), note["req_ids"],
                            ", ".join("%s %s" % (flying[r], r)
                                      for r in named)), flush=True)
    return note


def trace_chains(tel, pids):
    """One traced generate and one traced infer of this process's clients,
    followed through the replicas' trace-<pid>.jsonl (``pids``): client
    root -> serving.admission -> serving.request, which a
    serving.decode_step links (generate), or a serving.batch links whose
    serving.execute parents an executor.step (infer) -> [(root, chain of
    span names)]; fails when either is missing."""
    mine = read_trace(os.path.join(tel, "trace-%d.jsonl" % os.getpid()))
    theirs = []
    for pid in pids:
        path = os.path.join(tel, "trace-%d.jsonl" % pid)
        if os.path.exists(path):
            theirs += [r for r in read_trace(path) if r.get("t") == "span"]
    by_parent, linking = {}, {}
    for r in theirs:
        by_parent.setdefault((r["name"], r["parent"]), r)
        for link in r.get("links") or ():
            linking.setdefault((r["name"], tuple(link)), r)
    out = []
    for root_name, tail in (("client.generate", ("serving.decode_step",)),
                            ("client.infer", ("serving.batch",
                                              "serving.execute",
                                              "executor.step"))):
        found = None
        for root in (r for r in mine if r.get("t") == "span"
                     and r["name"] == root_name
                     and r["attrs"].get("status") == "ok"):
            adm = by_parent.get(("serving.admission", root["sid"]))
            req = adm and by_parent.get(("serving.request", adm["sid"]))
            if not req or not adm["tid"] == req["tid"] == root["tid"]:
                continue
            node = linking.get((tail[0], (req["tid"], req["sid"])))
            for name in tail[1:]:
                node = node and by_parent.get((name, node["sid"]))
            if node is not None:
                found = (root, [root_name, "serving.admission",
                                "serving.request", "(linked by) "
                                + " -> ".join(tail)])
                break
        if found is None:
            fail("fleet: no %s carried one trace id through a replica's "
                 "admission, request and %s spans" % (root_name,
                                                      " -> ".join(tail)))
        out.append(found)
    return out


# -- phase 5d: faults and the autoscaler ----------------------------------------

# the faults replica's spec: the first two encoder batches fail; the decode
# loop's 21st iteration with work SIGKILLs the replica, after 20 steps
FAULT_KILL_SKIP = 20
FAULT_SPEC = ("serving.execute.bert:error:1:2;"
              "serving.decode_step:kill:1:1:%d" % FAULT_KILL_SKIP)
# the client's RPC faults: three frames lost before the wire, three
# replies lost after delivery; each failure costs the client one attempt
CLIENT_FAULTS = "rpc.send:drop:1:3;rpc.get:error:1:3"
FAULT_ATTEMPTS = 8
# the autoscaler's flags: a 0.25 s poll, 2 ticks of pressure (queue depth
# >= FLAGS_serving_scale_up_depth, default 4) to scale up, 8 idle ticks
# to scale down, 4 ticks of cooldown after each event
AUTOSCALE_ENV = {"FLAGS_serving_autoscale_interval": "0.25",
                 "FLAGS_serving_scale_up_ticks": "2",
                 "FLAGS_serving_scale_down_ticks": "8",
                 "FLAGS_serving_autoscale_cooldown": "4",
                 "FLAGS_serving_fleetmon_interval": "0.5"}
BURST_CLIENTS = 16


def start_leftovers(bert_dir, dec_dir, tmp):
    """Start the next two ``tools/torch_serve.py`` processes on the card
    together: a traced replica with FAULT_SPEC armed (``faults_phase``)
    and rank 0 of a two-slot fleet with ``--autoscale`` and tracing off
    (``autoscale_phase``) -> what ``leftovers_phase`` needs."""
    got = {"t0": time.perf_counter(),
           "ftel": os.path.join(tmp, "faults-trace"),
           "atel": os.path.join(tmp, "autoscale-telemetry"),
           "eps_file": os.path.join(tmp, "autoscale-endpoints.json")}
    fport, *slots = free_ports(3)
    got["fep"] = "127.0.0.1:%d" % fport
    got["eps"] = ["127.0.0.1:%d" % p for p in slots]
    serve = [sys.executable, "-u", os.path.join(HERE, "tools",
                                                "torch_serve.py"),
             "--device", FLEET_DEVICE, "--buckets", BUCKETS,
             "--model", "bert=" + bert_dir]
    got["faults"] = Replica(serve + [
        "--port", str(fport), "--model", "gpt2-small=" + dec_dir,
        "--decode-buckets", "4,8", "--kv-blocks", "520"],
        dict(os.environ, FLAGS_tracing="1", FLAGS_telemetry_dir=got["ftel"],
             FLAGS_fault_spec=FAULT_SPEC, **FLEET_ENV))
    got["autoscale"] = Replica(serve + [
        "--rank", "0", "--fleet", ",".join(got["eps"]), "--endpoints-file",
        got["eps_file"], "--autoscale", "--min-replicas", "1",
        "--max-replicas", "2"],
        dict(os.environ, FLAGS_telemetry_dir=got["atel"], **FLEET_ENV,
             **AUTOSCALE_ENV))
    return got


def leftovers_phase(started, plain_v, allp, cfg=None):
    """``faults_phase`` and ``autoscale_phase`` on the replicas of
    ``start_leftovers``, each stopped after."""
    from paddle_tpu_torch.models.bert import BERT_BASE

    cfg = cfg or BERT_BASE
    standby = []
    try:
        faults_phase(started["faults"], started["fep"], started["ftel"],
                     plain_v, allp, cfg)
        autoscale_phase(started["autoscale"], started["eps"],
                        started["eps_file"], started["atel"], standby,
                        plain_v, cfg)
    finally:
        started["faults"].kill()
        started["autoscale"].kill()
        for pid in standby:
            try:
                os.kill(pid, 9)
            except OSError:
                pass
    print("faults and autoscale: %s; %.1f s from their replicas' launch "
          "(beside the fleet's relaunch)"
          % (card_line(), time.perf_counter() - started["t0"]), flush=True)


def faults_phase(rep, ep, tel, plain_v, allp, cfg):
    """One traced replica under FAULT_SPEC: six encoder requests one at a
    time (exactly the first two fail, with the reference's error reply,
    the rest equal the plain outputs); CLIENT_FAULTS armed in this
    process, four encoder requests all ok through the retries; then one
    generate, during which the decode loop's kill point SIGKILLs the
    replica after FAULT_KILL_SKIP steps, its flight record naming the
    request and that step."""
    from paddle_tpu_torch.native.rpc import RpcClient
    from paddle_tpu_torch.serving import ServingClient, codec
    from paddle_tpu_torch.utils import fault_injection

    card = card_line()
    manifest = rep.ready("faults replica")
    if manifest is None or manifest.get("device") != \
            torch.cuda.get_device_name(0):
        fail("faults replica prewarmed on %r" % (manifest,))
    print("faults: replica READY %.1f s after its launch, armed %r"
          % (rep.all("READY ")[0][0] - rep.t_launch, FAULT_SPEC),
          flush=True)
    cli = ServingClient(endpoints=[ep], deadline_ms=600000.0)
    order = [0, 12, 23, 0, 12, 23]
    enc = encoder_requests(cfg)
    got = [cli.infer("bert", enc[i]) for i in order]
    status = [r.status for r in got]
    errors = [r.error for r in got[:2]]
    if status != ["error", "error"] + ["ok"] * 4 or not all(
            "injected execute fault (bert)" in (e or "") for e in errors):
        fail("faults: serving.execute.bert:error:1:2 gave %s"
             % [(r.status, r.error) for r in got])
    check_encoder("faults encoder", got[2:], [enc[i] for i in order[2:]],
                  cfg, {k: plain_v["bert"][i]
                        for k, i in enumerate(order[2:])})
    fault_injection.arm(CLIENT_FAULTS)
    try:
        got = [cli.infer("bert", enc[i], max_attempts=FAULT_ATTEMPTS)
               for i in order[2:]]
        stats = fault_injection.fault_stats()
    finally:
        fault_injection.disarm()
    check_encoder("faults rpc", got, [enc[i] for i in order[2:]], cfg,
                  {k: plain_v["bert"][i] for k, i in enumerate(order[2:])})
    if stats["rpc.send"][1] != 3 or stats["rpc.get"][1] != 3:
        fail("faults: the client's points fired %s" % stats)
    print("faults: %s; serving.execute.bert:error:1:2 failed exactly the "
          "first 2 of 6 encoder requests (%r), the other 4 within "
          "ENCODER_ATOL of the plain CPU output; %s on the client: 4 "
          "requests all ok after %d failovers (checks, firings %s)"
          % (card, errors[0], CLIENT_FAULTS, cli.failovers,
             json.dumps(stats)), flush=True)
    # the kill: a generate under a known id, then the process must die
    c = RpcClient(ep, connect_timeout=10.0, rpc_deadline=60.0,
                  retry_times=0)
    t_kill = time.perf_counter()
    try:
        c.send_var(codec.GEN_KEY + "fault-kill", codec.pack(
            {"model": "gpt2-small", "max_new_tokens": 32,
             "deadline_ms": 600000.0}, [np.asarray(allp[0], np.int32)]))
    finally:
        c.close()
    rc = rep.wait(120.0)
    wall = time.time()
    if rc != -9:
        fail("faults: serving.decode_step:kill left the replica with rc %r"
             % rc)
    path = os.path.join(tel, "flightrec-%d.json" % rep.proc.pid)
    note = postmortem("faults", path, {"fault-kill": "generate"}, wall,
                      card)
    with open(path) as f:
        last = json.load(f)["records"][-1]
    if note["step"] != FAULT_KILL_SKIP or last.get("kind") != "fault" \
            or last.get("point") != "serving.decode_step" \
            or last.get("fault_kind") != "kill":
        fail("faults: the flight record ends with %s after step %s, want "
             "the kill after step %d" % (last, note["step"],
                                         FAULT_KILL_SKIP))
    print("faults: %s; serving.decode_step:kill:1:1:%d SIGKILLed the "
          "replica %.3f s after the generate was sent (rc %d); its flight "
          "record ends with the fault note (%s at %s) after decode step "
          "%d of request fault-kill"
          % (card, FAULT_KILL_SKIP, time.perf_counter() - t_kill, rc,
             last["fault_kind"], last["point"], note["step"]), flush=True)


def autoscale_phase(rep, eps, eps_file, tel, standby, plain_v, cfg):
    """Rank 0 alone in a two-slot fleet with --autoscale (tracing off):
    once slot 1 is evicted, BURST_CLIENTS threads send encoder requests
    until a standby forked into slot 1 is in the endpoints file and has
    served; then the traffic stops and the coordinator must retire it
    through a drain (its SERVED and LAUNCHES printed, the file back to
    rank 0).  Every reply ok and equal to the plain output; nothing under
    the telemetry directory from tracing."""
    from paddle_tpu_torch.core import telemetry
    from paddle_tpu_torch.serving import ServingClient

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    manifest = rep.ready("autoscale rank 0")
    if manifest is None or manifest.get("device") != kind:
        fail("autoscale rank 0 prewarmed on %r" % (manifest,))
    # the dead slot leaves the file by eviction or by a scale-down
    evict_s = wait_for("slot 1 out of the file", lambda: endpoints_doc(
        eps_file)["endpoints"] == eps[:1], 30.0)
    enc = encoder_requests(cfg)
    stop = threading.Event()
    replies = []
    lock = threading.Lock()

    def client(k):
        cli = ServingClient(endpoints_file=eps_file, deadline_ms=600000.0)
        i = k
        while not stop.is_set():
            r = cli.infer("bert", enc[i % len(enc)])
            with lock:
                replies.append((i % len(enc), r, time.perf_counter()))
            i += BURST_CLIENTS

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(BURST_CLIENTS)]
    to_wall = time.time() - time.perf_counter()
    t_burst = time.perf_counter()
    for th in threads:
        th.start()
    try:
        wait_for("the standby's READY", lambda: len(rep.all("READY ")) == 2,
                 FLEET_READY_S)
        t_ready, ready = rep.all("READY ")[1]
        standby.append(int(ready.split("pid=")[1]))
        if ready.split()[0] != "port=" + eps[1].rsplit(":", 1)[1]:
            fail("autoscale: the standby came up as %r, not slot 1" % ready)
        joined_s = wait_for("the file listing the standby", lambda:
                            endpoints_doc(eps_file)["endpoints"] == eps, 60.0)

        def standby_batches():
            return sum(v for k, v in telemetry.scrape(
                eps[1], timeout=10.0)["counters"].items()
                if k.startswith("serving_batches_total{"))

        wait_for("the standby serving 3 batches",
                 lambda: standby_batches() >= 3, 60.0, step=0.2)
    finally:
        stop.set()
        for th in threads:
            th.join(900)
    if any(th.is_alive() for th in threads):
        fail("autoscale: a burst client did not finish")
    t_last = max(t for _i, _r, t in replies)
    marks = {}

    def retired():
        if "shrink" not in marks and \
                endpoints_doc(eps_file)["endpoints"] == eps[:1]:
            marks["shrink"] = time.perf_counter()
        return "shrink" in marks and len(rep.all("LAUNCHES ")) == 1

    wait_for("the standby retired and the file back to rank 0", retired,
             120.0, step=0.005)
    t_served, served = rep.all("SERVED ")[0]
    served = json.loads(served)
    launches = json.loads(rep.all("LAUNCHES ")[0][1])
    # rank 0's scaling events, wall clock, from its steps.jsonl
    events = [e for e in read_trace(os.path.join(tel, "steps.jsonl"))
              if e.get("ev") == "autoscale"]
    ups = [e["t"] - to_wall for e in events if e["dir"] == "up"]
    downs = [e["t"] - to_wall for e in events if e["dir"] == "down"
             and e["t"] - to_wall > t_last]
    if len(ups) != 1 or len(downs) != 1:
        fail("autoscale: rank 0's scaling events %s" % events)
    bad = [(i, r.status, r.error) for i, r, _t in replies if r.status != "ok"]
    if bad:
        fail("autoscale: %d of %d burst requests failed: %s"
             % (len(bad), len(replies), bad[:5]))
    worst = 0.0
    for i, r, _t in replies:
        out, = r.outputs.values()
        worst = max(worst, float(np.abs(out - plain_v["bert"][i]).max()))
    if not worst <= ENCODER_ATOL:
        fail("autoscale: burst outputs %.3g from the plain CPU output"
             % worst)
    devices = [json.loads(m)["device"] for _t, m in rep.all("PREWARM ")]
    nb = served["encoder_batches"]
    want = serving_launches(gpt2_small(), cfg, 0, nb)
    if served["rank"] != 1 or nb == 0 or launches != want \
            or devices != [kind, kind]:
        fail("autoscale: the standby's SERVED %s, LAUNCHES %s (want %s), "
             "devices %s" % (served, launches, want, devices))
    if trace_files(tel):
        fail("autoscale: tracing off wrote %s" % trace_files(tel))
    snap = telemetry.scrape(eps[0], timeout=10.0)["counters"]
    print("autoscale: %s; rank 0 alone in the file %.1f s after its READY; "
          "%d client threads: scale-up %.3f s after the burst began, the "
          "standby (pid %d, on %s) READY %.3f s after the scale-up, in "
          "the file %.3f s after that; %d requests all ok, max_abs_err "
          "%.3g from the plain CPU output (atol %g); after the last reply: "
          "scale-down %.3f s, the file back to rank 0 %.3f s, the "
          "standby's SERVED %.3f s (a drain: %d encoder batches, launches "
          "%s); autoscale events %s"
          % (card, evict_s, BURST_CLIENTS, ups[0] - t_burst, standby[0],
             devices[1], t_ready - ups[0], joined_s, len(replies), worst,
             ENCODER_ATOL, downs[0] - t_last, marks["shrink"] - t_last,
             t_served - t_last, nb, json.dumps(launches), json.dumps(
                 {k: v for k, v in snap.items()
                  if k.startswith("autoscale_events_total")})), flush=True)


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
            "bn_fold": cb.bn_fold,
            "fused_momentum": fm.fused_momentum_step,
            "embedding_bag": eb.embedding_bag,
            "channel_stats": cst.stats,
            "affine_stats": cst.affine_stats}


def sub_counted():
    """{name: (wrapper, counter)}: the launches of the bf16
    instantiations (dropout, row 14) and of rows 9 and 10 writing the
    param carry's bf16 copies, counted beside each wrapper's total."""
    from paddle_tpu_torch.kernels import dropout as dk
    from paddle_tpu_torch.kernels import fused_adam as fad
    from paddle_tpu_torch.kernels import fused_momentum as fm
    from paddle_tpu_torch.kernels import layer_norm as ln

    return {"dropout (bf16)": (dk.dropout, "launches_bf16"),
            "layer_norm (bf16)": (ln.layer_norm_2d, "launches_bf16"),
            "fused_adam (carry)": (fad.fused_adam_step, "launches_carry"),
            "fused_momentum (carry)": (fm.fused_momentum_step,
                                       "launches_carry")}


def launch_counts():
    counts = {k: f.launches for k, f in counted().items()}
    counts.update({k: getattr(f, a) for k, (f, a) in sub_counted().items()})
    return counts


def zero_counts():
    for f in counted().values():
        f.launches = 0
    for f, a in sub_counted().values():
        setattr(f, a, 0)


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


# -- phase 6b: BERT-base under the bf16 AMP policy ----------------------------

# launches a step of BERT-base's AMP program (the composed emission under
# decorate(Adam)): the f32 program's, of which the 12 attention-probs
# dropouts and the head's LayerNorm take the bf16 instantiations and the
# fused Adam writes the carried weights' copies; the embeddings' dropout
# and LayerNorm and the fused epilogues (an f32 residual) stay f32
AMP_STEP_LAUNCHES = dict(STEP_LAUNCHES[COMPOSED], **{
    "dropout (bf16)": 12, "layer_norm (bf16)": 1, "fused_adam (carry)": 1})


def busy_ms(step, n=2):
    """(device busy ms a step, the device's idle share over the kernels'
    span) of ``n`` profiled calls of ``step``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    ks = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ks:
        fail("the profiler recorded no device activity")
    busy = sum(e.time_range.elapsed_us() for e in ks)
    span = max(e.time_range.end for e in ks) \
        - min(e.time_range.start for e in ks)
    return busy / 1e3 / n, 1.0 - busy / span


def carry_is_the_cast(scope, plan):
    """Each carried weight's cached bf16 copy is bitwise its master's
    cast (the executor keeps them per scope)."""
    cache = scope.__dict__.get("_layout_carry_cache", {})
    return all(cache[n][0] is scope.find_var(n).get_tensor().get()
               and torch.equal(cache[n][2], cache[n][0].to(torch.bfloat16))
               for n in plan.carry_names)


def plan_of(exe, main_p):
    return [p for p in exe._cache.values() if p.block.program is main_p][-1]


def twin_programs(build, amps=(False, True)):
    """{amp: (main, startup, loss)} of ``build(amp)`` built once per
    ``amps`` under one name scope each, so the AMP program and its f32
    twin share their variable names and initial state."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.utils import unique_name

    out = {}
    for amp in amps:
        main_p, startup = framework.Program(), framework.Program()
        startup.random_seed = 11
        with unique_name.guard(), framework.program_guard(main_p, startup):
            out[amp] = (main_p, startup, build(amp))
    return out


def amp_steps(main_p, loss, init, feed, steps, check_carry=True):
    """``steps`` steps of ``main_p`` on the card from ``init``, the counts
    zeroed just before -> (losses, host ms a step, launch counts, plan,
    (busy ms, idle) of two more profiled steps)."""
    from paddle_tpu_torch.core import Executor, Scope, scope_from_numpy

    exe = Executor()
    sc = scope_from_numpy(Scope(), init, exe.device, program=main_p)
    torch.cuda.synchronize()
    zero_counts()
    losses, ms = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        out, = exe.run(main_p, feed=feed, fetch_list=[loss], scope=sc)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out.reshape(-1)[0]))
        if check_carry and not carry_is_the_cast(sc, plan_of(exe, main_p)):
            fail("a carried weight's bf16 copy is not its master's cast "
                 "after step %d" % i)
    launches = launch_counts()
    busy = busy_ms(lambda: exe.run(main_p, feed=feed, fetch_list=[loss],
                                   scope=sc))
    return losses, ms, launches, plan_of(exe, main_p), busy


def amp_train_phase(cfg):
    """BERT-base pretraining under decorate(Adam(1e-4)) (the composed
    emission at dropout 0.1), TRAIN_STEPS steps at batch 32 -> the launch
    counts; beside it the f32 twin from the same state: the first loss,
    host ms and busy; and the CPU's plain path from one state."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.core import Executor, Scope, scope_to_numpy
    from paddle_tpu_torch.models.bert import build_pretrain, pretrain_feed

    progs = twin_programs(lambda amp: build_pretrain(cfg, SEQ, lr=1e-4,
                                                     amp=amp)[1])
    main_p, startup, loss = progs[True]
    exe, scope = Executor(), Scope()
    exe.run(startup, scope=scope)
    init = scope_to_numpy(scope, main_p)
    del scope
    feed = pretrain_feed(np.random.RandomState(3), cfg, TRAIN_BATCH, SEQ)
    losses, ms, launches, plan, (busy, idle) = amp_steps(
        main_p, loss, init, feed, TRAIN_STEPS)
    print("train AMP: BERT-base under decorate(Adam(1e-4)), dropout %g, "
          "seq %d, batch %d; %d carried weights; %d steps, losses %s; "
          "step_ms %s, p50 %.3f (the first fuses, plans and casts the "
          "carry); busy %.3f ms/step, idle %.3f; launches %s"
          % (cfg.dropout, SEQ, TRAIN_BATCH, len(plan.carry_names),
             TRAIN_STEPS, json.dumps(losses),
             json.dumps([round(x, 3) for x in ms]),
             float(np.percentile(ms[1:], 50)), busy, idle,
             json.dumps({k: v for k, v in launches.items() if v})),
          flush=True)
    want = {k: AMP_STEP_LAUNCHES.get(k, 0) * TRAIN_STEPS for k in launches}
    if launches != want:
        fail("AMP training launches %s, want %s" % (launches, want))
    if len(plan.carry_names) != cfg.layers * 6 + 2:
        fail("AMP BERT carries %d weights, want %d (every product's)"
             % (len(plan.carry_names), cfg.layers * 6 + 2))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail("AMP training losses %s" % losses)
    f_main, _f_startup, f_loss = progs[False]
    f_losses, f_ms, _l, _p, (f_busy, f_idle) = amp_steps(
        f_main, f_loss, init, feed, 3, check_carry=False)
    print("train AMP: the f32 twin from the same state: losses %s; step_ms "
          "%s, p50 %.3f; busy %.3f ms/step, idle %.3f; AMP - f32 first "
          "loss %.4g" % (json.dumps(f_losses),
                         json.dumps([round(x, 3) for x in f_ms]),
                         float(np.percentile(f_ms[1:], 50)), f_busy, f_idle,
                         losses[0] - f_losses[0]), flush=True)
    feed2 = pretrain_feed(np.random.RandomState(4), cfg, CHECK_BATCH, SEQ)
    card, _m = check_steps(main_p, loss, init, feed2, None)
    cpu, _m = check_steps(main_p, loss, init, feed2, framework.CPUPlace())
    gap = max(abs(a - b) for a, b in zip(card, cpu))
    print("train AMP: card vs CPU plain path, %d chained steps from one "
          "state: max loss difference %.3g (limit %g)"
          % (CHECK_STEPS, gap, AMP_BERT_LOSS_ATOL), flush=True)
    if not gap <= AMP_BERT_LOSS_ATOL:
        fail("AMP training on the card disagrees with the CPU plain path")
    return {k: v for k, v in launches.items() if v}


def resnet_amp_build(decay):
    """A builder of ResNet-50's program for ``twin_programs``: with
    ``decay`` the bundled ``build_train`` (Momentum, L2Decay(1e-4));
    without, the same net under Momentum alone, whose weights the carry
    takes (L2Decay's scale ops read them, which bars them)."""
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.optimizer import Momentum

    def build(amp):
        if decay:
            return resnet.build_train(depth=RESNET_DEPTH, class_dim=CLASSES,
                                      image_size=IMAGE, lr=RESNET_LR,
                                      amp=amp)[2]
        img = layers.data("img", shape=[3, IMAGE, IMAGE])
        label = layers.data("label", shape=[1], dtype="int64")
        out = resnet.resnet(img, CLASSES, RESNET_DEPTH)
        loss = layers.mean(layers.softmax_with_cross_entropy(out, label))
        opt = Momentum(learning_rate=RESNET_LR, momentum=0.9)
        if amp:
            opt = mixed_precision.decorate(opt)
        opt.minimize(loss)
        return loss
    return build


def _norm_gap(got, want):
    """||got - want|| / ||want||, float64 on got's device."""
    want = want.to(got.device).double()
    return float((got.double() - want).norm()) / max(float(want.norm()),
                                                     1e-30)


def amp_replay(main_p, loss, feed, state, card="cuda"):
    """One step of the AMP ``main_p`` (its optimizer ops fused) from the
    persistables ``state`` by ``tools/torch_amp_opdiff.step_op_by_op``:
    op by op on the CPU, each op on the card fed the CPU's inputs, and
    the AMP_REPLAYS chained on the card; then the optimizer tail (decay
    and momentum) again from the "held" replay's state before it, once per
    planted fault.  -> (isolated rows: (difference relative to the CPU
    output's largest value, op index, op type, output, CPU dtype, card
    dtype); the max pool's grad's row; the CPU's loss; {replay: {velocity:
    norm-wise gap}}; {fault: {velocity: gap}}; {velocity: param}; the
    probes' conv weight)."""
    from paddle_tpu_torch.core.lowering import draws, op_seed, run_op

    updates = [op for op in main_p.global_block().ops
               if op.type in ("momentum", "fused_momentum")]
    vel_param = {v: p for op in updates
                 for p, v in zip(op.input("Param"), op.input("Velocity"))}
    updated = set(vel_param) | set(vel_param.values())
    pre_tail = {}

    def keep(i, envs):  # the updates write params and velocities in place
        pre_tail.update(tail=i, env={n: t.clone() if n in updated else t
                                     for n, t in envs["held"].items()})

    got = tool("torch_amp_opdiff").step_op_by_op(
        main_p, loss, feed, state, card, AMP_REPLAYS, keep)
    cenv = got.cpu
    replays = {k: {v: _norm_gap(env[v], cenv[v]) for v in vel_param}
               for k, env in got.envs.items()}
    got.envs.clear()
    # the probes' conv weight: its decay term the largest share of its
    # velocity on the CPU
    convs = [v for v, p in vel_param.items()
             if p.startswith("conv2d") and cenv[p].dim() == 4]
    pick = max(convs, key=lambda v: float(cenv[vel_param[v]].norm())
               / max(float(cenv[v].norm()), 1e-30))
    grad = vel_param[pick] + "@GRAD"

    def tail_run(fault):
        env = {n: t.clone() if n in updated else t
               for n, t in pre_tail["env"].items()}
        if fault == "grad x (1 + 2^-7)":
            env[grad] = env[grad] * (1.0 + 2.0 ** -7)
        for i in range(pre_tail["tail"], len(got.steps)):
            op, opdef, attrs = got.steps[i]
            if fault == "decay dropped" and op.type == "sum" \
                    and op.output("Out") == [grad]:
                continue
            if fault == "momentum 0.89" and op in updates:
                attrs = dict(attrs, mu=0.89)
            seed = op_seed(0, 0, i) if draws(opdef, attrs) else None
            run_op(op, opdef, attrs, env, torch.device(card), seed)
        return {v: _norm_gap(env[v], cenv[v]) for v in vel_param}

    faults = {f: tail_run(f) for f in ("decay dropped", "momentum 0.89",
                                       "grad x (1 + 2^-7)")}
    pool = max(r for r in got.iso if r[2] == "pool2d_grad"
               and got.steps[r[1]][2].get("pooling_type") == "max")
    return got.iso, pool, got.loss, replays, faults, vel_param, pick


def amp_resnet_phase():
    """Bundled ResNet-50 ``build_train(amp=True)`` at batch 32,
    TRAIN_STEPS steps -> the launch counts: row 10 once a step, no carry
    (L2Decay reads every weight, as the reference decides); beside it the
    f32 twin from the same state; then CHECK_STEPS steps at batch 32, each
    from one state on the card and on the CPU's plain path, and one step
    from the last state op by op (``amp_replay``): each op on the card fed
    the CPU's inputs, and the velocities replayed with the backward on the
    card (AMP_REPLAYS), held and probed with planted faults.  The
    conv2d_bn_relu
    trunk is left out: its kernels are f32, as the reference's trunk
    kernels are under the policy."""
    from paddle_tpu_torch.core import Executor, Scope, scope_to_numpy

    progs = twin_programs(resnet_amp_build(True))
    main_p, startup, loss = progs[True]
    exe, scope = Executor(), Scope()
    exe.run(startup, scope=scope)
    init = scope_to_numpy(scope, main_p)
    del scope
    feed = resnet_feed(np.random.RandomState(3), TRAIN_BATCH)
    losses, ms, launches, plan, (busy, idle) = amp_steps(
        main_p, loss, init, feed, TRAIN_STEPS)
    print("train resnet AMP [bundled]: ResNet-50 build_train(amp=True), "
          "batch %d; %d carried weights (the reference's rule: L2Decay "
          "reads them); %d steps, losses %s; step_ms %s, p50 %.3f; busy "
          "%.3f ms/step, idle %.3f; launches %s"
          % (TRAIN_BATCH, len(plan.carry_names), TRAIN_STEPS,
             json.dumps(losses), json.dumps([round(x, 3) for x in ms]),
             float(np.percentile(ms[1:], 50)), busy, idle,
             json.dumps({k: v for k, v in launches.items() if v})),
          flush=True)
    want = {k: 0 for k in launches}
    want["fused_momentum"] = TRAIN_STEPS
    if launches != want or plan.carry_names:
        fail("AMP ResNet-50 launches %s (want %s), carry %s"
             % (launches, want, plan.carry_names))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail("AMP ResNet-50 losses %s" % losses)
    f_main, _s, f_loss = progs[False]
    f_losses, f_ms, _l, _p, (f_busy, f_idle) = amp_steps(
        f_main, f_loss, init, feed, 3, check_carry=False)
    print("train resnet AMP: the f32 twin from the same state: losses %s; "
          "step_ms %s, p50 %.3f; busy %.3f ms/step, idle %.3f; AMP - f32 "
          "first loss %.4g" % (json.dumps(f_losses),
                               json.dumps([round(x, 3) for x in f_ms]),
                               float(np.percentile(f_ms[1:], 50)), f_busy,
                               f_idle, losses[0] - f_losses[0]), flush=True)
    # CHECK_STEPS steps at batch 32, each from one state on the card and
    # the CPU (the f32 twin's first step beside them), then one step from
    # the last state op by op: each op on the card fed the CPU's inputs,
    # and the velocity replays (AMP_REPLAYS)
    feed2 = resnet_feed(np.random.RandomState(4), TRAIN_BATCH)
    pairs, vels, (t_loss, t_vels), last = resnet_card_vs_cpu(
        main_p, loss, init, feed2, twin=(f_main, f_loss))
    rel = max(abs(a - b) / abs(b) for a, b in pairs)
    weights = [n for n in vels if init[n].ndim >= 2]  # the convs' and fc's
    w_worst = max(weights, key=vels.get)
    t_worst = max(weights, key=t_vels.get)
    t0 = time.perf_counter()
    iso, pool, op_loss, replays, faults, vel_param, pick = amp_replay(
        main_p, loss, feed2, last)
    worst = max(iso)
    dtypes = [r for r in iso if r[4] != r[5]]
    print("train resnet AMP: card vs CPU plain path, %d steps at batch %d, "
          "each from one state: losses' relative difference %.3g (limit "
          "%g), chained velocities (not held) %.3g at the conv and fc "
          "weights' worst (%s), the f32 twin's first step against the "
          "CPU's AMP step %.3g (%s), its loss %.3g relative; one step op "
          "by op from the last state (%.1f s), each op on the card fed the "
          "CPU's inputs: %d float outputs, %d of another dtype than the "
          "CPU's, the largest difference %.3g of the output's largest "
          "value (limit %g; op %d %s %s); the max pool's grad %.3g "
          "(bitwise: limit 0)"
          % (CHECK_STEPS, TRAIN_BATCH, rel, AMP_RESNET_LOSS_RTOL,
             vels[w_worst], w_worst, t_vels[t_worst], t_worst,
             abs(t_loss - pairs[0][1]) / abs(pairs[0][1]),
             time.perf_counter() - t0, len(iso), len(dtypes), worst[0],
             AMP_RESNET_OP_RTOL, worst[1], worst[2], worst[3], pool[0]),
          flush=True)
    weight_v = [v for v, p in vel_param.items() if init[p].ndim >= 2]
    other_v = [v for v in vel_param if v not in weight_v]
    for k, gaps in replays.items():
        w = max(weight_v, key=gaps.get)
        o = max(other_v, key=gaps.get)
        print("train resnet AMP: velocity replay %r: conv and fc weights "
              "%.3g norm-wise at the worst (%s), batch norms and the fc "
              "bias %.3g (%s); limit %g%s"
              % (k, gaps[w], w, gaps[o], o, AMP_VELOCITY_RTOL,
                 "" if k == "held" else ", not held"), flush=True)

    def fails(gaps):
        return max(gaps.values()) > AMP_VELOCITY_RTOL

    print("train resnet AMP: probes from the held replay's state on %s "
          "(its decay term %.3g of its velocity's norm "
          "before the step): (conv and fc weights, batch norms) at the "
          "worst %s" % (pick, 1e-4 * float(np.linalg.norm(
              last[vel_param[pick]])) / max(float(np.linalg.norm(
                  last[pick])), 1e-30), json.dumps(
              {f: [max(g[v] for v in weight_v), max(g[v] for v in other_v)]
               for f, g in faults.items()})), flush=True)
    if not rel <= AMP_RESNET_LOSS_RTOL or worst[0] > AMP_RESNET_OP_RTOL \
            or dtypes or pool[0] != 0 or not np.isfinite(op_loss):
        fail("AMP ResNet-50 on the card disagrees with the CPU plain path"
             " %s" % dtypes[:3])
    if fails(replays["held"]):
        fail("AMP ResNet-50 velocities on the card disagree with the CPU's")
    if not all(fails(g) for g in faults.values()):
        fail("the AMP velocity check does not see a planted fault")
    return {k: v for k, v in launches.items() if v}


def amp_resnet_carry_phase(steps=3):
    """ResNet-50 under decorate(Momentum) without weight decay, batch 32:
    every conv and the fc weight carried (54), row 10 writing the fc
    weight's copy in its group once a step, each copy bitwise its
    master's cast after every step -> the launch counts."""
    from paddle_tpu_torch.core import Executor, Scope, scope_to_numpy

    main_p, startup, loss = twin_programs(resnet_amp_build(False),
                                          (True,))[True]
    exe, scope = Executor(), Scope()
    exe.run(startup, scope=scope)
    init = scope_to_numpy(scope, main_p)
    del scope
    feed = resnet_feed(np.random.RandomState(3), TRAIN_BATCH)
    losses, ms, launches, plan, (busy, idle) = amp_steps(
        main_p, loss, init, feed, steps)
    print("train resnet AMP [no decay]: %d carried weights, each its "
          "master's cast after every step; %d steps, losses %s; step_ms "
          "%s; busy %.3f ms/step, idle %.3f; launches %s"
          % (len(plan.carry_names), steps, json.dumps(losses),
             json.dumps([round(x, 3) for x in ms]), busy, idle,
             json.dumps({k: v for k, v in launches.items() if v})),
          flush=True)
    want = {k: 0 for k in launches}
    want["fused_momentum"] = want["fused_momentum (carry)"] = steps
    if launches != want or len(plan.carry_names) != CONV_BN_PAIRS + 1:
        fail("AMP ResNet-50 without decay: launches %s (want %s), %d "
             "carried" % (launches, want, len(plan.carry_names)))
    if not all(np.isfinite(losses)):
        fail("AMP ResNet-50 without decay: losses %s" % losses)
    return {k: v for k, v in launches.items() if v}


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


def resnet_card_vs_cpu(main_p, loss, init, feed, twin=None):
    """CHECK_STEPS steps on the card from the persistables ``init``, each
    replayed on the CPU's plain path from the card's state before it ->
    ([(card loss, CPU loss)], {velocity: its largest norm-wise relative
    difference over the steps}, and with ``twin``, (main, loss) of a
    program over the same variables, its first step on the card against
    the CPU's first step of ``main_p``: (its loss, {velocity: difference}),
    else None; the state before the last step, numpy).  Each step
    starts both devices from one state, so the gaps are one step's
    rounding: chained steps of a randomly initialised ResNet-50 part by
    far more (PERF.md §6)."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.core import (Executor, Scope, scope_from_numpy,
                                       scope_to_numpy)

    card, cpu = Executor(), Executor(framework.CPUPlace())
    sc = scope_from_numpy(Scope(), init, card.device, program=main_p)
    vels = [n for n in init if "_velocity_" in n]
    losses, gaps, twin_out = [], dict.fromkeys(vels, 0.0), None

    def run(exe, prog, fetch, scope):
        return float(exe.run(prog, feed=feed, fetch_list=[fetch],
                             scope=scope)[0].reshape(-1)[0])

    def vel_gaps(scope, want):
        out = {}
        for n in vels:
            v = want.find_var(n).get_tensor().numpy()
            out[n] = float(np.linalg.norm(
                scope.find_var(n).get_tensor().numpy() - v)) / max(
                    float(np.linalg.norm(v)), 1e-30)
        return out

    t0 = time.perf_counter()
    for step in range(CHECK_STEPS):
        state = scope_to_numpy(sc, main_p)
        got = run(card, main_p, loss, sc)
        sp = scope_from_numpy(Scope(), state, "cpu", program=main_p)
        losses.append((got, run(cpu, main_p, loss, sp)))
        for n, gap in vel_gaps(sc, sp).items():
            gaps[n] = max(gaps[n], gap)
        if twin is not None and step == 0:
            st = scope_from_numpy(Scope(), state, card.device,
                                  program=twin[0])
            twin_out = (run(card, twin[0], twin[1], st), vel_gaps(st, sp))
    print("train resnet: %d steps at batch %d, (card, CPU) losses %s (%.1f "
          "s)" % (CHECK_STEPS, len(feed["img"]), json.dumps(losses),
                  time.perf_counter() - t0), flush=True)
    return losses, gaps, twin_out, state


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
            want["conv_stats"] = want["bn_fold"] = want["affine_act"] = \
                CONV_BN_PAIRS * TRAIN_STEPS
        if launches != want:
            fail("train resnet [%s] launches %s over %d steps, want %s"
                 % (which, launches, TRAIN_STEPS, want))
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            fail("train resnet [%s] losses %s: not finite, or the last is "
                 "not below the first" % (which, losses))
        feed2 = resnet_feed(np.random.RandomState(4), CHECK_BATCH)
        pairs, vels, _twin, _state = resnet_card_vs_cpu(main_p, loss, init,
                                                        feed2)
        loss_gap = max(abs(a - b) for a, b in pairs)
        worst = max(vels, key=vels.get)
        vel_gap = vels[worst]
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
    rows.append(ln_bwd_kernel_phase(fl, philox, dev, flush))
    rows.append(adam_kernel_phase(fad, dev, flush, bert_cfg))
    rows.append(dropout_kernel_phase(dk, philox, dev, flush))
    rows.append(momentum_kernel_phase(fm, dev, flush))
    rows += amp_kernel_phase(dk, ln, fad, fm, dev, flush, bert_cfg)
    rows += conv_kernel_phase(cb, dev, flush)
    rows.append(bag_kernel_phase(eb, dev, flush))
    rows += channel_stats_kernel_phase(cst, dev, flush)
    del flush
    torch.cuda.empty_cache()
    # each path is driven with the counts at 0 and read just after; a
    # kernel's row carries the newest path that launches it
    with tempfile.TemporaryDirectory() as tmp:
        bert_dir = os.path.join(tmp, "bert")
        dec_launches, params, refs = decode_phase(pa)
        launches, plain_outs = encoder_phase((fa, fl, ln), bert_dir)
        launches["paged_attention"] = dec_launches
        launches.update(wire_phase(pa, (fa, fl, ln), params, refs,
                                   bert_dir, plain_outs, tmp))
        try:
            plain_v, started = fleet_phase(
                params, refs, bert_dir, tmp, start_next=lambda dec_dir:
                start_leftovers(bert_dir, dec_dir, tmp))
            leftovers_phase(started, plain_v,
                            prompts(gpt2_small().vocab)[0])
        finally:
            for rep in REPLICAS:
                rep.kill()
        del params, refs, plain_v
    for name, dropout in ((DROPOUT0, 0.0), (COMPOSED, 0.1), (SMALL, 0.1)):
        with emission(name):
            counts = train_phase(BertConfig(dropout=dropout), name)
        launches.update({k: v for k, v in counts.items() if v})
    for which in ("bundled", "trunk"):
        launches.update(conv_serve_phase(which))
    amp = amp_train_phase(BertConfig(dropout=0.1))
    for which in ("bundled", "trunk"):
        launches.update(conv_train_phase(which))
    amp.update(amp_resnet_phase())
    amp.update(amp_resnet_carry_phase())
    # the f32 rows keep their f32 paths' counts; the bf16 and carry rows
    # take the AMP paths'
    launches.update({k: v for k, v in amp.items() if k in sub_counted()})
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
