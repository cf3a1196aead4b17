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
4b. speculative decode: the same requests through a DecodeEngine with a
   one-layer ``truncate_decoder`` draft, k = 3: tokens held the same way,
   the late request's prefix-cache hit, both pools empty after, row 1
   launched exactly once a target layer a verify column and a draft layer
   a rollout step and an ingest column; the acceptance and the rates
   printed beside phase 4's; one streamed generate through a
   ServingServer over it, every chunk once;
4c. int8 KV: the same requests through an int8 engine: the int8 kernel
   launched once a layer a step and row 1 never, the three shortest
   prompts' tokens those of the port's int8 path on the CPU up to its
   near-ties, the agreement with the f32 loop and the pool bytes
   printed; then int8 with speculation on those three, held the same
   way;
4d. (after 5b) a disaggregated pair in process: a prefill-role and a
   decode-role ServingServer over two DecodeEngines on the card, the
   decode mix from three client threads through ``ServingClient(roles=)``:
   every reply ok, each chunk once, tokens held as in 4, the decode half's
   adopted and cached blocks plus the sender's skipped ones adding up to
   ``(len - 1) // 16`` a prompt (102; the late request's 4 shared blocks
   shipped once), both pools empty after, row 1 launched 12 times a step
   of either half; one fresh prompt alone at bucket 4, its adopted blocks
   bitwise a monolith's under the same digests; then an int8 pair: the
   int8 kernel 12 times a step, row 1 never, its frame bytes at most
   0.55x the f32 pair's, the shortest prompts' tokens held as in 4c; the
   bytes, export ms, client TTFT and tokens/s printed beside 5b's;
4e. live session migration in process: the 200-token prompt's session
   moved between two engines on the card after 12 tokens, f32 and int8:
   tokens held (f32 as in 4, int8 equal to an uninterrupted int8 run),
   each index once at the client (which follows ``migrated_to``), fewer
   than 16 positions re-fed, the source's blocks held until the ack;
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
5e. a disaggregated fleet: three ``tools/torch_serve.py`` replicas
   (``--roles decode,decode,prefill``, FLAGS_migrate_on_drain=1): traffic
   through the pair across processes; the prefill replica SIGKILLed
   mid-transfer (the decode half's janitor frees its adoptions, the
   client's replay completes); a decode replica retired with live
   sessions (they move to the other through ``migrated_to``); a decode
   replica SIGKILLed mid-stream (the client's ``__resume__`` completes on
   the relaunched prefill replica); nothing dropped, every index once;
5f. SLO tiers over the wire: a ServingServer over a DecodeEngine whose
   lane bucket, queue cap and tier weights come from the flags alone; four
   requests hold the lanes (a ``serving.decode_step`` delay) while twelve
   paid, free, batch, unknown-tier and untiered generates arrive one by
   one: the shed requests and reasons equal the host replay of the
   reference's victim rule, no paid request is shed while a lighter one
   waits, ``serving_tier_shed_total`` in ``__metrics__`` equals the
   clients' sheds by tier, the completed tokens are the plain loop's, row
   1 launched 12 times a step; a session of tenant ``acme`` at tier
   ``free`` migrated mid-decode keeps both in its manifest and its resumed
   reply;
5g. one autoscaler a role: three ``tools/torch_serve.py`` slots with
   ``--roles decode,decode,prefill``, slot 1 dead, rank 0 ``--autoscale``,
   every pool small through ``FLAGS_kv_cache_blocks``: eight clients'
   long generates fill rank 0's pool (>= 0.85), the decode controller
   forks a standby into slot 1, which serves; once the traffic stops it
   retires a decode rank through a drain; the prefill replica is in every
   version of the endpoints file, every reply ok, every index once, and
   each replica's LAUNCHES equal to its SERVED decode steps;
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
11. Transformer NMT (``bench.py``'s nmt configuration: transformer-base,
    a 30000 vocabulary each side, seeded random weights) built with the
    port's ``build_train`` and trained 10 steps at batch 128 of 64 + 64
    tokens (dropout 0.1, label smoothing 0.1, noam warmup 400): the
    parameter count from the configuration's shapes, row 14 30 times,
    row 9 once and the dropout kernel 30 times a step, each step's
    learning rate noam's, the last loss below the first, step ms, tokens/s
    and peak memory printed; 3 steps at batch 16 (padded rows) from one
    state on the card and on the CPU's plain path, twice on the CPU (with
    its own relu decisions, and with the card's), with the same losses,
    learning rates, Adam moments and parameters, and two planted faults
    that the comparison must see; then ``build_beam_infer`` (batch 8,
    beam 4, 16 unrolled steps) from the trained weights, row 14 launched
    12 + 18 x 16 times a batch, ids and scores held against the CPU's up
    to each row's first near-tie; row 14 timed at the path's [8192, 512]
    rows, the dropout kernel held bitwise at the path's FFN and attention
    shapes and row 9 over the path's parameter group, and the
    assign_value ops' host cost printed;
12. BERT-base under LAMB's recipe (the small-attention emission,
    dropout 0.1, seq 128, batch 32): ``Lamb`` with weight decay 0.01 off
    the LayerNorm parameters and biases, ``GradientClipByGlobalNorm(1.0)``
    and ``linear_lr_warmup`` over ``polynomial_decay``, 10 steps: rows 5,
    6, 7, 8, 14 and the dropout kernel as phase 6's emission launches
    them, no fused Adam, each step's learning rate the schedule's, the
    last loss below the first, step p50 and sequences/s beside phase
    6's Adam, the lamb ops' aten ops and host ms a step; 3 chained steps
    at batch 2 from one state on the card and on the CPU's plain path
    (losses, learning rates, global norms, moments), and two faults
    planted on the card (the warmup skipped, the clip's scale dropped)
    that must miss those limits; then Adam behind the same clip, row 9
    once a step over the clipped gradients;
13. ResNet-50 under LARS (the ``conv2d_bn_relu`` trunk, batch 32):
    ``LarsMomentum(0.9)`` with a warmup into a polynomial decay of power
    2, 5 steps, rows 12, 13 and the fold 53 times a step, the learning
    rates the schedule's; each of 3 steps at batch 2 from one state on
    the card and the CPU (the trunk phase's limits), the LARS update ops
    of a card step against the plain op on the CPU fed the card's own
    inputs, and ``lars_weight_decay`` dropped on the card missing that
    limit;
14. the optimizer sweep over the MNIST MLP (BASELINE config 1) at batch
    64: 5 steps, each from one state on the card and on the CPU, of
    Adagrad, Adamax, DecayedAdagrad, Adadelta, RMSProp (plain, centered,
    with momentum), Ftrl, Lamb, LarsMomentum, Momentum with Nesterov,
    SGD with L1Decay and with a per-parameter learning rate, the value
    and norm clips, EMA and ModelAverage (their averages applied and the
    parameters restored), Lookahead and five schedules under SGD: every
    persistable held, row 10 once a step of the three momentum cases, and
    two planted faults (LARS's weight decay, ClipByNorm's scale dropped)
    missing the limit;
15. gradient merge and the control flow: BERT-base (the small-attention
    emission, dropout 0.1, seq 128) under
    ``GradientMergeOptimizer(Adam(1e-4), k_steps=8)`` at micro-batch 32,
    16 micro-steps (two updates of 256 sequences): rows 5-8, 14 and the
    dropout kernel as phase 6's emission launches them, no fused Adam
    (the branch's adam ops stay unfused, as the reference's), one host
    sync a step, step p50 between and at boundaries beside phase 6's
    Adam, ops a step and peak memory; (b) bitwise on the card, every
    parameter unchanged between boundaries, every merged buffer zero
    after one, the counter at 16; (c) the first window at batch 2 on the
    card and on the CPU's plain path from one state (losses, moments);
    (d) at dropout 0, one window of 8 micro-batches of 32 against one
    Adam step on the same 256 sequences (the averaged merged gradient,
    parameters and moments); faults planted on the card (an update at
    every micro-step, the buffers left unzeroed, the counter stepped by
    2) that must break each of those; (e) the reference's While, Switch,
    IfElse, cond and data-dependent greedy-decode programs and a
    StaticRNN (hidden 512, T 64) trained 5 steps, card against CPU, each
    beside a planted fault;
16. the recurrent networks: (a) the LSTM language model of Zaremba et
    al. 2014 at its large setting (vocab 10000, 2 layers, hidden 1500,
    35 steps, batch 20, dropout 0.65, SGD(1.0) under a global-norm clip
    of 10, seeded Markov tokens) through ``models/ptb_lm.py``, 20 steps
    of each emission (contrib's ``basic_lstm``, its states carried; and
    ``layers.lstm``'s StaticRNNs): the dropout kernel 3 times a step,
    finite losses, step p50, tokens/s, host ms, device
    busy and idle, ops a step and peak memory printed; (b) 3 steps of
    each emission at dropout 0 and 0.65 (the same Philox masks) and (c)
    of the ``basic_gru`` and ``dynamic_gru`` + ``rnn(GRUCell)`` emissions
    from one state on the card and on the CPU's plain path at batch 2
    (losses, carried states, parameters); (d) a BeamSearchDecoder under
    dynamic_decode over an LSTMCell(1500) with a 10000-way output, beam
    4, batch 8, 20 steps, held up to near-ties, and contrib's decoders;
    (e) the op-level recurrences and dynamic_lstmp at 2048 cells, card
    vs CPU; each beside a planted fault (the forget bias, two gates
    swapped, the GRU's dropout upscaled, the backward direction not
    reversed); the rnn ops' one mask draw timed and held bitwise;
17. the script's own wall time, a JSON line of the kernels (rows 9 and
    14 and the dropout kernel counting the NMT path's launches besides
    their earlier paths', row 1 the tiers and role-fleet phases' besides
    the pair's, rows 5-10, 12-14, the fold and the dropout kernel the
    update-rule phases' besides, rows 2-8, 14 and the dropout kernel
    the gradient-merge phase's, and the dropout kernel the recurrent
    phase's), then the result line.

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
    """Row 1 and the int8 kernel against their plain versions: the timed
    decode shape, lens on each side of a chunk boundary of the split
    kernel, full tables, a table of one block, and the head widths of each
    load path (row 1: float4 at D = 40, 64, 128, 256, scalar at D = 30;
    int8: 16-byte loads at D = 64, 128, 256, bytes at D = 30, 40), the
    int8 pools made by the port's ``quantize_kv`` from the same K/V; idle
    lanes zero; two calls at the timed shape give the same bits.  -> the
    two kernels' rows."""
    from paddle_tpu_torch.serving.kv_cache import quantize_kv

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
    def int8_args(c):
        kq, ks = quantize_kv(c["k"])
        vq, vs = quantize_kv(c["v"])
        return (c["q"], kq, vq, ks, vs, c["tables"], c["lens"])

    worst = worst8 = 0.0
    for name, c in cases.items():
        args = (c["q"], c["k"], c["v"], c["tables"], c["lens"])
        live = c["lens"] > 0
        for kname, kernel, plain, a in (
                ("paged_attention", pa.paged_attention,
                 pa.paged_attention_reference, args),
                ("paged_attention_int8", pa.paged_attention_int8,
                 pa.paged_attention_int8_reference, int8_args(c))):
            out = kernel(*a)
            err = check(kname, name, [out[live]], [plain(*a)[live]])
            if kname == "paged_attention":
                worst = max(worst, err)
            else:
                worst8 = max(worst8, err)
            if (~live).any() and float(out[~live].abs().max()) != 0.0:
                fail("%s idle lane not zero at %s" % (kname, name))

    c = cases["decode B=8 H=12 D=64 bs=16 MAXB=64"]
    args = (c["q"], c["k"], c["v"], c["tables"], c["lens"])
    args8 = int8_args(c)
    if not torch.equal(pa.paged_attention(*args), pa.paged_attention(*args)):
        fail("paged_attention: two calls at the decode shape differ")
    if not torch.equal(pa.paged_attention_int8(*args8),
                       pa.paged_attention_int8(*args8)):
        fail("paged_attention_int8: two calls at the decode shape differ")
    print("kernel paged_attention, paged_attention_int8: two calls at the "
          "decode shape give the same bits", flush=True)
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

    # int8: the yardstick is SDPA over the same K/V gathered and
    # dequantized beforehand (not timed); the bound the int8 rows and
    # their f32 scales read once
    kq, vq, ks, vs = args8[1:5]
    k8 = (kq[idx].float() * ks[idx][..., None]).reshape(bb, -1, h, d)
    v8 = (vq[idx].float() * vs[idx][..., None]).reshape(bb, -1, h, d)
    k8 = k8[:, :s].permute(0, 2, 1, 3).contiguous()
    v8 = v8[:, :s].permute(0, 2, 1, 3).contiguous()
    nbytes8 = (2 * tok * h * d               # live int8 K and V rows
               + 2 * tok * h * 4             # their scales
               + 2 * bb * h * d * 4 + 4 * bb
               + 4 * int(sum(-(-n // bs) for n in lens)))
    row8 = timed_row(
        "paged_attention_int8", lambda: pa.paged_attention_int8(*args8),
        lambda: pa.paged_attention_int8_reference(*args8),
        lambda: sdpa(qg, k8, v8, attn_mask=mask), nbytes8,
        tok * h * (4 * d + 7), flush, worst8,
        "decode shape (SDPA on pre-gathered, dequantized K/V)")
    row8.update(source="paddle_tpu_torch/kernels/csrc/paged_attention.cu",
                replaces="paddle_tpu/serving/decode_model.py:234")
    return [row, row8]


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


def check_decode_tokens(what, allp, replies, refs,
                        ref_name="the unpaged plain loop"):
    """Each reply's tokens against the plain unpaged loop's (``refs``:
    (tokens, logits) per prompt; another reference named ``ref_name``); a
    divergence must sit at a near-tie of the reference's logits.  -> the
    number of near-tie divergences."""
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
        print("%s: request %d (prompt %d) diverges at token %d: got %d, "
              "%s %d, its top-2 gap %.3g"
              % (what, i, len(p), j, got[j] if j < len(got) else -1,
                 ref_name, want[j], gap), flush=True)
        if gap >= LOGIT_TIE_TOL:
            fail("%s request %d diverges from %s where the top-2 logit gap "
                 "%.3g >= %g" % (what, i, ref_name, gap, LOGIT_TIE_TOL))
        ties += 1
    print("%s: tokens equal %s for %d of %d requests; %d near-tie "
          "divergences (gap < %g)"
          % (what, ref_name, len(replies) - ties, len(replies), ties,
             LOGIT_TIE_TOL), flush=True)
    return ties


def run_mix(eng, first, late):
    """The decode mix through a started ``eng``: the ``first`` prompts at
    once, then the ``late`` shared-prefix request, 32 new tokens each ->
    (replies, wall s), every reply ok."""
    t0 = time.perf_counter()
    reqs = [eng.submit("gpt2-small", p, max_new_tokens=32) for p in first]
    replies = [r.wait(timeout=900) for r in reqs]
    replies.append(eng.submit("gpt2-small", late, max_new_tokens=32)
                   .wait(timeout=900))
    wall = time.perf_counter() - t0
    for i, r in enumerate(replies):
        if r is None or r.status != "ok":
            fail("decode request %d: %s" % (i, None if r is None
                                            else (r.status, r.error)))
    return replies, wall


def mix_rates(what, m, replies, wall, steps, card, base=None):
    """Print the mix's tokens/s, step ms p50 and TTFT p50 (beside
    ``base``'s, decode_phase's) -> those three."""
    ntok = sum(len(r.outputs["tokens"]) for r in replies)
    rates = {"tokens_s": ntok / wall,
             "step_ms_p50": float(np.percentile(
                 list(m.step_ms_samples)[-steps:], 50)),
             "ttft_ms_p50": float(np.percentile(
                 [r.phases["ttft_ms"] for r in replies], 50))}
    print("%s: %s; %d tokens in %.3f s = %.2f tokens/s; step_ms p50 %.3f; "
          "ttft_ms p50 %.3f%s" % (
              what, card, ntok, wall, rates["tokens_s"],
              rates["step_ms_p50"], rates["ttft_ms_p50"],
              "" if base is None else
              " (decode phase, same card: %.2f tokens/s, step_ms p50 %.3f, "
              "ttft_ms p50 %.3f)" % (base["tokens_s"], base["step_ms_p50"],
                                     base["ttft_ms_p50"])), flush=True)
    return rates


def decode_phase(pa):
    """-> (paged_attention launches, the decoder's params, the plain
    unpaged loop's (tokens, logits) per prompt of ``prompts``, the mix's
    rates)."""
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
        replies, wall = run_mix(eng, first, late)
        launches = pa.paged_attention.launches
        steps = eng.steps - steps0
    finally:
        eng.stop()
    allp = first + [late]
    late_reply = replies[-1]
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
    rates = mix_rates("decode", m, replies, wall, steps, card_line())

    refs = [m.decoder.unpaged_generate(
        p, 32, pad_len=m.maxb * m.kv_config.block_size, return_logits=True)
        for p in allp]
    check_decode_tokens("decode", allp, replies, refs)
    return launches, params, refs, rates


# speculative decode: proposals a lane an iteration, and the draft's layers
SPEC_K = 3
DRAFT_LAYERS = 1


def shortest(allp, n=3):
    """The indices of the ``n`` shortest prompts of ``allp``."""
    return sorted(range(len(allp)), key=lambda i: len(allp[i]))[:n]


def spec_launches(cfg, k, dlayers, verifies, rollouts, ingests):
    """Paged-attention launches of a speculative run: a target layer a
    verify column, a draft layer a rollout step and an ingest column."""
    return (cfg.layers * (k + 1) * verifies + dlayers * k * rollouts
            + dlayers * (k + 1) * ingests)


def spec_decode_phase(pa, params, refs, base):
    """decode_phase's mix through a speculative DecodeEngine (k = SPEC_K,
    the first DRAFT_LAYERS layers of the same weights as the draft,
    ``truncate_decoder``; buckets 4, 8; 520 blocks): every reply ok, the
    tokens the plain loop's up to near-ties, the late request's 64 cached
    tokens, both pools empty after, and row 1 launched exactly once a
    target layer a verify column and a draft layer a rollout step and an
    ingest column.  Then one streamed generate through a ServingServer
    over the same engine: ``__spec__`` names k and the draft, and the
    chunks are 0..n-1 once each.  Last, the three shortest prompts with a
    draft of every layer (the target's own weights), whose proposals the
    target accepts but at near-ties: the full accept and its catch-up
    ingest, which the one-layer draft of random weights rarely reaches,
    held the same way."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.core import telemetry
    from paddle_tpu_torch.serving import (DecodeEngine, ServingClient,
                                          ServingEngine, ServingServer,
                                          truncate_decoder)

    cfg = gpt2_small()
    eng = DecodeEngine(buckets="4,8", block_size=16, deadline_ms=600000.0)
    m = eng.add_model("gpt2-small", (cfg, params), kv_blocks=520,
                      draft=truncate_decoder(cfg, params,
                                             layers=DRAFT_LAYERS),
                      speculative_k=SPEC_K)
    first, late = prompts(cfg.vocab)
    allp = first + [late]
    card = card_line()
    telemetry.reset()
    set_flags({"FLAGS_telemetry": True})
    eng.start()
    try:
        # the counts start at 0 just before the main path runs
        pa.paged_attention.launches = 0
        pa.paged_attention_int8.launches = 0
        steps0 = eng.steps
        calls0 = (m.verifies, m.rollouts, m.ingests)
        replies, wall = run_mix(eng, first, late)
        launches = pa.paged_attention.launches
        launches8 = pa.paged_attention_int8.launches
        steps = eng.steps - steps0
        verifies, rollouts, ingests = (
            n - n0 for n, n0 in zip((m.verifies, m.rollouts, m.ingests),
                                    calls0))
        in_use = (m.cache.allocator.in_use, m.draft_cache.allocator.in_use)
        proposed = telemetry.counter_total("spec_tokens_proposed_total")
        accepted = telemetry.counter_total("spec_tokens_accepted_total")
        rolled = telemetry.counter_total("spec_blocks_rolled_back_total")
        srv = ServingServer(ServingEngine(), port=0, decode_engine=eng)
        srv.start()
        try:
            cli = ServingClient(endpoints=["127.0.0.1:%d" % srv.port],
                                deadline_ms=600000.0)
            spec = cli.spec("gpt2-small")
            chunks = []
            wire = cli.generate("gpt2-small", allp[0], max_new_tokens=32,
                                stream=True,
                                on_token=lambda j, t: chunks.append((j, t)))
        finally:
            srv.shutdown()
    finally:
        eng.stop()
        set_flags({"FLAGS_telemetry": False})
        telemetry.reset()
    if replies[-1].phases["cached_tokens"] != 64:
        fail("spec: the shared-prefix request cached %d tokens, want 64"
             % replies[-1].phases["cached_tokens"])
    if in_use != (0, 0):
        fail("spec: blocks in use after the mix, target and draft pools: "
             "%s" % (in_use,))
    want = spec_launches(cfg, SPEC_K, DRAFT_LAYERS, verifies, rollouts,
                         ingests)
    print("spec: k %d, a %d-layer draft; %d replies ok, %d iterations: %d "
          "verifies, %d rollouts, %d ingests; paged_attention launches %d "
          "(%d x %d x verifies + %d x %d x rollouts + %d x %d x ingests = "
          "%d), paged_attention_int8 %d; prefix-cache hit %d tokens; both "
          "pools empty after; %d blocks rolled back"
          % (SPEC_K, DRAFT_LAYERS, len(replies), steps, verifies, rollouts,
             ingests, launches, cfg.layers, SPEC_K + 1, DRAFT_LAYERS, SPEC_K,
             DRAFT_LAYERS, SPEC_K + 1, want, launches8,
             replies[-1].phases["cached_tokens"], rolled), flush=True)
    if launches != want or verifies != steps or steps == 0 or rollouts == 0 \
            or launches8 != 0:
        fail("spec: paged_attention launched %d times, want %d (%d "
             "iterations, %d verifies), paged_attention_int8 %d"
             % (launches, want, steps, verifies, launches8))
    check_decode_tokens("spec", allp, replies, refs)
    acceptance = accepted / proposed if proposed else float("nan")
    print("spec: %s; acceptance %.4f (%d of %d proposed tokens accepted)"
          % (card, acceptance, accepted, proposed), flush=True)
    mix_rates("spec", m, replies, wall, steps, card, base)

    toks = [int(t) for t in wire.outputs["tokens"]] if wire.ok else []
    if spec.get("speculative_k") != SPEC_K \
            or (spec.get("draft") or {}).get("layers") != DRAFT_LAYERS:
        fail("spec wire: __spec__ %s" % json.dumps(spec))
    if not wire.ok or chunks != list(enumerate(toks)):
        fail("spec wire: reply %s, chunks %s" % (
            wire.status, [j for j, _t in chunks][:40]))
    same = toks == [int(t) for t in replies[0].outputs["tokens"]]
    if not same:
        check_decode_tokens("spec wire", allp[:1], [wire], refs[:1])
    print("spec wire: __spec__ speculative_k %d, draft %s; a streamed "
          "generate of %d tokens delivered chunks 0..%d once each, tokens "
          "%s the in-process reply's" % (
              spec["speculative_k"], json.dumps(spec["draft"]), len(toks),
              len(toks) - 1, "equal to" if same else
              "within the near-tie rule of"), flush=True)

    short = shortest(allp)
    feng = DecodeEngine(buckets="4,8", block_size=16, deadline_ms=600000.0)
    fm = feng.add_model("gpt2-small", (cfg, params), kv_blocks=520,
                        draft=truncate_decoder(cfg, params,
                                               layers=cfg.layers),
                        speculative_k=SPEC_K)
    telemetry.reset()
    set_flags({"FLAGS_telemetry": True})
    feng.start()
    try:
        pa.paged_attention.launches = 0
        calls0 = (fm.verifies, fm.rollouts, fm.ingests)
        reqs = [feng.submit("gpt2-small", allp[i], max_new_tokens=32)
                for i in short]
        freplies = [r.wait(timeout=900) for r in reqs]
        f_launches = pa.paged_attention.launches
        calls = [n - n0 for n, n0 in zip(
            (fm.verifies, fm.rollouts, fm.ingests), calls0)]
        f_prop = telemetry.counter_total("spec_tokens_proposed_total")
        f_acc = telemetry.counter_total("spec_tokens_accepted_total")
    finally:
        feng.stop()
        set_flags({"FLAGS_telemetry": False})
        telemetry.reset()
    for i, r in enumerate(freplies):
        if r is None or r.status != "ok":
            fail("spec full draft request %d: %s" % (
                i, None if r is None else (r.status, r.error)))
    want = spec_launches(cfg, SPEC_K, cfg.layers, *calls)
    if f_launches != want or f_acc == 0:
        fail("spec full draft: paged_attention launched %d times, want %d "
             "(verifies, rollouts, ingests %s); %d of %d proposals accepted"
             % (f_launches, want, calls, f_acc, f_prop))
    check_decode_tokens("spec full draft", [allp[i] for i in short],
                        freplies, [refs[i] for i in short])
    print("spec full draft: %s; a draft of all %d layers on prompts of %s "
          "tokens: acceptance %.4f (%d of %d), paged_attention launches %d "
          "(verifies, rollouts, ingests %s)"
          % (card, cfg.layers, [len(allp[i]) for i in short],
             f_acc / f_prop if f_prop else float("nan"), f_acc, f_prop,
             f_launches, calls), flush=True)


def int8_cpu_refs(cfg, params, allp):
    """The port's int8 path on the CPU for ``allp``: the int8 engine's
    tokens (one request at a time, bucket 1) and, for the near-tie rule,
    the same steps' logits from ``Decoder.paged_step`` over int8 pools ->
    (tokens, logits) per prompt; the two token lists must agree."""
    from paddle_tpu_torch.serving import (DecodeEngine, KVCacheConfig,
                                          PagedKVCache)

    eng = DecodeEngine(buckets="1", block_size=16, deadline_ms=600000.0,
                       kv_dtype="int8", device="cpu")
    m = eng.add_model("gpt2-small", (cfg, params), kv_blocks=16)
    eng.start()
    try:
        toks = [[int(t) for t in eng.generate(
            "gpt2-small", p, max_new_tokens=32).outputs["tokens"]]
            for p in allp]
    finally:
        eng.stop()
    one = lambda x: torch.tensor([x], dtype=torch.int32)  # noqa: E731
    out = []
    for p, want in zip(allp, toks):
        cache = PagedKVCache(KVCacheConfig(
            cfg.layers, cfg.heads, cfg.head_dim, 16, m.maxb + 1,
            dtype="int8"), device="cpu")
        table = torch.arange(1, m.maxb + 1, dtype=torch.int32)[None]
        got, logits = [], []
        tok, pos = p[0], 0
        while len(got) < 32:
            nxt, lg = m.decoder.paged_step(cache.k, cache.v, one(tok),
                                           one(pos), table, one(pos + 1),
                                           cache.pools[2:])
            pos += 1
            if pos < len(p):
                tok = p[pos]
                continue
            tok = int(nxt[0])
            got.append(tok)
            logits.append(lg[0].numpy())
        if got != want:
            fail("int8 on the CPU: the engine's tokens %s, the step loop's "
                 "%s" % (want, got))
        out.append((got, logits))
    return out


def int8_decode_phase(pa, params, refs, base):
    """decode_phase's mix through an int8 DecodeEngine (kv_dtype "int8",
    the same buckets and 520 blocks): every reply ok; the int8 kernel
    launched once a layer a step and row 1 never; on the three shortest
    prompts the tokens the port's int8 path on the CPU's, up to near-ties
    of the CPU's logits; each request's agreement with the f32 plain loop
    printed.  Then int8 with speculation (k = SPEC_K) on those three
    prompts, its tokens held the same way and its launches as in
    spec_decode_phase.  -> (the int8 kernel's launches, (the replies, the
    CPU's refs of the three shortest prompts, their indices))."""
    from paddle_tpu_torch.serving import (DecodeEngine, KVCacheConfig,
                                          block_bytes, truncate_decoder)

    cfg = gpt2_small()
    card = card_line()
    first, late = prompts(cfg.vocab)
    allp = first + [late]
    eng = DecodeEngine(buckets="4,8", block_size=16, deadline_ms=600000.0,
                       kv_dtype="int8")
    m = eng.add_model("gpt2-small", (cfg, params), kv_blocks=520)
    f32_bytes = block_bytes(KVCacheConfig(
        cfg.layers, cfg.heads, cfg.head_dim, 16, 520)) * 520
    print("int8: %d KV blocks of 16: %.1f MB int8 with scales against %.1f "
          "MB f32 (block_bytes)" % (m.kv_config.num_blocks,
                                    m.cache.nbytes / 1e6, f32_bytes / 1e6),
          flush=True)
    eng.start()
    try:
        # the counts start at 0 just before the main path runs
        pa.paged_attention.launches = 0
        pa.paged_attention_int8.launches = 0
        steps0 = eng.steps
        replies, wall = run_mix(eng, first, late)
        launches8 = pa.paged_attention_int8.launches
        launches = pa.paged_attention.launches
        steps = eng.steps - steps0
    finally:
        eng.stop()
    print("int8: %d replies ok, paged_attention_int8 launches %d, decode "
          "steps %d, layers x steps %d, paged_attention launches %d"
          % (len(replies), launches8, steps, cfg.layers * steps, launches),
          flush=True)
    if launches8 != cfg.layers * steps or steps == 0 or launches != 0:
        fail("int8: paged_attention_int8 launched %d times over %d steps "
             "of %d layers, row 1 %d times" % (launches8, steps, cfg.layers,
                                              launches))
    mix_rates("int8", m, replies, wall, steps, card, base)
    prefix, match, total = [], 0, 0
    for r, (want, _lg) in zip(replies, refs):
        got = [int(t) for t in r.outputs["tokens"]]
        prefix.append(next((j for j in range(min(len(got), len(want)))
                            if got[j] != want[j]), min(len(got), len(want))))
        match += sum(a == b for a, b in zip(got, want))
        total += len(want)
    print("int8: %s; against the f32 plain loop: common prefix %s tokens; "
          "token-match rate %.4f (%d of %d positions)"
          % (card, prefix, match / total, match, total), flush=True)

    short = shortest(allp)
    sp = [allp[i] for i in short]
    cpu = int8_cpu_refs(cfg, params, sp)
    on_cpu = "the port's int8 path on the CPU"
    check_decode_tokens("int8", sp, [replies[i] for i in short], cpu,
                        on_cpu)

    seng = DecodeEngine(buckets="4,8", block_size=16, deadline_ms=600000.0,
                        kv_dtype="int8")
    sm = seng.add_model("gpt2-small", (cfg, params), kv_blocks=520,
                        draft=truncate_decoder(cfg, params,
                                               layers=DRAFT_LAYERS),
                        speculative_k=SPEC_K)
    seng.start()
    try:
        pa.paged_attention.launches = 0
        pa.paged_attention_int8.launches = 0
        calls0 = (sm.verifies, sm.rollouts, sm.ingests)
        reqs = [seng.submit("gpt2-small", p, max_new_tokens=32) for p in sp]
        sreplies = [r.wait(timeout=900) for r in reqs]
        s_launches8 = pa.paged_attention_int8.launches
        s_launches = pa.paged_attention.launches
        calls = [n - n0 for n, n0 in zip(
            (sm.verifies, sm.rollouts, sm.ingests), calls0)]
    finally:
        seng.stop()
    for i, r in enumerate(sreplies):
        if r is None or r.status != "ok":
            fail("int8 spec request %d: %s" % (i, None if r is None
                                                else (r.status, r.error)))
    want = spec_launches(cfg, SPEC_K, DRAFT_LAYERS, *calls)
    if s_launches8 != want or s_launches != 0 or calls[1] == 0:
        fail("int8 spec: paged_attention_int8 launched %d times, want %d "
             "(verifies, rollouts, ingests %s), row 1 %d times"
             % (s_launches8, want, calls, s_launches))
    check_decode_tokens("int8 spec", sp, sreplies, cpu, on_cpu)
    same = sum([int(t) for t in a.outputs["tokens"]]
               == [int(t) for t in replies[i].outputs["tokens"]]
               for a, i in zip(sreplies, short))
    print("int8 spec: k %d on prompts of %s tokens: %d replies ok, "
          "paged_attention_int8 launches %d (verifies, rollouts, ingests "
          "%s); tokens equal int8 alone on the card for %d of %d"
          % (SPEC_K, [len(p) for p in sp], len(sreplies), s_launches8,
             calls, same, len(sp)), flush=True)
    return launches8, (replies, cpu, short)


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


# the monolith's rates over the wire (wire_phase), printed beside the
# disaggregated pair's
WIRE_RATES = {}


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
            pa.paged_attention_int8.launches = 0
            fa.flash_attention.launches = 0
            fl.fused_ln_fwd.launches = 0
            ln.layer_norm_2d.launches = 0
            return deng.steps, len(eeng.batch_log)

        def counts():
            return {"paged_attention": pa.paged_attention.launches,
                    "paged_attention_int8": pa.paged_attention_int8.launches,
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
    WIRE_RATES.update(
        tokens_s=ntok / walls["decode"], client_ttft_ms_p50=p50(
            [r.phases["client_ttft_ms"] for r in streamed]))
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
    ``dcfg`` (f32 pools) and ``batches`` batches of the BERT encoder
    ``cfg``: one paged attention a layer a step and no int8 one; a flash
    attention, two fused_ln and, on the embeddings, one layer_norm a
    batch."""
    return {"paged_attention": dcfg.layers * steps,
            "paged_attention_int8": 0,
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


# -- phase 5d: faults and the autoscaler --------------------------------------

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



# -- phase 4d: a disaggregated prefill and decode pair ------------------------

# the int8 pair's frame bytes may be at most this share of the f32 pair's
# (the reference's budget, tests/test_disagg_serving.py)
INT8_WIRE_BUDGET = 0.55


def sum_of(counters, name, **labels):
    """``counters`` ({flat name: value}) of ``name`` summed over the label
    sets that hold ``labels``."""
    return sum(v for k, v in counters.items() if k.split("{")[0] == name
               and all("%s=%s" % kv in k for kv in labels.items()))


def counter(name, **labels):
    """``sum_of`` this process's telemetry counters."""
    from paddle_tpu_torch.core import telemetry

    return sum_of(telemetry.snapshot()["counters"], name, **labels)


def transfer_blocks(allp, bs=16):
    """Full blocks below each prompt's tail: what a prefill half streams,
    ``(len - 1) // bs`` a prompt, as the reference counts them."""
    return sum((len(p) - 1) // bs for p in allp)


def timed_exports(cache, samples):
    """Make ``cache.export_block`` append its host ms to ``samples``."""
    export = cache.export_block

    def timed(block):
        t0 = time.perf_counter()
        out = export(block)
        samples.append((time.perf_counter() - t0) * 1e3)
        return out

    cache.export_block = timed


@contextlib.contextmanager
def pair_servers(params, kv_dtype, kv_blocks=520):
    """A prefill-role and a decode-role ServingServer in this process, over
    two DecodeEngines on the card (decode_phase's buckets and blocks),
    paired by ``decode_peers`` -> (prefill engine, decode engine, a client
    factory, the prefill half's export ms samples)."""
    from paddle_tpu_torch.serving import (DecodeEngine, ServingClient,
                                          ServingEngine, ServingServer)

    cfg = gpt2_small()
    engs = []
    for _ in range(2):
        e = DecodeEngine(buckets="4,8", block_size=16, deadline_ms=600000.0,
                         kv_dtype=kv_dtype)
        e.add_model("gpt2-small", (cfg, params), kv_blocks=kv_blocks)
        engs.append(e)
    samples = []
    timed_exports(engs[0]._models["gpt2-small"].cache, samples)
    sd = ServingServer(ServingEngine(), port=0, decode_engine=engs[1],
                       role="decode").start()
    sp = ServingServer(ServingEngine(), port=0, decode_engine=engs[0],
                       role="prefill",
                       decode_peers=["127.0.0.1:%d" % sd.port]).start()
    eps = ["127.0.0.1:%d" % s.port for s in (sp, sd)]
    try:
        yield engs[0], engs[1], lambda: ServingClient(
            endpoints=eps, roles=["prefill", "decode"],
            deadline_ms=600000.0), samples
    finally:
        sp.shutdown()
        sd.shutdown()


def pair_mix(pa_kernel, params, kv_dtype, allp, clients, what):
    """decode_phase's mix through a pair, ``clients`` threads over the wire
    (WIRE_MODES) -> (replies, chunks, wall s, kernel launches, steps of
    each half, export ms samples, {block counts})."""
    with pair_servers(params, kv_dtype) as (pe, de, client, samples):
        cli = [client() for _ in range(clients)]
        base = {k: counter("kv_xfer_adopt_total", result=k)
                for k in ("adopted", "cached")}
        base["skipped"] = counter("kv_xfer_skipped_total")
        base["shipped"] = counter("kv_xfer_blocks_total")
        steps0 = (pe.steps, de.steps)
        pa_kernel.launches = 0      # just before the pair's main path
        t0 = time.perf_counter()
        replies, _e, chunks, _w = drive_mix(
            allp, [], lambda k, i, p, mode, got: client_gen(cli[k], p, mode,
                                                            got),
            None, clients, what)
        wall = time.perf_counter() - t0
        launches = pa_kernel.launches
        steps = (pe.steps - steps0[0], de.steps - steps0[1])
        blocks = {k: counter("kv_xfer_adopt_total", result=k) - base[k]
                  for k in ("adopted", "cached")}
        blocks["skipped"] = counter("kv_xfer_skipped_total") - \
            base["skipped"]
        blocks["shipped"] = counter("kv_xfer_blocks_total") - \
            base["shipped"]
        step_ms = [float(np.percentile(list(
            e._models["gpt2-small"].step_ms_samples)[-n:], 50))
            for e, n in zip((pe, de), steps)]
        in_use = [e._models["gpt2-small"].cache.allocator.in_use
                  for e in (pe, de)]
        if in_use != [0, 0]:
            fail("%s: KV blocks in use after the mix: prefill %d, decode %d"
                 % (what, *in_use))
    for i, r in enumerate(replies):
        if r is None or r.status != "ok":
            fail("%s request %d: %s" % (what, i, None if r is None
                                         else (r.status, r.error)))
    check_chunks(what, replies, chunks, clients)
    return replies, wall, launches, steps, list(samples), blocks, step_ms


def pair_phases(replies):
    """p50 of the pair's reply phases, ms: the prefill half's queue wait
    and prefill, the commit's transfer, the decode half's queue wait and
    its TTFT (from the commit's submit)."""
    return {k: round(float(np.percentile([r.phases[k] for r in replies
                                          if k in r.phases], 50)), 3)
            for k in ("prefill_queue_wait_ms", "prefill_ms", "xfer_ms",
                      "queue_wait_ms", "ttft_ms")}


def disagg_phase(pa, params, refs, base, int8_refs, clients=3):
    """decode_phase's mix (11 prompts and the late one, 32 new tokens each)
    through a prefill-role and a decode-role ServingServer over two
    DecodeEngines on the card (buckets 4, 8; 16-token blocks; 520 blocks
    each), ``clients`` threads over the wire: every reply ok, each
    streamed chunk once, the tokens the plain loop's up to near-ties; the
    decode half's adopted and cached blocks plus the blocks the sender
    skipped as shipped add up to ``(len - 1) // 16`` a prompt (the late
    request's 4 blocks shared with request 4 shipped once); both pools
    empty after; row 1 launched 12 times a step of either half.  Then one
    fresh prompt alone through a pair at bucket 4: its adopted blocks
    bitwise those a monolith engine on the card holds under the same
    digests.  Then the mix through an int8 pair: the int8 kernel 12 times
    a step, row 1 never, the frame bytes at most INT8_WIRE_BUDGET of the
    f32 pair's, the three shortest prompts' tokens the port's int8 path on
    the CPU's up to its near-ties.  ``int8_refs`` is int8_decode_phase's
    (replies, CPU refs of the shortest, their indices).  -> (row 1's
    launches, the int8 kernel's launches)."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.core import telemetry
    from paddle_tpu_torch.serving import DecodeEngine

    cfg = gpt2_small()
    card = card_line()
    first, late = prompts(cfg.vocab)
    allp = first + [late]
    want_blocks = transfer_blocks(allp)
    telemetry.reset()
    set_flags({"FLAGS_telemetry": True})
    try:
        replies, wall, launches, steps, samples, blocks, step_ms = \
            pair_mix(pa.paged_attention, params, "f32", allp, clients,
                     "disagg")
        check_decode_tokens("disagg", allp, replies, refs)
        if blocks["adopted"] + blocks["cached"] + blocks["skipped"] \
                != want_blocks or blocks["shipped"] != want_blocks - 4 \
                or blocks["skipped"] != 4:
            fail("disagg: blocks %s, want %d adopted + cached + skipped and "
                 "the late request's 4 shared blocks shipped once"
                 % (blocks, want_blocks))
        if launches != cfg.layers * sum(steps) or 0 in steps:
            fail("disagg: paged_attention launched %d times over %s steps "
                 "(prefill, decode) of %d layers"
                 % (launches, steps, cfg.layers))
        f32_bytes = counter("kv_xfer_bytes_total", dtype="f32")
        streamed = [r for i, r in enumerate(replies)
                    if wire_mode(i, clients) != "no stream"]
        ntok = sum(len(r.outputs["tokens"]) for r in replies)
        ttft = float(np.percentile([r.phases["client_ttft_ms"]
                                    for r in streamed], 50))
        print("disagg: %d replies ok through the pair; blocks %s (%d = "
              "(len - 1) // 16 summed over the prompts); paged_attention "
              "launches %d = %d layers x (%d prefill + %d decode steps); "
              "both pools empty after" % (len(replies), json.dumps(blocks),
                                          want_blocks, launches, cfg.layers,
                                          steps[0], steps[1]), flush=True)
        print("disagg: %s; f32 kv_xfer_bytes_total %d for %d blocks (%.1f a "
              "block); export host ms p50 %.4f (%d exports); the %d "
              "streamed generates: client TTFT p50 %.3f ms (the monolith "
              "over the wire, same mix: %.3f ms); %d tokens in %.3f s = "
              "%.2f tokens/s (the monolith over the wire: %.2f); step ms p50 "
              "prefill half %.3f, decode half %.3f; reply phases p50 %s"
              % (card, f32_bytes, blocks["shipped"],
                 f32_bytes / max(blocks["shipped"], 1),
                 float(np.percentile(samples, 50)), len(samples),
                 len(streamed), ttft, WIRE_RATES.get("client_ttft_ms_p50",
                                                     float("nan")),
                 ntok, wall, ntok / wall,
                 WIRE_RATES.get("tokens_s", float("nan")), step_ms[0],
                 step_ms[1], json.dumps(pair_phases(replies))), flush=True)

        # one fresh prompt alone: both halves and the monolith at bucket 4
        probe = np.random.RandomState(5).randint(0, cfg.vocab, 200).tolist()
        mono = DecodeEngine(buckets="4,8", block_size=16,
                            deadline_ms=600000.0)
        mm = mono.add_model("gpt2-small", (cfg, params), kv_blocks=64)
        mono.start()
        try:
            mr = mono.generate("gpt2-small", probe, max_new_tokens=8)
        finally:
            mono.stop()
        with pair_servers(params, "f32", kv_blocks=64) as (pe, de, client,
                                                          _s):
            pr = client().generate("gpt2-small", probe, max_new_tokens=8)
            if mr.status != "ok" or pr.status != "ok":
                fail("disagg probe: monolith %s, pair %s"
                     % ((mr.status, mr.error), (pr.status, pr.error)))
            dm = de._models["gpt2-small"]
            digests = mm.prefix.chain(probe)[:(len(probe) - 1) // 16]
            worst, n = 0.0, 0
            for d in digests:
                got = dm.cache.export_block(dm.prefix.lookup(d))
                want = mm.cache.export_block(mm.prefix.lookup(d))
                for a, b in zip(got, want):
                    worst = max(worst, float(np.abs(a - b).max()))
                    n += int(not np.array_equal(a, b))
        same = [int(t) for t in pr.outputs["tokens"]] == \
            [int(t) for t in mr.outputs["tokens"]]
        print("disagg probe: %s; a 200-token prompt alone through a pair "
              "(both halves at bucket 4): its %d adopted blocks against a "
              "monolith's under the same digests: %d arrays differ, "
              "max_abs_err %.3g; tokens equal the monolith's: %s; "
              "cached_tokens %d" % (card, len(digests), n, worst, same,
                                    pr.phases["cached_tokens"]), flush=True)
        if n or pr.phases["cached_tokens"] != 16 * len(digests):
            fail("disagg probe: the adopted blocks are not the monolith's "
                 "bitwise (%d arrays differ) or were not matched" % n)
        torch.cuda.empty_cache()

        # the int8 pair
        i8_replies, _i8_cpu, short = int8_refs
        pa.paged_attention.launches = 0
        replies8, wall8, launches8, steps8, samples8, blocks8, step8 = \
            pair_mix(pa.paged_attention_int8, params, "int8", allp, clients,
                     "disagg int8")
        row1 = pa.paged_attention.launches
        if launches8 != cfg.layers * sum(steps8) or row1 != 0:
            fail("disagg int8: paged_attention_int8 launched %d times over "
                 "%s steps, row 1 %d times" % (launches8, steps8, row1))
        int8_bytes = counter("kv_xfer_bytes_total", dtype="int8")
        if not 0 < int8_bytes <= INT8_WIRE_BUDGET * f32_bytes:
            fail("disagg int8: %d frame bytes against the f32 pair's %d "
                 "(budget %.2fx)" % (int8_bytes, f32_bytes,
                                     INT8_WIRE_BUDGET))
        check_decode_tokens("disagg int8", [allp[i] for i in short],
                            [replies8[i] for i in short], _i8_cpu,
                            "the port's int8 path on the CPU")
        same8 = sum([int(t) for t in a.outputs["tokens"]]
                    == [int(t) for t in b.outputs["tokens"]]
                    for a, b in zip(replies8, i8_replies))
        ntok8 = sum(len(r.outputs["tokens"]) for r in replies8)
        print("disagg int8: %s; paged_attention_int8 launches %d = %d "
              "layers x (%d + %d steps), row 1 0; blocks %s; kv_xfer_bytes_"
              "total int8 %d = %.4fx the f32 pair's %d (budget %.2fx); "
              "export host ms p50 %.4f; tokens equal the int8 engine's (int8 "
              "phase) for %d of %d requests; %d tokens in %.3f s = %.2f "
              "tokens/s; step ms p50 prefill half %.3f, decode half %.3f; "
              "reply phases p50 %s"
              % (card, launches8, cfg.layers, steps8[0], steps8[1],
                 json.dumps(blocks8), int8_bytes, int8_bytes / f32_bytes,
                 f32_bytes, INT8_WIRE_BUDGET,
                 float(np.percentile(samples8, 50)), same8, len(replies8),
                 ntok8, wall8, ntok8 / wall8, step8[0], step8[1],
                 json.dumps(pair_phases(replies8))), flush=True)
    finally:
        set_flags({"FLAGS_telemetry": False})
        telemetry.reset()
    del base
    torch.cuda.empty_cache()
    return launches, launches8


# -- phase 4e: live session migration ----------------------------------------

MIGRATE_AFTER = 12      # tokens the session has emitted when it moves


def migrate_once(params, kv_dtype, prompt, what, tenant="default",
                 tier=None):
    """Two serve-role ServingServers over DecodeEngines on the card; a
    streamed generate of ``prompt`` (32 new tokens, from a client of
    ``tenant`` at ``tier``) on the first, moved to the second by the
    first's SessionMigrator once it has emitted MIGRATE_AFTER tokens ->
    (reply, what the hooks saw: the manifest's position, tokens, tier and
    tenant, the source's in-use blocks at the commit, the seconds to the
    commit and both engines' decode steps; positions re-fed, seconds from
    the export to the first resumed token, bytes moved)."""
    from paddle_tpu_torch.serving import (DecodeEngine, ServingClient,
                                          ServingEngine, ServingServer)

    cfg = gpt2_small()
    engs = []
    for _ in range(2):
        e = DecodeEngine(buckets="4,8", block_size=16, deadline_ms=600000.0,
                         kv_dtype=kv_dtype)
        e.add_model("gpt2-small", (cfg, params), kv_blocks=64)
        engs.append(e)
    src, dst = engs
    sd = ServingServer(ServingEngine(), port=0, decode_engine=dst).start()
    dst_ep = "127.0.0.1:%d" % sd.port
    ss = ServingServer(ServingEngine(), port=0, decode_engine=src,
                       decode_peers=[dst_ep]).start()
    seen = {}
    export, commit = src.export_session, src.commit_migration

    def export_hook(req_id):
        seen["t_export"] = time.perf_counter()
        manifest, payloads = export(req_id)
        seen["pos"] = manifest["pos"]
        seen["held"] = len(manifest["_out_arr"])
        seen["tier"], seen["tenant"] = manifest["tier"], manifest["tenant"]
        return manifest, payloads

    def commit_hook(req_id, peer):
        seen["in_use_at_commit"] = \
            src._models["gpt2-small"].cache.allocator.in_use
        return commit(req_id, peer)

    src.export_session, src.commit_migration = export_hook, commit_hook
    chunks, stamps, res = [], [], {}
    bytes0 = counter("kv_migrate_bytes_total")
    try:
        cli = ServingClient(endpoints=["127.0.0.1:%d" % ss.port],
                            deadline_ms=600000.0, tenant=tenant)

        def on_token(i, t):
            chunks.append((i, t))
            stamps.append(time.perf_counter())

        th = threading.Thread(target=lambda: res.setdefault(
            "r", cli.generate("gpt2-small", prompt, max_new_tokens=32,
                              on_token=on_token, tier=tier)), daemon=True)
        th.start()
        rid = [None]

        def emitted():
            with src._cond:
                for s in src._active:
                    if len(s.out) >= MIGRATE_AFTER:
                        rid[0] = s.pending.req_id
                        return True
            return False

        wait_for("%s: %d tokens emitted" % (what, MIGRATE_AFTER), emitted,
                 120.0, step=0.0005)
        if not ss.migrator.migrate(rid[0], peer=dst_ep, trigger="drain"):
            fail("%s: the push to %s was not acked" % (what, dst_ep))
        seen["commit_s"] = time.perf_counter() - seen["t_export"]
        th.join(120.0)
        if th.is_alive():
            fail("%s: the client never finished" % what)
        in_use = [e._models["gpt2-small"].cache.allocator.in_use
                  for e in engs]
        seen["steps"] = sum(e.steps for e in engs)
    finally:
        ss.shutdown()
        sd.shutdown()
    r = res["r"]
    if r.status != "ok":
        fail("%s: %s" % (what, (r.status, r.error)))
    toks = [int(t) for t in r.outputs["tokens"]]
    if chunks != list(enumerate(toks)):
        fail("%s: the client saw indices %s" % (what,
                                                 [i for i, _t in chunks]))
    if in_use != [0, 0] or not seen.get("in_use_at_commit"):
        fail("%s: blocks in use after %s, at the commit %s"
             % (what, in_use, seen.get("in_use_at_commit")))
    # positions fed before the first new token: the last emitted token's
    # and whatever below it neither matched nor came with the tail
    refed = seen["pos"] + 1 - r.phases["cached_tokens"]
    if r.phases.get("resumed_tokens") != seen["held"] or not refed <= 16:
        fail("%s: the destination re-fed %d positions (resumed %s of %d)"
             % (what, refed, r.phases.get("resumed_tokens"), seen["held"]))
    k = seen["held"]
    first_new = stamps[k] - seen["t_export"]
    return r, seen, refed, first_new, counter("kv_migrate_bytes_total") - \
        bytes0


def migration_phase(params, refs):
    """The 200-token prompt's session (32 new tokens) moved between two
    serve-role engines on the card once it has emitted MIGRATE_AFTER
    tokens: its tokens the plain loop's up to near-ties, each index seen
    once by the client (which follows ``migrated_to``), the destination
    re-feeding fewer than 16 positions before its first new token, the
    source's blocks held until the destination's ack.  Then the same with
    int8 pools, its tokens those of an uninterrupted int8 run of the
    prompt alone (the same bucket on both engines)."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.core import telemetry
    from paddle_tpu_torch.serving import DecodeEngine

    cfg = gpt2_small()
    card = card_line()
    first, _late = prompts(cfg.vocab)
    prompt = first[3]
    telemetry.reset()
    set_flags({"FLAGS_telemetry": True})
    try:
        for kv_dtype in ("f32", "int8"):
            what = "migration %s" % kv_dtype
            r, seen, refed, first_new, nbytes = migrate_once(
                params, kv_dtype, prompt, what)
            if kv_dtype == "f32":
                check_decode_tokens(what, [prompt], [r], refs[3:4])
            else:
                solo = DecodeEngine(buckets="4,8", block_size=16,
                                    deadline_ms=600000.0, kv_dtype="int8")
                solo.add_model("gpt2-small", (cfg, params), kv_blocks=64)
                solo.start()
                try:
                    want = solo.generate("gpt2-small", prompt,
                                         max_new_tokens=32)
                finally:
                    solo.stop()
                if [int(t) for t in r.outputs["tokens"]] != \
                        [int(t) for t in want.outputs["tokens"]]:
                    fail("%s: tokens %s, the uninterrupted int8 run's %s"
                         % (what, r.outputs["tokens"].tolist(),
                            want.outputs["tokens"].tolist()))
            nfull = seen["pos"] // 16
            print("%s: %s; exported at position %d (%d sealed blocks and a "
                  "%d-position tail) after %d tokens; %d bytes moved; the "
                  "destination fed %d position(s) before its first new "
                  "token (cached_tokens %d); "
                  "%.4f s from the export to the source's commit (the ack "
                  "in), %.4f s to the first resumed token at the client; the "
                  "source held %d blocks until the ack; every index seen "
                  "once" % (what, card, seen["pos"], nfull,
                            seen["pos"] - 16 * nfull, seen["held"], nbytes,
                            refed, r.phases["cached_tokens"],
                            seen["commit_s"], first_new,
                            seen["in_use_at_commit"]), flush=True)
    finally:
        set_flags({"FLAGS_telemetry": False})
        telemetry.reset()
    torch.cuda.empty_cache()


# -- phase 5e: a disaggregated fleet of replicas ------------------------------

# the pair replicas' slots: two decode replicas (rank 0 coordinates) and a
# prefill replica; a fault point slows the prefill replica's steps (its
# transfer is long enough to be killed mid-way) and the drained decode
# replica's (its sessions are still live when it retires)
PAIR_ROLES = ("decode", "decode", "prefill")
SLOW_STEPS = "serving.decode_step:delay:0.3"


def pair_replica(dec_dir, eps, eps_file, rank, slow):
    env = dict(os.environ, FLAGS_migrate_on_drain="1", **FLEET_ENV)
    if slow:
        env["FLAGS_fault_spec"] = SLOW_STEPS
    return Replica([sys.executable, "-u", os.path.join(HERE, "tools",
                                                       "torch_serve.py"),
                    "--model", "gpt2-small=" + dec_dir, "--decode-buckets",
                    "4,8", "--kv-blocks", "520", "--rank", str(rank),
                    "--fleet", ",".join(eps), "--roles",
                    ",".join(PAIR_ROLES), "--endpoints-file", eps_file,
                    "--device", FLEET_DEVICE], env)


def scrape_counters(ep):
    from paddle_tpu_torch.core import telemetry

    snap = telemetry.scrape(ep, timeout=10.0)
    return snap["counters"], snap["gauges"]


def served_launches(what, served, launches, dcfg):
    """A replica's SERVED and LAUNCHES documents: row 1 launched 12 times
    a decode step it ran, the int8 kernel never -> its row 1 launches."""
    steps = served["decode_steps"]
    if launches["paged_attention"] != dcfg.layers * steps or steps == 0 \
            or launches["paged_attention_int8"]:
        fail("%s: launches %s over %d decode steps" % (what, launches,
                                                        steps))
    return launches["paged_attention"]


def check_served(what, rep, dcfg):
    """A replica that exited 0 printed SERVED and LAUNCHES, which
    ``served_launches`` holds -> (its decode steps, its row 1 launches)."""
    served, launches = rep.line("SERVED "), rep.line("LAUNCHES ")
    if served is None or launches is None:
        fail("%s: no SERVED / LAUNCHES; output ends:\n%s" % (what,
                                                            rep.tail()))
    return served["decode_steps"], served_launches(what, served, launches,
                                                   dcfg)


def pair_fleet_phase(dec_dir, refs, tmp):
    """Three ``tools/torch_serve.py`` replicas on the card, one fleet over
    an endpoints file with the role column PAIR_ROLES and
    FLAGS_migrate_on_drain=1: (1) the three shortest prompts through the
    pair across processes; (2) the prefill replica SIGKILLed while it
    streams the 384-token prompt's blocks: the decode half's janitor
    frees what it adopted (its ``__metrics__``: an orphan reaped, the
    blocks forgotten, none in use) and the client's replay completes;
    (3) the prefill replica relaunched while rank 1, holding live
    sessions, is retired by ``__retire__``: they finish on rank 0 through
    ``migrated_to``, resumed, not replayed whole; (4) rank 0 SIGKILLed
    mid-stream: the client's ``__resume__`` completes on the relaunched
    prefill replica.  Every reply ok, every index once, tokens the plain
    loop's up to near-ties; a replica that exits 0 launched row 1 12
    times a decode step it served."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.native.rpc import RpcClient
    from paddle_tpu_torch.serving import ServingClient, codec

    dcfg = gpt2_small()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    t_phase = time.perf_counter()
    first, _late = prompts(dcfg.vocab)
    eps_file = os.path.join(tmp, "pair-endpoints.json")
    eps = ["127.0.0.1:%d" % p for p in free_ports(3)]
    reps = {r: pair_replica(dec_dir, eps, eps_file, r, slow=r != 0)
            for r in range(3)}
    set_flags({"FLAGS_telemetry": True})
    try:
        for r, rep in reps.items():
            manifest = rep.ready("pair replica %d" % r)
            if manifest is None or manifest.get("device") != kind:
                fail("pair replica %d prewarmed on %r" % (r, manifest))
        wait_for("the endpoints file listing the three with their roles",
                 lambda: endpoints_doc(eps_file).get("roles")
                 == list(PAIR_ROLES)
                 and endpoints_doc(eps_file)["endpoints"] == eps, 60.0)
        print("pair fleet: 3 replicas (%s) ready and published in %.1f s"
              % (",".join(PAIR_ROLES), time.perf_counter() - t_phase),
              flush=True)

        # 1. through the pair
        short = shortest(first)
        cli = ServingClient(endpoints_file=eps_file, deadline_ms=600000.0)
        replies, chunks = [], []
        for i in short:
            got = []
            replies.append(cli.generate("gpt2-small", first[i],
                                        max_new_tokens=32,
                                        on_token=lambda j, t, g=got:
                                        g.append((j, t))))
            chunks.append(got)
        for r, got in zip(replies, chunks):
            if r.status != "ok" or r.phases.get("role") != "disagg" or \
                    got != list(enumerate(int(t) for t in
                                          r.outputs["tokens"])):
                fail("pair fleet: a generate through the pair: %s, role %s"
                     % ((r.status, r.error), r.phases.get("role")))
        check_decode_tokens("pair fleet", [first[i] for i in short],
                            replies, [refs[i] for i in short])

        # 2. the prefill replica SIGKILLed mid-transfer
        base = {ep: sum_of(scrape_counters(ep)[0], "kv_xfer_adopt_total",
                           result="adopted") for ep in eps[:2]}
        long_i = max(range(len(first)), key=lambda i: len(first[i]))
        res = {}
        th = threading.Thread(target=lambda: res.setdefault(
            "r", cli.generate("gpt2-small", first[long_i],
                              max_new_tokens=32, max_attempts=40)),
            daemon=True)
        th.start()
        adopting = [None]

        def adopted_some():
            for ep in eps[:2]:
                if sum_of(scrape_counters(ep)[0], "kv_xfer_adopt_total",
                          result="adopted") > base[ep]:
                    adopting[0] = ep
                    return True
            return False

        wait_for("a decode replica adopting the long prompt's blocks",
                 adopted_some, 60.0, step=0.05)
        t_kill = time.perf_counter()
        reps[2].proc.kill()
        if reps[2].wait(30.0) != -9:
            fail("pair fleet: the prefill replica did not die by SIGKILL")
        th.join(300.0)
        r = res.get("r")
        if r is None or r.status != "ok":
            fail("pair fleet: the replay after the prefill kill: %s"
                 % (None if r is None else (r.status, r.error)))
        check_decode_tokens("pair fleet replay", [first[long_i]], [r],
                            [refs[long_i]])
        t_replay = time.perf_counter() - t_kill
        snap = [None]

        def reaped():
            c, g = scrape_counters(adopting[0])
            snap[0] = (c, g)
            return sum_of(c, "kv_xfer_orphans_total") >= 1 and \
                sum_of(c, "kv_xfer_forget_total") >= 1 and \
                g.get("kv_blocks_in_use") == 0.0
        wait_for("the decode half's janitor freeing the adopted blocks",
                 reaped, 30.0, step=0.2)
        c, g = snap[0]
        print("pair fleet: %s; the prefill replica SIGKILLed while %s "
              "adopted the 384-token prompt's blocks; its janitor: orphans "
              "%s, forgotten %d, kv_blocks_in_use %d, kv_blocks_evictable "
              "%d; the client's replay ok %.3f s after the kill (%d "
              "failovers), its tokens the plain loop's"
              % (card, adopting[0], json.dumps(
                  {k: v for k, v in c.items()
                   if k.startswith("kv_xfer_orphans_total")}),
                 sum_of(c, "kv_xfer_forget_total"),
                 g.get("kv_blocks_in_use", -1),
                 g.get("kv_blocks_evictable", -1), t_replay, cli.failovers),
              flush=True)

        # 3. the prefill replica relaunched; rank 1 drained by migration
        reps[2] = pair_replica(dec_dir, eps, eps_file, 2, slow=False)
        live, started, mthreads = {}, [], []
        for i in short:
            def run(i=i, ev=threading.Event()):
                # rank 1 first, rank 0 to fail over to
                mig = ServingClient(endpoints=[eps[1], eps[0]],
                                    deadline_ms=600000.0)
                got = []

                def on_token(j, t):
                    got.append((j, t))
                    ev.set()

                live[i] = (mig.generate("gpt2-small", first[i],
                                        max_new_tokens=32,
                                        on_token=on_token), got)
            started.append(run.__defaults__[1])
            mthreads.append(threading.Thread(target=run, daemon=True))
            mthreads[-1].start()
        wait_for("every session on rank 1 past its prefill", lambda: all(
            ev.is_set() for ev in started), 120.0)
        follow0 = counter("client_migrate_follow_total")
        t_retire = time.perf_counter()
        rc_ = RpcClient(eps[1], connect_timeout=10.0, rpc_deadline=30.0,
                        retry_times=0)
        try:
            rc_.send_var(codec.RETIRE_KEY, codec.pack({}))
        finally:
            rc_.close()
        for t in mthreads:
            t.join(300.0)
        if reps[1].wait(120.0) != 0:
            fail("pair fleet: rank 1 after __retire__; output ends:\n%s"
                 % reps[1].tail())
        t_drained = time.perf_counter() - t_retire
        moved = [i for i in short if "resumed_tokens" in
                 live[i][0].phases]
        for i in short:
            r, got = live[i]
            if r.status != "ok" or got != list(enumerate(
                    int(t) for t in r.outputs["tokens"])):
                fail("pair fleet drain: request %d %s, chunks %s"
                     % (i, (r.status, r.error), [j for j, _t in got]))
        check_decode_tokens("pair fleet drain", [first[i] for i in short],
                            [live[i][0] for i in short],
                            [refs[i] for i in short])
        follows = counter("client_migrate_follow_total") - follow0
        if not moved or follows < len(moved):
            fail("pair fleet drain: no session moved by migration (follows "
                 "%d)" % follows)
        steps1, l1 = check_served("pair fleet rank 1", reps[1], dcfg)
        print("pair fleet: %s; rank 1 retired with %d live sessions and "
              "FLAGS_migrate_on_drain: %d followed migrated_to to rank 0 "
              "and resumed there (feeding %s positions before their first "
              "new token, resumed_tokens %s), "
              "none replayed whole; rank 1 exited 0 %.3f s after the "
              "__retire__, its paged_attention launches %d = %d layers x "
              "%d decode steps" % (card, len(short), len(moved),
                                [len(first[i]) + live[i][0].phases[
                                    "resumed_tokens"]
                                 - live[i][0].phases["cached_tokens"]
                                 for i in moved],
                                [live[i][0].phases["resumed_tokens"]
                                 for i in moved], t_drained, l1,
                                dcfg.layers, steps1),
              flush=True)

        # 4. rank 0 SIGKILLed mid-stream; resumed on the relaunched replica
        reps[2].ready("relaunched prefill replica")
        kc = ServingClient(endpoints=[eps[0], eps[2]], deadline_ms=600000.0)
        got, first_tok = [], threading.Event()

        def on_token(j, t):
            got.append((j, t))
            first_tok.set()

        killer = threading.Thread(target=lambda: (
            first_tok.wait(120.0), reps[0].proc.kill()), daemon=True)
        killer.start()
        i = short[-1]
        r = kc.generate("gpt2-small", first[i], max_new_tokens=32,
                        on_token=on_token)
        killer.join(60.0)
        if reps[0].wait(30.0) != -9:
            fail("pair fleet: rank 0 did not die by SIGKILL")
        if r.status != "ok" or got != list(enumerate(
                int(t) for t in r.outputs["tokens"])) \
                or not r.phases.get("resumed_tokens"):
            fail("pair fleet: the resume after rank 0's kill: %s, chunks "
                 "%s, resumed_tokens %s" % ((r.status, r.error),
                                            [j for j, _t in got],
                                            r.phases.get("resumed_tokens")))
        check_decode_tokens("pair fleet resume", [first[i]], [r],
                            [refs[i]])
        print("pair fleet: %s; rank 0 SIGKILLed after its first streamed "
              "token; the client's __resume__ went on at the relaunched "
              "replica from index %d (resumed_tokens %d, cached_tokens "
              "%d), every index once, %d failover(s)"
              % (card, r.phases["resumed_tokens"],
                 r.phases["resumed_tokens"], r.phases["cached_tokens"],
                 kc.failovers), flush=True)
        reps[2].proc.send_signal(15)
        if reps[2].wait(120.0) != 0:
            fail("pair fleet: the relaunched replica after SIGTERM; output "
                 "ends:\n%s" % reps[2].tail())
        steps2, l2 = check_served("pair fleet relaunched rank 2", reps[2],
                                  dcfg)
        print("pair fleet: the relaunched replica exited 0 on SIGTERM, its "
              "paged_attention launches %d = %d layers x %d decode steps; "
              "%s; phase wall %.1f s" % (l2, dcfg.layers, steps2, card,
                                         time.perf_counter() - t_phase),
              flush=True)
    finally:
        set_flags({"FLAGS_telemetry": False})
        for rep in reps.values():
            rep.kill()


# -- phase 5f: SLO tiers on the decode engine, over the wire ------------------

# the waiting queue's cap and the tier weights, set through the flags only
TIERS_FLAGS = {"FLAGS_serving_decode_buckets": "4",
               "FLAGS_serving_max_queue": 4,
               "FLAGS_serving_tier_weights": "paid:1.0,free:0.5,batch:0.2"}
TIER_WEIGHTS = {"paid": 1.0, "free": 0.5, "batch": 0.2}
# the lanes' requests (the four shortest prompts, untiered), then the
# tiered sequence: (tier or None, prompt index); "gold" is a tier the
# weights do not name, so it weighs as the lowest
TIER_FILLERS = (0, 6, 2, 9)
TIER_SEQUENCE = (("batch", 1), ("free", 3), ("gold", 5), ("free", 8),
                 ("paid", 4), ("batch", 1), (None, 7), ("free", 3),
                 ("paid", 11), ("gold", 5), ("paid", 10), ("paid", 8))
HOLD_STEPS = "serving.decode_step:delay:1"


def tier_replay(tiers, weights, max_queue):
    """The reference's queue-full rule replayed on the host over arrivals
    into a queue that nothing leaves -> ({arrival: (reason, the arriving
    tier that caused it)} of the shed ones, the weights queued at each
    arrival)."""
    def weight(t):
        return 1.0 if not t else weights.get(t, min(weights.values()))

    queue, shed, seen = [], {}, []
    for i, t in enumerate(tiers):
        seen.append([weight(tiers[j]) for j in queue])
        if len(queue) >= max_queue:
            victim = min(queue, key=lambda j: (weight(tiers[j]), -j))
            if weight(tiers[victim]) < weight(t):
                queue.remove(victim)
                shed[victim] = ("tier_evicted", t or "default")
            else:
                shed[i] = ("queue_full", t or "default")
                continue
        queue.append(i)
    return shed, seen


def tiers_phase(pa, params, refs):
    """A ServingServer over a DecodeEngine on the card whose lane bucket,
    queue cap and tier weights come from the flags alone (TIERS_FLAGS):
    four untiered requests hold the four lanes (the ``serving.decode_step``
    delay slowing their steps), then ``ServingClient.generate(tier=)``
    sends TIER_SEQUENCE one request at a time, each admitted or shed
    before the next goes.  The shed requests and their reasons must be
    ``tier_replay``'s, no paid request shed while a lighter one waits,
    the ``serving_tier_shed_total`` of the server's ``__metrics__`` the
    sheds the clients saw, tier by tier, every completed request's tokens
    the plain loop's up to near-ties, row 1 launched 12 times a decode
    step.  Then one session of tenant ``acme`` at tier ``free`` moves
    between two engines mid-decode (``migrate_once``): the manifest and
    the resumed reply keep both.  -> row 1's launches."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.core import telemetry
    from paddle_tpu_torch.serving import (DecodeEngine, ServingClient,
                                          ServingEngine, ServingServer)
    from paddle_tpu_torch.utils import fault_injection

    cfg = gpt2_small()
    card = card_line()
    first, late = prompts(cfg.vocab)
    allp = first + [late]
    t_phase = time.perf_counter()
    telemetry.reset()
    set_flags(dict(TIERS_FLAGS, FLAGS_telemetry=True))
    try:
        eng = DecodeEngine(block_size=16, deadline_ms=600000.0)
        if eng.buckets != (4,) or eng.max_queue != 4 or \
                eng.tier_weights != TIER_WEIGHTS:
            fail("tiers: the flags set lanes %s, queue %d, weights %s"
                 % (eng.buckets, eng.max_queue, eng.tier_weights))
        eng.add_model("gpt2-small", (cfg, params), kv_blocks=520)
        submitted = []
        submit = eng.submit

        def recorded(*a, **kw):
            p = submit(*a, **kw)
            submitted.append(p)
            return p

        eng.submit = recorded
        srv = ServingServer(ServingEngine(), port=0,
                            decode_engine=eng).start()
        ep = "127.0.0.1:%d" % srv.port
        replies = {}

        def send(key, i, tier):
            cli = ServingClient(endpoints=[ep], deadline_ms=600000.0)
            got = []
            r = cli.generate("gpt2-small", allp[i], max_new_tokens=32,
                             tier=tier, max_attempts=1,
                             on_token=lambda j, t: got.append(j))
            replies[key] = (r, got)

        threads = []
        pa.paged_attention.launches = 0
        steps0 = eng.steps
        fault_injection.arm(HOLD_STEPS)
        try:
            for k, i in enumerate(TIER_FILLERS):
                threads.append(threading.Thread(
                    target=send, args=(("fill", k), i, None), daemon=True))
                threads[-1].start()
            wait_for("tiers: the four lanes busy", lambda: len(
                eng._active) == 4 and not eng._waiting, 120.0)
            for k, (tier, i) in enumerate(TIER_SEQUENCE):
                threads.append(threading.Thread(
                    target=send, args=(k, i, tier), daemon=True))
                threads[-1].start()
                wait_for("tiers: arrival %d admitted or shed" % k,
                         lambda: len(submitted) == len(TIER_FILLERS) + k + 1,
                         60.0, step=0.001)
            held = len(eng._active)
        finally:
            fault_injection.disarm()
        if held != 4:
            fail("tiers: a lane freed while the sequence arrived")
        for th in threads:
            th.join(600.0)
        if any(th.is_alive() for th in threads):
            fail("tiers: a client never finished")
        launches, steps = pa.paged_attention.launches, eng.steps - steps0
        snap = telemetry.scrape(ep, timeout=10.0)["counters"]
        srv.shutdown()
    finally:
        set_flags({"FLAGS_serving_decode_buckets": "4,8",
                   "FLAGS_serving_max_queue": 256,
                   "FLAGS_serving_tier_weights":
                       "paid:1.0,free:0.45,batch:0.15"})
    tiers = [t for t, _i in TIER_SEQUENCE]
    want, queued = tier_replay(tiers, TIER_WEIGHTS, 4)
    got = {k: (r.status, r.error) for k, (r, _g) in replies.items()
           if k not in [("fill", j) for j in range(len(TIER_FILLERS))]
           and r.status != "ok"}
    want_err = {k: ("shed", "evicted by %s-tier arrival" % by
                    if reason == "tier_evicted" else "queue full (4)")
                for k, (reason, by) in want.items()}
    if got != want_err:
        fail("tiers: shed %s, the host replay %s" % (got, want_err))
    for k, (reason, _by) in want.items():
        if tiers[k] == "paid" and reason == "queue_full" and \
                min(queued[k]) < 1.0:
            fail("tiers: paid arrival %d shed while weights %s waited"
                 % (k, queued[k]))
    by_tier = {}
    for k in want:
        t = tiers[k] or "default"
        by_tier[t] = by_tier.get(t, 0) + 1
    metric = {t: sum_of(snap, "serving_tier_shed_total", tier=t)
              for t in by_tier}
    if metric != by_tier or sum_of(snap, "serving_tier_shed_total") != \
            len(want):
        fail("tiers: __metrics__ tier sheds %s, the clients saw %s"
             % (metric, by_tier))
    done = [k for k in replies if k not in want]
    bad = [(k, r.status, r.error) for k in done for r, g in [replies[k]]
           if r.status != "ok" or g != list(range(32))
           or r.phases.get("tier") != (
               "default" if isinstance(k, tuple) else tiers[k] or "default")]
    if bad:
        fail("tiers: completed requests %s" % bad)
    idx = [TIER_FILLERS[k[1]] if isinstance(k, tuple)
           else TIER_SEQUENCE[k][1] for k in done]
    check_decode_tokens("tiers", [allp[i] for i in idx],
                        [replies[k][0] for k in done], [refs[i] for i in idx])
    if launches != cfg.layers * steps or steps == 0:
        fail("tiers: paged_attention launched %d times over %d steps"
             % (launches, steps))
    print("tiers: %s; lanes %s, queue cap %d, weights %s from the flags; "
          "%d requests held 4 lanes, then %d tiered arrivals: shed %s "
          "(the host replay's), __metrics__ serving_tier_shed_total %s; "
          "%d completed with the plain loop's tokens; paged_attention "
          "launches %d = %d layers x %d decode steps"
          % (card, list(eng.buckets), eng.max_queue, json.dumps(
              TIER_WEIGHTS), len(TIER_FILLERS), len(TIER_SEQUENCE),
             json.dumps({str(k): v for k, v in sorted(want.items())}),
             json.dumps(metric), len(done), launches, cfg.layers, steps),
          flush=True)

    # a session keeps its tenant and tier across a migration
    acme0 = counter("serving_decode_requests_total", tenant="acme")
    pa.paged_attention.launches = 0
    r, seen, refed, first_new, _nbytes = migrate_once(
        params, "f32", first[3], "tiers migration", tenant="acme",
        tier="free")
    mig_launches = pa.paged_attention.launches
    admitted = counter("serving_decode_requests_total", tenant="acme") - \
        acme0
    if (seen["tier"], seen["tenant"]) != ("free", "acme") or \
            r.phases.get("tier") != "free" or admitted != 2:
        fail("tiers migration: manifest tier %r tenant %r, the resumed "
             "reply's tier %r, acme admissions %s"
             % (seen["tier"], seen["tenant"], r.phases.get("tier"),
                admitted))
    check_decode_tokens("tiers migration", [first[3]], [r], refs[3:4])
    if mig_launches != cfg.layers * seen["steps"]:
        fail("tiers migration: paged_attention launched %d times over %d "
             "steps" % (mig_launches, seen["steps"]))
    set_flags({"FLAGS_telemetry": False})
    telemetry.reset()
    torch.cuda.empty_cache()
    print("tiers migration: %s; tenant acme at tier free exported at "
          "position %d, the manifest's tier %r and tenant %r, resumed on the "
          "peer (its reply's tier %r, admitted under tenant acme on both "
          "sides) after re-feeding %d positions; paged_attention launches "
          "%d = %d layers x %d decode steps; phase wall %.1f s"
          % (card, seen["pos"], seen["tier"], seen["tenant"],
             r.phases["tier"], refed, mig_launches, cfg.layers,
             seen["steps"], time.perf_counter() - t_phase), flush=True)
    return launches + mig_launches


# -- phase 5g: one autoscaler a role -----------------------------------------

# the decode pools' blocks in the replicas' environment: eight clients'
# sequences of 33 + 96..208 tokens want about 100 blocks of 16 at their
# ends, so rank 0's pool stays full (>= 0.85) under the burst
ROLE_POOL_BLOCKS = 64
ROLE_CLIENTS = 8
ROLE_PROMPT = 33            # two full blocks handed off a request
ROLE_NEW = 96               # client k asks for ROLE_NEW + 16 k tokens


def start_role_fleet(dec_dir, tmp):
    """Start rank 0 (decode, ``--autoscale``) and rank 2 (prefill) of a
    ``--roles decode,decode,prefill`` fleet on the card, slot 1 left
    dead, every pool sized by FLAGS_kv_cache_blocks -> what
    ``role_autoscale_phase`` needs."""
    got = {"t0": time.perf_counter(),
           "eps_file": os.path.join(tmp, "role-endpoints.json")}
    got["eps"] = ["127.0.0.1:%d" % p for p in free_ports(3)]
    env = dict(os.environ, FLAGS_kv_cache_blocks=str(ROLE_POOL_BLOCKS),
               **FLEET_ENV, **AUTOSCALE_ENV)
    base = [sys.executable, "-u", os.path.join(HERE, "tools",
                                               "torch_serve.py"),
            "--model", "gpt2-small=" + dec_dir, "--fleet",
            ",".join(got["eps"]), "--roles", ",".join(PAIR_ROLES),
            "--endpoints-file", got["eps_file"], "--device", FLEET_DEVICE]
    got[0] = Replica(base + ["--rank", "0", "--autoscale", "--min-replicas",
                             "1", "--max-replicas", "2"], env)
    got[2] = Replica(base + ["--rank", "2"], env)
    return got


def role_autoscale_phase(started):
    """``role_fleet_holds`` on the fleet of ``start_role_fleet``, its
    replicas and every standby they forked stopped after -> row 1's
    launches in the replicas."""
    try:
        return role_fleet_holds(started)
    finally:
        for _t, ready in started[0].all("READY ")[1:]:
            try:
                os.kill(int(ready.split("pid=")[1]), 9)
            except OSError:
                pass
        started[0].kill()
        started[2].kill()


def role_fleet_holds(started):
    """The fleet of ``start_role_fleet``: once slot 1 is out of the
    endpoints file, ROLE_CLIENTS threads send long generates through the
    prefill replica until the decode controller (KV-pool occupancy >=
    0.85) has forked a standby into slot 1, the standby is in the file
    and has served; then the traffic stops and the decode controller
    (occupancy <= 0.30) retires a decode rank through a drain.  The
    prefill replica is in every version of the file, every reply is ok
    with every index once, and each replica that exits 0 launched row 1
    12 times a decode step it ran.  -> row 1's launches in the replicas."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.core import telemetry
    from paddle_tpu_torch.serving import ServingClient

    dcfg = gpt2_small()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    eps, eps_file = started["eps"], started["eps_file"]
    rep0, rep2 = started[0], started[2]
    for r, rep in ((0, rep0), (2, rep2)):
        manifest = rep.ready("role fleet rank %d" % r)
        if manifest is None or manifest.get("device") != kind:
            fail("role fleet rank %d prewarmed on %r" % (r, manifest))
    versions, watching = [], threading.Event()

    def watch():
        while not watching.is_set():
            d = endpoints_doc(eps_file)
            if d.get("epoch", -1) >= 0 and (not versions
                                            or d != versions[-1]):
                versions.append(d)
            time.sleep(0.005)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    evict_s = wait_for("role fleet: slot 1 out of the file", lambda:
                       endpoints_doc(eps_file)["endpoints"]
                       == [eps[0], eps[2]], 30.0)
    stop = threading.Event()
    replies, lock = [], threading.Lock()

    def client(k):
        rng = np.random.RandomState(100 + k)
        cli = ServingClient(endpoints_file=eps_file, deadline_ms=600000.0)
        while not stop.is_set():
            got = []
            r = cli.generate("gpt2-small", rng.randint(
                0, dcfg.vocab, ROLE_PROMPT).tolist(),
                max_new_tokens=ROLE_NEW + 16 * k, max_attempts=400,
                on_token=lambda j, t: got.append(j))
            with lock:
                replies.append((r, got, ROLE_NEW + 16 * k,
                                time.perf_counter()))

    # a shed under a full pool is retried after its hint
    set_flags({"FLAGS_serving_client_shed_retries": 200})
    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(ROLE_CLIENTS)]
    t_burst = time.perf_counter()
    try:
        for th in threads:
            th.start()
        wait_for("role fleet: the standby's READY", lambda: len(
            rep0.all("READY ")) >= 2, FLEET_READY_S)
        t_ready, ready = rep0.all("READY ")[1]
        if ready.split()[0] != "port=" + eps[1].rsplit(":", 1)[1]:
            fail("role fleet: the standby came up as %r, not slot 1" % ready)
        joined_s = wait_for("role fleet: the file listing the standby",
                            lambda: endpoints_doc(eps_file)["endpoints"]
                            == eps, 60.0)

        def standby_served():
            if any(json.loads(s)["decode_steps"] > 0
                   for _t, s in rep0.all("SERVED ")):
                return True
            try:
                return sum_of(telemetry.scrape(eps[1], timeout=10.0)[
                    "counters"], "serving_decode_requests_total") > 0
            except Exception:  # between a retire and a new fork
                return False

        wait_for("role fleet: the standby serving", standby_served, 120.0,
                 step=0.2)
    finally:
        stop.set()
        for th in threads:
            th.join(600.0)
        set_flags({"FLAGS_serving_client_shed_retries": 2})
    if any(th.is_alive() for th in threads):
        fail("role fleet: a client did not finish")
    t_last = max(t for _r, _g, _n, t in replies)
    wait_for("role fleet: the standby retired", lambda: len(rep0.all(
        "SERVED ")) == len(rep0.all("READY ")) - 1, 120.0, step=0.005)
    wait_for("role fleet: the file back to ranks 0 and 2", lambda:
             endpoints_doc(eps_file)["endpoints"] == [eps[0], eps[2]], 30.0)
    counters = {}

    def scaled_down():
        # __metrics__ republishes on its own tick
        counters.update(telemetry.scrape(eps[0], timeout=10.0)["counters"])
        return sum_of(counters, "autoscale_events_total", dir="down") >= 1

    wait_for("role fleet: the scale-down in rank 0's __metrics__",
             scaled_down, 30.0, step=0.2)
    ups = [t for t, _l in rep0.all("WARNING:root:[autoscale] scale up")]
    t_served = rep0.all("SERVED ")[-1][0]
    bad = [(r.status, r.error, len(g), n) for r, g, n, _t in replies
           if r.status != "ok" or g != list(range(n))]
    if not replies or bad:
        fail("role fleet: %d of %d replies failed: %s"
             % (len(bad), len(replies), bad[:5]))
    total = 0
    standbys = [json.loads(s) for _t, s in rep0.all("SERVED ")]
    for doc, (_t, lau) in zip(standbys, rep0.all("LAUNCHES ")):
        if doc["rank"] != 1:
            fail("role fleet: a retire took rank %d" % doc["rank"])
        if doc["decode_steps"]:
            total += served_launches("role fleet standby", doc,
                                     json.loads(lau), dcfg)
    if not any(doc["decode_steps"] for doc in standbys):
        fail("role fleet: no standby served (%s)" % standbys)
    if rep2.proc.poll() is not None:
        fail("role fleet: the prefill replica left (rc %s)"
             % rep2.proc.poll())
    for r, rep in ((0, rep0), (2, rep2)):
        rep.proc.send_signal(15)
        if rep.wait(120.0) != 0:
            fail("role fleet: rank %d after SIGTERM; output ends:\n%s"
                 % (r, rep.tail()))
        doc = json.loads(rep.all("SERVED ")[-1][1])
        if doc["rank"] != r:
            fail("role fleet: rank %d printed SERVED %s" % (r, doc))
        total += served_launches("role fleet rank %d" % r, doc, json.loads(
            rep.all("LAUNCHES ")[-1][1]), dcfg)
    watching.set()
    watcher.join(5.0)
    if len(versions) < 3 or not all(
            eps[2] in d["endpoints"] and d["roles"][d["endpoints"].index(
                eps[2])] == "prefill" for d in versions):
        fail("role fleet: the prefill replica missing from a version of "
             "the file: %s" % versions)
    print("role fleet: %s; --roles %s, rank 0 --autoscale, slot 1 dead "
          "(out of the file %.1f s after the wait began), pools of %d "
          "blocks; %d client threads: scale-up %.3f s after the burst "
          "began, the standby READY in slot 1 %.3f s after the scale-up, in "
          "the file %.3f s after that; %d replies ok, every index once; "
          "after the last reply the retire's SERVED %.3f s (standbys %s); "
          "the prefill replica in all %d versions of the file; autoscale "
          "events %s; paged_attention launches %d over the replicas, 12 a "
          "decode step; phase wall %.1f s from the replicas' launch"
          % (card, ",".join(PAIR_ROLES), evict_s, ROLE_POOL_BLOCKS,
             ROLE_CLIENTS, ups[0] - t_burst, t_ready - ups[0], joined_s,
             len(replies), t_served - t_last, json.dumps(standbys),
             len(versions), json.dumps({k: v for k, v in counters.items()
                                        if k.startswith("autoscale_")}),
             total, time.perf_counter() - started["t0"]), flush=True)
    return total


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


def moment_gap(got, want, only=None):
    """(largest of max|got - want| / scale over the moment tensors, or over
    those named in ``only``, the tensor where it is).  A tensor's scale is
    its largest |want|, but at least MOMENT_FLOOR of the largest first
    moment (MOMENT_FLOOR squared of the largest second moment): a gradient
    that is zero but for rounding, as the key projection's bias has
    (softmax ignores a shift shared by a row's scores), leaves moments of
    rounding noise alone, which only the floor holds.  numpy arrays or
    tensors on one device."""
    top = {k: max(float(abs(w).max()) for n, w in want.items() if k in n)
           for k in ("_moment1_", "_moment2_")}
    floor = {"_moment1_": MOMENT_FLOOR * top["_moment1_"],
             "_moment2_": MOMENT_FLOOR ** 2 * top["_moment2_"]}
    gap, worst = 0.0, None
    for n, w in want.items():
        if only is not None and n not in only:
            continue
        kind = "_moment1_" if "_moment1_" in n else "_moment2_"
        scale = max(float(abs(w).max()), floor[kind])
        rel = float(abs(got[n] - w).max()) / scale
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
    TRAIN_P50[name] = float(np.percentile(step_ms, 50))
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


def resnet_program(which, is_test, optimizer=None):
    """(main, startup, img, label, output): ``which`` is "bundled" (the
    port's models.resnet) or "trunk"; the output is the logits at
    is_test, else the loss, Momentum(0.1, 0.9, L2Decay(1e-4)) appended as
    ``build_train`` appends it, or for the trunk ``optimizer()`` where a
    callable is given."""
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
            opt = optimizer() if optimizer is not None else Momentum(
                learning_rate=RESNET_LR, momentum=0.9,
                regularization=L2Decay(1e-4))
            opt.minimize(out)
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


# -- phase 11: Transformer NMT ------------------------------------------------

# bench.py's nmt configuration: transformer-base (Vaswani et al. 2017, a
# 30000 vocabulary each side), batch 128 of 64 source and 64 target tokens,
# dropout 0.1, label smoothing 0.1, noam warmup 400
NMT_BATCH = 128
NMT_LEN = 64
NMT_WARMUP = 400
NMT_STEPS = 10
# card vs CPU: 3 steps from the initial state at batch 16 (rows padded to
# lengths of 32-64 tokens, so the masks and weights take part)
NMT_CHECK_BATCH = 16
# beam decode at full width from the trained weights: batch 8, beam 4, the
# decode loop unrolled 16 steps (cut from max_len 64, which keeps the
# program at ~5.6k ops)
NMT_BEAM_BATCH = 8
NMT_BEAM = 4
NMT_BEAM_LEN = 16
NMT_BEAM_RUNS = 3
# card vs CPU, both f32 with TF32 off, so they differ by summation order
# only: losses (~10.3 = ln 30000 plus the smoothing's share) absolutely;
# the noam learning rate of each step (the same [1] f32 ops on both)
# relatively; the Adam moments as ``moment_gap`` reads them, after the
# first step and after the last; the parameters after the last step as
# ``param_gap`` reads them.  Every FFN passes relu, which keeps or zeroes
# a hidden unit by the sign of its pre-activation: one within rounding of
# 0 may take the other sign on the other device and move that token's
# whole term in or out of every gradient upstream of it.  So the CPU runs
# the steps twice.  Once with the card's relu decisions (each relu keeps,
# and passes the gradient, where the card's input was > 0): every moment
# at BERT's TRAIN_MOMENT_RTOL, the parameters at NMT_PARAM_RTOL.  Once
# with its own: every input whose sign differs from the card's in the
# first step lies within NMT_RELU_TIE of 0; the moments of parameters
# upstream of no relu that took another sign (in any step) at
# TRAIN_MOMENT_RTOL, the others at NMT_MOMENT_RTOL, 5x that; the
# parameters at NMT_PARAM_RTOL.  Two faults planted on the card must
# each miss one limit of that comparison: the step counter one step late
# (an increment run twice) and the fused Adam at Adam's default beta2
# 0.999 in place of the program's 0.997.
# Beam decode: the card's beam_search steps are walked beside the CPU's,
# row by row; a step whose ids and parents differ ends the row's walk if
# the CPU's best beam_size + 1 candidates there lie closer than NMT_TIE
# (``beam_margins``: a near-tie either run may break either way) and
# fails it otherwise; selected scores agree to NMT_SCORE_ATOL; a row
# never parted has the CPU's final sequences and scores.
NMT_LOSS_ATOL = 1e-4
NMT_MOMENT_RTOL = 5e-2
NMT_PARAM_RTOL = 1e-2
NMT_RELU_TIE = 1e-4
NMT_LR_RTOL = 1e-6
NMT_TIE = 1e-3
NMT_SCORE_ATOL = 1e-3
# kernel launches a training step: row 14 on every LayerNorm (2 an encoder
# layer, 3 a decoder layer: 12 + 18), row 9 once over all parameters, the
# dropout kernel on every attention's probabilities (6 + 12) and every
# FFN's hidden layer (6 + 6); layer_norm_grad and dropout_grad are plain
# torch.  A beam batch runs no dropout, and row 14 on the encoder's 12
# LayerNorms and the decoder's 18 at each unrolled step.
NMT_STEP_LAUNCHES = {"layer_norm": 30, "fused_adam": 1, "dropout": 30}


def nmt_config():
    from paddle_tpu_torch.models.transformer import TRANSFORMER_BASE

    return TRANSFORMER_BASE


def nmt_param_shapes(cfg):
    """{name: shape} of build_train(cfg)'s parameters: the two embeddings,
    per encoder layer self-attention (q, k, v, o), the FFN and two
    LayerNorms, per decoder layer self- and cross-attention, the FFN and
    three LayerNorms, and the output projection."""
    d, f = cfg.d_model, cfg.ffn
    shapes = {"src_emb": (cfg.src_vocab, d), "trg_emb": (cfg.trg_vocab, d),
              "out_proj_w": (d, cfg.trg_vocab), "out_proj_b": (cfg.trg_vocab,)}
    layers = [("enc%d" % i, ("_self",), ("att", "ffn"))
              for i in range(cfg.enc_layers)]
    layers += [("dec%d" % i, ("_self", "_cross"), ("att", "cross", "ffn"))
               for i in range(cfg.dec_layers)]
    for p, attns, norms in layers:
        for a in attns:
            for nm in ("_q", "_k", "_v", "_o"):
                shapes[p + a + nm + "_w"] = (d, d)
                shapes[p + a + nm + "_b"] = (d,)
        for nm in norms:
            shapes["%s_%s_ln_s" % (p, nm)] = (d,)
            shapes["%s_%s_ln_b" % (p, nm)] = (d,)
        shapes.update({p + "_fc1_w": (d, f), p + "_fc1_b": (f,),
                       p + "_fc2_w": (f, d), p + "_fc2_b": (d,)})
    return shapes


def nmt_feed(rng, cfg, batch, pad=False):
    """bench.py's nmt feed (ids drawn from [2, vocab), every token real);
    with ``pad`` each row keeps 32-64 tokens, the rest EOS with weight 0."""
    from paddle_tpu_torch.models.transformer import EOS

    shape = (batch, NMT_LEN)
    f = {"src_ids": rng.randint(2, cfg.src_vocab, shape).astype("int64"),
         "trg_ids": rng.randint(2, cfg.trg_vocab, shape).astype("int64"),
         "trg_next": rng.randint(2, cfg.trg_vocab, shape).astype("int64"),
         "trg_weight": np.ones(shape, "float32")}
    if pad:
        for name in ("src_ids", "trg_ids"):
            lens = rng.randint(NMT_LEN // 2, NMT_LEN + 1, batch)
            tail = np.arange(NMT_LEN)[None, :] >= lens[:, None]
            f[name][tail] = EOS
            if name == "trg_ids":
                f["trg_next"][tail] = EOS
                f["trg_weight"][tail] = 0.0
    return f


def noam(step, cfg):
    """noam_decay's learning rate at ``step`` (from 1), in float64."""
    return cfg.d_model ** -0.5 * min(step ** -0.5,
                                     step * NMT_WARMUP ** -1.5)


def nmt_lr_gap(lrs, cfg):
    return max(abs(lr - noam(i + 1, cfg)) / noam(i + 1, cfg)
               for i, lr in enumerate(lrs))


def nmt_check_steps(main_p, loss, lr_name, init, feed, place, pin=None):
    """CHECK_STEPS steps from the persistables ``init`` on ``place`` (None:
    the card) -> (losses, learning rates, [{name: Adam moment} after the
    first step, after the last], {name: parameter} after the last, per
    step the relus' inputs).  ``pin``: per step another run's relu inputs,
    whose signs decide this run's relus (``pinned_relus``)."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.core import Executor, Scope, scope_from_numpy

    ex = Executor(place)
    sc = scope_from_numpy(Scope(), init, ex.device, program=main_p)
    relu_in = [op.input("X")[0] for op in main_p.global_block().ops
               if op.type == "relu"]
    names = [n for n in init if "_moment1_" in n or "_moment2_" in n]
    t0 = time.perf_counter()
    losses, lrs, moments, relus = [], [], [], []
    for i in range(CHECK_STEPS):
        with pinned_relus(dict(zip(relu_in, pin[i])) if pin else None):
            out = ex.run(main_p, feed=feed, scope=sc,
                         fetch_list=[loss, lr_name] + relu_in)
        losses.append(float(out[0].reshape(-1)[0]))
        lrs.append(float(out[1].reshape(-1)[0]))
        relus.append(out[2:])
        if i in (0, CHECK_STEPS - 1):
            moments.append({n: sc.find_var(n).get_tensor().numpy()
                            for n in names})
    params = {v.name: sc.find_var(v.name).get_tensor().numpy()
              for v in main_p.list_vars()
              if isinstance(v, framework.Parameter)}
    print("nmt: %d steps at batch %d on the %s%s: losses %s, lr %s (%.1f s)"
          % (CHECK_STEPS, len(feed["src_ids"]),
             "card" if place is None else "CPU",
             " with the card's relu decisions" if pin else "",
             json.dumps(losses), json.dumps(lrs), time.perf_counter() - t0),
          flush=True)
    return losses, lrs, moments, params, relus


@contextlib.contextmanager
def pinned_relus(signs):
    """While active, a relu whose input is named in ``signs`` keeps its
    input, and passes its gradient, where signs[name] > 0, in place of
    where its own input is > 0 (None: no change)."""
    from paddle_tpu_torch.core.registry import get_op_def

    if signs is None:
        yield
        return
    fwd, bwd = get_op_def("relu"), get_op_def("relu_grad")
    real = fwd.lower, bwd.lower

    def keep(ctx, t):
        return torch.from_numpy(signs[ctx.op.input("X")[0]] > 0).to(t.device)

    def zero(t):
        return torch.zeros((), dtype=t.dtype, device=t.device)

    def relu(ctx, x):
        return torch.where(keep(ctx, x), x, zero(x))

    def relu_grad(ctx, x, out, dout):
        if dout is None:
            return (None,)
        dout = dout.to(out.dtype)
        return (torch.where(keep(ctx, dout), dout, zero(dout)),)

    fwd.lower, bwd.lower = relu, relu_grad
    try:
        yield
    finally:
        fwd.lower, bwd.lower = real


def upstream_params(program, names):
    """The parameters from which the forward ops reach a var in
    ``names``: those whose gradients a change at those vars moves."""
    from paddle_tpu_torch import framework

    ops = program.global_block().ops
    n_fwd = next(i for i, op in enumerate(ops)
                 if any(n.endswith("@GRAD") for n in op.output_arg_names))
    need = set(names)
    for op in reversed(ops[:n_fwd]):
        if need.intersection(op.output_arg_names):
            need.update(op.input_arg_names)
    return {v.name for v in program.list_vars()
            if isinstance(v, framework.Parameter) and v.name in need}


def param_gap(got, want, init, skip=()):
    """(largest mean|got - want| / mean|want - init| over the parameters
    but ``skip``, the tensor where it is).  The mean reads every element's
    step: Adam divides each gradient by its own RMS, so an element whose
    gradient is zero but for rounding steps ~lr either way on either
    device, which a largest-element measure would read as a full step,
    and the mean reads as its share of the tensor.  numpy arrays or
    tensors on one device."""
    gap, worst = 0.0, None
    for n, w in want.items():
        if n in skip:
            continue
        moved = float(abs(w - init[n]).mean())
        diff = float(abs(got[n] - w).mean())
        rel = diff / moved if moved > 0 else (0.0 if diff == 0 else np.inf)
        if worst is None or rel > gap:
            gap, worst = rel, n
    return gap, worst


def nmt_gaps(card, cpu, init, loose, cfg):
    """A card run against a CPU run (each ``nmt_check_steps``'s) -> {what:
    (gap, where, limit)}: losses, learning rates, the moments after the
    first and after the last step (those of the parameters in ``loose`` at
    NMT_MOMENT_RTOL, the others at TRAIN_MOMENT_RTOL) and the parameters
    after the last (the attention's key biases aside: softmax ignores a
    shift shared by a row's scores, so their gradient is zero but for
    rounding, which Adam turns into ~lr steps either way on either
    device; ``moment_gap``'s floor holds their moments)."""
    loss = max(abs(a - b) for a, b in zip(card[0], cpu[0]))
    gaps = {"losses": (loss, None, NMT_LOSS_ATOL),
            "noam lr": (max(nmt_lr_gap(card[1], cfg), nmt_lr_gap(cpu[1], cfg)),
                        None, NMT_LR_RTOL)}
    names = set(cpu[2][0])
    wide = {n for n in names if n.rsplit("_moment", 1)[0] in loose}
    for i, when in enumerate(("first", "last")):
        for only, limit, what in ((names - wide, TRAIN_MOMENT_RTOL, ""),
                                  (wide, NMT_MOMENT_RTOL, ", upstream of a "
                                   "flipped relu")):
            if only:
                gaps["moments after the %s step%s" % (when, what)] = \
                    moment_gap(card[2][i], cpu[2][i], only) + (limit,)
    keys = {n for n in cpu[3] if n.endswith("_k_b")}
    gaps["parameters"] = param_gap(card[3], cpu[3], init, keys) \
        + (NMT_PARAM_RTOL,)
    return gaps


def gaps_line(gaps):
    return "; ".join("%s %.3g%s (limit %.3g)" % (
        what, g, " at %s" % where if where else "", limit)
        for what, (g, where, limit) in gaps.items())


def missed(gaps):
    return [what for what, (g, _w, limit) in gaps.items() if not g <= limit]


def beam_probe(beam_p):
    """Names of each beam_search op's inputs (pre_ids, pre_scores, scores)
    and outputs (selected_ids, selected_scores, parent_idx), in order."""
    names = []
    for op in beam_p.global_block().ops:
        if op.type == "beam_search":
            names += [op.input(s)[0] for s in ("pre_ids", "pre_scores",
                                               "scores")]
            names += [op.output(s)[0] for s in (
                "selected_ids", "selected_scores", "parent_idx")]
    return names


def beam_margins(pre_ids, pre_scores, scores, beam_size, end_id):
    """Per batch row, the smallest gap between neighbours among the
    ``beam_size + 1`` best candidates of one ``beam_search`` step, from
    its inputs as numpy (pre_ids and pre_scores [B, K], the accumulated
    scores [B, K, V]), a finished beam offering only ``end_id`` at its
    own score as the op has it.  Where the gap is small, two runs that
    round differently may pick or order the beams differently."""
    b, k, v = scores.shape
    cand = np.array(scores, dtype=np.float64)
    done = np.asarray(pre_ids) == end_id
    cand[done] = -1e9
    cand[done, end_id] = np.asarray(pre_scores, np.float64)[done]
    top = -np.sort(-cand.reshape(b, k * v), axis=1)[:, :beam_size + 1]
    return (top[:, :-1] - top[:, 1:]).min(axis=1)


def beam_agreement(card, cpu, k):
    """Walk the card's beam run beside the CPU's (each [seq_ids,
    seq_scores] + the ``beam_probe`` fetches) row by row, as NMT_TIE's
    comment says -> (rows held whole, row-steps held, rows parted at a
    near-tie, what broke the walk: one line a row)."""
    from paddle_tpu_torch.models.transformer import EOS

    steps = (len(cpu) - 2) // 6
    at = lambda run, t, i: run[2 + 6 * t + i]  # noqa: E731
    margins = [beam_margins(at(cpu, t, 0), at(cpu, t, 1), at(cpu, t, 2), k,
                            EOS) for t in range(steps)]
    whole = held = parted = 0
    problems = []
    for b in range(cpu[0].shape[0]):
        for t in range(steps):
            if not all(np.array_equal(at(card, t, i)[b], at(cpu, t, i)[b])
                       for i in (3, 5)):
                if margins[t][b] > NMT_TIE:
                    problems.append(
                        "beam decode row %d step %d: card ids %s parents %s, "
                        "CPU %s %s, %.3g apart" % (
                            b, t, at(card, t, 3)[b], at(card, t, 5)[b],
                            at(cpu, t, 3)[b], at(cpu, t, 5)[b],
                            margins[t][b]))
                else:
                    parted += 1
                break
            gap = float(np.abs(at(card, t, 4)[b] - at(cpu, t, 4)[b]).max())
            if not gap <= NMT_SCORE_ATOL:
                problems.append("beam decode row %d step %d: scores %s, CPU "
                                "%s" % (b, t, at(card, t, 4)[b],
                                        at(cpu, t, 4)[b]))
                break
            held += 1
        else:
            if not np.array_equal(card[0][b], cpu[0][b]) or not float(
                    np.abs(card[1][b] - cpu[1][b]).max()) <= NMT_SCORE_ATOL:
                problems.append(
                    "beam decode row %d: card sequences %s scores %s, CPU %s "
                    "%s" % (b, card[0][b], card[1][b], cpu[0][b], cpu[1][b]))
            else:
                whole += 1
    return whole, held, parted, problems


def nmt_adam_hold(fad, dev, shapes, hyper, lr):
    """Row 9 over the path's parameter group (its shapes, its beta1, beta2
    and epsilon, noam's first learning rate), each member with its own
    beta pows, bitwise equal to its plain version, as its own phase holds
    it over BERT-base's."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)

    def rand(s, scale=1.0, normal=True):
        f = torch.randn if normal else torch.rand
        return f(s, generator=gen, device=dev) * scale

    def full(v):
        return torch.full((1,), v, dtype=torch.float32, device=dev)

    grp = ([rand(s) for s in shapes], [rand(s, 1e-3) for s in shapes],
           [rand(s, 1e-3) for s in shapes],
           [rand(s, 1e-6, normal=False) for s in shapes], full(lr),
           [full(hyper["beta1"] ** (1 + i % 3)) for i in range(len(shapes))],
           [full(hyper["beta2"] ** (1 + i % 5)) for i in range(len(shapes))])
    p, g, m1, m2, lr_t, b1, b2 = grp
    want = fad.fused_adam_reference(*grp, **hyper)
    c = lambda ts: [x.clone() for x in ts]  # noqa: E731
    got = fad.fused_adam_step(c(p), g, c(m1), c(m2), lr_t, c(b1), c(b2),
                              **hyper)
    torch.cuda.synchronize()
    for name, gs, ws in zip(("param", "moment1", "moment2", "beta1_pow",
                             "beta2_pow"), got, want):
        if not all(torch.equal(a, b) for a, b in zip(gs, ws)):
            fail("fused_adam %s not bitwise equal to the plain version over "
                 "the NMT group" % name)
    print("kernel fused_adam NMT group, %d members, %d elements, beta1 %g "
          "beta2 %g epsilon %g: bitwise equal to the plain version"
          % (len(shapes), sum(x.numel() for x in p), hyper["beta1"],
             hyper["beta2"], hyper["epsilon"]), flush=True)
    del grp, p, g, m1, m2, want, got
    torch.cuda.empty_cache()


def nmt_phase(ln, dev):
    """Transformer NMT through the port's Program front end: training at
    bench.py's nmt configuration (parameter count, launches, the noam
    learning rates, 3 steps against the CPU's plain path), then beam
    decode from the weights the steps left (launches, ids and scores
    against the CPU's) -> the path's launch counts."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.core import (Executor, Scope, scope_from_numpy,
                                       scope_guard, scope_to_numpy)
    from paddle_tpu_torch.core.lowering import LowerCtx
    from paddle_tpu_torch.core.registry import get_op_def, lower_attrs
    from paddle_tpu_torch.kernels import dropout as dk
    from paddle_tpu_torch.kernels import fused_adam as fad
    from paddle_tpu_torch.models import transformer as tr
    from paddle_tpu_torch.ops.common import (byte_threshold,
                                             realized_keep_prob,
                                             realized_prob)

    cfg = nmt_config()
    card = card_line()
    rows, d = NMT_BATCH * NMT_LEN, cfg.d_model
    rng = np.random.RandomState(8)
    x, g, b = (torch.from_numpy(_rand(rng, *s)).to(dev)
               for s in ((rows, d), (d,), (d,)))
    worst = check("layer_norm", "NMT rows [%d, %d]" % (rows, d),
                  ln.layer_norm_2d(x, g, b, 1e-5),
                  ln.layer_norm_2d_reference(x, g, b, 1e-5))
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    timed_row("layer_norm", lambda: ln.layer_norm_2d(x, g, b, 1e-5),
              lambda: ln.layer_norm_2d_reference(x, g, b, 1e-5),
              lambda: torch.nn.functional.layer_norm(x, (d,), g, b, 1e-5),
              4 * (2 * rows * d + 2 * d + 2 * rows), 8 * rows * d, flush,
              worst, "NMT rows [%d, %d] (F.layer_norm), %s"
              % (rows, d, card))
    del flush, x, g, b
    # the dropout kernel at the path's shapes, bitwise, as its own phase
    # holds it at BERT's: every FFN's hidden layer, every attention's
    # probabilities
    thr = byte_threshold(1 - cfg.dropout)
    q = realized_keep_prob(1 - cfg.dropout)
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    for what, shape in (
            ("FFN hidden", (NMT_BATCH, NMT_LEN, cfg.ffn)),
            ("attention probs", (NMT_BATCH, cfg.heads, NMT_LEN, NMT_LEN))):
        x = torch.randn(shape, generator=gen, device=dev)
        out, mask = dk.dropout(x, WORDS, thr, q, True)
        wout, wmask = dk.dropout_reference(x, WORDS, thr, q, True)
        torch.cuda.synchronize()
        if not (torch.equal(mask, wmask) and torch.equal(out, wout)):
            fail("dropout not bitwise its plain version at the NMT %s %s"
                 % (what, list(shape)))
        frac, qr = float(mask.float().mean()), realized_prob(1 - cfg.dropout)
        sigma = (qr * (1 - qr) / x.numel()) ** 0.5
        print("kernel dropout NMT %s %s: mask and out bitwise equal to the "
              "plain version; keep fraction %.6f (%.2f sigma)"
              % (what, list(shape), frac, abs(frac - qr) / sigma),
              flush=True)
        if abs(frac - qr) > KEEP_SIGMAS * sigma:
            fail("dropout keep fraction %.6f at the NMT %s" % (frac, what))
    del x, out, mask, wout, wmask

    t0 = time.perf_counter()
    main_p, startup = framework.Program(), framework.Program()
    startup.random_seed = 13
    with framework.program_guard(main_p, startup):
        _feeds, loss = tr.build_train(cfg, NMT_LEN, NMT_LEN,
                                      warmup=NMT_WARMUP)
    lr_name = next(op.input("LearningRate")[0]
                   for op in main_p.global_block().ops if op.type == "adam")
    params = {v.name: tuple(v.shape) for v in main_p.list_vars()
              if isinstance(v, framework.Parameter)}
    n_params = sum(int(np.prod(s)) for s in params.values())
    if params != nmt_param_shapes(cfg):
        fail("build_train made parameters %s, want %s"
             % (sorted(params.items()), sorted(nmt_param_shapes(cfg).items())))
    adam = next(op for op in main_p.global_block().ops if op.type == "adam")
    hyper = {k: adam.attrs[k] for k in ("beta1", "beta2", "epsilon")}
    nmt_adam_hold(fad, dev, list(params.values()), hyper, noam(1, cfg))
    print("nmt: transformer (vocab %d/%d, d_model %d, %d heads, %d+%d "
          "layers, ffn %d, dropout %g, label smoothing %g, noam warmup %d), "
          "batch %d of %d + %d tokens; %d parameters in %d tensors (%.1f MB "
          "f32), %d ops in the main program; built in %.1f s"
          % (cfg.src_vocab, cfg.trg_vocab, d, cfg.heads, cfg.enc_layers,
             cfg.dec_layers, cfg.ffn, cfg.dropout, cfg.label_smooth,
             NMT_WARMUP, NMT_BATCH, NMT_LEN, NMT_LEN, n_params, len(params),
             n_params * 4 / 1e6, len(main_p.global_block().ops),
             time.perf_counter() - t0), flush=True)
    exe = Executor()                  # the card
    scope = Scope()
    with scope_guard(scope):
        exe.run(startup)
        init = scope_to_numpy(scope, main_p)
        feed = nmt_feed(np.random.RandomState(0), cfg, NMT_BATCH)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()   # just before the main path runs
        losses, lrs, step_ms = [], [], []
        for _ in range(NMT_STEPS):
            t0 = time.perf_counter()
            lo, lr = exe.run(main_p, feed=feed, fetch_list=[loss, lr_name])
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(lo.reshape(-1)[0]))
            lrs.append(float(lr.reshape(-1)[0]))
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        trained = scope_to_numpy(scope, main_p)
    del scope, exe
    torch.cuda.empty_cache()
    p50 = float(np.percentile(step_ms[1:], 50))
    tokens = NMT_BATCH * 2 * NMT_LEN
    print("nmt: %d steps, losses %s; lr %s; step_ms %s, p50 %.3f over "
          "steps 2-%d (the first fuses the optimizer ops and plans); %.1f "
          "tokens/s (%d tokens a step, bench.py's count); peak memory %.2f "
          "GB; launches %s; %s" % (
              NMT_STEPS, json.dumps(losses), json.dumps(lrs),
              json.dumps([round(t, 3) for t in step_ms]), p50, NMT_STEPS,
              tokens / p50 * 1e3, tokens, peak / 1e9, json.dumps(launches),
              card), flush=True)
    want = {k: NMT_STEP_LAUNCHES.get(k, 0) * NMT_STEPS for k in launches}
    if launches != want:
        fail("nmt training launches %s over %d steps, want %s"
             % (launches, NMT_STEPS, want))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail("nmt losses %s: not finite, or the last is not below the "
             "first" % losses)
    if not nmt_lr_gap(lrs, cfg) <= NMT_LR_RTOL:
        fail("nmt learning rates %s are not noam's" % lrs)

    # the assign_value ops' host cost: each run turns an attr list into a
    # tensor and copies it to the card
    ops = [op for op in main_p.global_block().ops
           if op.type == "assign_value"]
    big = max(ops, key=lambda op: np.prod(op.attrs["shape"]))
    lower, attrs = get_op_def("assign_value").lower, lower_attrs(big.attrs)
    ctx = LowerCtx(dev, big)
    lower(ctx, **attrs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        lower(ctx, **attrs)
    torch.cuda.synchronize()
    print("nmt: assign_value %s: %.3f host ms a run (%d such ops a "
          "training step: %s)" % (
              big.attrs["shape"], (time.perf_counter() - t0) / 20 * 1e3,
              len(ops), json.dumps([op.attrs["shape"] for op in ops])),
          flush=True)

    # the same initial state and feeds on the card and on the CPU's plain
    # path, at a batch the CPU runs in seconds: the CPU with the card's
    # relu decisions, then with its own (NMT_MOMENT_RTOL's comment)
    feed2 = nmt_feed(np.random.RandomState(1), cfg, NMT_CHECK_BATCH,
                     pad=True)
    cpu = framework.CPUPlace()
    on_card = nmt_check_steps(main_p, loss, lr_name, init, feed2, None)
    pinned = nmt_check_steps(main_p, loss, lr_name, init, feed2, cpu,
                             pin=on_card[4])
    on_cpu = nmt_check_steps(main_p, loss, lr_name, init, feed2, cpu)
    relu_in = [op.input("X")[0] for op in main_p.global_block().ops
               if op.type == "relu"]
    flips, flipped, tie = [], set(), 0.0
    for step, (card_x, cpu_x) in enumerate(zip(on_card[4], on_cpu[4])):
        n = 0
        for name, a, b in zip(relu_in, card_x, cpu_x):
            other = (a > 0) != (b > 0)
            if other.any():
                flipped.add(name)
                n += int(other.sum())
                if step == 0:
                    tie = max(tie, float(np.abs(b[other]).max()))
        flips.append(n)
    reach = upstream_params(main_p, flipped)
    print("nmt: relu inputs of another sign on the CPU than on the card: %s "
          "a step of %d; in the first step all within %.3g of 0 (limit "
          "%.3g); %d of %d relus flipped, upstream of %d of %d parameters"
          % (json.dumps(flips), sum(a.size for a in on_cpu[4][0]), tie,
             NMT_RELU_TIE, len(flipped), len(relu_in), len(reach),
             len(on_cpu[3])), flush=True)
    if not tie <= NMT_RELU_TIE:
        fail("nmt: a relu input %.3g from 0 takes another sign on the card"
             % tie)
    checks = {"the CPU with the card's relu decisions":
              nmt_gaps(on_card, pinned, init, set(), cfg),
              "the CPU with its own":
              nmt_gaps(on_card, on_cpu, init, reach, cfg)}
    del pinned
    for what, gaps in checks.items():
        print("nmt: card vs %s: %s" % (what, gaps_line(gaps)), flush=True)
        if missed(gaps):
            fail("nmt training on the card disagrees with %s: %s"
                 % (what, missed(gaps)))
    # planted on the card, each must miss a limit of the comparison
    late = dict(init)
    late["@LR_DECAY_COUNTER@"] = init["@LR_DECAY_COUNTER@"] + 1
    real = fad._fused_adam_cuda
    planted = {"the step counter one step late": (late, None),
               "the fused Adam at beta2 0.999": (init, lambda *a: real(
                   *a[:8], 0.999, *a[9:]))}
    for what, (state, adam_fault) in planted.items():
        fad._fused_adam_cuda = adam_fault or real
        try:
            run = nmt_check_steps(main_p, loss, lr_name, state, feed2, None)
        finally:
            fad._fused_adam_cuda = real
        gaps = nmt_gaps(run, on_cpu, init, reach, cfg)
        print("nmt: planted fault, %s: %s; misses %s" % (
            what, gaps_line(gaps), missed(gaps)), flush=True)
        if not missed(gaps):
            fail("nmt: the card-vs-CPU check does not see %s" % what)
    del init, on_card, on_cpu, late, run

    t0 = time.perf_counter()
    beam_p, beam_start = framework.Program(), framework.Program()
    with framework.program_guard(beam_p, beam_start):
        _src, seq_ids, seq_scores = tr.build_beam_infer(
            cfg, NMT_LEN, beam_size=NMT_BEAM, max_out_len=NMT_BEAM_LEN)
    n_assign = sum(op.type == "assign_value"
                   for op in beam_p.global_block().ops)
    print("nmt: beam program, beam %d, %d unrolled steps (cut from %d): %d "
          "ops (%d assign_value); built in %.1f s" % (
              NMT_BEAM, NMT_BEAM_LEN, cfg.max_len,
              len(beam_p.global_block().ops), n_assign,
              time.perf_counter() - t0), flush=True)
    weights = {v.name: trained[v.name] for v in beam_p.list_vars()
               if v.persistable and not v.is_data}
    del trained
    src = {"src_ids": nmt_feed(np.random.RandomState(2), cfg,
                               NMT_BEAM_BATCH, pad=True)["src_ids"]}
    fetch = [seq_ids, seq_scores]
    exe = Executor()
    sc = scope_from_numpy(Scope(), weights, exe.device, program=beam_p)
    torch.cuda.synchronize()
    zero_counts()   # just before the main path runs
    batch_ms = []
    for _ in range(NMT_BEAM_RUNS):
        t0 = time.perf_counter()
        exe.run(beam_p, feed=src, fetch_list=fetch, scope=sc)
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    beam_launches = launch_counts()
    per_batch = 2 * cfg.enc_layers + 3 * cfg.dec_layers * NMT_BEAM_LEN
    want = {k: 0 for k in beam_launches}
    want["layer_norm"] = per_batch * NMT_BEAM_RUNS
    if beam_launches != want:
        fail("nmt beam launches %s over %d batches, want %s"
             % (beam_launches, NMT_BEAM_RUNS, want))
    probe = beam_probe(beam_p)
    on_card = exe.run(beam_p, feed=src, fetch_list=fetch + probe, scope=sc)
    del sc, exe
    cpu_exe = Executor(framework.CPUPlace())
    on_cpu = cpu_exe.run(beam_p, feed=src, fetch_list=fetch + probe,
                         scope=scope_from_numpy(Scope(), weights, "cpu",
                                                program=beam_p))
    ids, scores = on_card[:2]
    want_shape = (NMT_BEAM_BATCH, NMT_BEAM, NMT_BEAM_LEN)
    if ids.shape != want_shape or not np.isfinite(scores).all() \
            or not (scores[:, :-1] >= scores[:, 1:]).all():
        fail("beam decode gave ids %s (want %s), scores %s: not finite or "
             "not sorted" % (ids.shape, want_shape, scores))
    whole, held, parted, problems = beam_agreement(on_card, on_cpu,
                                                   NMT_BEAM)
    if problems:
        fail(problems[0])
    print("nmt: beam decode, batch %d, beam %d, %d steps: batch_ms %s, p50 "
          "%.3f over batches 2-%d; row 14 %d launches a batch; card vs CPU: "
          "%d of %d rows equal to the end, %d row-steps equal, %d rows "
          "parted at a near-tie (gap <= %g), scores to %g; %s" % (
              NMT_BEAM_BATCH, NMT_BEAM, NMT_BEAM_LEN,
              json.dumps([round(t, 3) for t in batch_ms]),
              float(np.percentile(batch_ms[1:], 50)), NMT_BEAM_RUNS,
              per_batch, whole, NMT_BEAM_BATCH, held, parted, NMT_TIE,
              NMT_SCORE_ATOL, card), flush=True)
    total = {k: launches[k] + beam_launches[k] for k in launches}
    return {k: v for k, v in total.items() if v}


# -- phases 12-14: the update rules -------------------------------------------

# phase 12, BERT-base under LAMB's recipe (You et al. 2019): LAMB with
# weight decay 0.01 off the LayerNorm parameters and the biases
# (``models.bert.no_weight_decay``), a global-norm clip of 1.0, and a
# linear warmup into a polynomial decay of power 1, cut to the run: a
# warmup of 2 steps to 1e-3, then down to 0 at step 10
LAMB_STEPS = 10
LAMB_PEAK_LR = 1e-3
LAMB_WARMUP = 2
LAMB_DECAY_STEPS = 10
LAMB_CLIP = 1.0
# card vs CPU, CHECK_STEPS chained steps at batch 2 from one state: the
# losses absolutely, each step's learning rate and the global norm the
# clip divides by relatively, the moments after the last step as
# ``moment_gap`` reads them.  Two faults planted on the card must miss
# them: the warmup skipped (the step counter starting past it) and the
# clip's scale dropped (its clip_norm made 1e30).  The readings (NVIDIA
# H100 80GB HBM3, 700 W; sound / the smaller fault): losses 9.54e-7 /
# 2.07e-3 (the clip dropped); learning rates 0 / 8e26 (the warmup
# skipped: the CPU's first rate is 0); global norms 4.84e-7 / 1.43e-3;
# moments 7.0e-5 / 1.34
LAMB_LOSS_ATOL = 1e-5
LAMB_LR_RTOL = 1e-6
LAMB_NORM_RTOL = 1e-4
LAMB_MOMENT_RTOL = 1e-2
# phase 13, ResNet-50 under LARS (You et al. 2017; MLPerf Training's
# ResNet-50 LARS rules): LarsMomentum 0.9 (coefficient 0.001, weight
# decay 5e-4) with a linear warmup into a polynomial decay of power 2,
# cut to the run: 2 steps to 2.0, then down to 0 at step 5
LARS_STEPS = 5
LARS_PEAK_LR = 2.0
LARS_WARMUP = 2
LARS_DECAY_STEPS = 5
# the LARS update ops of one card step held against the plain op on the
# CPU fed the card's own inputs (its parameters, velocities and learning
# rate before the step, the step's gradients): each parameter and
# velocity within LARS_UPDATE_RTOL of its largest value; the fault
# planted on the card (lars_weight_decay 0) must miss it.  Read on the
# H100: sound 1.63e-7 (the norms' summation order), the fault 0.101
LARS_UPDATE_RTOL = 1e-5
# phase 14, the sweep: the MNIST MLP (BASELINE config 1) at batch 64, 5
# steps, each from one state on the card and on the CPU: every
# persistable within SWEEP_RTOL of its largest value but for at most
# SWEEP_FLIP_SHARE of its elements (Adam-like first steps divide by |g|:
# a gradient that cancels to rounding noise moves its weight by a whole
# step on the noise's sign; tests/test_torch_optimizers.py); the
# learning rate of each step to LAMB_LR_RTOL.  Two faults planted on the
# card must miss: LARS's weight decay dropped and ClipByNorm's scale
# dropped.  Read on the H100: every case within 1.66e-5 (Lamb) but
# DecayedAdagrad's and Ftrl's first-step flips (3.4e-4 on a share of
# 5e-5, 1.05e-4 on 6.4e-6), learning rates 1.01e-7; the faults 1.95e-3
# (LARS: 0.779 of a tensor beyond 1e-4, 0.571 beyond 2e-4) and 2.41 on
# all of one (the clip)
SWEEP_BATCH = 64
SWEEP_STEPS = 5
SWEEP_RTOL = 2e-4
SWEEP_FLIP_SHARE = 1e-3
# step p50 of phase 6's emissions, for the LAMB phase to print beside
TRAIN_P50 = {}


def lamb_optimizer():
    """LAMB's recipe above, built inside the program being made."""
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.clip import GradientClipByGlobalNorm
    from paddle_tpu_torch.models.bert import no_weight_decay
    from paddle_tpu_torch.optimizer import Lamb

    lr = layers.linear_lr_warmup(
        layers.polynomial_decay(LAMB_PEAK_LR, LAMB_DECAY_STEPS, 0.0,
                                power=1.0),
        LAMB_WARMUP, 0.0, LAMB_PEAK_LR)
    return Lamb(lr, lamb_weight_decay=0.01,
                exclude_from_weight_decay_fn=no_weight_decay,
                grad_clip=GradientClipByGlobalNorm(LAMB_CLIP))


def warmup_poly(step, peak, warmup, decay_steps, power):
    """The schedule's learning rate at ``step`` (from 0), in float64."""
    if step < warmup:
        return peak * step / warmup
    return peak * (1 - min(step, decay_steps) / decay_steps) ** power


def lr_and_norm(main_p):
    """Names of the learning rate the update ops read and of the global
    norm the clip divides by (None without a global-norm clip)."""
    ops = main_p.global_block().ops
    lr, = {op.input("LearningRate")[0] for op in ops
           if op.type in ("lamb", "lars_momentum", "adam")}
    norms = [op.output("Out")[0] for op in ops if op.type == "sqrt"]
    return lr, (norms[0] if norms else None)


def with_attr(main_p, op_type, attr, value, where=lambda op: True):
    """A clone of ``main_p`` with ``attr`` of its ``op_type`` ops (those
    ``where`` holds for, in any block) set to ``value``: a fault planted on
    the card."""
    bad = main_p.clone()
    n = 0
    for op in (op for blk in bad.blocks for op in blk.ops):
        if op.type == op_type and where(op):
            op.attrs[attr] = value
            n += 1
    if not n:
        fail("no %s op to plant a fault in" % op_type)
    bad._bump_version()
    return bad


def lamb_check_steps(main_p, loss, init, feed, place):
    """CHECK_STEPS chained steps of the LAMB program from ``init`` on
    ``place`` (None: the card) -> (losses, learning rates, global norms,
    {name: Adam moment after the steps})."""
    from paddle_tpu_torch.core import Executor, Scope, scope_from_numpy

    lr, norm = lr_and_norm(main_p)
    ex = Executor(place)
    sc = scope_from_numpy(Scope(), init, ex.device, program=main_p)
    rows = [[float(v.reshape(-1)[0]) for v in ex.run(
        main_p, feed=feed, fetch_list=[loss, lr, norm], scope=sc)]
        for _ in range(CHECK_STEPS)]
    moments = {n: sc.find_var(n).get_tensor().numpy() for n in init
               if "_moment1_" in n or "_moment2_" in n}
    return [r[0] for r in rows], [r[1] for r in rows], \
        [r[2] for r in rows], moments


def lamb_gaps(card, cpu):
    """{what: (gap, where, limit)} of a card run against the CPU's."""
    def rel(a, b):
        return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))

    return {"losses": (max(abs(a - b) for a, b in zip(card[0], cpu[0])),
                       None, LAMB_LOSS_ATOL),
            "learning rates": (rel(card[1], cpu[1]), None, LAMB_LR_RTOL),
            "global norms": (rel(card[2], cpu[2]), None, LAMB_NORM_RTOL),
            "moments": moment_gap(card[3], cpu[3]) + (LAMB_MOMENT_RTOL,)}


class UpdateOpCounter:
    """While active, counts the calls of the ``op_type`` lowering and its
    host seconds, and with ``aten`` the aten ops it dispatches (each a
    kernel launch on the card, but for views; counting them slows the
    host, so time a step without it)."""

    def __init__(self, op_type, aten=False):
        from paddle_tpu_torch.core.registry import get_op_def

        self.opdef = get_op_def(op_type)
        self.count_aten = aten
        self.calls = self.aten = 0
        self.seconds = 0.0

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter, lower = self, self.opdef.lower
        self.saved = lower

        class Count(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if not getattr(func, "is_view", False):
                    counter.aten += 1
                return func(*args, **(kwargs or {}))

        def counted_lower(*a, **k):
            self.calls += 1
            t0 = time.perf_counter()
            with Count() if self.count_aten else contextlib.nullcontext():
                out = lower(*a, **k)
            self.seconds += time.perf_counter() - t0
            return out

        self.opdef.lower = counted_lower
        return self

    def __exit__(self, *exc):
        self.opdef.lower = self.saved


def count_update_ops(exe, main_p, feed, scope, op_type):
    """Two more steps: one counting the ``op_type`` ops' aten ops, one
    timing their host ms -> (calls a step, aten ops a step, host ms)."""
    with UpdateOpCounter(op_type, aten=True) as counted_ops:
        exe.run(main_p, feed=feed, fetch_list=[], scope=scope)
        torch.cuda.synchronize()
    with UpdateOpCounter(op_type) as timed:
        exe.run(main_p, feed=feed, fetch_list=[], scope=scope)
        torch.cuda.synchronize()
    return counted_ops.calls, counted_ops.aten, timed.seconds * 1e3


def lamb_bert_phase(cfg):
    """Phase 12 -> the launch counts of its LAMB steps and of the Adam +
    clip probe."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.clip import GradientClipByGlobalNorm
    from paddle_tpu_torch.core import (Executor, Scope, scope_guard,
                                       scope_to_numpy)
    from paddle_tpu_torch.models.bert import build_pretrain, pretrain_feed
    from paddle_tpu_torch.optimizer import Adam

    t_phase = time.perf_counter()
    with emission(SMALL):
        main_p, startup = framework.Program(), framework.Program()
        startup.random_seed = 11           # phase 6's initial weights
        with framework.program_guard(main_p, startup):
            _inputs, loss = build_pretrain(cfg, SEQ, optimizer=lamb_optimizer)
        ops = main_p.global_block().ops
        n_params = len(main_p.global_block().all_parameters())
        counts = {t: sum(op.type == t for op in ops)
                  for t in ("lamb", "squared_l2_norm", "adam")}
        if counts != {"lamb": n_params, "squared_l2_norm": n_params,
                      "adam": 0}:
            fail("lamb bert: update ops %s for %d parameters"
                 % (counts, n_params))
        lr, norm = lr_and_norm(main_p)
        exe, scope = Executor(), Scope()
        with scope_guard(scope):
            exe.run(startup)
            init = scope_to_numpy(scope, main_p)
            feed = pretrain_feed(np.random.RandomState(3), cfg, TRAIN_BATCH,
                                 SEQ)
            torch.cuda.synchronize()
            zero_counts()   # just before the main path runs
            rows, step_ms = [], []
            for _ in range(LAMB_STEPS):
                t0 = time.perf_counter()
                out = exe.run(main_p, feed=feed, fetch_list=[loss, lr, norm])
                step_ms.append((time.perf_counter() - t0) * 1e3)
                rows.append([float(v.reshape(-1)[0]) for v in out])
            launches = launch_counts()
            calls, aten, lamb_ms = count_update_ops(exe, main_p, feed, scope,
                                                    "lamb")
        del scope
        losses, lrs, norms = ([r[i] for r in rows] for i in range(3))
        p50 = float(np.percentile(step_ms, 50))
        adam_p50 = TRAIN_P50.get(SMALL)
        print("lamb bert: BERT-base, seq %d, batch %d, dropout %g, small "
              "attention; Lamb(warmup %d to %g, poly to 0 at %d, weight "
              "decay 0.01 on %d of %d parameters), clip by global norm %g; "
              "losses %s; learning rates %s; global norms %s; step_ms %s, "
              "p50 %.3f (%.1f sequences/s; phase 6's Adam, same emission: "
              "p50 %s ms, %s sequences/s); launches %s" % (
                  SEQ, TRAIN_BATCH, cfg.dropout, LAMB_WARMUP, LAMB_PEAK_LR,
                  LAMB_DECAY_STEPS,
                  sum(op.attr("weight_decay") > 0 for op in ops
                      if op.type == "lamb"), n_params, LAMB_CLIP,
                  json.dumps(losses), json.dumps(lrs), json.dumps(norms),
                  json.dumps([round(x, 3) for x in step_ms]), p50,
                  TRAIN_BATCH / p50 * 1e3,
                  "%.3f" % adam_p50 if adam_p50 else "not run",
                  "%.1f" % (TRAIN_BATCH / adam_p50 * 1e3) if adam_p50
                  else "not run",
                  json.dumps({k: v for k, v in launches.items() if v})),
              flush=True)
        print("lamb bert: the update ops a step: %d lamb ops dispatching %d "
              "aten ops (%.1f each; a kernel launch each on the card but "
              "for views), %.1f host ms a step (of p50 %.1f)"
              % (calls, aten, aten / max(calls, 1), lamb_ms, p50),
              flush=True)
        want = {k: STEP_LAUNCHES[SMALL].get(k, 0) * LAMB_STEPS
                for k in launches}
        want["fused_adam"] = 0
        if launches != want:
            fail("lamb bert launches %s over %d steps, want %s"
                 % (launches, LAMB_STEPS, want))
        if not all(np.isfinite(losses + norms)) \
                or not losses[-1] < losses[0]:
            fail("lamb bert losses %s: not finite, or the last is not below "
                 "the first" % losses)
        sched = [warmup_poly(s, LAMB_PEAK_LR, LAMB_WARMUP, LAMB_DECAY_STEPS,
                             1.0) for s in range(LAMB_STEPS)]
        if not np.allclose(lrs, sched, rtol=LAMB_LR_RTOL, atol=1e-12):
            fail("lamb bert learning rates %s are not the schedule's %s"
                 % (lrs, sched))

        # card vs CPU from one state, and the planted faults on the card
        feed2 = pretrain_feed(np.random.RandomState(4), cfg, CHECK_BATCH, SEQ)
        card = lamb_check_steps(main_p, loss, init, feed2, None)
        cpu = lamb_check_steps(main_p, loss, init, feed2,
                               framework.CPUPlace())
        gaps = lamb_gaps(card, cpu)
        print("lamb bert: card vs CPU plain path, %d steps at batch %d: %s; "
              "card losses %s, global norms %s" % (
                  CHECK_STEPS, CHECK_BATCH, gaps_line(gaps),
                  json.dumps(card[0]), json.dumps(card[2])), flush=True)
        if missed(gaps):
            fail("lamb bert on the card disagrees with the CPU plain path: "
                 "%s" % missed(gaps))
        late = dict(init, **{"@LR_DECAY_COUNTER@": np.full(
            (1,), LAMB_WARMUP - 1, np.float32)})
        clip_var, = [op.input("X")[0] for op in ops
                     if op.type == "elementwise_max"]
        no_clip = with_attr(main_p, "fill_constant", "value", 1e30,
                            lambda op: op.output("Out") == [clip_var])
        seen = set()
        for what, (prog, state) in {
                "the warmup skipped": (main_p, late),
                "the clip's scale dropped": (no_clip, init)}.items():
            bad = lamb_gaps(lamb_check_steps(prog, loss, state, feed2, None),
                            cpu)
            print("lamb bert: planted fault, %s: %s; misses %s" % (
                what, gaps_line(bad), missed(bad)), flush=True)
            if not missed(bad):
                fail("lamb bert: the planted fault (%s) passed every limit"
                     % what)
            seen.update(missed(bad))
        if seen != set(gaps):
            fail("lamb bert: no planted fault missed %s"
                 % sorted(set(gaps) - seen))

        # Adam behind the global-norm clip: row 9 still one launch a step
        probe_p, probe_s = framework.Program(), framework.Program()
        probe_s.random_seed = 11
        with framework.program_guard(probe_p, probe_s):
            _inputs, probe_loss = build_pretrain(
                cfg, SEQ, optimizer=lambda: Adam(
                    1e-4, grad_clip=GradientClipByGlobalNorm(LAMB_CLIP)))
        exe, scope = Executor(), Scope()
        with scope_guard(scope):
            exe.run(probe_s)
            torch.cuda.synchronize()
            zero_counts()
            probe = [float(exe.run(probe_p, feed=feed,
                                   fetch_list=[probe_loss])[0].reshape(-1)[0])
                     for _ in range(CHECK_STEPS)]
            probe_launches = launch_counts()
        del scope
    fused, = [op for op in probe_p.global_block().ops
              if op.type == "fused_adam"]
    clipped = sum(not g.endswith("@GRAD") for g in fused.input("Grad"))
    print("lamb bert: Adam behind the global-norm clip, %d steps: losses "
          "%s; one fused_adam over %d parameters, %d of them reading a "
          "clipped gradient; launches %s; the phase %.1f s" % (
              CHECK_STEPS, json.dumps(probe), len(fused.input("Param")),
              clipped, json.dumps({k: v for k, v in probe_launches.items()
                                   if v}),
              time.perf_counter() - t_phase), flush=True)
    want = {k: STEP_LAUNCHES[SMALL].get(k, 0) * CHECK_STEPS
            for k in probe_launches}
    if probe_launches != want or clipped != len(fused.input("Param")) \
            or not all(np.isfinite(probe)):
        fail("lamb bert: the Adam + clip probe launched %s, want %s; %d of "
             "%d fused members clipped; losses %s" % (
                 probe_launches, want, clipped, len(fused.input("Param")),
                 probe))
    return {k: launches[k] + probe_launches[k] for k in launches}


def lars_optimizer():
    """The LARS recipe above, built inside the program being made."""
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.optimizer import LarsMomentum

    lr = layers.linear_lr_warmup(
        layers.polynomial_decay(LARS_PEAK_LR, LARS_DECAY_STEPS, 0.0,
                                power=2.0),
        LARS_WARMUP, 0.0, LARS_PEAK_LR)
    return LarsMomentum(lr, momentum=0.9)


def lars_update_gap(main_p, before, grads, lr, after):
    """The card's LARS update ops against the plain op on the CPU fed the
    card's inputs -> (largest gap over the parameters and velocities,
    relative to each tensor's largest value, the tensor where it is)."""
    from paddle_tpu_torch.core.lowering import LowerCtx
    from paddle_tpu_torch.core.registry import get_op_def, lower_attrs

    lower = get_op_def("lars_momentum").lower
    ctx = LowerCtx(torch.device("cpu"))
    worst, where = 0.0, None
    for op in main_p.global_block().ops:
        if op.type != "lars_momentum":
            continue
        p, v = op.input("Param")[0], op.input("Velocity")[0]
        got = lower(ctx, torch.from_numpy(before[p].copy()),
                    torch.from_numpy(grads[op.input("Grad")[0]]),
                    torch.from_numpy(before[v].copy()),
                    torch.tensor([lr], dtype=torch.float32),
                    **lower_attrs(op.attrs))
        for name, want in ((p, got[0]), (v, got[1])):
            want = want.numpy()
            gap = float(np.abs(after[name] - want).max()) / max(
                float(np.abs(want).max()), 1e-30)
            if gap > worst:
                worst, where = gap, name
    return worst, where


def lars_card_step(main_p, loss, state, feed):
    """One card step of ``main_p`` from ``state`` -> (loss, {grad: value},
    the learning rate, the persistables after)."""
    from paddle_tpu_torch.core import (Executor, Scope, scope_from_numpy,
                                       scope_to_numpy)

    lr, _norm = lr_and_norm(main_p)
    grads = [op.input("Grad")[0] for op in main_p.global_block().ops
             if op.type == "lars_momentum"]
    ex = Executor()
    sc = scope_from_numpy(Scope(), state, ex.device, program=main_p)
    out = ex.run(main_p, feed=feed, fetch_list=[loss, lr] + grads, scope=sc)
    return (float(out[0].reshape(-1)[0]), dict(zip(grads, out[2:])),
            float(out[1].reshape(-1)[0]), scope_to_numpy(sc, main_p))


def lars_resnet_phase():
    """Phase 13 -> the launch counts of its LARS steps."""
    from paddle_tpu_torch.core import (Executor, Scope, scope_guard,
                                       scope_to_numpy)

    t_phase = time.perf_counter()
    with flag_set("FLAGS_use_pallas_conv_block", True):
        main_p, startup, _img, _label, loss = resnet_program(
            "trunk", False, optimizer=lars_optimizer)
        ops = main_p.global_block().ops
        n_params = len(main_p.global_block().all_parameters())
        if sum(op.type == "lars_momentum" for op in ops) != n_params:
            fail("lars resnet: not one lars_momentum op a parameter")
        lr, _norm = lr_and_norm(main_p)
        exe, scope = Executor(), Scope()
        with scope_guard(scope):
            exe.run(startup)
            init = scope_to_numpy(scope, main_p)
            feed = resnet_feed(np.random.RandomState(3), TRAIN_BATCH)
            torch.cuda.synchronize()
            zero_counts()   # just before the main path runs
            rows, step_ms = [], []
            for _ in range(LARS_STEPS):
                t0 = time.perf_counter()
                out = exe.run(main_p, feed=feed, fetch_list=[loss, lr])
                step_ms.append((time.perf_counter() - t0) * 1e3)
                rows.append([float(v.reshape(-1)[0]) for v in out])
            launches = launch_counts()
            calls, aten, lars_ms = count_update_ops(exe, main_p, feed, scope,
                                                    "lars_momentum")
        del scope
        losses, lrs = [r[0] for r in rows], [r[1] for r in rows]
        p50 = float(np.percentile(step_ms, 50))
        print("lars resnet: ResNet-50 trunk, %dx%d, batch %d, LarsMomentum "
              "0.9 (warmup %d to %g, poly power 2 to 0 at %d), %d "
              "parameters; losses %s; learning rates %s; step_ms %s, p50 "
              "%.3f (%.1f images/s); launches %s" % (
                  IMAGE, IMAGE, TRAIN_BATCH, LARS_WARMUP, LARS_PEAK_LR,
                  LARS_DECAY_STEPS, n_params, json.dumps(losses),
                  json.dumps(lrs), json.dumps([round(x, 3) for x in step_ms]),
                  p50, TRAIN_BATCH / p50 * 1e3,
                  json.dumps({k: v for k, v in launches.items() if v})),
              flush=True)
        print("lars resnet: the update ops a step: %d lars_momentum ops "
              "dispatching %d aten ops (%.1f each), %.1f host ms a step (of "
              "p50 %.1f)" % (calls, aten, aten / max(calls, 1), lars_ms,
                             p50), flush=True)
        want = {k: 0 for k in launches}
        want["conv_stats"] = want["bn_fold"] = want["affine_act"] = \
            CONV_BN_PAIRS * LARS_STEPS
        if launches != want:
            fail("lars resnet launches %s over %d steps, want %s"
                 % (launches, LARS_STEPS, want))
        sched = [warmup_poly(s, LARS_PEAK_LR, LARS_WARMUP, LARS_DECAY_STEPS,
                             2.0) for s in range(LARS_STEPS)]
        if not all(np.isfinite(losses)) or not np.allclose(
                lrs, sched, rtol=LAMB_LR_RTOL, atol=1e-12):
            fail("lars resnet: losses %s not finite, or learning rates %s "
                 "not the schedule's %s" % (losses, lrs, sched))

        # card vs CPU, each step from one state (the trunk phase's limits)
        feed2 = resnet_feed(np.random.RandomState(4), CHECK_BATCH)
        pairs, vels, _twin, state = resnet_card_vs_cpu(main_p, loss, init,
                                                       feed2)
        loss_gap = max(abs(a - b) for a, b in pairs)
        worst = max(vels, key=vels.get)
        # the update ops alone: the card's step from the state before the
        # last, against the plain op on the CPU fed the card's inputs
        _l, grads, step_lr, after = lars_card_step(main_p, loss, state, feed2)
        upd_gap = lars_update_gap(main_p, state, grads, step_lr, after)
        print("lars resnet: card vs CPU plain path, each step from one "
              "state: max loss difference %.3g (limit %.3g); velocities' "
              "norm-wise gap %.3g (limit %.3g, worst %s); the update ops "
              "against the plain op on the card's inputs %.3g at %s (limit "
              "%.3g)" % (loss_gap, RESNET_LOSS_ATOL, vels[worst],
                         RESNET_VELOCITY_RTOL, worst, upd_gap[0], upd_gap[1],
                         LARS_UPDATE_RTOL), flush=True)
        if not (loss_gap <= RESNET_LOSS_ATOL
                and vels[worst] <= RESNET_VELOCITY_RTOL
                and upd_gap[0] <= LARS_UPDATE_RTOL):
            fail("lars resnet on the card disagrees with the CPU plain path")
        no_wd = with_attr(main_p, "lars_momentum", "lars_weight_decay", 0.0)
        _l, grads, step_lr, after = lars_card_step(no_wd, loss, state, feed2)
        bad = lars_update_gap(main_p, state, grads, step_lr, after)
        print("lars resnet: planted fault, lars_weight_decay dropped: the "
              "update ops %.3g at %s (limit %.3g); the phase %.1f s" % (
                  bad[0], bad[1], LARS_UPDATE_RTOL,
                  time.perf_counter() - t_phase), flush=True)
        if not bad[0] > LARS_UPDATE_RTOL:
            fail("lars resnet: the planted fault passed the update limit")
    return {k: v for k, v in launches.items() if v}


def _sweep_cases():
    """name -> a builder of the case's optimizer (called inside the
    program) and what else it needs: a per-parameter LR, an averaging
    wrapper, a clip."""
    from paddle_tpu_torch import clip, layers
    from paddle_tpu_torch import optimizer as opt
    from paddle_tpu_torch.regularizer import L1Decay

    def sched(make):
        return lambda: opt.SGD(make(layers))

    return {
        "adagrad": lambda: opt.Adagrad(0.1, initial_accumulator_value=0.1),
        "adamax": lambda: opt.Adamax(0.002),
        "decayed_adagrad": lambda: opt.DecayedAdagrad(0.005),
        "adadelta": lambda: opt.Adadelta(1.0, rho=0.9),
        "rmsprop": lambda: opt.RMSProp(0.001),
        "rmsprop centered": lambda: opt.RMSProp(0.001, centered=True),
        "rmsprop momentum": lambda: opt.RMSProp(0.001, momentum=0.9),
        "ftrl": lambda: opt.Ftrl(0.01, l1=1e-4, l2=1e-3),
        "lamb": lambda: opt.Lamb(0.01, exclude_from_weight_decay_fn=lambda p:
                                 p.name.endswith(".b_0")),
        "lars": lambda: opt.LarsMomentum(2.0, momentum=0.9),
        "momentum nesterov": lambda: opt.Momentum(0.01, 0.9,
                                                  use_nesterov=True),
        "sgd l1": lambda: opt.SGD(0.05, regularization=L1Decay(1e-3)),
        "sgd lr 0.5 on fc_1.w_0": lambda: opt.SGD(0.05),
        "clip by value": lambda: opt.SGD(
            0.05, grad_clip=clip.GradientClipByValue(0.01)),
        "clip by norm": lambda: opt.SGD(
            0.05, grad_clip=clip.GradientClipByNorm(0.1)),
        "ema": lambda: opt.Momentum(0.01, 0.9),
        "model average": lambda: opt.SGD(0.05),
        # an inner rule that updates in place: the startup's slow copy
        # must not alias the parameter
        "lookahead": lambda: opt.LookaheadOptimizer(opt.Momentum(0.01, 0.9)),
        "piecewise": sched(lambda L: L.piecewise_decay([2, 4],
                                                       [0.1, 0.05, 0.01])),
        "cosine": sched(lambda L: L.cosine_decay(0.1, 2, 5)),
        "exponential": sched(lambda L: L.exponential_decay(0.1, 2, 0.5)),
        "natural_exp": sched(lambda L: L.natural_exp_decay(0.1, 2, 0.5)),
        "inverse_time": sched(lambda L: L.inverse_time_decay(0.1, 2, 0.5)),
    }


def sweep_program(name, make):
    """(main, startup, loss, lr name, wrapper or None) of the MLP under
    the sweep case ``name``."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch import optimizer as opt
    from paddle_tpu_torch.models.mnist import build_mlp
    from paddle_tpu_torch.utils import unique_name

    main_p, startup = framework.Program(), framework.Program()
    startup.random_seed = 5
    wrapper = None
    with unique_name.guard(), framework.program_guard(main_p, startup):
        loss = build_mlp()[3]
        if name.startswith("sgd lr 0.5"):
            main_p.global_block().var("fc_1.w_0").optimize_attr[
                "learning_rate"] = 0.5
        make().minimize(loss)
        if name == "ema":
            wrapper = opt.ExponentialMovingAverage(0.9)
            wrapper.update()
        elif name == "model average":
            wrapper = opt.ModelAverage(0.15)
    lrs = [op.input("LearningRate")[0] for op in main_p.global_block().ops
           if "LearningRate" in op.inputs]
    return main_p, startup, loss, (lrs[0] if lrs else None), wrapper


def sweep_feeds():
    rng = np.random.RandomState(0)
    centres = rng.randn(10, 784).astype(np.float32)
    out = []
    for _ in range(SWEEP_STEPS):
        label = rng.randint(0, 10, (SWEEP_BATCH, 1)).astype(np.int64)
        out.append({"img": (centres[label.ravel()]
                            + rng.randn(SWEEP_BATCH, 784)).astype(np.float32),
                    "label": label})
    return out


def state_gap(got, want):
    """(largest |got - want| over a tensor's largest |want|, where, the
    largest share of a tensor's elements beyond SWEEP_RTOL, the tensors
    not finite)."""
    worst, where, share, bad = 0.0, None, 0.0, []
    for n, w in want.items():
        if not np.isfinite(got[n]).all():
            bad.append(n)
        d = np.abs(got[n] - w) / max(float(np.abs(w).max()), 1e-30)
        if float(d.max()) > worst:
            worst, where = float(d.max()), n
        share = max(share, float((d > SWEEP_RTOL).mean()))
    return worst, where, share, bad


def sweep_case(main_p, loss, lr, wrapper, init, card_prog=None):
    """SWEEP_STEPS steps on the card (of ``card_prog``, a planted fault,
    where given), each replayed on the CPU from the card's state before
    it -> (each step's ``state_gap``, the learning rates' largest relative
    gap, the card's losses, the averages ``apply`` swaps in, card against
    CPU, or None)."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.core import (Executor, Scope, scope_from_numpy,
                                       scope_guard, scope_to_numpy)

    card, cpu = Executor(), Executor(framework.CPUPlace())
    fetch = [loss] + ([lr] if lr else [])
    gaps, lr_gap, losses, state = [], 0.0, [], init
    for f in sweep_feeds():
        card_sc = scope_from_numpy(Scope(), state, card.device,
                                   program=main_p)
        cpu_sc = scope_from_numpy(Scope(), state, "cpu", program=main_p)
        got = card.run(card_prog or main_p, feed=f, fetch_list=fetch,
                       scope=card_sc)
        want = cpu.run(main_p, feed=f, fetch_list=fetch, scope=cpu_sc)
        losses.append(float(got[0].reshape(-1)[0]))
        if lr:
            lr_gap = max(lr_gap, abs(float(got[1][0]) - float(want[1][0]))
                         / max(abs(float(want[1][0])), 1e-30))
        state = scope_to_numpy(card_sc, main_p)
        gaps.append(state_gap(state, scope_to_numpy(cpu_sc, main_p)))
    wrap_gap = None
    if wrapper is not None:
        applied = []
        for sc in (card_sc, cpu_sc):
            with scope_guard(sc):
                before = scope_to_numpy(sc, main_p)
                with wrapper.apply(None):
                    applied.append(scope_to_numpy(sc, main_p))
                if state_gap(scope_to_numpy(sc, main_p), before)[0] != 0:
                    fail("sweep: apply did not restore the parameters")
        wrap_gap = state_gap(applied[0], applied[1])[0]
    return gaps, lr_gap, losses, wrap_gap


def worst_of(gaps):
    """(worst gap, where, worst share, the tensors not finite) over the
    steps' ``state_gap``s."""
    top = max(gaps, key=lambda g: g[0])
    return (top[0], top[1], max(g[2] for g in gaps),
            sorted({n for g in gaps for n in g[3]}))


def optimizer_sweep_phase():
    """Phase 14 -> the launch counts of the sweep's card steps."""
    from paddle_tpu_torch.core import Executor, Scope, scope_to_numpy

    t_phase = time.perf_counter()
    built = {}
    for name, make in _sweep_cases().items():
        main_p, startup, loss, lr, wrapper = sweep_program(name, make)
        sc = Scope()
        Executor().run(startup, scope=sc)
        built[name] = (main_p, loss, lr, wrapper, scope_to_numpy(sc, main_p))
    torch.cuda.synchronize()
    zero_counts()   # just before the sweep's steps run
    failures = []
    for name, (main_p, loss, lr, wrapper, init) in built.items():
        gaps, lr_gap, losses, wrap_gap = sweep_case(main_p, loss, lr,
                                                    wrapper, init)
        worst, where, share, bad = worst_of(gaps)
        ok = not bad and (worst <= SWEEP_RTOL or share <= SWEEP_FLIP_SHARE) \
            and lr_gap <= LAMB_LR_RTOL and losses[-1] < losses[0] \
            and (wrap_gap is None or wrap_gap <= SWEEP_RTOL)
        print("sweep %s: losses %s; state gap %.3g at %s, share beyond %.3g "
              "%.3g (limit %.3g); learning rates %.3g; %s%s" % (
                  name, json.dumps([round(x, 5) for x in losses]), worst,
                  where, SWEEP_RTOL, share, SWEEP_FLIP_SHARE, lr_gap,
                  "applied averages %.3g; " % wrap_gap
                  if wrap_gap is not None else "",
                  "ok" if ok else "FAILED (%s)" % bad), flush=True)
        if not ok:
            failures.append(name)
    launches = launch_counts()
    planted = {"lars": ("lars_momentum", "lars_weight_decay", 0.0),
               "clip by norm": ("clip_by_norm", "max_norm", 1e30)}
    passed = []
    for name, (op_type, attr, value) in planted.items():
        main_p, loss, lr, _wrapper, init = built[name]
        gaps = sweep_case(main_p, loss, lr, None, init, card_prog=with_attr(
            main_p, op_type, attr, value))[0]
        worst, where, share, _bad = worst_of(gaps)
        hit = worst > SWEEP_RTOL and share > SWEEP_FLIP_SHARE
        print("sweep: planted fault, %s with %s %g: state gap %.3g at %s, "
              "share %.3g: %s" % (name, attr, value, worst, where, share,
                                  "misses the limit" if hit
                                  else "PASSES the limit"), flush=True)
        if not hit:
            passed.append(name)
    # the three momentum cases (Nesterov, EMA's and Lookahead's inner) run
    # row 10 once a step; nothing else launches
    want = {k: 0 for k in launches}
    want["fused_momentum"] = 3 * SWEEP_STEPS
    print("sweep: %d cases, launches %s (want %s); the phase %.1f s" % (
        len(built), json.dumps({k: v for k, v in launches.items() if v}),
        json.dumps({k: v for k, v in want.items() if v}),
        time.perf_counter() - t_phase), flush=True)
    if failures or passed or launches != want:
        fail("sweep: cases %s disagree with the CPU plain path, planted "
             "faults %s passed, or the launches are off" % (failures, passed))
    return {k: v for k, v in launches.items() if v}


# -- phase 15: gradient merge and the control flow ----------------------------

# BERT-base pretraining under GradientMergeOptimizer(Adam(1e-4)): one update
# every MERGE_K micro-steps of TRAIN_BATCH, Devlin et al.'s batch of 256
MERGE_K = 8
MERGE_STEPS = 16          # two windows
# (c) the first window on the card against the CPU's plain path from one
# state, at CHECK_BATCH: PERF.md's BERT training limits (the losses and
# the Adam moments after the window, ``moment_gap``)
MERGE_LOSS_ATOL = TRAIN_LOSS_ATOL
MERGE_MOMENT_RTOL = TRAIN_MOMENT_RTOL
# (d) one window of MERGE_K micro-batches against one Adam step on the same
# MERGE_K * TRAIN_BATCH sequences, dropout 0, on the card from one state:
# the averaged merged gradient against the batch's (each tensor's largest
# difference over its largest value, floored at MOMENT_FLOOR of the largest
# of all, as ``moment_gap`` floors the moments), the parameters after the
# update (``param_gap``, the key biases aside) and the moments
# (``moment_gap``).  The two sum the same terms in another order: f32
# rounding apart, the gradients are equal
MERGE_GRAD_RTOL = 1e-3
MERGE_PARAM_RTOL = 1e-2
MERGE_DMOMENT_RTOL = TRAIN_MOMENT_RTOL
# (e) the control-flow programs on the card against the CPU's plain path:
# the fetches to CF_RTOL of their largest value (integers exactly); a
# StaticRNN (hidden RNN_HIDDEN over RNN_T steps, batch RNN_BATCH) trained
# RNN_STEPS SGD steps from one state, its losses to RNN_LOSS_RTOL
CF_RTOL = 1e-5
RNN_HIDDEN, RNN_T, RNN_BATCH, RNN_STEPS = 512, 64, 32, 5
RNN_LOSS_RTOL = 1e-4


def merge_program(cfg, plain=False):
    """(main, startup, loss) of BERT pretraining under gradient merge (or,
    ``plain``, Adam itself), built under a fresh name guard so the two
    programs name their parameters and moments alike."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.models.bert import build_pretrain
    from paddle_tpu_torch.optimizer import Adam, GradientMergeOptimizer
    from paddle_tpu_torch.utils import unique_name

    main_p, startup = framework.Program(), framework.Program()
    startup.random_seed = 11
    opt = (lambda: Adam(1e-4)) if plain else (
        lambda: GradientMergeOptimizer(Adam(1e-4), k_steps=MERGE_K))
    with unique_name.guard(), framework.program_guard(main_p, startup):
        _inputs, loss = build_pretrain(cfg, SEQ, optimizer=opt)
    return main_p, startup, loss


def merge_names(main_p):
    """{params, moments, buffers, counter, avg ({param: its averaged merged
    gradient, the branch's 1/k scale}), key_biases} of a merge program."""
    g = main_p.global_block()
    params = [p.name for p in g.all_parameters()]
    cond = next(op for op in g.ops if op.type == "conditional_block")
    branch = main_p.block(cond.attr("sub_block"))
    avg = {op.input("X")[0]: op.output("Out")[0] for op in branch.ops
           if op.type == "scale" and op.attr("scale") == 1.0 / MERGE_K}
    bufs = {n.split(".merged_grad")[0]: n for n in g.vars
            if ".merged_grad" in n}
    # softmax ignores a shift shared by a row's scores: the key
    # projections' biases get a gradient that is zero but for rounding
    k_out = {op.output("Out")[0] for op in g.ops
             if op.type == "mul" and op.input("Y")[0].endswith("_k_w")}
    keys = {op.input("Y")[0] for op in g.ops
            if op.type == "elementwise_add" and op.input("X")[0] in k_out}
    return {"params": params,
            "moments": [n for n in g.vars if "_moment1_" in n
                        or "_moment2_" in n],
            "buffers": [bufs[p] for p in params],
            "avg": {p: avg[bufs[p]] for p in params},
            "counter": next(n for n in g.vars
                            if n.startswith("gradient_merge_step")),
            "key_biases": keys}


def merge_faults(main_p, names):
    """{what: program} of the faults planted on the card: the update at
    every micro-step (k's constant 1), the buffers left unzeroed (the
    zeroing scale by 1) and the counter stepped by 2."""
    mod = next(op for op in main_p.global_block().ops
               if op.type == "elementwise_mod")
    k_var, counter = mod.input("Y")[0], names["counter"]
    return {
        "an update at every micro-step": with_attr(
            main_p, "fill_constant", "value", 1.0,
            lambda op: op.output("Out") == [k_var]),
        "the buffers left unzeroed": with_attr(
            main_p, "scale", "scale", 1.0,
            lambda op: op.attr("scale") == 0.0),
        "the counter stepped by 2": with_attr(
            main_p, "increment", "step", 2.0,
            lambda op: op.input("X") == [counter])}


def bits(t):
    return t.contiguous().view(torch.int32)


def window_violations(scope, names, snap, steps, boundary):
    """The (b) invariants after micro-step ``steps`` (from 1): between
    boundaries every parameter bitwise the window's start ``snap``; at a
    boundary every merged buffer zero; the counter equal to ``steps``.
    Returns the names of the invariants broken."""
    def get(n):
        return scope.find_var(n).get_tensor().get()

    bad = []
    if boundary:
        if any(int(torch.count_nonzero(get(n))) for n in names["buffers"]):
            bad.append("merged buffers zero after a boundary")
    elif not all(torch.equal(bits(get(n)), bits(snap[n]))
                 for n in names["params"]):
        bad.append("parameters unchanged between boundaries")
    if int(get(names["counter"]).reshape(-1)[0]) != steps:
        bad.append("the counter")
    return bad


def merge_window(main_p, loss, init, feeds, place, fetch_last=()):
    """The micro-steps of ``feeds`` from the persistables ``init`` on
    ``place`` (None: the card) -> (losses, the last step's ``fetch_last``
    values, the scope)."""
    from paddle_tpu_torch.core import Executor, Scope, scope_from_numpy

    ex = Executor(place)
    sc = scope_from_numpy(Scope(), init, ex.device, program=main_p)
    losses, last = [], None
    for i, f in enumerate(feeds):
        extra = list(fetch_last) if i == len(feeds) - 1 else []
        out = ex.run(main_p, feed=f, fetch_list=[loss] + extra, scope=sc,
                     return_numpy=False)
        losses.append(float(out[0].reshape(-1)[0]))
        last = out[1:]
    return losses, last, sc


def scope_values(sc, names):
    return {n: sc.find_var(n).get_tensor().get() for n in names}


def floored_gap(got, want, floor=MOMENT_FLOOR, skip=()):
    """(largest max|got - want| / scale over the tensors but ``skip``, the
    tensor): a tensor's scale is its largest |want|, at least ``floor`` of
    the largest |want| of all (``moment_gap``'s rule), on the device."""
    top = max(float(w.abs().max()) for w in want.values())
    gap, worst = 0.0, None
    for n, w in want.items():
        if n in skip:
            continue
        scale = max(float(w.abs().max()), floor * top)
        rel = float((got[n].float() - w.float()).abs().max()) / scale
        if worst is None or rel > gap:
            gap, worst = rel, n
    return gap, worst


def merged_feeds(cfg, seed, k, batch):
    """k micro-batch feeds and the one feed of all k * batch sequences,
    its mask positions offset into the whole batch, so the mean loss over
    the batch is the mean of the micro-batches' means."""
    from paddle_tpu_torch.models.bert import pretrain_feed

    micro = [pretrain_feed(np.random.RandomState(seed + i), cfg, batch, SEQ)
             for i in range(k)]
    whole = {n: np.concatenate([f[n] for f in micro]) for n in micro[0]}
    whole["mask_pos"] = np.concatenate(
        [f["mask_pos"] + i * batch * SEQ for i, f in enumerate(micro)])
    return micro, whole


def cf_programs():
    """{name: (main, startup, feeds, fetch)}: the control-flow programs of
    the reference's tests (tests/test_control_flow.py, While, Switch,
    IfElse and cond; tests/test_dynamic_array_while.py, the greedy decode
    whose length the data decides), built in the port."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch import layers as L

    def build(make):
        main_p, startup = framework.Program(), framework.Program()
        with framework.program_guard(main_p, startup):
            feeds, fetch = make()
        return main_p, startup, feeds, fetch

    def while_counter():
        i = L.fill_constant([1], "int64", 0)
        limit = L.fill_constant([1], "int64", 10)
        total = L.fill_constant([1], "float32", 0.0)
        x = L.data("x", shape=[10], append_batch_size=False)
        cond = L.less_than(i, limit)
        with L.While(cond).block():
            L.assign(L.elementwise_add(total, L.gather(x, i)), total)
            L.increment(i, value=1, in_place=True)
            L.less_than(i, limit, cond=cond)
        return [{"x": np.arange(10).astype("float32")}], [total, i]

    def while_traced():
        n = L.data("n", shape=[1], dtype="int64", append_batch_size=False)
        i = L.elementwise_add(L.zeros([1], "int64"), L.zeros([1], "int64"))
        acc = L.data("acc0", shape=[1], append_batch_size=False)
        cond = L.less_than(i, n)
        with L.While(cond).block():
            L.assign(L.elementwise_add(acc, acc), acc)
            L.increment(i, value=1, in_place=True)
            L.less_than(i, n, cond=cond)
        return [{"n": np.array([k], "int64"),
                 "acc0": np.array([1.0], "float32")} for k in (5, 0)], [acc]

    def switch():
        x = L.data("x", shape=[4], append_batch_size=False)
        flag = L.data("flag", shape=[1], append_batch_size=False)
        out = L.elementwise_add(L.fill_constant([4], "float32", -1.0),
                                L.zeros([4], "float32"))
        lr = L.fill_constant([1], "float32", 0.0)
        sw = L.Switch()
        with sw.case(L.greater_than(flag, L.zeros([1], "float32"))):
            L.assign(L.elementwise_mul(x, x), out)
            L.assign(L.fill_constant([1], "float32", 0.1), lr)
        with sw.default():
            L.assign(L.fill_constant([1], "float32", 0.01), lr)
        xs = np.arange(1, 5).astype("float32")
        return [{"x": xs, "flag": np.array([f], "float32")}
                for f in (1.0, -1.0)], [out, lr]

    def ifelse():
        a = L.data("a", shape=[1], append_batch_size=False)
        b = L.data("b", shape=[1], append_batch_size=False)
        ie = L.IfElse(L.less_than(a, b))
        with ie.true_block():
            ie.output(L.elementwise_add(a, b))
        with ie.false_block():
            ie.output(L.elementwise_sub(a, b))
        return [{"a": np.array([v], "float32"),
                 "b": np.array([2.0], "float32")} for v in (1.0, 5.0)], ie()

    def cond():
        a = L.data("a", shape=[2], append_batch_size=False)
        pred = L.less_than(L.reduce_sum(a), L.fill_constant([1], "float32",
                                                            0.0))
        out = L.cond(pred, lambda: L.scale(a, scale=-1.0),
                     lambda: L.elementwise_mul(a, a))
        return [{"a": np.array(v, "float32")}
                for v in ([1.0, 2.0], [-3.0, 1.0])], [out]

    def greedy_decode():
        V, eos, max_len = 12, 0, 10
        tr = L.data("tr", shape=[V, V], append_batch_size=False)
        tok = L.assign(np.array([3], "int64"))
        i = L.fill_constant([1], "int64", 0)
        going = L.assign(np.array([True]))
        arr = L.array_write(tok, i, array=L.create_array("int64"))
        with L.While(cond=going).block():
            L.increment(i, value=1, in_place=True)
            nxt = L.cast(L.reshape(L.argmax(L.gather(tr, tok), axis=-1),
                                   [1]), "int64")
            L.assign(nxt, output=tok)
            L.array_write(nxt, i, array=arr)
            L.assign(L.logical_and(
                L.not_equal(nxt, L.fill_constant([1], "int64", eos)),
                L.less_than(i, L.fill_constant([1], "int64", max_len - 1))),
                output=going)
        trans = np.random.RandomState(0).rand(V, V).astype("float32")
        for a, b in ((3, 7), (7, 5), (5, eos)):
            trans[a] = 0
            trans[a, b] = 1
        return [{"tr": trans}], [L.array_length(arr)] + [
            L.array_read(arr, L.fill_constant([1], "int64", k))
            for k in range(max_len)]

    return {f.__name__: build(f) for f in (
        while_counter, while_traced, switch, ifelse, cond, greedy_decode)}


def cf_run(main_p, startup, feeds, fetch, place):
    """-> ([fetches of each feed as numpy], host syncs of each run)."""
    from paddle_tpu_torch.core import Executor, Scope

    ex, sc = Executor(place), Scope()
    ex.run(startup, scope=sc)
    outs, syncs = [], []
    for f in feeds:
        outs.append(ex.run(main_p, feed=f, fetch_list=fetch, scope=sc))
        syncs.append(ex.last_host_syncs)
    return outs, syncs


def cf_gap(card, cpu):
    """The largest difference of the fetches over their largest value
    (integers and masks: 0 or inf)."""
    gap = 0.0
    for a_run, b_run in zip(card, cpu):
        for a, b in zip(a_run, b_run):
            a, b = np.asarray(a), np.asarray(b)
            if a.shape != b.shape:
                return np.inf
            if b.dtype.kind != "f":
                gap = max(gap, 0.0 if np.array_equal(a, b) else np.inf)
            elif b.size:
                gap = max(gap, float(np.abs(a - b).max())
                          / max(float(np.abs(b).max()), 1e-30))
    return gap


def rnn_program(reverse=False):
    """(main, startup, loss) of a StaticRNN regressor: tanh(fc(x_t) + h)
    over RNN_T steps of hidden RNN_HIDDEN, the last state through an fc,
    SGD(0.01) on the squared error (``reverse`` runs the recurrence last
    step first: the planted fault)."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.utils import unique_name

    main_p, startup = framework.Program(), framework.Program()
    startup.random_seed = 13
    T, B, H = RNN_T, RNN_BATCH, RNN_HIDDEN
    with unique_name.guard(), framework.program_guard(main_p, startup):
        x = L.data("x", shape=[T, B, H], append_batch_size=False)
        y = L.data("y", shape=[B, 1], append_batch_size=False)
        h0 = L.fill_constant([B, H], "float32", 0.0)
        rnn = L.StaticRNN()
        with rnn.step():
            h_prev = rnn.memory(init=h0)
            h = L.tanh(L.elementwise_add(
                L.fc(rnn.step_input(x), H, name="rnn_fc"), h_prev))
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        last = L.reshape(L.slice(rnn(), axes=[0], starts=[T - 1], ends=[T]),
                         [B, H])
        loss = L.reduce_mean(L.square(L.fc(last, 1) - y))
        SGD(0.01).minimize(loss)
    if reverse:
        for op in main_p.global_block().ops:
            if op.type in ("recurrent", "recurrent_grad"):
                op.attrs["reverse"] = True
        main_p._bump_version()
    return main_p, startup, loss


def rnn_steps(main_p, loss, init, feed, place):
    from paddle_tpu_torch.core import Executor, Scope, scope_from_numpy

    ex = Executor(place)
    sc = scope_from_numpy(Scope(), init, ex.device, program=main_p)
    t0 = time.perf_counter()
    losses = [float(ex.run(main_p, feed=feed, fetch_list=[loss],
                           scope=sc)[0].reshape(-1)[0])
              for _ in range(RNN_STEPS)]
    return losses, (time.perf_counter() - t0) * 1e3 / RNN_STEPS


def control_flow_checks(card):
    """(e): the programs and the StaticRNN on the card (``card``: its
    name and power limit) against the CPU, and a fault planted on the
    card in each."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.core import Executor, Scope, scope_to_numpy

    cpu = framework.CPUPlace()
    for name, (main_p, startup, feeds, fetch) in cf_programs().items():
        outs, syncs = cf_run(main_p, startup, feeds, fetch, None)
        want, cpu_syncs = cf_run(main_p, startup, feeds, fetch, cpu)
        gap = cf_gap(outs, want)
        print("merge (e): %s on the card vs CPU, gap %.3g (limit %g); host "
              "syncs a run %s (CPU %s); fetches %s" % (
                  name, gap, CF_RTOL, syncs, cpu_syncs,
                  json.dumps([[np.asarray(v).ravel().tolist()[:4]
                               for v in run] for run in outs])), flush=True)
        if not gap <= CF_RTOL or syncs != cpu_syncs:
            fail("control flow: %s on the card disagrees with the CPU" % name)
    main_p, startup, feeds, fetch = cf_programs()["while_counter"]
    bad = with_attr(main_p, "increment", "step", 2.0)
    gap = cf_gap(cf_run(bad, startup, feeds, fetch, None)[0],
                 cf_run(main_p, startup, feeds, fetch, cpu)[0])
    print("merge (e): planted fault, the loop's counter stepped by 2: gap "
          "%.3g" % gap, flush=True)
    if gap <= CF_RTOL:
        fail("control flow: the planted fault passed the limit")

    main_p, startup, loss = rnn_program()
    rng = np.random.RandomState(9)
    feed = {"x": rng.randn(RNN_T, RNN_BATCH, RNN_HIDDEN).astype("float32"),
            "y": rng.randn(RNN_BATCH, 1).astype("float32")}
    ex, sc = Executor(), Scope()
    ex.run(startup, scope=sc)
    init = scope_to_numpy(sc, main_p)
    got, card_ms = rnn_steps(main_p, loss, init, feed, None)
    cpu_l, cpu_ms = rnn_steps(main_p, loss, init, feed, cpu)
    rev, _ms = rnn_steps(rnn_program(reverse=True)[0], loss, init, feed,
                         None)

    def rel(a):
        return max(abs(x - y) / abs(y) for x, y in zip(a, cpu_l))

    print("merge (e): StaticRNN, hidden %d, T %d, batch %d, %d SGD steps: "
          "card losses %s (%.1f ms a step), CPU %s (%.1f ms); gap %.3g "
          "(limit %g); planted fault, the recurrence reversed: gap %.3g; %s"
          % (RNN_HIDDEN, RNN_T, RNN_BATCH, RNN_STEPS, json.dumps(got),
             card_ms, json.dumps(cpu_l), cpu_ms, rel(got), RNN_LOSS_RTOL,
             rel(rev), card), flush=True)
    if not (rel(got) <= RNN_LOSS_RTOL and got[-1] < got[0]):
        fail("StaticRNN on the card disagrees with the CPU or does not learn")
    if rel(rev) <= RNN_LOSS_RTOL:
        fail("StaticRNN: the planted fault passed the limit")


def merge_phase(cfg):
    """Phase 15 -> the launch counts of its merged BERT-base windows."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.core import Executor, Scope, scope_to_numpy
    from paddle_tpu_torch.models.bert import BertConfig, pretrain_feed

    t_phase = time.perf_counter()
    cpu = framework.CPUPlace()
    card = card_line()
    # (a) two windows at the small emission, dropout 0.1
    with emission(SMALL):
        main_p, startup, loss = merge_program(cfg)
        names = merge_names(main_p)
        g = main_p.global_block()
        branch = main_p.block(next(op for op in g.ops
                                   if op.type == "conditional_block")
                              .attr("sub_block"))
        n_adam = sum(op.type == "adam" for op in branch.ops)
        if n_adam != len(names["params"]) or any(
                op.type == "adam" for op in g.ops):
            fail("merge: %d adam ops in the branch for %d parameters"
                 % (n_adam, len(names["params"])))
        exe, scope = Executor(), Scope()
        exe.run(startup, scope=scope)
        init = scope_to_numpy(scope, main_p)
        feeds = [pretrain_feed(np.random.RandomState(30 + s), cfg,
                               TRAIN_BATCH, SEQ) for s in range(MERGE_STEPS)]
        snap = {n: t.clone() for n, t in scope_values(
            scope, names["params"]).items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()   # just before the main path runs
        losses, step_ms, syncs, broken = [], [], [], []
        for s, feed in enumerate(feeds):
            t0 = time.perf_counter()
            out, = exe.run(main_p, feed=feed, fetch_list=[loss], scope=scope)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(out.reshape(-1)[0]))
            syncs.append(exe.last_host_syncs)
            boundary = (s + 1) % MERGE_K == 0
            broken += ["%s (step %d)" % (b, s + 1) for b in window_violations(
                scope, names, snap, s + 1, boundary)]
            if boundary:
                moved = sum(not torch.equal(bits(t), bits(snap[n])) for n, t
                            in scope_values(scope, names["params"]).items())
                if moved < len(names["params"]) - len(names["key_biases"]):
                    broken.append("an update at step %d (%d of %d moved)"
                                  % (s + 1, moved, len(names["params"])))
                snap = {n: t.clone() for n, t in scope_values(
                    scope, names["params"]).items()}
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        del snap
        bnd = [m for s, m in enumerate(step_ms) if (s + 1) % MERGE_K == 0]
        mid = [m for s, m in enumerate(step_ms) if (s + 1) % MERGE_K]
        adam_p50 = TRAIN_P50.get(SMALL)
        print("merge (a): BERT (hidden %d, %d layers), seq %d, dropout %g, "
              "small attention; "
              "GradientMergeOptimizer(Adam(1e-4), k_steps=%d), micro-batch "
              "%d (an update every %d sequences), %d micro-steps; losses %s; "
              "step_ms %s; p50 non-boundary %.3f, boundary %.3f (phase 6's "
              "Adam, same emission and batch: p50 %s); host syncs a step %s; "
              "ops a step %d, a boundary step %d (%d in the branch); peak "
              "memory %.2f GB (a copy of the parameters for (b) included); "
              "launches %s; %s" % (
                  cfg.hidden, cfg.layers, SEQ, cfg.dropout, MERGE_K,
                  TRAIN_BATCH, MERGE_K * TRAIN_BATCH, MERGE_STEPS,
                  json.dumps(losses),
                  json.dumps([round(x, 3) for x in step_ms]),
                  float(np.percentile(mid, 50)), float(np.percentile(bnd, 50)),
                  "%.3f ms" % adam_p50 if adam_p50 else "not run",
                  json.dumps(syncs), len(g.ops), len(g.ops) + len(branch.ops),
                  len(branch.ops), peak,
                  json.dumps({k: v for k, v in launches.items() if v}), card),
              flush=True)
        want = {k: STEP_LAUNCHES[SMALL].get(k, 0) * MERGE_STEPS
                for k in launches}
        want["fused_adam"] = 0
        if launches != want:
            fail("merge launches %s over %d micro-steps, want %s"
                 % (launches, MERGE_STEPS, want))
        if syncs != [1] * MERGE_STEPS:
            fail("merge: host syncs a step %s, want one each" % syncs)
        if not all(np.isfinite(losses)):
            fail("merge losses %s not finite" % losses)
        # (b) bitwise on the card, and the faults planted in it
        print("merge (b): parameters bitwise unchanged over the 7 "
              "non-boundary micro-steps of each window, the merged buffers "
              "zero after each boundary, the counter %d after %d steps: %s"
              % (int(scope_values(scope, [names["counter"]])[
                  names["counter"]].reshape(-1)[0]), MERGE_STEPS,
                 "held" if not broken else "broken: %s" % broken),
              flush=True)
        if broken:
            fail("merge invariants broken: %s" % broken)
        del scope
        faults = merge_faults(main_p, names)
        before_boundary = dict(init, **{names["counter"]: np.full(
            (1,), MERGE_K - 1, np.int64)})
        seen = set()
        for what, bad in faults.items():
            state = before_boundary if what == "the buffers left unzeroed" \
                else init
            _l, _v, sc = merge_window(bad, loss, state, feeds[:1], None)
            start = int(state[names["counter"]][0])
            miss = window_violations(
                sc, names, {n: torch.from_numpy(init[n]).to(exe.device)
                            for n in names["params"]},
                start + 1, (start + 1) % MERGE_K == 0)
            print("merge (b): planted fault, %s: breaks %s" % (what, miss),
                  flush=True)
            seen.update(miss)
            del sc
        if len(seen) != 3:
            fail("merge (b): the planted faults broke only %s" % sorted(seen))

        # (c) the first window on the card and on the CPU from one state
        small = [pretrain_feed(np.random.RandomState(60 + s), cfg,
                               CHECK_BATCH, SEQ) for s in range(MERGE_K)]
        t0 = time.perf_counter()
        cpu_l, _v, cpu_sc = merge_window(main_p, loss, init, small, cpu)
        cpu_m = {n: t.numpy() for n, t in scope_values(
            cpu_sc, names["moments"]).items()}
        cpu_s = time.perf_counter() - t0
        del cpu_sc
        for what, prog in (("sound", main_p), (
                "planted fault, an update at every micro-step",
                faults["an update at every micro-step"])):
            card_l, _v, sc = merge_window(prog, loss, init, small, None)
            card_m = {n: t.cpu().numpy() for n, t in scope_values(
                sc, names["moments"]).items()}
            del sc
            gaps = {"losses": (max(abs(a - b) for a, b in zip(card_l, cpu_l)),
                               None, MERGE_LOSS_ATOL),
                    "moments": moment_gap(card_m, cpu_m)
                    + (MERGE_MOMENT_RTOL,)}
            print("merge (c): %s, the first window (%d micro-steps at batch "
                  "%d) on the card vs the CPU's plain path (%.1f s): %s; card "
                  "losses %s" % (what, MERGE_K, CHECK_BATCH, cpu_s,
                                 gaps_line(gaps), json.dumps(card_l)),
                  flush=True)
            if set(missed(gaps)) != (set() if what == "sound"
                                     else set(gaps)):
                fail("merge (c): %s: %s" % (what, gaps_line(gaps)))

    # (d) k merged micro-batches against one batch, dropout 0, on the card
    cfg0 = BertConfig(**dict(cfg.__dict__, dropout=0.0))
    with emission(DROPOUT0):
        main0, start0, loss0 = merge_program(cfg0)
        names0 = merge_names(main0)
        plain, _ps, ploss = merge_program(cfg0, plain=True)
        ex, sc = Executor(), Scope()
        ex.run(start0, scope=sc)
        init0 = scope_to_numpy(sc, main0)
        del sc
        micro, whole = merged_feeds(cfg0, 90, MERGE_K, TRAIN_BATCH)
        params, moments = names0["params"], names0["moments"]
        avg = [names0["avg"][p] for p in params]
        torch.cuda.synchronize()
        zero_counts()
        _l, got_avg, msc = merge_window(main0, loss0, init0, micro, None,
                                        fetch_last=avg)
        launches_d = launch_counts()
        got = scope_values(msc, params + moments)
        got_avg = dict(zip(params, got_avg))
        want_l = {k: STEP_LAUNCHES[DROPOUT0].get(k, 0) * MERGE_K
                  for k in launches_d}
        want_l["fused_adam"] = 0
        if launches_d != want_l:
            fail("merge (d) launches %s, want %s" % (launches_d, want_l))
        pinit = {v.name: init0[v.name] for v in plain.list_vars()
                 if v.persistable and not v.is_data}
        batch = len(whole["src_ids"])
        try:
            pl, grads, psc = merge_window(
                plain, ploss, pinit, [whole], None,
                fetch_last=[p + "@GRAD" for p in params])
        except torch.cuda.OutOfMemoryError:
            fail("merge (d): a step of %d sequences does not fit" % batch)
        want = scope_values(psc, params + moments)
        grads = dict(zip(params, grads))
        init_t = {p: torch.from_numpy(init0[p]).to(ex.device)
                  for p in params}
        keys = names0["key_biases"]

        def d_gaps(avg_g, state):
            return {
                "averaged merged gradient": floored_gap(avg_g, grads)
                + (MERGE_GRAD_RTOL,),
                "parameters": param_gap(
                    {p: state[p] for p in params},
                    {p: want[p] for p in params}, init_t, keys)
                + (MERGE_PARAM_RTOL,),
                "moments": moment_gap({n: state[n] for n in moments},
                                      {n: want[n] for n in moments})
                + (MERGE_DMOMENT_RTOL,)}

        gaps = d_gaps(got_avg, got)
        del msc
        print("merge (d): %d micro-batches of %d against one Adam step on "
              "the same %d sequences, dropout 0, from one state: %s; losses "
              "%.6f (the window's mean) vs %.6f; launches %s" % (
                  MERGE_K, TRAIN_BATCH, batch, gaps_line(gaps),
                  float(np.mean(_l)), pl[0],
                  json.dumps({k: v for k, v in launches_d.items() if v})),
              flush=True)
        if missed(gaps):
            fail("merge (d): the merged window is not the batch: %s"
                 % missed(gaps))
        bad = merge_faults(main0, names0)["an update at every micro-step"]
        _l, bad_avg, bsc = merge_window(bad, loss0, init0, micro, None,
                                        fetch_last=avg)
        bad_gaps = d_gaps(dict(zip(params, bad_avg)),
                          scope_values(bsc, params + moments))
        del bsc, psc, init_t
        print("merge (d): planted fault, an update at every micro-step: %s; "
              "misses %s" % (gaps_line(bad_gaps), missed(bad_gaps)),
              flush=True)
        if set(missed(bad_gaps)) != set(gaps):
            fail("merge (d): the planted fault passed %s"
                 % sorted(set(gaps) - set(missed(bad_gaps))))
    torch.cuda.empty_cache()

    # (e) the control-flow programs and a StaticRNN
    control_flow_checks(card)
    print("merge: the phase %.1f s; %s" % (time.perf_counter() - t_phase,
                                           card), flush=True)
    return {k: launches[k] + launches_d[k] for k in launches}


# -- phase 16: the recurrent networks -----------------------------------------

# PTB-LM large (Zaremba et al. 2014; PaddleNLP language_model's ``large``):
# RNN_LM_STEPS steps of each emission at full width and batch 20, the
# dropout kernel 3 times a step (the embedding's dropout, basic_lstm_rnn's
# one draw and its grad op's draw of the same masks; or the embedding's,
# the one between the layers and the output's).  Card vs the
# CPU's plain path: RNN_CHECK_STEPS steps at full width from one state,
# the batch cut to RNN_CHECK_BATCH for the CPU's time (3 steps at batch 4
# took 3.7-14.1 s an emission on an H100 machine's host), at dropout 0 and
# 0.65 with the same Philox masks on both: losses relative LM_LOSS_RTOL
# (~322, sums over 35 steps of 10000-way cross entropies), the carried
# states to LM_STATE_ATOL of their largest value (at least 1), the
# parameters to LM_PARAM_RTOL of their mean step (``param_gap``); both
# f32 with TF32 off, so they differ by summation order only.  The op-level
# recurrences (hidden 512, T 32, batch 16; lstmp at 2048 cells and a
# 512-wide projection): each output and input gradient to RNN_OP_RTOL of
# its largest value.  The LSTMCell beam decode: ids held up to near-ties
# (``beam_agreement``, NMT_TIE), scores to NMT_SCORE_ATOL; contrib's
# decoders to KERNEL_ATOL.  A planted fault on the card must miss each.
RNN_LM_STEPS = 20
RNN_CHECK_STEPS = 3
RNN_CHECK_BATCH = 2
LM_LOSS_RTOL = 1e-5
LM_STATE_ATOL = 1e-4
LM_PARAM_RTOL = 1e-3
RNN_OP_RTOL = 1e-4
RNN_OP_D, RNN_OP_T, RNN_OP_B = 512, 32, 16
RNN_LSTMP_CELLS, RNN_LSTMP_PROJ = 2048, 512
RNN_DECODE = dict(hidden=1500, vocab=10000, beam=4, batch=8, steps=20)
# the dropout kernel's launches a training step, in either emission
LM_DROPOUT_LAUNCHES = 3
# (a) holds finite losses, the first (at the initial weights) within
# LM_FIRST_RTOL of T ln V: SGD(1.0) under the clip swings over its first
# steps on the seeded stream, and the reference swings the same way from
# the same weights and feeds (``tests/torch_ptb_lm_reference.py``: each
# clipped step of norm 10 can raise the loss of its own batch).
LM_FIRST_RTOL = 1e-3
# (b) at dropout 0 also holds the card's losses to LM_LOSS_RTOL of the
# reference's: the JAX package on the CPU from the same initial weights
# (their float64 sum ``init_sum``) and feeds, ``python
# tests/torch_ptb_lm_reference.py --rnn-model M --batch 2 --steps 3
# --feed-seed 5``.
LM_REFERENCE = {
    "basic_lstm": {"init_sum": 34.17151133436219,
                   "losses": [322.37738037109375, 272.3048400878906,
                              572.1105346679688]},
    "cudnn": {"init_sum": 75.87375662511752,
              "losses": [322.37823486328125, 273.0965576171875,
                         497.52044677734375]},
}


def lm_program(cfg, rnn_model, seed=21):
    """(main, startup, [loss, last_hidden, (last_cell)]) of
    ``ptb_lm.build_train``."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.models import ptb_lm
    from paddle_tpu_torch.utils import unique_name

    main_p, startup = framework.Program(), framework.Program()
    main_p.random_seed = startup.random_seed = seed
    with unique_name.guard(), framework.program_guard(main_p, startup):
        fetch = [v for v in ptb_lm.build_train(cfg, rnn_model)
                 if v is not None]
    return main_p, startup, fetch


def lm_init(startup, main_p):
    """The persistables of ``startup`` run on the CPU: the same draws on
    any machine, the reference run of LM_REFERENCE's too."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.core import Executor, Scope, scope_to_numpy

    exe, sc = Executor(framework.CPUPlace()), Scope()
    exe.run(startup, scope=sc)
    init = scope_to_numpy(sc, main_p)
    del sc
    return init


def lm_steps(main_p, fetch, init, feeds, place, carry, cfg):
    """The steps of ``feeds`` on ``place`` (None: the card) from ``init``,
    the final states carried into the next init where ``carry`` -> (losses,
    last states, step ms, scope, executor)."""
    from paddle_tpu_torch.core import Executor, Scope, scope_from_numpy

    exe = Executor(place)
    sc = scope_from_numpy(Scope(), init, exe.device, program=main_p)
    z = np.zeros((cfg.num_layers, cfg.batch_size, cfg.hidden_size),
                 np.float32)
    h = c = z
    losses, states, ms = [], [], []
    for f in feeds:
        t0 = time.perf_counter()
        out = exe.run(main_p, feed=dict(f, init_hidden=h, init_cell=c),
                      fetch_list=fetch, scope=sc)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out[0].reshape(-1)[0]))
        states = [np.asarray(o) for o in out[1:]]
        if carry:
            h = states[0]
            c = states[1] if len(states) > 1 else z
    return losses, states, ms, sc, exe


def ops_a_step(main_p, n_steps):
    """(ops of the global block, ops run a step: each recurrent op's and
    its grad's sub-block once a time step)."""
    g = main_p.global_block()
    run = 0
    for op in g.ops:
        if op.type in ("recurrent", "recurrent_grad"):
            run += n_steps * len(main_p.block(op.attr("sub_block")).ops)
        else:
            run += 1
    return len(g.ops), run


def lm_gaps(got, want, params, init):
    """Card run vs CPU run (each ``lm_steps``'s) -> gaps."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got[0], want[0]))
    state = max(float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))
                for a, b in zip(got[1], want[1]))
    gp = {n: scope_values(got[3], [n])[n].cpu().numpy() for n in params}
    wp = {n: scope_values(want[3], [n])[n].numpy() for n in params}
    pgap, where = param_gap(gp, wp, init)
    return {"losses": (loss, None, LM_LOSS_RTOL),
            "states": (state, None, LM_STATE_ATOL),
            "parameters": (pgap, where, LM_PARAM_RTOL)}


def with_split_swapped(main_p, n_out, i, j):
    """A clone of ``main_p`` with outputs ``i`` and ``j`` of every
    ``n_out``-way split (in any block) swapped: two gates swapped, a fault
    planted on the card."""
    bad = main_p.clone()
    n = 0
    for op in (op for blk in bad.blocks for op in blk.ops):
        outs = op.outputs.get("Out", []) if op.type == "split" else []
        if len(outs) == n_out:
            outs[i], outs[j] = outs[j], outs[i]
            n += 1
    if not n:
        fail("no %d-way split to plant a fault in" % n_out)
    bad._bump_version()
    return bad


@contextlib.contextmanager
def gru_dropout_upscaled(main_p):
    """``main_p`` with basic_gru_rnn dividing its kept values by 1 - p
    (the LSTM's rule, at the phase's p = 0.65): a fault planted on the
    card."""
    from paddle_tpu_torch.ops import rnn as trnn

    saved = trnn.dropped
    trnn.dropped = lambda v, keep, q: saved(
        v, keep, q if q is not None else 1.0 - 0.65)
    try:
        yield main_p
    finally:
        trnn.dropped = saved


def lm_check(rnn_model, dropout, faults, card):
    """(b), (c): RNN_CHECK_STEPS steps of the emission at batch
    RNN_CHECK_BATCH from one state on the card and on the CPU, and each
    fault planted on the card against the same CPU run."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.models import ptb_lm

    cfg = ptb_lm.PTB_LARGE.replace(batch_size=RNN_CHECK_BATCH,
                                   dropout=dropout)
    main_p, startup, fetch = lm_program(cfg, rnn_model)
    init = lm_init(startup, main_p)
    feeds = list(ptb_lm.batches(cfg, RNN_CHECK_STEPS, seed=5))
    carry = rnn_model != "cudnn"
    params = [p.name for p in main_p.global_block().all_parameters()]
    t0 = time.perf_counter()
    want = lm_steps(main_p, fetch, init, feeds, framework.CPUPlace(), carry,
                    cfg)
    cpu_s = time.perf_counter() - t0
    got = lm_steps(main_p, fetch, init, feeds, None, carry, cfg)
    gaps = lm_gaps(got, want, params, init)
    print("rnn (%s): %s, dropout %g, %d steps at batch %d from one state, "
          "card vs the CPU's plain path (%.1f s): %s; card losses %s; %s" % (
              "c" if "gru" in rnn_model else "b",
              rnn_model, dropout, RNN_CHECK_STEPS, RNN_CHECK_BATCH, cpu_s,
              gaps_line(gaps), json.dumps(got[0]), card), flush=True)
    if missed(gaps):
        fail("rnn: %s at dropout %g on the card disagrees with the CPU: %s"
             % (rnn_model, dropout, missed(gaps)))
    ref = LM_REFERENCE.get(rnn_model) if not dropout else None

    def ref_gap(losses):
        return max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                       ref["losses"]))

    if ref is not None:
        isum = float(sum(init[n].astype(np.float64).sum() for n in params))
        if abs(isum - ref["init_sum"]) > 1e-9 * abs(ref["init_sum"]):
            fail("rnn (b): %s's initial weights sum to %r, the reference "
                 "run's to %r" % (rnn_model, isum, ref["init_sum"]))
        rgap = ref_gap(got[0])
        print("rnn (b): %s, dropout 0, card vs the reference (the JAX "
              "package on the CPU, the same weights and feeds): losses %.3g "
              "(limit %g); reference %s; %s" % (
                  rnn_model, rgap, LM_LOSS_RTOL, json.dumps(ref["losses"]),
                  card), flush=True)
        if rgap > LM_LOSS_RTOL:
            fail("rnn (b): %s's card losses %s, the reference's %s"
                 % (rnn_model, got[0], ref["losses"]))
    del got
    for what, make in faults.items():
        bad = make(main_p)    # a planted program, or a context giving one
        if not hasattr(bad, "__enter__"):
            bad = contextlib.nullcontext(bad)
        with bad as bad:
            res = lm_steps(bad, fetch, init, feeds, None, carry, cfg)
        bad_gaps = lm_gaps(res, want, params, init)
        if ref is not None:
            bad_gaps["reference"] = (ref_gap(res[0]), None, LM_LOSS_RTOL)
        print("rnn: planted fault in %s, %s: %s; misses %s; %s" % (
            rnn_model, what, gaps_line(bad_gaps), missed(bad_gaps), card),
            flush=True)
        if not missed(bad_gaps) or (ref is not None
                                    and "reference" not in missed(bad_gaps)):
            fail("rnn: the planted fault (%s) passed the limits" % what)


def lm_phase(card):
    """(a): PTB-LM large, both emissions, RNN_LM_STEPS steps each ->
    their launch counts."""
    from paddle_tpu_torch.models import ptb_lm

    cfg = ptb_lm.PTB_LARGE
    total = {}
    for rnn_model in ("basic_lstm", "cudnn"):
        main_p, startup, fetch = lm_program(cfg, rnn_model)
        init = lm_init(startup, main_p)
        feeds = list(ptb_lm.batches(cfg, RNN_LM_STEPS + 3, seed=7))
        carry = rnn_model != "cudnn"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()   # just before the main path runs
        losses, states, ms, sc, exe = lm_steps(
            main_p, fetch, init, feeds[:RNN_LM_STEPS], None, carry, cfg)
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.synchronize()
        feed = dict(feeds[RNN_LM_STEPS], init_hidden=np.zeros(
            (cfg.num_layers, cfg.batch_size, cfg.hidden_size), np.float32))
        feed["init_cell"] = feed["init_hidden"]
        t0 = time.perf_counter()
        exe.run(main_p, feed=feed, fetch_list=[], scope=sc)
        host = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        busy, idle = busy_ms(lambda: exe.run(main_p, feed=feed,
                                             fetch_list=[fetch[0]],
                                             scope=sc))
        del sc, exe
        p50 = float(np.percentile(ms[1:], 50))
        tokens = cfg.batch_size * cfg.num_steps
        n_ops, n_run = ops_a_step(main_p, cfg.num_steps)
        print("rnn (a): PTB-LM large (vocab %d, %d layers, hidden %d, %d "
              "steps, batch %d, dropout %g), %s emission, SGD(%g) under "
              "GradientClipByGlobalNorm(%g), %d steps%s: losses first %.4f "
              "last %.4f (%s); step_ms %s; p50 %.3f ms, %.1f tokens/s; host "
              "%.3f ms a step (a run's issue, no fetch); busy %.3f ms a "
              "step, idle %.3f; ops a step %d (%d run, each sub-block once "
              "a time step); peak memory %.2f GB; launches %s; %s" % (
                  cfg.vocab_size, cfg.num_layers, cfg.hidden_size,
                  cfg.num_steps, cfg.batch_size, cfg.dropout, rnn_model,
                  cfg.lr, cfg.max_grad_norm, RNN_LM_STEPS,
                  ", states carried" if carry else "", losses[0],
                  losses[-1], json.dumps([round(x, 4) for x in losses]),
                  json.dumps([round(x, 3) for x in ms]), p50,
                  tokens / p50 * 1e3, host, busy, idle, n_ops, n_run, peak,
                  json.dumps({k: v for k, v in launches.items() if v}),
                  card), flush=True)
        want = {k: 0 for k in launches}
        want["dropout"] = LM_DROPOUT_LAUNCHES * RNN_LM_STEPS
        if launches != want:
            fail("rnn (a): %s launches %s over %d steps, want %s"
                 % (rnn_model, launches, RNN_LM_STEPS, want))
        at_init = cfg.num_steps * np.log(cfg.vocab_size)
        if not all(np.isfinite(losses)) \
                or abs(losses[0] - at_init) > LM_FIRST_RTOL * at_init:
            fail("rnn (a): %s losses %s (the first within %g of %.4f)"
                 % (rnn_model, losses, LM_FIRST_RTOL, at_init))
        if rnn_model == "basic_lstm":
            bad = with_attr(with_attr(main_p, "reduce_mean", "dim", [1]),
                            "reduce_mean_grad", "dim", [1])
            first = lm_steps(bad, fetch, init, feeds[:1], None, carry,
                             cfg)[0][0]
            gap = abs(first - at_init) / at_init
            print("rnn (a): planted fault, the loss's mean over the steps "
                  "where the batch's: the first loss %.4f, %.3g from %.4f "
                  "(limit %g); %s" % (first, gap, at_init, LM_FIRST_RTOL,
                                      card), flush=True)
            if gap <= LM_FIRST_RTOL:
                fail("rnn (a): the planted fault (the loss's mean over the "
                     "steps) passed the first-loss limit")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


def decode_program():
    """(main, startup, [sequences [T, B, K], final log-probs [B K, 1]])
    of a BeamSearchDecoder under dynamic_decode over an LSTMCell with an
    embedding and an output fc, RNN_DECODE's widths."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch.param_attr import ParamAttr
    from paddle_tpu_torch.utils import unique_name

    d = RNN_DECODE
    main_p, startup = framework.Program(), framework.Program()
    main_p.random_seed = startup.random_seed = 31
    with unique_name.guard(), framework.program_guard(main_p, startup):
        h0 = L.data("h0", shape=[d["hidden"]])
        c0 = L.data("c0", shape=[d["hidden"]])
        bsd = L.BeamSearchDecoder(
            L.LSTMCell(d["hidden"]), start_token=0, end_token=1,
            beam_size=d["beam"],
            embedding_fn=lambda ids: L.embedding(
                ids, (d["vocab"], d["hidden"]),
                param_attr=ParamAttr(name="dec_emb")),
            output_fn=lambda o: L.fc(o, d["vocab"],
                                     param_attr=ParamAttr(name="dec_out_w")))
        outs, st = L.dynamic_decode(bsd, inits=[h0, c0],
                                    max_step_num=d["steps"])
        fetch = [bsd.finalize(outs), st[-2]]
    return main_p, startup, fetch


def contrib_decoder_programs():
    """{name: (main, startup, feed, fetch)}: contrib's TrainingDecoder and
    BeamSearchDecoder over a StateCell h' = tanh(fc([h, x]))."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch.contrib import decoder as D
    from paddle_tpu_torch.param_attr import ParamAttr
    from paddle_tpu_torch.utils import unique_name

    b, t, d, v, k = 4, 6, 32, 50, 3
    rng = np.random.RandomState(17)

    def cell():
        ctx = L.data("ctx0", shape=[b, d], append_batch_size=False)
        sc = D.StateCell(inputs={"x": None},
                         states={"h": D.InitState(init=ctx)}, out_state="h")

        @sc.state_updater
        def updater(sc):
            sc.set_state("h", L.fc(
                [sc.get_state("h"), sc.get_input("x")], d, act="tanh",
                param_attr=[ParamAttr(name="dec_wh"),
                            ParamAttr(name="dec_wx")],
                bias_attr=ParamAttr(name="dec_b")))

        return sc

    out = {}
    for name in ("training", "beam"):
        main_p, startup = framework.Program(), framework.Program()
        main_p.random_seed = startup.random_seed = 23
        feed = {"ctx0": rng.randn(b, d).astype("float32")}
        with unique_name.guard(), framework.program_guard(main_p, startup):
            if name == "training":
                trg = L.data("trg", shape=[t, b, d], append_batch_size=False)
                dec = D.TrainingDecoder(cell())
                with dec.block():
                    dec.state_cell.compute_state(
                        inputs={"x": dec.step_input(trg)})
                    h = dec.state_cell.get_state("h")
                    dec.state_cell.update_states()
                    dec.output(h)
                fetch = [dec()]
                feed["trg"] = rng.randn(t, b, d).astype("float32")
            else:
                ids = L.data("init_ids", shape=[b, k], dtype="int64",
                             append_batch_size=False)
                scores = L.data("init_scores", shape=[b, k],
                                append_batch_size=False)
                dec = D.BeamSearchDecoder(
                    state_cell=cell(), init_ids=ids, init_scores=scores,
                    target_dict_dim=v, word_dim=d, topk_size=10, max_len=t,
                    beam_size=k, end_id=1)
                dec.decode()
                fetch = list(dec())
                feed["init_ids"] = np.zeros((b, k), np.int64)
                feed["init_scores"] = np.zeros((b, k), np.float32)
        out[name] = (main_p, startup, feed, fetch)
    return out


def decode_check(card):
    """(d): the LSTMCell beam decode and contrib's decoders, card vs
    CPU."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.core import Executor, Scope, scope_from_numpy

    d = RNN_DECODE
    main_p, startup, fetch = decode_program()
    init = lm_init(startup, main_p)
    rng = np.random.RandomState(41)
    feed = {"h0": rng.randn(d["batch"], d["hidden"]).astype("float32"),
            "c0": rng.randn(d["batch"], d["hidden"]).astype("float32")}
    probe = beam_probe(main_p)

    def run(prog, place, times=1):
        exe = Executor(place)
        sc = scope_from_numpy(Scope(), init, exe.device, program=prog)
        ms = []
        for _ in range(times):
            t0 = time.perf_counter()
            out = exe.run(prog, feed=feed, fetch_list=fetch + probe,
                          scope=sc)
            ms.append((time.perf_counter() - t0) * 1e3)
        seqs, logp = out[:2]
        # beam_agreement's layout: sequences [B, K, T], scores [B, K]
        return [np.transpose(seqs, (1, 2, 0)),
                logp.reshape(d["batch"], d["beam"])] + list(out[2:]), ms

    on_card, ms = run(main_p, None, times=4)
    on_cpu, _ = run(main_p, framework.CPUPlace())
    whole, held, parted, problems = beam_agreement(on_card, on_cpu,
                                                   d["beam"])
    print("rnn (d): BeamSearchDecoder under dynamic_decode over an "
          "LSTMCell(%d), vocab %d, beam %d, batch %d, %d steps: batch_ms "
          "%s, p50 %.3f over batches 2-4; card vs CPU: %d of %d rows equal "
          "to the end, %d row-steps equal, %d rows parted at a near-tie "
          "(gap <= %g), scores to %g; %s" % (
              d["hidden"], d["vocab"], d["beam"], d["batch"], d["steps"],
              json.dumps([round(x, 3) for x in ms]),
              float(np.percentile(ms[1:], 50)), whole, d["batch"], held,
              parted, NMT_TIE, NMT_SCORE_ATOL, card), flush=True)
    if problems:
        fail("rnn (d): " + problems[0])
    if parted > d["batch"] // 2:
        fail("rnn (d): %d of %d rows parted at near-ties" % (parted,
                                                             d["batch"]))
    # the LSTMCell's forget bias (f + 1.0, a scale op) dropped on the card
    bad = with_attr(main_p, "scale", "bias", 0.0,
                    where=lambda op: op.attr("bias") == 1.0
                    and op.attr("scale") == 1.0)
    bad_card, _ = run(bad, None)
    _w, _h, _p, bad_problems = beam_agreement(bad_card, on_cpu, d["beam"])
    print("rnn (d): planted fault, the LSTMCell's forget bias dropped: %d "
          "violations (%s); %s" % (len(bad_problems), bad_problems[:1], card),
          flush=True)
    if not bad_problems:
        fail("rnn (d): the planted fault passed the beam checks")

    for name, (prog, start, f, fe) in contrib_decoder_programs().items():
        w = lm_init(start, prog)
        outs = []
        for place in (None, framework.CPUPlace()):
            exe = Executor(place)
            sc = scope_from_numpy(Scope(), w, exe.device, program=prog)
            outs.append([np.asarray(o) for o in exe.run(
                prog, feed=f, fetch_list=fe, scope=sc)])
        gap = max(float(np.abs(a.astype(np.float64) - b).max())
                  for a, b in zip(*outs))
        print("rnn (d): contrib %s decoder, card vs CPU: gap %.3g (limit "
              "%g); shapes %s; %s" % (name, gap, KERNEL_ATOL,
                                      [o.shape for o in outs[0]], card),
              flush=True)
        if not gap <= KERNEL_ATOL:
            fail("rnn (d): contrib's %s decoder on the card disagrees"
                 % name)


def rnn_op_cases():
    """(op type, inputs as numpy, attrs) of the op-level recurrences at
    hidden RNN_OP_D, T RNN_OP_T, batch RNN_OP_B; lstmp at RNN_LSTMP_CELLS
    cells and a RNN_LSTMP_PROJ projection."""
    rng = np.random.RandomState(51)
    d, t, b = RNN_OP_D, RNN_OP_T, RNN_OP_B
    c, p = RNN_LSTMP_CELLS, RNN_LSTMP_PROJ

    def r(*shape, s=None):
        s = s if s is not None else 1.0 / np.sqrt(shape[0])
        return (rng.randn(*shape) * s).astype(np.float32)

    blob = (d * 4 * d + d * 4 * d + 8 * d) * 2 \
        + (2 * d * 4 * d + d * 4 * d + 8 * d) * 2
    return [
        ("gru", [r(b, t, 3 * d, s=1.0), r(b, d, s=0.5), r(d, 3 * d),
                 r(1, 3 * d, s=0.1)], {"origin_mode": True}),
        ("gru_unit", [r(b, 3 * d, s=1.0), r(b, d, s=0.5), r(d, 3 * d),
                      r(1, 3 * d, s=0.1)], {}),
        ("lstm", [r(b, t, 4 * d, s=1.0), r(b, d, s=0.5), r(b, d, s=0.5),
                  r(d, 4 * d), r(1, 7 * d, s=0.1)], {"is_reverse": True}),
        ("lstmp", [r(b, t, 4 * c, s=1.0), r(b, p, s=0.5), r(b, c, s=0.5),
                   r(p, 4 * c), r(c, p), r(1, 7 * c, s=0.1)],
         {"cell_clip": 3.0, "proj_clip": 2.0}),
        ("lstm_unit", [r(b, 4 * d, s=1.0), r(b, d, s=0.5)],
         {"forget_bias": 1.0}),
        ("cudnn_lstm", [r(b, t, d, s=1.0), r(4, b, d, s=0.5),
                        r(4, b, d, s=0.5),
                        (rng.randn(blob) * 0.04).astype(np.float32)],
         {"hidden_size": d, "num_layers": 2, "is_bidirec": True,
          "max_len": t}),
        ("fusion_gru", [r(b, t, d, s=1.0), None, r(d, 3 * d), r(d, 3 * d),
                        r(1, 3 * d, s=0.1)], {"is_reverse": True}),
        ("fusion_lstm", [r(b, t, d, s=1.0), r(b, d, s=0.5), r(b, d, s=0.5),
                         r(d, 4 * d), r(d, 4 * d), r(1, 4 * d, s=0.1)], {}),
    ]


def rnn_op_run(op_type, args, attrs, device, cots=None):
    """Outputs and, under the cotangents ``cots``, input gradients (the
    grad op's lowering) of one op on ``device``, as numpy."""
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.core.lowering import LowerCtx

    dev = torch.device(device)
    t = [None if a is None else torch.from_numpy(a).to(dev) for a in args]
    opdef = registry.get_op_def(op_type)
    attrs = dict(opdef.default_attrs, **attrs)
    outs = opdef.lower(LowerCtx(dev), *t, **attrs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    if cots is None:
        return [o.cpu().numpy() for o in outs]
    gargs = list(t)
    for o, c in zip(outs, cots):
        gargs += [o, None if c is None else torch.from_numpy(c).to(dev)]
    grads = registry.get_op_def(op_type + "_grad").lower(
        LowerCtx(dev), *gargs, **attrs)
    return [o.cpu().numpy() for o in outs] + [
        g.cpu().numpy() for g in grads if g is not None]


def rnn_ops_check(card):
    """(e): each op-level recurrence card vs CPU, dynamic_lstmp at 2048
    cells, and the backward direction not reversed on the card."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch.core import Executor, Scope, scope_from_numpy
    from paddle_tpu_torch.utils import unique_name

    def gap(got, want):
        return max(float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                                    1e-30)
                   for a, b in zip(got, want))

    rng = np.random.RandomState(61)
    rows = []
    for op_type, args, attrs in rnn_op_cases():
        cpu = rnn_op_run(op_type, args, attrs, "cpu")
        cots = [rng.randn(*o.shape).astype(np.float32)
                if o.shape != (1,) else None for o in cpu]
        cpu = rnn_op_run(op_type, args, attrs, "cpu", cots)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = rnn_op_run(op_type, args, attrs, "cuda", cots)
        ms = (time.perf_counter() - t0) * 1e3
        g = gap(got, cpu)
        rows.append("%s %.3g (%.1f ms)" % (op_type, g, ms))
        if not g <= RNN_OP_RTOL:
            fail("rnn (e): %s on the card disagrees with the CPU: %.3g"
                 % (op_type, g))
        if op_type == "lstm":
            bad = rnn_op_run(op_type, args, dict(attrs, is_reverse=False),
                             "cuda", cots)
            bad_gap = gap(bad, cpu)
    print("rnn (e): the op-level recurrences (hidden %d, T %d, batch %d; "
          "lstmp %d cells, a %d projection), outputs and input gradients "
          "card vs CPU (limit %g of each one's largest): %s; planted fault, "
          "lstm's backward direction not reversed: %.3g; %s" % (
              RNN_OP_D, RNN_OP_T, RNN_OP_B, RNN_LSTMP_CELLS, RNN_LSTMP_PROJ,
              RNN_OP_RTOL, "; ".join(rows), bad_gap, card), flush=True)
    if bad_gap <= RNN_OP_RTOL:
        fail("rnn (e): the planted fault passed the limit")

    main_p, startup = framework.Program(), framework.Program()
    main_p.random_seed = startup.random_seed = 71
    with unique_name.guard(), framework.program_guard(main_p, startup):
        x = L.data("x", shape=[RNN_OP_T, RNN_OP_D])
        proj, cells = L.dynamic_lstmp(
            L.fc(x, 4 * RNN_LSTMP_CELLS, num_flatten_dims=2),
            4 * RNN_LSTMP_CELLS, proj_size=RNN_LSTMP_PROJ)
    init = lm_init(startup, main_p)
    feed = {"x": rng.randn(RNN_OP_B, RNN_OP_T, RNN_OP_D).astype("float32")}
    outs = []
    for place in (None, framework.CPUPlace()):
        exe = Executor(place)
        sc = scope_from_numpy(Scope(), init, exe.device, program=main_p)
        outs.append([np.asarray(o) for o in exe.run(
            main_p, feed=feed, fetch_list=[proj, cells], scope=sc)])
    g = gap(*outs)
    print("rnn (e): dynamic_lstmp, %d cells, a %d projection, T %d, batch "
          "%d, card vs CPU: %.3g (limit %g); %s" % (
              RNN_LSTMP_CELLS, RNN_LSTMP_PROJ, RNN_OP_T, RNN_OP_B, g,
              RNN_OP_RTOL, card), flush=True)
    if not g <= RNN_OP_RTOL:
        fail("rnn (e): dynamic_lstmp on the card disagrees with the CPU")


def rnn_mask_timing(dk, card):
    """The dropout kernel over one basic_lstm_rnn call's [T, L, B, H]
    block at PTB-LM large's widths, beside its plain version and
    F.dropout."""
    from paddle_tpu_torch.ops import rnn as trnn
    from paddle_tpu_torch.ops.common import byte_threshold

    shape = (35, 2, 20, 1500)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    ones = torch.ones(shape, device="cuda")
    thr = byte_threshold(1 - 0.65)
    got = trnn.rnn_keep_masks(WORDS, shape, 0.65, torch.device("cuda"))
    want = dk.dropout_reference(ones, WORDS, thr, 1.0, False)[1].bool()
    if not torch.equal(got, want):
        fail("rnn: the kernel's masks over the rnn block are not its plain "
             "version's")
    n = ones.numel()
    row = timed_row(
        "dropout", lambda: dk.dropout(ones, WORDS, thr, 1.0, False),
        lambda: dk.dropout_reference(ones, WORDS, thr, 1.0, False),
        lambda: torch.nn.functional.dropout(ones, 0.65), n * 4 + n * 5, 0,
        flush, 0.0, "over basic_lstm_rnn's [35, 2, 20, 1500] mask block "
        "(%s)" % card)
    del flush, ones
    print("rnn: the masks of one basic_lstm_rnn call, %d keep flags, "
          "bitwise the plain version's; kernel %.6f ms; %s"
          % (n, row["ms"], card), flush=True)


def rnn_phase(dk):
    """Phase 16 -> the launch counts of its PTB-LM training steps."""
    t_phase = time.perf_counter()
    card = card_line()
    launches = lm_phase(card)
    torch.cuda.empty_cache()
    # (b) the LSTM emissions, (c) the GRU ones, card vs CPU
    forget_bias = {"the forget bias 1 where the program has 0":
                   lambda p: with_attr(p, "basic_lstm_rnn", "forget_bias",
                                       1.0)}
    f_c_swap = {"the forget and candidate gates swapped":
                lambda p: with_split_swapped(p, 4, 1, 2)}
    lm_check("basic_lstm", 0.0, forget_bias, card)
    lm_check("basic_lstm", 0.65, forget_bias, card)
    lm_check("cudnn", 0.0, f_c_swap, card)
    lm_check("cudnn", 0.65, f_c_swap, card)
    lm_check("basic_gru", 0.65, {
        "the GRU's dropout upscaled": gru_dropout_upscaled},
        card)
    lm_check("dynamic_gru", 0.65, {
        "the update and reset gates swapped":
            lambda p: with_split_swapped(p, 3, 0, 1)}, card)
    torch.cuda.empty_cache()
    decode_check(card)
    rnn_ops_check(card)
    rnn_mask_timing(dk, card)
    print("rnn: the phase %.1f s; %s" % (time.perf_counter() - t_phase,
                                         card), flush=True)
    return launches


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
    rows = paged_kernel_phase(pa, dev, flush)
    rows.append(flash_kernel_phase(fa, dev, flush))
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
        dec_launches, params, refs, dec_rates = decode_phase(pa)
        spec_decode_phase(pa, params, refs, dec_rates)
        int8_launches, int8_refs = int8_decode_phase(pa, params, refs,
                                                     dec_rates)
        launches, plain_outs = encoder_phase((fa, fl, ln), bert_dir)
        launches["paged_attention"] = dec_launches
        launches.update(wire_phase(pa, (fa, fl, ln), params, refs,
                                   bert_dir, plain_outs, tmp))
        launches["paged_attention_int8"] = int8_launches
        # rows 1 and the int8 kernel take the disaggregated pair's paths
        (launches["paged_attention"],
         launches["paged_attention_int8"]) = disagg_phase(
            pa, params, refs, dec_rates, int8_refs)
        migration_phase(params, refs)
        try:
            plain_v, started = fleet_phase(
                params, refs, bert_dir, tmp, start_next=lambda dec_dir:
                start_leftovers(bert_dir, dec_dir, tmp))
            leftovers_phase(started, plain_v,
                            prompts(gpt2_small().vocab)[0])
            dec_dir = os.path.join(tmp, "gpt2-small")
            pair_fleet_phase(dec_dir, refs, tmp)
            # the role fleet's replicas prewarm while the tiers phase runs;
            # row 1 adds both phases' launches
            role_fleet = start_role_fleet(dec_dir, tmp)
            launches["paged_attention"] += tiers_phase(pa, params, refs)
            launches["paged_attention"] += role_autoscale_phase(role_fleet)
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
    # rows 9 and 14 and the dropout kernel: the NMT path's launches are
    # added to those of the paths before it, and so are the update-rule
    # phases' (rows 5-9, 14 and the dropout kernel in LAMB-BERT and its
    # Adam probe, rows 12, 13 and the fold in LARS-ResNet-50, row 10 in
    # the sweep), the gradient-merge phase's (rows 2-8, 14 and the
    # dropout kernel) and the recurrent phase's (the dropout kernel)
    for phase in (lambda: nmt_phase(ln, dev),
                  lambda: lamb_bert_phase(BertConfig(dropout=0.1)),
                  lars_resnet_phase, optimizer_sweep_phase,
                  lambda: merge_phase(BertConfig(dropout=0.1)),
                  lambda: rnn_phase(dk)):
        for name, n in phase().items():
            launches[name] = launches.get(name, 0) + n
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
