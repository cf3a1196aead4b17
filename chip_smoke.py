#!/usr/bin/env python3
"""Drive the PyTorch port (``paddle_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (nonzero exit, no result line):

1. the card: name and power limit from nvidia-smi;
2. the build: every CUDA source of the port compiled with nvcc for
   sm_90a (all started together), with seconds and ptxas usage;
3. the kernels: each kernel against its plain PyTorch version on the card
   at its main-path shape and others, then timed (CUDA events, L2 flushed
   before every launch, as the serving loops find it) beside its plain
   version, a one-call PyTorch yardstick and its bound;
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
6. a JSON line of the kernels, then the result line.

Needs one CUDA card; exits nonzero without one, and outside a checkout of
the repository.
"""

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

# H100 SXM data-sheet rates (dense): device memory and f32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

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

def time_cold(fn, flush, iters=50):
    """Mean device ms of ``fn`` with L2 flushed before each call.  The
    flush (a 256 MB write) and a device-side sleep of ~0.5 ms keep the
    card busy while the host enqueues ``fn``, so the events bracket device
    work, not the wrapper's host time before its first launch."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def bound(nbytes, flops):
    """(bound_ms, bound_by) of work moving ``nbytes`` and doing ``flops``
    f32 operations on the card."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOPS * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def timed_row(name, kernel, plain, library, nbytes, flops, flush, worst,
              what):
    """Time kernel, plain version and library call; print and return the
    kernel's row (launches filled in after the serving phase)."""
    kernel_ms = time_cold(kernel, flush)
    plain_ms = time_cold(plain, flush)
    library_ms = time_cold(library, flush) if library is not None else None
    bound_ms, bound_by = bound(nbytes, flops)
    print("kernel %s %s: kernel_ms %.6f plain_ms %.6f library_ms %s "
          "bound_ms %.6f (%s; %d bytes over 3.35 TB/s, %d flops over "
          "67 TF/s)" % (name, what, kernel_ms, plain_ms,
                        "%.6f" % library_ms if library_ms is not None
                        else "none", bound_ms, bound_by, nbytes, flops),
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
        tensors[what] = (q, k, v, bias)
        got = fa.flash_attention(q, k, v, bias, causal)
        want = fa.flash_attention_reference(q, k, v, bias, causal)
        worst = max(worst, check("flash_attention", what, got, want))
    what = cases[0][0]
    q, k, v, bias = tensors[what]
    bb, h, s, d = q.shape
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_err = float((sdpa(q, k, v, attn_mask=bias)
                     - fa.flash_attention_reference(q, k, v, bias)[0])
                    .abs().max())
    nbytes = 4 * (4 * bb * h * s * d + bb * s * s + bb * h * s)
    row = timed_row(
        "flash_attention", lambda: fa.flash_attention(q, k, v, bias),
        lambda: fa.flash_attention_reference(q, k, v, bias),
        lambda: sdpa(q, k, v, attn_mask=bias), nbytes,
        4 * bb * h * s * s * d, flush, worst,
        "%s (SDPA with the same attn_mask, err vs plain %.3g)"
        % (what, lib_err))
    row.update(source="paddle_tpu_torch/kernels/csrc/flash_attention.cu",
               replaces="paddle_tpu/pallas_kernels/flash_attention.py:49")
    return row


def ln_kernel_phase(fl, ln, dev, flush):
    rng = np.random.RandomState(2)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    ln_f = torch.nn.functional.layer_norm
    worst_f = worst_l = 0.0
    shapes = {(1024, 768): "BERT rows [1024, 768]", (37, 200): "odd [37, 200]"}
    tensors = {}
    for (n, hd), what in shapes.items():
        x, y, g, b = (t(_rand(rng, *s)) for s in ((n, hd), (n, hd), (hd,),
                                                  (hd,)))
        tensors[n, hd] = (x, y, g, b)
        worst_f = max(worst_f, check(
            "fused_ln", what, fl.fused_ln_fwd(x, y, g, b, 0.0, None, 1e-5),
            fl.fused_ln_reference(x, y, g, b, 1e-5)))
        worst_l = max(worst_l, check(
            "layer_norm", what, ln.layer_norm_2d(x, g, b, 1e-5),
            ln.layer_norm_2d_reference(x, g, b, 1e-5)))
    x, y, g, b = tensors[1024, 768]
    n, hd = x.shape
    rows = []
    row = timed_row(
        "fused_ln", lambda: fl.fused_ln_fwd(x, y, g, b, 0.0, None, 1e-5),
        lambda: fl.fused_ln_reference(x, y, g, b, 1e-5),
        lambda: ln_f(x + y, (hd,), g, b, 1e-5),
        4 * (4 * n * hd + 2 * hd + 2 * n), 9 * n * hd, flush, worst_f,
        "BERT rows [1024, 768] (F.layer_norm(x + y))")
    row.update(source="paddle_tpu_torch/kernels/csrc/fused_ln.cu",
               replaces="paddle_tpu/pallas_kernels/fused_ln.py:106")
    rows.append(row)
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


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs the port on the card")
    if not os.path.isdir(os.path.join(HERE, "paddle_tpu_torch")):
        fail("no paddle_tpu_torch/ beside chip_smoke.py: run it from a "
             "checkout of the repository")
    sys.path.insert(0, HERE)
    from paddle_tpu_torch import set_f32_numerics
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_ln as fl
    from paddle_tpu_torch.kernels import layer_norm as ln
    from paddle_tpu_torch.kernels import paged_attention as pa

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
                 if "registers" in line or "spill" in line]
        print("build %s: %.2f s%s" % (name, info["seconds"],
                                      " (cached)" if info["cached"] else ""))
        for line in usage:
            print("  ptxas " + line)

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    rows = [paged_kernel_phase(pa, dev, flush),
            flash_kernel_phase(fa, dev, flush)]
    rows += ln_kernel_phase(fl, ln, dev, flush)
    del flush
    launches = {"paged_attention": decode_phase(pa)}
    launches.update(encoder_phase((fa, fl, ln)))
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": [{k: row[k] for k in KEYS}
                                  for row in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
