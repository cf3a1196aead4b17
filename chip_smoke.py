#!/usr/bin/env python3
"""Drive the PyTorch port (``paddle_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (nonzero exit, no result line):

1. the card: name and power limit from nvidia-smi;
2. the build: every CUDA source of the port compiled with nvcc for
   sm_90a (all started together), with seconds and ptxas usage;
3. the kernels: each kernel against its plain PyTorch version on the card
   at the decode shape and two others, then timed (CUDA events, L2
   flushed before every launch, as the decode loop finds it) beside its
   plain version, a one-call PyTorch yardstick and its bound;
4. serving: a GPT-2-small-width decoder (seeded random weights) in the
   port's DecodeEngine answers a dozen requests; every reply must be ok,
   every decode step must have gone through the kernel, and every
   request's tokens must equal the port's plain unpaged loop on the card
   up to near-ties of the logits;
5. a JSON line of the kernels, then the result line.

Needs one CUDA card; exits nonzero without one, and outside a checkout of
the repository.
"""

import json
import os
import subprocess
import sys
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
    flush (a 256 MB write) keeps the card busy while the host enqueues
    ``fn``, so the events bracket device work, not launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


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


def kernel_phase(pa, dev):
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
        torch.cuda.synchronize()
        live = c["lens"] > 0
        err = float((out[live] - ref[live]).abs().max())
        if not torch.isfinite(out).all():
            fail("kernel output not finite at %s" % name)
        if (~live).any() and float(out[~live].abs().max()) != 0.0:
            fail("kernel idle lane not zero at %s" % name)
        print("kernel paged_attention %s: max_abs_err %.3g (atol %g)"
              % (name, err, KERNEL_ATOL), flush=True)
        if not err <= KERNEL_ATOL:
            fail("paged_attention disagrees with its plain version at %s"
                 % name)
        worst = max(worst, err)

    c = cases["decode B=8 H=12 D=64 bs=16 MAXB=64"]
    args = (c["q"], c["k"], c["v"], c["tables"], c["lens"])
    bb, h, d = c["q"].shape
    bs = c["k"].shape[1]
    lens = c["lens"].cpu().numpy().astype(np.int64)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    kernel_ms = time_cold(lambda: pa.paged_attention(*args), flush)
    plain_ms = time_cold(lambda: pa.paged_attention_reference(*args), flush)
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

    def library():
        return sdpa(qg, kg, vg, attn_mask=mask)

    library_ms = time_cold(library, flush)
    lib_err = float((library()[:, :, 0] - pa.paged_attention_reference(
        *args)).abs().max())
    tok = int(lens.sum())
    nbytes = (2 * tok * h * d * 4            # live K and V rows
              + 2 * bb * h * d * 4           # q in, out
              + 4 * bb                       # lens
              + 4 * int(sum(-(-n // bs) for n in lens)))   # live table
    flops = tok * h * (4 * d + 5)            # q.k, p.v, softmax
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = flops / F32_FLOPS * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    print("kernel paged_attention decode shape: kernel_ms %.6f plain_ms "
          "%.6f library_ms %.6f (SDPA, gather excluded, err vs plain %.3g) "
          "bound_ms %.6f (%d bytes over 3.35 TB/s; ops bound %.6f ms)"
          % (kernel_ms, plain_ms, library_ms, lib_err, bound_ms, nbytes,
             bound_ops_ms), flush=True)
    return {"name": "paged_attention", "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/pallas_kernels/paged_attention.py:105",
            "max_abs_err": worst, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms
            else "operations",
            "library_ms": library_ms}


# -- phase 4: serving --------------------------------------------------------

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


def serving_phase(pa, dev):
    from paddle_tpu_torch.serving import DecodeEngine, init_decoder_params

    cfg = gpt2_small()
    t0 = time.perf_counter()
    params = init_decoder_params(cfg, seed=0)
    eng = DecodeEngine(buckets="4,8", block_size=16, deadline_ms=600000.0)
    m = eng.add_model("gpt2-small", (cfg, params), kv_blocks=520)
    del params
    torch.cuda.synchronize()
    print("serving: GPT-2-small width (vocab %d, %d layers, %d heads x %d, "
          "ffn %d, max_seq %d), %d KV blocks of 16 (%.1f MB), set up in "
          "%.1f s" % (cfg.vocab, cfg.layers, cfg.heads, cfg.head_dim,
                      cfg.ffn, cfg.max_seq, m.kv_config.num_blocks,
                      m.cache.nbytes / 1e6, time.perf_counter() - t0),
          flush=True)
    first, late = prompts(cfg.vocab)
    eng.start()
    try:
        # the counts start at 0 just before the main path runs
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
            fail("request %d: %s" % (i, None if r is None
                                     else (r.status, r.error)))
    if late_reply.phases["cached_tokens"] != 64:
        fail("shared-prefix request cached %d tokens, want 64"
             % late_reply.phases["cached_tokens"])
    print("serving: %d replies ok, kernel launches %d, decode steps %d, "
          "layers x steps %d, prefix-cache hit %d tokens"
          % (len(replies), launches, steps, cfg.layers * steps,
             late_reply.phases["cached_tokens"]), flush=True)
    if launches != cfg.layers * steps or steps == 0:
        fail("paged_attention launched %d times over %d steps of %d layers"
             % (launches, steps, cfg.layers))

    ntok = sum(len(r.outputs["tokens"]) for r in replies)
    ttft = [r.phases["ttft_ms"] for r in replies]
    step_ms = list(m.step_ms_samples)[-steps:]
    print("serving: %d tokens in %.3f s = %.2f tokens/s; step_ms p50 %.3f; "
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
        print("serving: request %d (prompt %d) diverges at token %d: "
              "paged %d, unpaged %d, unpaged top-2 gap %.3g"
              % (i, len(p), j, got[j], want[j], gap), flush=True)
        if gap >= LOGIT_TIE_TOL:
            fail("request %d diverges from the unpaged loop where the "
                 "top-2 logit gap %.3g >= %g" % (i, gap, LOGIT_TIE_TOL))
        ties += 1
    print("serving: tokens equal the unpaged plain loop for %d of %d "
          "requests; %d near-tie divergences (gap < %g)"
          % (len(replies) - ties, len(replies), ties, LOGIT_TIE_TOL),
          flush=True)
    return {"paged_attention": launches}


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs the port on the card")
    if not os.path.isdir(os.path.join(HERE, "paddle_tpu_torch")):
        fail("no paddle_tpu_torch/ beside chip_smoke.py: run it from a "
             "checkout of the repository")
    sys.path.insert(0, HERE)
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import paged_attention as pa

    dev = torch.device("cuda")
    print(card_line(), flush=True)      # name, power limit
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)),
          flush=True)

    t0 = time.perf_counter()
    _build.build_all()
    print("build: %d CUDA source(s) for sm_90a in %.2f s"
          % (len(_build.SOURCES), time.perf_counter() - t0), flush=True)
    for name, info in _build.BUILD_INFO.items():
        usage = [ln.strip() for ln in info["ptxas"].splitlines()
                 if "registers" in ln or "spill" in ln]
        print("build %s: %.2f s%s" % (name, info["seconds"],
                                      " (cached)" if info["cached"] else ""))
        for ln in usage:
            print("  ptxas " + ln)

    row = kernel_phase(pa, dev)
    launches = serving_phase(pa, dev)
    row["launches"] = launches["paged_attention"]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
