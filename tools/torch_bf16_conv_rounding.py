#!/usr/bin/env python3
"""How a bf16 convolution and its grads round, on the card and on the CPU,
against the exact result.

    python3 tools/torch_bf16_conv_rounding.py

For ResNet-50's conv shapes at batch 32 (the stem, 1x1 and 3x3 convs at
56x56, a 1x1 at 14x14, a 3x3 at 7x7) and its fc product, seeded bf16
operands go through the forward, the input grad and the weight grad in
bf16 (cuDNN and cuBLAS on the card, oneDNN on the CPU, the port's
numerics: no TF32, no bf16 split reductions) and in float64 on the card.
Prints, for each result, the share of elements off the exactly rounded
bf16 value (a sum kept in f32 lands off it only near a rounding tie),
the largest error in bf16 ulps of the exact element, its RMS, and the
largest error relative to the exact result's largest value.  Needs a
CUDA card.
"""

import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONVS = (("stem 7x7 s2 [32, 3, 224]", (32, 3, 224, 224), (64, 3, 7, 7), 2,
          3),
         ("1x1 64-64 @56", (32, 64, 56, 56), (64, 64, 1, 1), 1, 0),
         ("3x3 64-64 @56", (32, 64, 56, 56), (64, 64, 3, 3), 1, 1),
         ("1x1 64-256 @56", (32, 64, 56, 56), (256, 64, 1, 1), 1, 0),
         ("1x1 1024-256 @14", (32, 1024, 14, 14), (256, 1024, 1, 1), 1, 0),
         ("3x3 512-512 @7", (32, 512, 7, 7), (512, 512, 3, 3), 1, 1))


def rounding(got, exact):
    want = exact.float().to(torch.bfloat16).float()
    g = got.float().to(exact.device)
    ulp = torch.exp2(torch.floor(torch.log2(
        want.abs().clamp_min(2.0 ** -126))) - 7).double()
    err = (g.double() - exact).abs() / ulp
    return ("off %.5f, max %.2f ulps, rms %.3f, %.3g of the largest"
            % (float((g != want).float().mean()), float(err.max()),
               float((err ** 2).mean().sqrt()),
               float((g.double() - exact).abs().max() / exact.abs().max())))


def conv_grads(go, x, w, stride, pad):
    dx, dw, _ = torch.ops.aten.convolution_backward(
        go, x, w, None, [stride] * 2, [pad] * 2, [1, 1], False, [0, 0], 1,
        [True, True, False])
    return dx, dw


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this compares the card's bf16 rounding")
    sys.path.insert(0, ROOT)
    from paddle_tpu_torch import set_f32_numerics

    set_f32_numerics()
    print("torch %s, CUDA %s, cuDNN %s, %s" % (
        torch.__version__, torch.version.cuda, torch.backends.cudnn.version(),
        torch.cuda.get_device_name(0)), flush=True)
    torch.manual_seed(0)
    conv = torch.nn.functional.conv2d
    for name, xs, ws, stride, pad in CONVS:
        x = torch.randn(*xs, device="cuda").bfloat16()
        w = (torch.randn(*ws, device="cuda")
             * (2.0 / (ws[1] * ws[2] * ws[3])) ** 0.5).bfloat16()
        y = conv(x, w, stride=stride, padding=pad)
        go = torch.randn(*y.shape, device="cuda").bfloat16()
        exact = (conv(x.double(), w.double(), stride=stride, padding=pad),) \
            + conv_grads(go.double(), x.double(), w.double(), stride, pad)
        card = (y,) + conv_grads(go, x, w, stride, pad)
        xc, wc, gc = x.cpu(), w.cpu(), go.cpu()
        t0 = time.perf_counter()
        cpu = (conv(xc, wc, stride=stride, padding=pad),) \
            + conv_grads(gc, xc, wc, stride, pad)
        secs = time.perf_counter() - t0
        for what, c, h, e in zip(("forward", "input grad", "weight grad"),
                                 card, cpu, exact):
            print("%-24s %-11s card: %s | CPU: %s" % (
                name, what, rounding(c, e), rounding(h, e)), flush=True)
        print("%-24s CPU %.1f s" % (name, secs), flush=True)
    a = torch.randn(32, 2048, device="cuda").bfloat16()
    b = (torch.randn(2048, 1000, device="cuda") * 0.02).bfloat16()
    g = torch.randn(32, 1000, device="cuda").bfloat16()
    for what, f in (("forward", lambda p, q, r: p @ q),
                    ("input grad", lambda p, q, r: r @ q.t()),
                    ("weight grad", lambda p, q, r: p.t() @ r)):
        e = f(a.double(), b.double(), g.double())
        print("%-24s %-11s card: %s | CPU: %s" % (
            "fc [32, 2048] x [2048, 1000]", what, rounding(f(a, b, g), e),
            rounding(f(a.cpu(), b.cpu(), g.cpu()), e)), flush=True)


if __name__ == "__main__":
    main()
