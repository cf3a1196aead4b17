"""Transformer decoder for autoregressive decode serving, in PyTorch.

Counterpart of ``paddle_tpu/serving/decode_model.py``: a GPT-2-style
pre-LN decoder (token embedding + learned positions, per-layer multi-head
attention and a 4x tanh-GELU MLP, LayerNorm eps 1e-5, untied vocab head,
no q/k/v/o biases).  Weights keep the reference's names and layouts
(``x @ W`` with W ``[in, out]``), so a ``save_decoder`` directory written
by either package loads into the other.

``Decoder`` has two steps that share every layer of math through one
``attend`` callback:

* ``paged_step`` writes this token's K/V into the paged pool (block ids
  from the lane's block table) and attends through ``paged_attention``,
  the CUDA kernel on the card and the plain gather on the CPU; over int8
  pools it quantizes the token's K/V (``kv_cache.quantize_kv``), writes
  payload and scales, and attends through ``paged_attention_int8``;
* ``unpaged_step`` is the reference: contiguous per-lane K/V
  ``[L, B, S, H, D]`` written at ``pos`` and attended by the same
  ``masked_attention`` core.

Speculative decode composes ``paged_step``: ``paged_step_multi`` scores
W tokens a lane (the target's verify, the draft's catch-up ingest) and
``draft_rollout`` chains k greedy draft steps.  ``save_decoder(draft=)``
bundles a draft under ``<dir>/draft`` and ``truncate_decoder`` cuts one
from a target.

Where the JAX steps take a donated carry and return new arrays, these
write the pools in place (``index_put_``) and return only tokens and
logits.
"""

import json
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..kernels import _build
from ..kernels.paged_attention import (masked_attention, paged_attention,
                                       paged_attention_int8)
from .kv_cache import quantize_kv

__all__ = ["DecoderConfig", "init_decoder_params", "save_decoder",
           "load_decoder", "is_decoder_dir", "has_draft", "load_draft",
           "truncate_decoder", "Decoder", "from_jax_params"]


class DecoderConfig:
    __slots__ = ("vocab", "layers", "heads", "head_dim", "ffn", "max_seq")

    def __init__(self, vocab, layers, heads, head_dim, ffn=None,
                 max_seq=64):
        self.vocab = int(vocab)
        self.layers = int(layers)
        self.heads = int(heads)
        self.head_dim = int(head_dim)
        self.ffn = int(ffn if ffn is not None else 4 * heads * head_dim)
        self.max_seq = int(max_seq)

    @property
    def hidden(self):
        return self.heads * self.head_dim

    def to_dict(self):
        return {s: getattr(self, s) for s in self.__slots__}


def init_decoder_params(cfg, seed=0):
    """name -> np.float32 array; 0.02-normal weights, identity LN.  The
    draws are the reference's, in the reference's order, so the arrays
    are bitwise equal to ``paddle_tpu``'s for the same seed."""
    r = np.random.RandomState(seed)
    h, f, v = cfg.hidden, cfg.ffn, cfg.vocab

    def w(*shape):
        return (r.standard_normal(shape) * 0.02).astype(np.float32)

    p = {"embed": w(v, h), "pos_embed": w(cfg.max_seq, h),
         "lnf_g": np.ones(h, np.float32), "lnf_b": np.zeros(h, np.float32),
         "head": w(h, v)}
    for l in range(cfg.layers):
        p.update({
            "l%d_ln1_g" % l: np.ones(h, np.float32),
            "l%d_ln1_b" % l: np.zeros(h, np.float32),
            "l%d_wq" % l: w(h, h), "l%d_wk" % l: w(h, h),
            "l%d_wv" % l: w(h, h), "l%d_wo" % l: w(h, h),
            "l%d_ln2_g" % l: np.ones(h, np.float32),
            "l%d_ln2_b" % l: np.zeros(h, np.float32),
            "l%d_w1" % l: w(h, f), "l%d_b1" % l: np.zeros(f, np.float32),
            "l%d_w2" % l: w(f, h), "l%d_b2" % l: np.zeros(h, np.float32),
        })
    return p


def save_decoder(dirname, cfg, params, draft=None):
    """params.npz + decoder.json under ``dirname`` (the reference's
    format).  ``draft``, a (DecoderConfig, params) pair, lands as a nested
    bundle under ``<dirname>/draft``; its vocab must be the target's."""
    if draft is not None and draft[0].vocab != cfg.vocab:
        raise ValueError("draft vocab %d != target vocab %d"
                         % (draft[0].vocab, cfg.vocab))
    os.makedirs(dirname, exist_ok=True)
    np.savez(os.path.join(dirname, "params.npz"),
             **{k: np.asarray(v, np.float32) for k, v in params.items()})
    with open(os.path.join(dirname, "decoder.json"), "w") as fp:
        json.dump(cfg.to_dict(), fp, indent=1, sort_keys=True)
    if draft is not None:
        save_decoder(os.path.join(dirname, "draft"), *draft)
    return dirname


def load_decoder(dirname):
    """-> (DecoderConfig, {name: np.ndarray}) from a ``save_decoder``
    directory of either package."""
    with open(os.path.join(dirname, "decoder.json")) as fp:
        cfg = DecoderConfig(**json.load(fp))
    with np.load(os.path.join(dirname, "params.npz")) as z:
        params = {k: z[k] for k in z.files}
    return cfg, params


def is_decoder_dir(dirname):
    return os.path.exists(os.path.join(dirname, "decoder.json"))


def has_draft(dirname):
    return is_decoder_dir(os.path.join(dirname, "draft"))


def load_draft(dirname):
    """The bundled draft decoder, or None when the target ships alone."""
    return load_decoder(os.path.join(dirname, "draft")) \
        if has_draft(dirname) else None


def truncate_decoder(cfg, params, layers=1):
    """A draft cut from a target: its first ``layers`` transformer layers
    with the embeddings, final LayerNorm and head as they are (the
    reference's distillation-free draft for demos and smokes)."""
    layers = min(int(layers), cfg.layers)
    dcfg = DecoderConfig(vocab=cfg.vocab, layers=layers, heads=cfg.heads,
                         head_dim=cfg.head_dim, ffn=cfg.ffn,
                         max_seq=cfg.max_seq)
    keep = {"embed", "pos_embed", "lnf_g", "lnf_b", "head"}
    dparams = {k: np.asarray(v) for k, v in params.items()
               if k in keep or (k.startswith("l")
                                and int(k[1:k.index("_")]) < layers)}
    return dcfg, dparams


def _ln(x, g, b):
    # the reference writes LayerNorm out as mean(square(x - m)) with eps
    # 1e-5 (biased variance); F.layer_norm computes the same function in
    # one kernel, and the tests hold the two against each other
    return F.layer_norm(x, (x.shape[-1],), g, b, eps=1e-5)


class Decoder(torch.nn.Module):
    """The decoder's weights on ``device`` (default ``cuda``) and its two
    step functions.  Inference only: every step runs under no_grad."""

    def __init__(self, cfg, params, device=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        for name, arr in params.items():
            # np.array copies: the source may be a read-only view
            self.register_buffer(name, torch.from_numpy(
                np.array(arr, np.float32)).to(dev))
        if dev.type == "cuda":
            # build the step's kernels at set-up, not inside the first
            # request's deadline
            _build.build_all(("paged_attention",))

    @property
    def device(self):
        return self.embed.device

    def _token_logits(self, tok, pos, attend):
        """One token per lane through every layer; ``attend(l, q, k, v)``
        owns the KV write and the history attention."""
        cfg = self.cfg
        bb = tok.shape[0]
        x = self.embed[tok] + self.pos_embed[pos]
        for l in range(cfg.layers):
            def p(n, _l=l):
                return getattr(self, "l%d_%s" % (_l, n))

            h = _ln(x, p("ln1_g"), p("ln1_b"))
            q = (h @ p("wq")).reshape(bb, cfg.heads, cfg.head_dim)
            k = (h @ p("wk")).reshape(bb, cfg.heads, cfg.head_dim)
            v = (h @ p("wv")).reshape(bb, cfg.heads, cfg.head_dim)
            a = attend(l, q, k, v).reshape(bb, cfg.hidden)
            x = x + a @ p("wo")
            h2 = _ln(x, p("ln2_g"), p("ln2_b"))
            # jax.nn.gelu defaults to the tanh approximation; the exact
            # erf form would drift the logits away from the reference
            x = x + F.gelu(h2 @ p("w1") + p("b1"), approximate="tanh") \
                @ p("w2") + p("b2")
        x = _ln(x, self.lnf_g, self.lnf_b)
        return x @ self.head

    @torch.no_grad()
    def paged_step(self, k_pool, v_pool, tok, pos, block_tables,
                   context_lens, scales=None):
        """One token per lane through the paged pools -> (next_tokens
        int32 [B], logits [B, vocab]).  ``scales`` (k_scale, v_scale)
        marks int8 pools (``PagedKVCache.pools`` gives the four tensors in
        this order).

        tok/pos/context_lens are [B], block_tables [B, MAXB], all int32
        tensors on the decoder's device.  ``context_lens[b]`` counts the
        tokens valid AFTER this step's write (pos + 1 for live lanes, 0
        for idle lanes, whose table points at the scratch block 0).  The
        step writes exactly one position per lane, ``pos``, into block
        ``block_tables[b, pos // bs]`` (negative entries clamp to block
        0), and only reads earlier positions through the table — which is
        what lets prefix-cache hits share read-only blocks.  Per layer the
        order is fixed: write this token's K/V, then attend.  Idle lanes
        all write block 0 at offset 0; those duplicate writes are
        harmless and their outputs are discarded."""
        bs = k_pool.shape[2]
        tok = tok.long()
        pos = pos.long()
        slot = block_tables.long().clamp(min=0).gather(
            1, (pos // bs)[:, None])[:, 0]
        offs = pos % bs

        def attend(l, q, k, v):
            if scales is None:
                k_pool[l].index_put_((slot, offs), k)
                v_pool[l].index_put_((slot, offs), v)
                return paged_attention(q, k_pool[l], v_pool[l],
                                       block_tables, context_lens)
            # the quantize stays plain torch ops, as the reference's jnp
            k_scale, v_scale = scales
            qk, sk = quantize_kv(k)
            qv, sv = quantize_kv(v)
            k_pool[l].index_put_((slot, offs), qk)
            v_pool[l].index_put_((slot, offs), qv)
            k_scale[l].index_put_((slot, offs), sk)
            v_scale[l].index_put_((slot, offs), sv)
            return paged_attention_int8(q, k_pool[l], v_pool[l], k_scale[l],
                                        v_scale[l], block_tables,
                                        context_lens)

        logits = self._token_logits(tok, pos, attend)
        # torch.argmax, like jnp.argmax, returns the first maximum
        return torch.argmax(logits, dim=-1).to(torch.int32), logits

    def _pools_step(self, pools, tok, pos, block_tables, context_lens):
        return self.paged_step(pools[0], pools[1], tok, pos, block_tables,
                               context_lens,
                               scales=tuple(pools[2:]) or None)

    @torch.no_grad()
    def paged_step_multi(self, pools, tok, pos, block_tables, context_lens):
        """W query tokens a lane -> (next_tokens int32 [B, W], logits [B,
        W, vocab]): tok/pos/context_lens [B, W], block_tables [B, MAXB];
        ``pools`` as ``PagedKVCache.pools``.  Column j is one
        ``paged_step`` at the [B] shapes of a plain decode step, in column
        order: the same write-then-attend sequence is what makes a
        speculative verify's tokens the non-speculative ones.  A lane
        feeding fewer than W tokens puts them last and fills the leading
        columns with lens 0 writes at its first valid position, which the
        first real column overwrites before anything attends it."""
        nxts, logits = [], []
        for j in range(tok.shape[1]):
            nxt, lg = self._pools_step(pools, tok[:, j], pos[:, j],
                                       block_tables,
                                       context_lens[:, j].contiguous())
            nxts.append(nxt)
            logits.append(lg)
        return torch.stack(nxts, dim=1), torch.stack(logits, dim=1)

    @torch.no_grad()
    def draft_rollout(self, pools, tok, pos, block_tables, context_lens,
                      max_pos, k):
        """``k`` chained greedy proposals a lane -> int32 [B, k]: feed
        tok[b] at pos[b], its argmax at pos[b] + 1, and so on, writing K/V
        through the lane's table.  All [B] tensors on the device, the
        chain stays there.  The write position is clamped to ``max_pos``
        (the lane's last reserved position), so a lane near its budget
        re-writes that position instead of a block it does not hold; an
        idle lane (context_lens 0) keeps lens 0 throughout."""
        live = context_lens > 0
        props = []
        for j in range(k):
            nxt, _lg = self._pools_step(
                pools, tok, torch.minimum(pos + j, max_pos), block_tables,
                torch.where(live, torch.minimum(context_lens + j,
                                                max_pos + 1),
                            torch.zeros_like(context_lens)))
            props.append(nxt)
            tok = nxt
        return torch.stack(props, dim=1)

    @torch.no_grad()
    def unpaged_step(self, k_c, v_c, tok, pos, context_lens):
        """Reference step over contiguous per-lane K/V [L, B, S, H, D],
        written in place at ``pos`` and attended with the same
        ``masked_attention`` core as the paged gather path."""
        tok = tok.long()
        pos = pos.long()
        lanes = torch.arange(k_c.shape[1], device=k_c.device)

        def attend(l, q, k, v):
            k_c[l].index_put_((lanes, pos), k)
            v_c[l].index_put_((lanes, pos), v)
            return masked_attention(q, k_c[l], v_c[l], context_lens)

        logits = self._token_logits(tok, pos, attend)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits

    def unpaged_generate(self, prompt_ids, max_new, pad_len=None, eos_id=-1,
                         return_logits=False):
        """Greedy single-sequence reference loop (no paging, no
        batching): feed the prompt one token per step, then decode
        ``max_new`` tokens.  ``pad_len`` (default max_seq) is the
        contiguous history length; matching the paged path's gathered
        width (MAXB * block_size) makes the two bitwise-comparable on the
        CPU.  Logits come back as numpy arrays when asked for."""
        cfg = self.cfg
        if pad_len is None:
            pad_len = cfg.max_seq
        dev = self.device
        shape = (cfg.layers, 1, pad_len, cfg.heads, cfg.head_dim)
        k_c = torch.zeros(shape, dtype=torch.float32, device=dev)
        v_c = torch.zeros(shape, dtype=torch.float32, device=dev)
        prompt_ids = [int(t) for t in prompt_ids]
        out, logits_hist = [], []
        tok, pos = prompt_ids[0], 0
        while len(out) < max_new:
            nxt, logits = self.unpaged_step(
                k_c, v_c, torch.tensor([tok], dtype=torch.int32, device=dev),
                torch.tensor([pos], dtype=torch.int32, device=dev),
                torch.tensor([pos + 1], dtype=torch.int32, device=dev))
            pos += 1
            if pos < len(prompt_ids):
                tok = prompt_ids[pos]          # still feeding the prompt
                continue
            tok = int(nxt[0])
            out.append(tok)
            if return_logits:
                logits_hist.append(logits[0].cpu().numpy())
            if tok == eos_id:
                break
        return (out, logits_hist) if return_logits else out


def from_jax_params(cfg, params, device=None):
    """A ``Decoder`` from the reference's parameter dict, whose values
    may be numpy or JAX arrays (read through ``np.asarray``)."""
    return Decoder(cfg, {k: np.asarray(v) for k, v in params.items()},
                   device=device)

