"""Attention ops: the plain PyTorch versions and the dispatchers
(counterpart of modelcompose_tpu/ops/attention.py).

Ragged batches are segment ids (0 = padding, real tokens >= 1); attention
is allowed only within matching segments, optionally causal.

``attention()`` goes through the flash-attention autograd Function (K1
forward, K3/K4 backward; ops/flash_attention.py) and ``decode_attention()``
through K2 (ops/flash_decode.py): each launches its kernel on a CUDA
tensor and runs the kernel's plain version on a CPU tensor, as the JAX
package runs its Pallas kernels in interpret mode off the TPU.
``impl="reference"`` asks for the plain attention on any device,
differentiated by torch autograd, to check the kernel path against it.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _route

NEG_INF = -1e30


def attention_reference(q, k, v, *, causal: bool = True,
                        q_segment_ids=None, kv_segment_ids=None,
                        q_offset: int = 0, sm_scale: Optional[float] = None):
    """Plain attention with an fp32 softmax (HF eager semantics).

    q: [B, Lq, H, D]; k, v: [B, S, Hkv, D]; segment ids [B, Lq] / [B, S]
    (0 = padding) or None; q_offset: absolute position of q[0] on the kv
    axis.  Returns [B, Lq, H, D] in q.dtype."""
    B, Lq, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = D ** -0.5
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    logits = torch.einsum("blhd,bshd->bhls", q.float(), k.float()) * sm_scale
    mask = torch.ones((B, 1, Lq, S), dtype=torch.bool, device=q.device)
    if causal:
        q_pos = q_offset + torch.arange(Lq, device=q.device)[:, None]
        mask = mask & (q_pos >= torch.arange(S, device=q.device)[None, :])
    if q_segment_ids is not None and kv_segment_ids is not None:
        seg = q_segment_ids[:, :, None] == kv_segment_ids[:, None, :]
        seg = seg & (kv_segment_ids[:, None, :] != 0)
        mask = mask & seg[:, None]
    elif kv_segment_ids is not None:
        mask = mask & (kv_segment_ids[:, None, None, :] != 0)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhls,bshd->blhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def attention(q, k, v, *, causal: bool = True, q_segment_ids=None,
              kv_segment_ids=None, q_offset: int = 0,
              sm_scale: Optional[float] = None, impl: str = "auto"):
    """impl: 'auto' (the flash path: the kernels on a CUDA tensor, their
    plain versions on a CPU tensor) or 'reference' (plain attention)."""
    if impl == "auto":
        from .flash_attention import flash_attention
        return flash_attention(
            q, k, v, causal=causal, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, q_offset=q_offset,
            sm_scale=sm_scale)
    if impl != "reference":
        raise ValueError(f"unknown attention impl {impl!r}")
    return attention_reference(
        q, k, v, causal=causal, q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids, q_offset=q_offset, sm_scale=sm_scale)


def decode_attention(q, k_cache, v_cache, kv_len, *, sm_scale=None,
                     chunk: int = 512, layer_idx: Optional[int] = None,
                     impl: str = "auto"):
    """Single-token attention against a preallocated KV cache.

    q: [B, 1, H, D]; k_cache/v_cache: [B, S, Hkv, D] tensors or int8 dicts
    {'q': int8, 'scale': [..., Hkv, 1]}; with ``layer_idx`` they carry a
    leading layer axis ([NL, B, S, Hkv, D]) and only that layer is read.
    kv_len: [B] or scalar valid entries (the new token's slot included).

    On a CUDA tensor (impl 'auto') this is kernel K2.  Otherwise it is the
    JAX package's chunked loop, eagerly: running max/sum accumulators over
    ``chunk``-position slices, the last chunk's start clamped to S - C and
    an owned-range mask so the overlap is not counted twice; the int8
    scales factor out of both contractions.
    """
    B, _, H, D = q.shape
    kv_len = torch.as_tensor(kv_len, device=q.device).to(torch.int32)
    if kv_len.dim() == 0:
        kv_len = kv_len.expand(B)
    if sm_scale is None:
        sm_scale = D ** -0.5
    if layer_idx is None:  # a per-layer cache is a one-layer stack
        def stack(c):
            return {n: x[None] for n, x in c.items()} if isinstance(c, dict) \
                else c[None]
        k_cache, v_cache, layer_idx = stack(k_cache), stack(v_cache), 0
    if impl == "auto" and _route.on_card(q, "attention"):
        from .flash_decode import flash_decode_attention
        return flash_decode_attention(q, k_cache, v_cache,
                                      kv_len.contiguous(), layer_idx,
                                      sm_scale=sm_scale)
    if impl not in ("auto", "reference"):
        raise ValueError(f"unknown attention impl {impl!r}")

    k_q, k_s = (k_cache["q"], k_cache["scale"]) \
        if isinstance(k_cache, dict) else (k_cache, None)
    v_q, v_s = (v_cache["q"], v_cache["scale"]) \
        if isinstance(v_cache, dict) else (v_cache, None)
    S, Hkv = k_q.shape[2], k_q.shape[3]
    rep = H // Hkv
    C = min(chunk, S)
    n_chunks = (S + C - 1) // C
    qf = q[:, 0].float() * sm_scale  # [B, H, D]

    def read(x, start):  # [B, C, H, last] fp32 chunk of this layer
        c = x[layer_idx, :, start:start + C].float()
        return c if rep == 1 else c.repeat_interleave(rep, dim=2)

    m = torch.full((B, H), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, D), dtype=torch.float32, device=q.device)
    for i in range(n_chunks):
        start = min(i * C, S - C)
        logits = torch.einsum("bhd,bchd->bhc", qf, read(k_q, start))
        if k_s is not None:
            logits = logits * read(k_s, start)[..., 0].transpose(1, 2)
        pos = start + torch.arange(C, device=q.device)
        valid = (pos[None] >= i * C) & (pos[None] < kv_len[:, None])
        logits = torch.where(valid[:, None, :], logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * corr + p.sum(-1)
        if v_s is not None:
            p = p * read(v_s, start)[..., 0].transpose(1, 2)
        acc = acc * corr[..., None] + torch.einsum("bhc,bchd->bhd", p,
                                                   read(v_q, start))
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)[:, None]
