"""Flash-attention forward: the wrapper of kernel K1 and its plain version.

K1 (``csrc/flash_attention_fwd.cu``) replaces the Pallas TPU kernel
``modelcompose_tpu/ops/flash_attention.py::_fa_kernel``.  Ragged batches are
segment ids (0 = padding): attention runs only within equal nonzero
segments, optionally causal with the query offset ``q_offset``.  The TPU's
128-lane padding and lifted ``[B, 8, L]`` segment ids are not carried over:
the kernel reads ``[B, L]`` segment ids and masks ragged edges itself.

Numerics (flash-attn-2, as the JAX kernel): bf16 operands, fp32
accumulation and softmax, P cast to bf16 before the P.V product.  Fully
masked (padding) rows come out as a mean of V; callers ignore them.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build

NEG_INF = -1e30


def _segments(seg, B, L, device):
    if seg is None:
        return torch.ones((B, L), dtype=torch.int32, device=device)
    return seg.to(device=device, dtype=torch.int32)


def flash_attention_reference(q, k, v, *, causal: bool = True,
                              q_segment_ids=None, kv_segment_ids=None,
                              q_offset: int = 0,
                              sm_scale: Optional[float] = None):
    """Plain PyTorch version of K1, for CPU tensors and for checking the
    kernel.  q: [B, Lq, H, D]; k, v: [B, S, Hkv, D].
    Returns (out [B, Lq, H, D] in q.dtype, lse [B, H, Lq] fp32)."""
    B, Lq, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = D ** -0.5
    q_seg = _segments(q_segment_ids, B, Lq, q.device)
    kv_seg = _segments(kv_segment_ids, B, S, q.device)
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("blhd,bshd->bhls", q.float(), k.float()) * sm_scale
    mask = (q_seg[:, :, None] == kv_seg[:, None, :]) & (kv_seg[:, None, :] != 0)
    if causal:
        q_pos = q_offset + torch.arange(Lq, device=q.device)
        mask = mask & (q_pos[:, None] >= torch.arange(S, device=q.device))
    s = torch.where(mask[:, None], s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    # P in the operand dtype for the second product (the kernel's cast).
    o = torch.einsum("bhls,bshd->bhld", p.to(v.dtype).float(), v.float()) / l
    lse = (m + torch.log(l))[..., 0]
    return o.transpose(1, 2).to(q.dtype), lse


def _check_cuda_inputs(q, k, v, q_seg, kv_seg):
    B, Lq, H, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"{H} q heads not a multiple of {k.shape[2]} kv heads")
    if D not in (64, 128):
        raise ValueError(f"flash-attention kernel takes head_dim 64 or 128, "
                         f"not {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash-attention kernel takes bf16 {name}, "
                            f"got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    for name, t in (("q", q), ("k", k), ("v", v), ("q_seg", q_seg),
                    ("kv_seg", kv_seg)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q_seg.shape != (B, Lq) or kv_seg.shape != (B, k.shape[1]):
        raise ValueError("segment ids must be [B, Lq] and [B, S]")


def flash_attention_forward(q, k, v, *, causal: bool = True,
                            q_segment_ids=None, kv_segment_ids=None,
                            q_offset: int = 0,
                            sm_scale: Optional[float] = None):
    """Kernel K1 on a CUDA tensor, its plain version on a CPU tensor.
    Returns (out [B, Lq, H, D], lse [B, H, Lq] fp32)."""
    if not q.is_cuda:
        return flash_attention_reference(
            q, k, v, causal=causal, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, q_offset=q_offset,
            sm_scale=sm_scale)
    B, Lq, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = D ** -0.5
    q_seg = _segments(q_segment_ids, B, Lq, q.device).contiguous()
    kv_seg = _segments(kv_segment_ids, B, S, q.device).contiguous()
    _check_cuda_inputs(q, k, v, q_seg, kv_seg)
    lib = _build.load("flash_attention_fwd")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    err = lib.mc_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_seg.data_ptr(),
        kv_seg.data_ptr(), out.data_ptr(), lse.data_ptr(), B, H, Hkv, Lq, S,
        D, float(sm_scale), int(bool(causal)), int(q_offset),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_fwd")
    flash_attention_forward.launches += 1
    return out, lse


flash_attention_forward.launches = 0


def flash_attention(q, k, v, *, causal: bool = True, q_segment_ids=None,
                    kv_segment_ids=None, q_offset: int = 0,
                    sm_scale: Optional[float] = None):
    """Public entry, as in the JAX package: the output only."""
    return flash_attention_forward(
        q, k, v, causal=causal, q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids, q_offset=q_offset,
        sm_scale=sm_scale)[0]
