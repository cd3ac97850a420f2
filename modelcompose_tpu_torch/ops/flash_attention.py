"""Flash attention: the wrappers of kernels K1 (forward), K3 (dQ) and K4
(dK, dV), their plain versions, and the autograd Function joining them.

K1 (``csrc/flash_attention_fwd.cu``, TMA + wgmma) replaces the Pallas TPU kernel
``modelcompose_tpu/ops/flash_attention.py::_fa_kernel``; K3 and K4
(``csrc/flash_attention_bwd.cu``, TMA + wgmma) replace ``_bwd_dq_kernel``
and ``_bwd_dkv_kernel``.  Ragged batches are segment ids (0 = padding):
attention runs only within equal nonzero segments, optionally causal with
the query offset ``q_offset``.  The TPU's 128-lane padding and lifted
``[B, 8, L]`` segment ids are not carried over: the kernels read ``[B, L]``
segment ids and mask ragged edges themselves.  The LSE crosses from the
forward to the backward at the true Lq.

Numerics (flash-attn-2, as the JAX kernels): bf16 operands, fp32
accumulation and softmax, P cast to bf16 before the P.V and P^T.dO
products, dS cast to bf16 before dS.K and dS^T.Q.  Fully masked (padding)
rows come out of the forward as a mean of V (callers ignore them) and get
zero gradients: the backward masks P by a select, since exp(S - LSE) of a
padding row is not 0.

K1 inside a CUDA graph (the prefill and chunk-step graphs of
core/prefill_graph): a capture records each launch in the thread's
``capturing()`` record instead of counting it, and the graph's owner adds
the recorded launches to ``flash_attention_forward.launches`` at each
replay.  A launch's host work is all baked into what the capture keeps:
the three tensor maps are encoded from the (static) addresses into the
kernel's parameters, and the shared-memory attribute, set by the first
launch outside the capture, stays set.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

from .. import _build

NEG_INF = -1e30


class CaptureRecord:
    """The K1 launches of one CUDA-graph capture, in order, each as
    ``(q shape, k shape, q segment ids, kv segment ids)``: a replay re-runs
    them with no Python call, so the graph's owner counts them.  The
    segment ids are the graph's own tensors (after a replay they hold that
    replay's values); q, k and v are not kept, so the record holds no
    activation memory in the graph's pool."""

    def __init__(self):
        self.launches = []


_CAPTURE = threading.local()


@contextlib.contextmanager
def capturing():
    """Record the K1 launches captured on this thread into a CUDA graph
    while the block runs; yields the ``CaptureRecord``.  A K1 launch made
    while its stream captures, outside this block, raises: no replay of
    that graph would be counted."""
    previous = getattr(_CAPTURE, "record", None)
    record = _CAPTURE.record = CaptureRecord()
    try:
        yield record
    finally:
        _CAPTURE.record = previous


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
    s = torch.where(_mask(q_seg, kv_seg, causal, q_offset, Lq, S, q.device),
                    s, NEG_INF)
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


def _k1_launch(q, k, v, causal, q_segment_ids, kv_segment_ids, q_offset,
               sm_scale, mask_all=False, record=None):
    """Launch K1 on CUDA tensors, with every tile through the mask when
    ``mask_all``; a captured launch goes into ``record``.  (out, lse)."""
    B, Lq, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    q_seg = _segments(q_segment_ids, B, Lq, q.device).contiguous()
    kv_seg = _segments(kv_segment_ids, B, S, q.device).contiguous()
    _check_cuda_inputs(q, k, v, q_seg, kv_seg)
    if record is not None:
        record.launches.append((tuple(q.shape), tuple(k.shape), q_seg,
                                kv_seg))
    lib = _build.load("flash_attention_fwd")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    entry = (lib.mc_flash_attention_fwd_mask_all if mask_all
             else lib.mc_flash_attention_fwd)
    err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_seg.data_ptr(),
                kv_seg.data_ptr(), out.data_ptr(), lse.data_ptr(), B, H, Hkv,
                Lq, S, D, float(_scale(sm_scale, D)), int(bool(causal)),
                int(q_offset), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_fwd")
    return out, lse


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
    record = None
    if torch.cuda.is_current_stream_capturing():
        record = getattr(_CAPTURE, "record", None)
        if record is None:
            raise RuntimeError(
                "flash_attention_forward captured into a CUDA graph outside "
                "flash_attention.capturing(): its replays would not be "
                "counted")
    res = _k1_launch(q, k, v, causal, q_segment_ids, kv_segment_ids,
                     q_offset, sm_scale, record=record)
    if record is None:  # recorded, not run: each replay runs it
        flash_attention_forward.launches += 1
    return res


def flash_attention_forward_mask_all(q, k, v, *, causal: bool = True,
                                     q_segment_ids=None, kv_segment_ids=None,
                                     q_offset: int = 0,
                                     sm_scale: Optional[float] = None):
    """K1 with every kv tile through the per-element mask, for the test
    that holds the unmasked fast path to it on the card.  Not counted as a
    launch."""
    if not q.is_cuda:
        raise ValueError("the masked-path K1 runs only on a CUDA tensor")
    return _k1_launch(q, k, v, causal, q_segment_ids, kv_segment_ids,
                      q_offset, sm_scale, mask_all=True)


# Launches of K1: one per call that ran it, and a replayed graph adds the
# launches its capture recorded (core/decode_graph.CapturedStep).
flash_attention_forward.launches = 0


def _mask(q_seg, kv_seg, causal, q_offset, Lq, S, device):
    """[B, 1, Lq, S] validity: segment match, kv segment != 0, causal."""
    mask = (q_seg[:, :, None] == kv_seg[:, None, :]) & (kv_seg[:, None, :] != 0)
    if causal:
        q_pos = q_offset + torch.arange(Lq, device=device)
        mask = mask & (q_pos[:, None] >= torch.arange(S, device=device))
    return mask[:, None]


def _bwd_scores(q, k, v, do, lse, di, causal, q_segment_ids, kv_segment_ids,
                q_offset, sm_scale):
    """P and dS [B, H, Lq, S] fp32 of the JAX backward kernels, with k/v
    repeated to the q heads."""
    B, Lq, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    q_seg = _segments(q_segment_ids, B, Lq, q.device)
    kv_seg = _segments(kv_segment_ids, B, S, q.device)
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("blhd,bshd->bhls", q.float(), k.float()) * sm_scale
    mask = _mask(q_seg, kv_seg, causal, q_offset, Lq, S, q.device)
    # A select, not an underflow: a padding row's LSE is about -1e30.
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("blhd,bshd->bhls", do.float(), v.float())
    ds = p * (dp - di[..., None]) * sm_scale
    return p, ds, k


def _scale(sm_scale, D):
    return D ** -0.5 if sm_scale is None else sm_scale


def flash_attention_bwd_dq_reference(q, k, v, do, lse, di, *,
                                     causal: bool = True, q_segment_ids=None,
                                     kv_segment_ids=None, q_offset: int = 0,
                                     sm_scale: Optional[float] = None):
    """Plain PyTorch version of K3: dQ [B, Lq, H, D] in q.dtype."""
    _, ds, k_rep = _bwd_scores(q, k, v, do, lse, di, causal, q_segment_ids,
                               kv_segment_ids, q_offset,
                               _scale(sm_scale, q.shape[-1]))
    dq = torch.einsum("bhls,bshd->blhd", ds.to(k.dtype).float(),
                      k_rep.float())
    return dq.to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, di, *,
                                      causal: bool = True, q_segment_ids=None,
                                      kv_segment_ids=None, q_offset: int = 0,
                                      sm_scale: Optional[float] = None):
    """Plain PyTorch version of K4: (dK, dV) [B, S, Hkv, D], each summed
    over its GQA group in fp32."""
    p, ds, _ = _bwd_scores(q, k, v, do, lse, di, causal, q_segment_ids,
                           kv_segment_ids, q_offset,
                           _scale(sm_scale, q.shape[-1]))
    B, S, Hkv, D = k.shape
    group = q.shape[2] // Hkv
    dv = torch.einsum("bhls,blhd->bshd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhls,blhd->bshd", ds.to(q.dtype).float(), q.float())
    dk = dk.reshape(B, S, Hkv, group, D).sum(3)
    dv = dv.reshape(B, S, Hkv, group, D).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


def _di(o, do):
    """Di = rowsum(O * dO) in fp32 from the saved (bf16) output, as the JAX
    wrapper computes it outside the kernels: [B, H, Lq]."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_backward_reference(q, k, v, o, lse, do, *,
                                       causal: bool = True,
                                       q_segment_ids=None,
                                       kv_segment_ids=None,
                                       q_offset: int = 0,
                                       sm_scale: Optional[float] = None):
    """The written-out formula of the JAX ``_flash_attention_backward``
    (not autograd of the forward).  q, o, do: [B, Lq, H, D]; k, v:
    [B, S, Hkv, D]; lse: [B, H, Lq].  Returns (dq, dk, dv)."""
    kw = dict(causal=causal, q_segment_ids=q_segment_ids,
              kv_segment_ids=kv_segment_ids, q_offset=q_offset,
              sm_scale=sm_scale)
    di = _di(o, do)
    dq = flash_attention_bwd_dq_reference(q, k, v, do, lse, di, **kw)
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, do, lse, di, **kw)
    return dq, dk, dv


def _bwd_launch_args(q, k, v, do, lse, di, causal, q_segment_ids,
                     kv_segment_ids, q_offset, sm_scale):
    B, Lq, H, D = q.shape
    S = k.shape[1]
    q_seg = _segments(q_segment_ids, B, Lq, q.device).contiguous()
    kv_seg = _segments(kv_segment_ids, B, S, q.device).contiguous()
    _check_cuda_inputs(q, k, v, q_seg, kv_seg)
    if do.shape != q.shape or do.dtype != q.dtype or not do.is_contiguous() \
            or do.data_ptr() % 16 or do.device != q.device:
        raise ValueError(f"dout {tuple(do.shape)} {do.dtype} must be a "
                         f"contiguous, 16-byte aligned {q.dtype} like q "
                         f"{tuple(q.shape)}")
    for name, t in (("lse", lse), ("di", di)):
        if t.shape != (B, H, Lq) or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be contiguous fp32 [B, H, Lq] "
                             f"on {q.device}")
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), q_seg.data_ptr(),
            kv_seg.data_ptr()), (q_seg, kv_seg), (
        B, H, k.shape[2], Lq, S, D, float(_scale(sm_scale, D)),
        int(bool(causal)), int(q_offset),
        torch.cuda.current_stream(q.device).cuda_stream)


def _k3_launch(q, k, v, do, lse, di, mask_all=False, **kw):
    """Launch K3 on CUDA tensors, with every tile through the mask when
    ``mask_all``: dQ."""
    ptrs, _keep, sizes = _bwd_launch_args(q, k, v, do, lse, di, **kw)
    lib = _build.load("flash_attention_bwd")
    dq = torch.empty_like(q)
    entry = (lib.mc_flash_attention_bwd_dq_mask_all if mask_all
             else lib.mc_flash_attention_bwd_dq)
    _build.check(entry(*ptrs, dq.data_ptr(), *sizes), "flash_attention_bwd_dq")
    return dq


def _k4_launch(q, k, v, do, lse, di, mask_all=False, **kw):
    """Launch K4 on CUDA tensors, with every tile through the mask when
    ``mask_all``: (dK, dV)."""
    ptrs, _keep, sizes = _bwd_launch_args(q, k, v, do, lse, di, **kw)
    lib = _build.load("flash_attention_bwd")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    entry = (lib.mc_flash_attention_bwd_dkv_mask_all if mask_all
             else lib.mc_flash_attention_bwd_dkv)
    _build.check(entry(*ptrs, dk.data_ptr(), dv.data_ptr(), *sizes),
                 "flash_attention_bwd_dkv")
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, di, *, causal: bool = True,
                           q_segment_ids=None, kv_segment_ids=None,
                           q_offset: int = 0,
                           sm_scale: Optional[float] = None):
    """Kernel K3 on a CUDA tensor, its plain version on a CPU tensor."""
    kw = dict(causal=causal, q_segment_ids=q_segment_ids,
              kv_segment_ids=kv_segment_ids, q_offset=q_offset,
              sm_scale=sm_scale)
    if not q.is_cuda:
        return flash_attention_bwd_dq_reference(q, k, v, do, lse, di, **kw)
    dq = _k3_launch(q, k, v, do, lse, di, **kw)
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, do, lse, di, *, causal: bool = True,
                            q_segment_ids=None, kv_segment_ids=None,
                            q_offset: int = 0,
                            sm_scale: Optional[float] = None):
    """Kernel K4 on a CUDA tensor, its plain version on a CPU tensor."""
    kw = dict(causal=causal, q_segment_ids=q_segment_ids,
              kv_segment_ids=kv_segment_ids, q_offset=q_offset,
              sm_scale=sm_scale)
    if not q.is_cuda:
        return flash_attention_bwd_dkv_reference(q, k, v, do, lse, di, **kw)
    res = _k4_launch(q, k, v, do, lse, di, **kw)
    flash_attention_bwd_dkv.launches += 1
    return res


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd_mask_all(q, k, v, do, lse, di, *,
                                 causal: bool = True, q_segment_ids=None,
                                 kv_segment_ids=None, q_offset: int = 0,
                                 sm_scale: Optional[float] = None):
    """K3 and K4 with every tile through the per-element mask, for the test
    that holds their unmasked fast path to it on the card: (dQ, dK, dV).
    Not counted as launches."""
    if not q.is_cuda:
        raise ValueError("the masked-path K3/K4 run only on a CUDA tensor")
    kw = dict(causal=causal, q_segment_ids=q_segment_ids,
              kv_segment_ids=kv_segment_ids, q_offset=q_offset,
              sm_scale=sm_scale)
    return (_k3_launch(q, k, v, do, lse, di, mask_all=True, **kw),
            *_k4_launch(q, k, v, do, lse, di, mask_all=True, **kw))


def flash_attention_backward(q, k, v, o, lse, do, *, causal: bool = True,
                             q_segment_ids=None, kv_segment_ids=None,
                             q_offset: int = 0,
                             sm_scale: Optional[float] = None):
    """(dq, dk, dv): Di in plain torch, then K3 and K4 (their plain versions
    on CPU tensors)."""
    kw = dict(causal=causal, q_segment_ids=q_segment_ids,
              kv_segment_ids=kv_segment_ids, q_offset=q_offset,
              sm_scale=sm_scale)
    do = do.contiguous()
    di = _di(o, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, di, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, di, **kw)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K1 forward; K3 and K4 backward (the JAX ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, causal, q_offset, sm_scale):
        out, lse = flash_attention_forward(
            q, k, v, causal=causal, q_segment_ids=q_seg,
            kv_segment_ids=kv_seg, q_offset=q_offset, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, out, lse, q_seg, kv_seg)
        ctx.args = (causal, q_offset, sm_scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, q_seg, kv_seg = ctx.saved_tensors
        causal, q_offset, sm_scale = ctx.args
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, do, causal=causal, q_segment_ids=q_seg,
            kv_segment_ids=kv_seg, q_offset=q_offset, sm_scale=sm_scale)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, q_segment_ids=None,
                    kv_segment_ids=None, q_offset: int = 0,
                    sm_scale: Optional[float] = None):
    """Public entry, as in the JAX package: the output only, differentiable
    through K3 and K4."""
    B, Lq, _, D = q.shape
    q_seg = _segments(q_segment_ids, B, Lq, q.device)
    kv_seg = _segments(kv_segment_ids, B, k.shape[1], q.device)
    return _FlashAttention.apply(q, k, v, q_seg, kv_seg, bool(causal),
                                 int(q_offset), float(_scale(sm_scale, D)))
