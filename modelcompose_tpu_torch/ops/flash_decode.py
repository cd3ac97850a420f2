"""Flash-decode: the wrapper of kernel K2 and its plain version.

K2 (``csrc/flash_decode.cu``) replaces the Pallas TPU kernel
``modelcompose_tpu/ops/flash_decode.py::_fd_kernel``: single-token attention
per batch row over layer ``layer_idx`` of the layer-stacked KV cache,
masked to ``pos < kv_len[b]``, in one launch (the split-KV partials are
combined by the last block of each row and kv head).  On the TPU that kernel was opt-in and lost
to the XLA loop; on the card the kernel is the decode path, and the loop
(ops/attention.decode_attention) defines its semantics.

Layout contract (core/llama.KVCache):
  q:      [B, 1, H, D]
  cache:  [NL, B, S, Hkv, D] bf16, or {"q": int8, "scale": fp32
          [NL, B, S, Hkv, 1]} with the scales factored out of both
          contractions (k scale on the logits, v scale on the probabilities)
  kv_len: [B] valid entries, the new token's slot included
"""

from __future__ import annotations

import contextlib
import threading

import torch

from .. import _build

NEG_INF = -1e30

# K2's scratch, one set per CUDA stream: the fp32 split partials and the
# int32 counters of the fused combine, one per (row, kv head), which the
# kernel leaves at zero.  Launches on one stream run one after another (a
# decode step's layers), so they share it; a launch on another stream gets
# its own.  A stream keeps only its last shape's set.  A launch captured
# into a CUDA graph takes its scratch from the capture's record instead
# (``capturing``): a set replaced here would be freed under the graph.
_SCRATCH = {}


def _new_scratch(device, B: int, H: int, Hkv: int, n_splits: int, D: int):
    return (torch.empty((B, H, n_splits), dtype=torch.float32, device=device),
            torch.empty((B, H, n_splits), dtype=torch.float32, device=device),
            torch.empty((B, H, n_splits, D), dtype=torch.float32,
                        device=device),
            torch.zeros(B * Hkv, dtype=torch.int32, device=device))


def _scratch(device, stream: int, B: int, H: int, Hkv: int, n_splits: int,
             D: int):
    """(m, l [B, H, n_splits], acc [B, H, n_splits, D] fp32, counters
    [B * Hkv] zeroed int32) for this launch shape on ``stream``."""
    shape = (B, H, Hkv, n_splits, D)
    cached = _SCRATCH.get((device, stream))
    if cached is None or cached[0] != shape:
        cached = _SCRATCH[(device, stream)] = (
            shape, _new_scratch(device, *shape))
    return cached[1]


class CaptureRecord:
    """The K2 launches of one CUDA-graph capture: each launch's inputs
    ``(q, k, v, k_scale, v_scale, kv_len)`` in order (a replay re-runs them
    with no Python call, so the graph's owner counts them), and the
    scratch they wrote, one set per shape, which lives as long as this
    record: the graph's owner keeps the record as long as the graph."""

    def __init__(self):
        self.launches = []
        self._scratch = {}

    def scratch(self, device, *shape):
        if shape not in self._scratch:
            self._scratch[shape] = _new_scratch(device, *shape)
        return self._scratch[shape]


_CAPTURE = threading.local()


@contextlib.contextmanager
def capturing():
    """Record the K2 launches captured on this thread into a CUDA graph
    while the block runs; yields the ``CaptureRecord``.  A K2 launch made
    while its stream captures, outside this block, raises: its scratch
    would not outlive the shape's next launch."""
    previous = getattr(_CAPTURE, "record", None)
    record = _CAPTURE.record = CaptureRecord()
    try:
        yield record
    finally:
        _CAPTURE.record = previous


def _parts(cache):
    if isinstance(cache, dict):
        return cache["q"], cache["scale"]
    return cache, None


def flash_decode_reference(q, k_cache, v_cache, kv_len, layer_idx: int, *,
                           sm_scale: float):
    """Plain PyTorch version of K2 (one softmax over the whole layer), for
    CPU tensors and for checking the kernel.  Returns [B, 1, H, D]."""
    k_q, k_s = _parts(k_cache)
    v_q, v_s = _parts(v_cache)
    B, _, H, D = q.shape
    S, Hkv = k_q.shape[2], k_q.shape[3]
    rep = H // Hkv

    def heads(x):  # [B, S, Hkv, last] of this layer -> [B, S, H, last] fp32
        return x[layer_idx].float().repeat_interleave(rep, dim=2)

    qf = q[:, 0].float() * sm_scale
    logits = torch.einsum("bhd,bshd->bhs", qf, heads(k_q))
    if k_s is not None:
        logits = logits * heads(k_s)[..., 0].transpose(1, 2)
    valid = (torch.arange(S, device=q.device)[None]
             < kv_len.to(q.device)[:, None])
    logits = torch.where(valid[:, None, :], logits, NEG_INF)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    l = p.sum(-1)
    if v_s is not None:
        p = p * heads(v_s)[..., 0].transpose(1, 2)
    acc = torch.einsum("bhs,bshd->bhd", p, heads(v_q))
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)[:, None]


def _check_cuda_inputs(q, k_q, v_q, k_s, v_s, kv_len):
    B, one, H, D = q.shape
    if one != 1:
        raise ValueError(f"decode takes one query token, got {one}")
    if k_q.dim() != 5 or k_q.shape != v_q.shape or k_q.shape[1] != B \
            or k_q.shape[4] != D:
        raise ValueError(f"cache {tuple(k_q.shape)} does not match q "
                         f"{tuple(q.shape)}")
    Hkv = k_q.shape[3]
    if H % Hkv or H // Hkv not in (1, 2, 4, 8):
        raise ValueError(f"flash-decode kernel takes GQA groups 1/2/4/8, "
                         f"not {H}/{Hkv}")
    if D not in (64, 128):
        raise ValueError(f"flash-decode kernel takes head_dim 64 or 128, "
                         f"not {D}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"flash-decode kernel takes a bf16 q, got {q.dtype}")
    quantized = k_s is not None
    want = torch.int8 if quantized else torch.bfloat16
    tensors = [("q", q), ("k", k_q), ("v", v_q), ("kv_len", kv_len)]
    if quantized:
        tensors += [("k scale", k_s), ("v scale", v_s)]
        if k_s.dtype != torch.float32 or v_s.dtype != torch.float32 \
                or k_s.shape != k_q.shape[:4] + (1,) \
                or v_s.shape != k_s.shape:
            raise ValueError(
                "int8 cache scales must be fp32 [NL, B, S, Hkv, 1]")
    if k_q.dtype != want or v_q.dtype != want:
        raise TypeError(f"cache must be bf16 or int8 with scales, got "
                        f"{k_q.dtype}/{v_q.dtype}")
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if kv_len.shape != (B,) or kv_len.dtype != torch.int32:
        raise ValueError("kv_len must be int32 [B]")


def flash_decode_attention(q, k_cache, v_cache, kv_len, layer_idx: int, *,
                           sm_scale: float):
    """Kernel K2 on a CUDA tensor, its plain version on a CPU tensor.
    Any cache length S is taken.  Returns [B, 1, H, D] in q.dtype."""
    if not q.is_cuda:
        return flash_decode_reference(q, k_cache, v_cache, kv_len, layer_idx,
                                      sm_scale=sm_scale)
    k_q, k_s = _parts(k_cache)
    v_q, v_s = _parts(v_cache)
    _check_cuda_inputs(q, k_q, v_q, k_s, v_s, kv_len)
    NL, B, S, Hkv, D = k_q.shape
    H = q.shape[2]
    if not 0 <= int(layer_idx) < NL:
        raise ValueError(f"layer_idx {layer_idx} outside the {NL}-layer cache")
    lib = _build.load("flash_decode")
    n_splits = -(-S // lib.mc_flash_decode_split_len())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    record = None
    if torch.cuda.is_current_stream_capturing():
        record = getattr(_CAPTURE, "record", None)
        if record is None:
            raise RuntimeError(
                "flash_decode_attention captured into a CUDA graph outside "
                "flash_decode.capturing(): its scratch would be freed "
                "while the graph still uses it")
        scratch = record.scratch(q.device, B, H, Hkv, n_splits, D)
    else:
        scratch = _scratch(q.device, stream, B, H, Hkv, n_splits, D)
    part_m, part_l, part_acc, counters = scratch
    out = torch.empty_like(q)
    quantized = k_s is not None
    err = lib.mc_flash_decode(
        q.data_ptr(), k_q.data_ptr(), v_q.data_ptr(),
        k_s.data_ptr() if quantized else None,
        v_s.data_ptr() if quantized else None, kv_len.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
        counters.data_ptr(), out.data_ptr(), NL, B, H, Hkv, S, D,
        int(layer_idx), int(quantized),
        float(sm_scale), stream)
    _build.check(err, "flash_decode")
    if record is not None:  # recorded, not run: each replay runs it
        record.launches.append((q, k_q, v_q, k_s, v_s, kv_len))
    else:
        flash_decode_attention.launches += 1
    return out


# Launches of K2: one per call that ran it, and a replayed graph adds the
# launches its capture recorded (core/decode_graph).
flash_decode_attention.launches = 0
