"""The decode layer's elementwise passes, fused: the wrappers of kernels K8,
K9 and K10 (``csrc/decode_fused.cu``) and their plain versions.

The JAX package runs a decode step as one jitted XLA program
(modelcompose_tpu/core/generate.py ``_decode_step``), and XLA fuses each
layer's elementwise work into a few fusions: the residual adds with
RMSNorm, RoPE with the int8 KV quantize and the cache scatter, and
``silu(gate) * up``.  These are their counterparts on the card, one launch
each, called by ``core/llama``'s fused decode layer:

- K8 ``add_rms_norm(x, y, weight, eps)``: ``(x + y, rms_norm(x + y))``, or
  ``(x, rms_norm(x))`` with no ``y``;
- K9 ``rope_kv_write(q, k, v, cos, sin, cache_k, cache_v, layer_idx,
  pos)``: q and k rotated, k and v written (int8 with per-vector scales,
  or the activations' type) at ``cache[layer_idx, b, pos[b]]`` in place;
  returns the rotated q;
- K10 ``silu_mul(gate, up)``: ``silu(gate) * up``.

Each plain version is the composition of the port's own ops that the
unfused decode layer runs (``ops/norms.rms_norm``, ``ops/rope.apply_rope``,
``ops/quant.quantize_int8`` and the indexed cache writes, ``F.silu``), and
each kernel computes the same arithmetic: K9 and K10 bit for bit, K8's sum
bit for bit and its normed value within one unit in the last place (the sum
of squares is taken in another order).  A wrapper takes the plain version
for a CPU tensor; on a CUDA tensor it launches the kernel or raises (a type,
shape or layout the kernel does not take).  The kernels take bf16 or fp16
activations; the decode layer sends fp32 activations to the plain ops on
every device (``fused_decode``), the rule by dtype of ``ops/quant``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import _build
from . import quant
from .flash_decode import _parts
from .norms import rms_norm
from .rope import apply_rope

_HALF = (torch.bfloat16, torch.float16)
_NORM_MAX_H = 8192  # K8 holds a row in registers: 256 threads x 4 vectors
_HEAD_DIMS = (64, 128)


def _on_card(x: torch.Tensor) -> bool:
    """Whether the kernels take x: a CUDA tensor (the CPU takes the plain
    version)."""
    return x.is_cuda


def fused_decode(x: torch.Tensor, attn_impl: str) -> bool:
    """Whether a decode step on activations ``x`` runs the fused passes:
    ``attn_impl`` "auto" on the card (``_on_card``) with bf16 or fp16
    activations.  "reference" (the plain path), the CPU and fp32
    activations run the unfused ops."""
    return attn_impl == "auto" and _on_card(x) and x.dtype in _HALF


# ---------------------------------------------------------------- plain

def add_rms_norm_reference(x, y, weight, eps: float):
    """K8's plain version: (x + y, rms_norm(x + y)), or (x, rms_norm(x))."""
    s = x if y is None else x + y
    return s, rms_norm(s, weight, eps)


def write_token(cache, layer_idx: int, pos, val):
    """``cache[layer_idx, b, pos[b]] = val[b, 0]`` in place, for a cache of
    the activations' type or an int8 one ({"q", "scale"}: ``val``
    quantized per head vector): the unfused decode step's cache write."""
    rows = torch.arange(val.shape[0], device=val.device)
    if isinstance(cache, dict):
        qval = quant.quantize_int8(val, axis=-1)
        parts = [(cache[part], qval[part]) for part in cache]
    else:
        parts = [(cache, val)]
    for c, v in parts:
        c[layer_idx, rows, pos] = v[:, 0].to(c.dtype)


def rope_kv_write_reference(q, k, v, cos, sin, cache_k, cache_v,
                            layer_idx: int, pos):
    """K9's plain version: ``apply_rope`` on q and k, k and v written at
    their slots; returns the rotated q."""
    q, k = apply_rope(q, k, cos, sin)
    write_token(cache_k, layer_idx, pos, k)
    write_token(cache_v, layer_idx, pos, v)
    return q


def silu_mul_reference(gate, up):
    """K10's plain version: ``F.silu(gate) * up``."""
    return F.silu(gate) * up


# ---------------------------------------------------------------- checks

def _check_half(name, t, dtype=None):
    if t.dtype not in _HALF:
        raise TypeError(f"{name}: the fused decode kernels take bf16 or fp16, "
                        f"got {t.dtype}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, the activations {dtype}")


def _check_dense(name, t, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the activations on "
                         f"{device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _record(kind: str, shape) -> bool:
    """Record a launch into the capturing graph's record (``quant.
    capturing``), or count it now; True if it was recorded."""
    record = quant._capture_record(kind)
    if record is not None:  # recorded, not run: each replay runs it
        getattr(record, {"add_rms_norm": "norm", "rope_kv_write": "rope",
                         "silu_mul": "silu"}[kind]).append(shape)
        return True
    return False


# ---------------------------------------------------------------- K8

def _k8(x, y, weight, eps: float):
    """Kernel K8 on x [..., H] (and y): (sum, normed), one launch."""
    _check_half("x", x)
    H = x.shape[-1]
    if H % 8 or H > _NORM_MAX_H:
        raise ValueError(f"K8 takes H % 8 == 0 and H <= {_NORM_MAX_H}, "
                         f"got {H}")
    _check_dense("x", x, x.device)
    _check_half("weight", weight, x.dtype)
    if weight.shape != (H,):
        raise ValueError(f"K8 takes a weight of [{H}], got "
                         f"{tuple(weight.shape)}")
    _check_dense("weight", weight, x.device)
    if y is not None:
        _check_half("y", y, x.dtype)
        if y.shape != x.shape:
            raise ValueError(f"y {tuple(y.shape)} != x {tuple(x.shape)}")
        _check_dense("y", y, x.device)
    M = x.numel() // H
    out = torch.empty_like(x)
    total = x if y is None else torch.empty_like(x)
    err = _build.load("decode_fused").mc_add_rms_norm(
        x.data_ptr(), None if y is None else y.data_ptr(), weight.data_ptr(),
        None if y is None else total.data_ptr(), out.data_ptr(), M, H,
        float(eps), int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "add_rms_norm")
    if not _record("add_rms_norm", (M, H)):
        add_rms_norm.launches += 1
    return total, out


def add_rms_norm(x: torch.Tensor, y: Optional[torch.Tensor],
                 weight: torch.Tensor, eps: float = 1e-5):
    """(x + y, rms_norm(x + y, weight, eps)), or (x, rms_norm(x)) where y
    is None: kernel K8 on a CUDA tensor, its plain version on a CPU one."""
    if not _on_card(x):
        return add_rms_norm_reference(x, y, weight, eps)
    return _k8(x, y, weight, eps)


# ---------------------------------------------------------------- K9

def _k9(q, k, v, cos, sin, cache_k, cache_v, layer_idx: int, pos):
    """Kernel K9: q [B, 1, H, D], k and v [B, 1, Hkv, D], cos and sin
    [B, 1, D] fp32, caches [NL, B, S, Hkv, D] (int8 with fp32 scales
    [NL, B, S, Hkv, 1], or q's type), pos [B] int32 or int64 on the card.
    One launch; returns the rotated q."""
    _check_half("q", q)
    B, one, H, D = q.shape
    if one != 1:
        raise ValueError(f"K9 takes one token a row, got {one}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"K9 takes head_dim 64 or 128, not {D}")
    Hkv = k.shape[2]
    for name, t in (("k", k), ("v", v)):
        _check_half(name, t, q.dtype)
        if t.shape != (B, 1, Hkv, D):
            raise ValueError(f"{name} {tuple(t.shape)} does not match "
                             f"[{B}, 1, {Hkv}, {D}]")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_dense(name, t, q.device)
    for name, t in (("cos", cos), ("sin", sin)):
        if t.dtype != torch.float32 or t.shape != (B, 1, D):
            raise ValueError(f"K9 takes fp32 {name} [{B}, 1, {D}], got "
                             f"{t.dtype} {tuple(t.shape)}")
        _check_dense(name, t, q.device)
    if pos.dtype not in (torch.int32, torch.int64) or pos.shape != (B,):
        raise ValueError(f"K9 takes int32 or int64 positions [{B}], got "
                         f"{pos.dtype} {tuple(pos.shape)}")
    _check_dense("pos", pos, q.device)
    kq, ks = _parts(cache_k)
    vq, vs = _parts(cache_v)
    int8 = ks is not None
    if (vs is not None) != int8:
        raise ValueError("K9 takes two int8 caches or two of q's type")
    want = torch.int8 if int8 else q.dtype
    NL, _, S = kq.shape[:3]
    for name, t in (("cache k", kq), ("cache v", vq)):
        if t.dtype != want or t.shape != (NL, B, S, Hkv, D):
            raise ValueError(f"{name} {t.dtype} {tuple(t.shape)}: K9 takes "
                             f"{want} [{NL}, {B}, {S}, {Hkv}, {D}]")
        _check_dense(name, t, q.device)
    if int8:
        for name, t in (("k scale", ks), ("v scale", vs)):
            if t.dtype != torch.float32 or t.shape != (NL, B, S, Hkv, 1):
                raise ValueError(f"{name}: K9 takes fp32 [{NL}, {B}, {S}, "
                                 f"{Hkv}, 1], got {t.dtype} "
                                 f"{tuple(t.shape)}")
            _check_dense(name, t, q.device)
    if not 0 <= int(layer_idx) < NL:
        raise ValueError(f"layer_idx {layer_idx} outside the {NL}-layer "
                         f"cache")
    q_out = torch.empty_like(q)
    err = _build.load("decode_fused").mc_rope_kv_write(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), q_out.data_ptr(), kq.data_ptr(), vq.data_ptr(),
        ks.data_ptr() if int8 else None, vs.data_ptr() if int8 else None,
        pos.data_ptr(), int(pos.dtype == torch.int64), B, S, H, Hkv, D,
        int(layer_idx), int(int8), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "rope_kv_write")
    if not _record("rope_kv_write", (B, H, Hkv, D, S, int8)):
        rope_kv_write.launches += 1
    return q_out


def rope_kv_write(q, k, v, cos, sin, cache_k, cache_v, layer_idx: int,
                  pos):
    """Rotate q and k (``apply_rope``), write k and v at ``cache[layer_idx,
    b, pos[b]]`` in place (quantized per head vector into an int8 cache);
    returns the rotated q.  Kernel K9 on a CUDA tensor (one launch; ``pos``
    is read on the card, so a captured step replays with each step's
    positions), its plain version on a CPU one."""
    if not _on_card(q):
        return rope_kv_write_reference(q, k, v, cos, sin, cache_k, cache_v,
                                       layer_idx, pos)
    return _k9(q, k, v, cos, sin, cache_k, cache_v, layer_idx, pos)


# ---------------------------------------------------------------- K10

def _k10(gate, up):
    """Kernel K10 on gate and up [..., I] (I % 8 == 0): one launch."""
    _check_half("gate", gate)
    _check_half("up", up, gate.dtype)
    if up.shape != gate.shape:
        raise ValueError(f"up {tuple(up.shape)} != gate "
                         f"{tuple(gate.shape)}")
    if gate.shape[-1] % 8:
        raise ValueError(f"K10 takes a last axis % 8 == 0, got "
                         f"{gate.shape[-1]}")
    for name, t in (("gate", gate), ("up", up)):
        _check_dense(name, t, gate.device)
    out = torch.empty_like(gate)
    n = gate.numel()
    err = _build.load("decode_fused").mc_silu_mul(
        gate.data_ptr(), up.data_ptr(), out.data_ptr(), n,
        int(gate.dtype == torch.bfloat16),
        torch.cuda.current_stream(gate.device).cuda_stream)
    _build.check(err, "silu_mul")
    if not _record("silu_mul", tuple(gate.shape)):
        silu_mul.launches += 1
    return out


def silu_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``silu(gate) * up`` (silu rounded to the activations' type before
    the product): kernel K10 on a CUDA tensor, its plain version on a CPU
    one."""
    if not _on_card(gate):
        return silu_mul_reference(gate, up)
    return _k10(gate, up)


# Launches of K8, K9 and K10: one per call that ran the kernel; a replayed
# graph adds the launches its capture recorded (core/decode_graph).
add_rms_norm.launches = 0
rope_kv_write.launches = 0
silu_mul.launches = 0
