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

At 1-2 rows K8, K9 and K10 run inside the K5 launch next to them instead
(``csrc/w8a16_gemv.cu`` ``mc_w8a16_gemv_norm``, ``mc_w8a16_gemv_silu``):
``norm_matmul_group`` puts K8 in the prologue of the grouped int8 product
of its output (a layer's gate/up, or q/k/v), ``norm_qkv_rope`` also K9 in
the q/k/v launch's epilogue, both bit-equal to K8, the grouped K5 and K9
launched in turn; ``silu_matmul`` puts K10 in the prologue of the down
product, bit-equal to K10 and the streaming K5 in turn.
``ops/routed_lora.routed_lora_norm_group`` routes by ``norm_fuses`` and
``rope_fuses``, ``routed_lora_silu`` by ``silu_fuses``;
``norm_matmul_group_reference`` and ``silu_matmul_reference`` are the plain
versions.

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

import ctypes
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F

from .. import _build
from . import _route, quant
from .flash_decode import _parts
from .norms import rms_norm
from .rope import apply_rope

_NORM_MAX_H = 8192  # K8 holds a row in registers: 256 threads x 4 vectors
_HEAD_DIMS = (64, 128)


def fused_decode(x: torch.Tensor, attn_impl: str) -> bool:
    """Whether a decode step on activations ``x`` runs the fused passes:
    ``attn_impl`` "auto" on the card with bf16 or fp16 activations.
    "reference" (the plain path), the CPU and fp32 activations run the
    unfused ops."""
    return attn_impl == "auto" and _route.on_card(x, "decode") \
        and x.dtype in _route.HALF


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
    if t.dtype not in _route.HALF:
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
                         "silu_mul": "silu", "norm_matmul_group":
                         "norm_group", "norm_qkv_rope": "norm_rope",
                         "silu_matmul": "silu_group"}[kind]
                ).append(shape)
        return True
    return False


# ---------------------------------------------------------------- K8

def _check_norm(x, y, weight):
    """Raise on what K8 (alone or in K5's prologue) does not take: x [...,
    H] bf16/fp16 contiguous and 16-byte aligned, H % 8 == 0, H <= 8,192;
    y (or None) and the weight [H] of x's type, the same."""
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


def _k8(x, y, weight, eps: float):
    """Kernel K8 on x [..., H] (and y): (sum, normed), one launch."""
    _check_norm(x, y, weight)
    H = x.shape[-1]
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
    if not _route.on_card(x, "decode"):
        return add_rms_norm_reference(x, y, weight, eps)
    return _k8(x, y, weight, eps)


# ---------------------------------------------------------------- K9

def _check_rope(cos, sin, cache_k, cache_v, layer_idx: int, pos, B: int,
                Hkv: int, D: int, dtype, device):
    """Raise on what K9 (alone or in K5's epilogue) does not take besides
    q, k and v: cos and sin [B, 1, D] fp32, pos [B] int32 or int64, caches
    [NL, B, S, Hkv, D] both int8 (with fp32 scales [NL, B, S, Hkv, 1]) or
    both of the activations' type, layer_idx inside the cache, all
    contiguous on ``device``.  Returns (k values, k scales or None, v
    values, v scales or None, S)."""
    for name, t in (("cos", cos), ("sin", sin)):
        if t.dtype != torch.float32 or t.shape != (B, 1, D):
            raise ValueError(f"K9 takes fp32 {name} [{B}, 1, {D}], got "
                             f"{t.dtype} {tuple(t.shape)}")
        _check_dense(name, t, device)
    if pos.dtype not in (torch.int32, torch.int64) or pos.shape != (B,):
        raise ValueError(f"K9 takes int32 or int64 positions [{B}], got "
                         f"{pos.dtype} {tuple(pos.shape)}")
    _check_dense("pos", pos, device)
    kq, ks = _parts(cache_k)
    vq, vs = _parts(cache_v)
    int8 = ks is not None
    if (vs is not None) != int8:
        raise ValueError("K9 takes two int8 caches or two of q's type")
    want = torch.int8 if int8 else dtype
    NL, _, S = kq.shape[:3]
    for name, t in (("cache k", kq), ("cache v", vq)):
        if t.dtype != want or t.shape != (NL, B, S, Hkv, D):
            raise ValueError(f"{name} {t.dtype} {tuple(t.shape)}: K9 takes "
                             f"{want} [{NL}, {B}, {S}, {Hkv}, {D}]")
        _check_dense(name, t, device)
    if int8:
        for name, t in (("k scale", ks), ("v scale", vs)):
            if t.dtype != torch.float32 or t.shape != (NL, B, S, Hkv, 1):
                raise ValueError(f"{name}: K9 takes fp32 [{NL}, {B}, {S}, "
                                 f"{Hkv}, 1], got {t.dtype} "
                                 f"{tuple(t.shape)}")
            _check_dense(name, t, device)
    if not 0 <= int(layer_idx) < NL:
        raise ValueError(f"layer_idx {layer_idx} outside the {NL}-layer "
                         f"cache")
    return kq, ks, vq, vs, S


def _check_k9(q, k, v, cos, sin, cache_k, cache_v, layer_idx: int, pos):
    """Raise on what K9 does not take: q [B, 1, H, D] bf16/fp16 (D 64 or
    128), k and v [B, 1, Hkv, D] of q's type, all contiguous, and the rest
    as ``_check_rope`` says.  Returns its values."""
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
    return _check_rope(cos, sin, cache_k, cache_v, layer_idx, pos, B, Hkv,
                       D, q.dtype, q.device)


def _k9(q, k, v, cos, sin, cache_k, cache_v, layer_idx: int, pos):
    """Kernel K9: q [B, 1, H, D], k and v [B, 1, Hkv, D], cos and sin
    [B, 1, D] fp32, caches [NL, B, S, Hkv, D] (int8 with fp32 scales
    [NL, B, S, Hkv, 1], or q's type), pos [B] int32 or int64 on the card.
    One launch; returns the rotated q."""
    kq, ks, vq, vs, S = _check_k9(q, k, v, cos, sin, cache_k, cache_v,
                                  layer_idx, pos)
    B, _, H, D = q.shape
    Hkv = k.shape[2]
    int8 = ks is not None
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
    if not _route.on_card(q, "decode"):
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
    if not _route.on_card(gate, "decode"):
        return silu_mul_reference(gate, up)
    return _k10(gate, up)


# ------------------------------------------------- K8 and K9 inside K5

class RopeWrite(NamedTuple):
    """K9's operands besides q, k and v: cos and sin [B, 1, D] fp32, the
    layer-stacked caches (int8 ``{"q", "scale"}`` or the activations'
    type), the layer and the token's position of each row [B] on the
    device."""
    cos: torch.Tensor
    sin: torch.Tensor
    cache_k: Any
    cache_v: Any
    layer_idx: int
    pos: torch.Tensor


def rotate_and_write(outs, rope: RopeWrite, write):
    """``write`` (``rope_kv_write`` or its plain version) on the q, k and v
    products ``outs`` [B, 1, N] seen as head vectors; the rotated q."""
    q, k, v = outs
    B, D = q.shape[0], rope.cos.shape[-1]
    return write(*(t.reshape(B, 1, -1, D) for t in (q, k, v)), rope.cos,
                 rope.sin, rope.cache_k, rope.cache_v, rope.layer_idx,
                 rope.pos)


def norm_matmul_group_reference(x, y, weight, eps: float, weights,
                                out_dtype=None, rope: Optional[RopeWrite]
                                = None, keep_h: bool = False):
    """The fused launch's plain version: K8's (``add_rms_norm_reference``),
    each member's ``dequant_matmul_reference`` of its h, and with ``rope``
    K9's (``rope_kv_write_reference``) on the three.  Returns (s, h where
    ``keep_h`` else None, the outputs: [the rotated q] with ``rope``)."""
    s, h = add_rms_norm_reference(x, y, weight, eps)
    outs = [quant.dequant_matmul_reference(h, wq, out_dtype)
            for wq in weights]
    if rope is not None:
        outs = [rotate_and_write(outs, rope, rope_kv_write_reference)]
    return s, (h if keep_h else None), outs


def norm_fuses(x: torch.Tensor, weights) -> bool:
    """Whether K8 runs in the prologue of the K5 launch of ``weights`` (the
    products of its output): on the card, bf16 or fp16 x of 1..
    ``quant.K5_GROUP_ROWS`` rows that no gradient flows through, a width K8
    takes, and 2-3 int8 weights that ``quant.k5_groups`` puts in one
    launch."""
    H = x.shape[-1]
    return _route.on_card(x, "decode") \
        and not (torch.is_grad_enabled() and x.requires_grad) \
        and quant.k5_groups(x, len(weights)) and H % 8 == 0 \
        and H <= _NORM_MAX_H and all(quant.is_quantized(w) for w in weights)


def rope_fuses(weights, head_dim: int) -> bool:
    """Whether K9 runs in the epilogue of the fused q/k/v launch (given
    ``norm_fuses`` and nothing after the products in fp32): three members,
    a head dim K9 takes, each member's columns whole heads."""
    return len(weights) == 3 and head_dim in _HEAD_DIMS and all(
        w["q"].shape[-1] % head_dim == 0 for w in weights)


def _k5_norm(x, y, weight, eps: float, weights, out_dtype, rope, keep_h,
             wrapper):
    """One K5 streaming launch over ``weights`` (1-3 int8 members) with K8
    in its prologue and, with ``rope``, K9 in its epilogue: (s, h or None,
    outputs [M, N]: q alone, rotated, with ``rope``), counted on
    ``wrapper`` and as a K5 launch."""
    _check_norm(x, y, weight)
    H = x.shape[-1]
    M = x.numel() // H
    if not 0 < M <= quant.K5_GROUP_ROWS:
        raise ValueError(f"the fused K5 launch takes 1..{quant.K5_GROUP_ROWS}"
                         f" rows, got {M}")
    if not 0 < len(weights) <= quant.K5_GROUP_MAX:
        raise ValueError(f"the fused K5 launch takes 1..{quant.K5_GROUP_MAX}"
                         f" weights, got {len(weights)}")
    x2 = x.reshape(M, H)
    for wq in weights:
        quant._check_cuda_inputs(x2, wq["q"], wq["scale"])
    Ns = [wq["q"].shape[1] for wq in weights]
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (torch.float32, x.dtype):
        raise TypeError(f"the fused K5 launch writes fp32 or {x.dtype}, not "
                        f"{out_dtype}")
    kq = ks = vq = vs = cos = sin = pos = None
    head_dim = S = Hkv = layer = 0
    if rope is not None:
        cos, sin, pos, layer = rope.cos, rope.sin, rope.pos, rope.layer_idx
        head_dim = rope.cos.shape[-1]
        if len(Ns) != 3 or out_dtype != x.dtype:
            raise ValueError("K9 in K5's epilogue takes the three q/k/v "
                             "products rounded to the activations' type")
        if head_dim not in _HEAD_DIMS:
            raise ValueError(f"K9 takes head_dim 64 or 128, not {head_dim}")
        if any(N % head_dim for N in Ns) or Ns[1] != Ns[2]:
            raise ValueError(f"K9 in K5's epilogue takes whole heads of "
                             f"{head_dim} and k, v alike, got {Ns}")
        Hkv = Ns[1] // head_dim
        kq, ks, vq, vs, S = _check_rope(cos, sin, rope.cache_k,
                                        rope.cache_v, layer, pos, M, Hkv,
                                        head_dim, x.dtype, x.device)
    plan = quant._k5_group_plan(M, H, Ns)
    _, rows, _, _ = plan
    stream = torch.cuda.current_stream(x.device).cuda_stream
    kind = wrapper.__name__
    record = quant._capture_record(kind)
    part, counters = quant._split_scratch(x.device, stream, record, M, Ns,
                                          plan)
    outs = [torch.empty((M, N), dtype=out_dtype, device=x.device)
            for N in (Ns[:1] if rope is not None else Ns)]
    total = x if y is None else torch.empty_like(x)
    h = torch.empty_like(x) if keep_h else None
    err = _build.load("w8a16_gemv").mc_w8a16_gemv_norm(
        x.data_ptr(), quant._ptr(y), weight.data_ptr(),
        None if y is None else total.data_ptr(), quant._ptr(h), float(eps),
        len(Ns), quant._pointers([wq["q"] for wq in weights]),
        quant._pointers([wq["scale"] for wq in weights]),
        quant._pointers(outs + [None] * (len(Ns) - len(outs))),
        (ctypes.c_int * len(Ns))(*Ns), quant._ptr(part),
        quant._ptr(counters), M, H, rows, int(x.dtype == torch.bfloat16),
        quant._OUT_TYPES[out_dtype], head_dim, quant._ptr(cos),
        quant._ptr(sin), quant._ptr(kq), quant._ptr(vq), quant._ptr(ks),
        quant._ptr(vs), quant._ptr(pos),
        int(pos is not None and pos.dtype == torch.int64), S, Hkv,
        int(layer), stream)
    _build.check(err, "w8a16_gemv_norm")
    shape = (M, H, tuple(Ns))
    if record is not None:  # recorded, not run: each replay runs it
        record.launches.append(shape)
    else:
        quant.dequant_matmul.launches += 1
    if not _record(kind, shape):
        wrapper.launches += 1
    return total, h, [o.view(*x.shape[:-1], o.shape[-1]) for o in outs]


def norm_matmul_group(x: torch.Tensor, y: Optional[torch.Tensor],
                      weight: torch.Tensor, eps: float, weights,
                      out_dtype=None, keep_h: bool = False):
    """``add_rms_norm(x, y, weight, eps)`` and the int8 products of its
    output h with ``weights`` (a layer's q/k/v or gate/up), in
    ``out_dtype`` (default x's): (s, h where ``keep_h`` else None,
    outputs).  On a CUDA tensor one K5 launch with K8 in its prologue (the
    products read K8's h bit for bit; h reaches device memory only where
    kept), counted as a K5 launch and on this wrapper; on a CPU tensor the
    plain version."""
    if not _route.on_card(x, "decode"):
        return norm_matmul_group_reference(x, y, weight, eps, weights,
                                           out_dtype, keep_h=keep_h)
    return _k5_norm(x, y, weight, eps, weights, out_dtype, None, keep_h,
                    norm_matmul_group)


def norm_qkv_rope(x: torch.Tensor, y: Optional[torch.Tensor],
                  weight: torch.Tensor, eps: float, weights,
                  rope: RopeWrite):
    """``add_rms_norm(x, y, weight, eps)``, the q/k/v products of its
    output rounded to x's type, and ``rope_kv_write`` on them: (s, the
    rotated q [B, 1, H, D]), k and v written into the caches in place.  On
    a CUDA tensor one K5 launch with K8 in its prologue and K9 in its
    epilogue, bit-equal to K8, the grouped K5 and K9 in turn (k and v never
    reach device memory but in the cache), counted as a K5 launch and on
    this wrapper; on a CPU tensor the plain version."""
    if _route.on_card(x, "decode"):
        s, _, (q,) = _k5_norm(x, y, weight, eps, weights, x.dtype, rope,
                              False, norm_qkv_rope)
        return s, q.view(q.shape[0], 1, -1, rope.cos.shape[-1])
    s, _, (q,) = norm_matmul_group_reference(x, y, weight, eps, weights,
                                             x.dtype, rope)
    return s, q


# ------------------------------------------------------- K10 inside K5

def silu_matmul_reference(gate, up, wq, out_dtype=None):
    """The fused launch's plain version: K10's (``silu_mul_reference``),
    then the down product's ``dequant_matmul_reference`` of its output h.
    Returns (h, the product)."""
    h = silu_mul_reference(gate, up)
    return h, quant.dequant_matmul_reference(h, wq, out_dtype)


def _silu_streams(M: int, K: int, N: int) -> bool:
    """Whether the down product [M, K] @ [K, N] runs on K5's streaming
    grid, the one K10's prologue is written for: 1..``quant.K5_GROUP_ROWS``
    rows where ``quant._k5_plan`` picks it (always at one row; at two rows
    not for the narrow tp 4 shard, which keeps the tensor cores)."""
    return 0 < M <= min(quant.K5_GROUP_ROWS, quant.K5_MAX_ROWS) \
        and quant._k5_plan(M, K, N)[0] == quant._STREAM_TILE


def silu_fuses(gate: torch.Tensor, w) -> bool:
    """Whether K10 runs in the prologue of the K5 launch of the down
    product ``w`` (which reads its output): on the card, bf16 or fp16 gate
    that no gradient flows through, an int8 weight, and a shape that K5
    streams (``_silu_streams``)."""
    return _route.on_card(gate, "decode") and gate.dtype in _route.HALF \
        and not (torch.is_grad_enabled() and gate.requires_grad) \
        and quant.is_quantized(w) \
        and _silu_streams(quant._rows(gate), gate.shape[-1],
                          w["q"].shape[-1])


def _k5_silu(gate, up, wq, out_dtype, keep_h: bool):
    """One K5 streaming launch of the int8 weight ``wq`` with K10 in its
    prologue: (h or None, the product [..., N]), counted on
    ``silu_matmul`` and as a K5 launch."""
    _check_half("gate", gate)
    _check_half("up", up, gate.dtype)
    if up.shape != gate.shape:
        raise ValueError(f"up {tuple(up.shape)} != gate "
                         f"{tuple(gate.shape)}")
    for name, t in (("gate", gate), ("up", up)):
        _check_dense(name, t, gate.device)
    K = gate.shape[-1]
    M = quant._rows(gate)
    if not 0 < M <= quant.K5_GROUP_ROWS:
        raise ValueError(f"the fused K5 launch takes 1..{quant.K5_GROUP_ROWS}"
                         f" rows, got {M}")
    x2 = gate.reshape(M, K)
    quant._check_cuda_inputs(x2, wq["q"], wq["scale"])
    N = wq["q"].shape[1]
    if not _silu_streams(M, K, N):
        raise ValueError(f"the fused K5 launch streams; K5 takes {M} x {K} x "
                         f"{N} on the tensor cores")
    out_dtype = out_dtype or gate.dtype
    if out_dtype not in (torch.float32, gate.dtype):
        raise TypeError(f"the fused K5 launch writes fp32 or {gate.dtype}, "
                        f"not {out_dtype}")
    plan = quant._k5_plan(M, K, N)
    _, rows, _, _ = plan
    stream = torch.cuda.current_stream(gate.device).cuda_stream
    record = quant._capture_record("silu_matmul")
    part, counters = quant._split_scratch(gate.device, stream, record, M,
                                          [N], plan)
    out = torch.empty((M, N), dtype=out_dtype, device=gate.device)
    h = torch.empty_like(gate) if keep_h else None
    err = _build.load("w8a16_gemv").mc_w8a16_gemv_silu(
        gate.data_ptr(), up.data_ptr(), quant._ptr(h), wq["q"].data_ptr(),
        wq["scale"].data_ptr(), out.data_ptr(), N, quant._ptr(part),
        quant._ptr(counters), M, K, rows, int(gate.dtype == torch.bfloat16),
        quant._OUT_TYPES[out_dtype], stream)
    _build.check(err, "w8a16_gemv_silu")
    shape = (M, K, N)
    if record is not None:  # recorded, not run: each replay runs it
        record.launches.append(shape)
    else:
        quant.dequant_matmul.launches += 1
    if not _record("silu_matmul", shape):
        silu_matmul.launches += 1
    return h, out.view(*gate.shape[:-1], N)


def silu_matmul(gate: torch.Tensor, up: torch.Tensor, wq, out_dtype=None,
                keep_h: bool = False):
    """``silu_mul(gate, up)`` and its int8 product with ``wq`` (a layer's
    down weight), in ``out_dtype`` (default gate's): (h where ``keep_h``
    else None, the product).  On a CUDA tensor one K5 launch with K10 in
    its prologue, bit-equal to K10 and K5 in turn (h reaches device memory
    only where kept), counted as a K5 launch and on this wrapper; it
    raises on a shape K5 does not stream (``_silu_streams``).  On a CPU
    tensor the plain version."""
    if not _route.on_card(gate, "decode"):
        h, y = silu_matmul_reference(gate, up, wq, out_dtype)
        return (h if keep_h else None), y
    return _k5_silu(gate, up, wq, out_dtype, keep_h)


# Launches of K8, K9 and K10, and of K5 with K8 in its prologue
# (``norm_matmul_group``), with K8 and K9 (``norm_qkv_rope``) or with K10
# (``silu_matmul``; each also one of K5's): one per call that ran the
# kernel; a replayed graph adds the launches its capture recorded
# (core/decode_graph).
add_rms_norm.launches = 0
rope_kv_write.launches = 0
silu_mul.launches = 0
norm_matmul_group.launches = 0
norm_qkv_rope.launches = 0
silu_matmul.launches = 0
