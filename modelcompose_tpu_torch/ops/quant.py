"""Weight-only int8 quantization (counterpart of
modelcompose_tpu/ops/quant.py) and the wrappers of kernels K5, K6 and K7.

Per-output-channel symmetric int8 halves the bytes batch-1 decode streams
per step, as long as the int8 tensor is what the product reads: the JAX
package keeps the convert inside the contraction and XLA fuses it into the
dot's operand load, at every number of rows, and into the transposed dot
of its gradient.  Here ``dequant_matmul`` on a CUDA tensor launches K5
(``csrc/w8a16_gemv.cu``) for the decode-time products of 1..``K5_MAX_ROWS``
rows, which reads each int8 weight once and converts it in registers, and
K6 (``csrc/w8a16_gemm.cu``) for larger ones (prefill, prefill chunks,
training on an int8 base), a tensor-core GEMM that converts each int8
tile on its way to the tensor cores; the gradient through x is K7
(``csrc/w8a16_dx.cu``, ``w8a16_dx``), a pass that scales and rounds the
cotangent once and the same GEMM transposed: no path on the card writes a
bf16 copy of a weight.  The kernels take bf16 or fp16 x; x of
another float type (fp32) takes ``dequant_matmul_reference`` on every
device, as the JAX package computes ``x @ q.astype(x.dtype)`` for any
float x.  CPU tensors and ``impl="reference"`` take
``dequant_matmul_reference`` (the convert and the fp32-output GEMM).  At
1-2 rows the products that share an input (a layer's q/k/v, its gate/up)
are one K5 launch (``dequant_matmul_group``); in the decode layer that
launch also takes the norm before it and the RoPE + KV-cache write after
it (``ops/decode_fused.norm_matmul_group``, ``norm_qkv_rope``).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Any, Dict, NamedTuple, Optional

import torch

from .. import _build
from . import _route


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """2-D ``a @ b`` accumulated and returned in fp32: the fp32-output GEMM
    for half-precision operands on the card, upcast operands elsewhere
    (products of bf16 values are exact in fp32, so only the summation order
    differs)."""
    if a.is_cuda and a.dtype == b.dtype and a.dtype in _route.HALF:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _MatmulF32(torch.autograd.Function):
    """``x [M, i] @ w [i, o]`` -> fp32, differentiable.

    ``torch.mm(..., out_dtype=...)`` has no derivative, so the backward is
    written out: dX = g W^T and dW = X^T g, each accumulated in fp32 and
    cast to its input's dtype.  The fp32 cotangent is rounded to the
    operands' half type first, on every device, so both products are the
    same fp32-output GEMM as the forward.  This is the arithmetic of the
    JAX package on a TPU: JAX transposes ``dot_general(x, w,
    preferred_element_type=f32)`` into an fp32 x fp32 ``dot_general`` at
    precision DEFAULT (the bf16 operand upcast) and a convert to the
    operand's dtype, and XLA runs a DEFAULT-precision fp32 dot on a TPU as
    one bf16 pass.  (XLA on a CPU keeps fp32 there: the JAX CPU gradient
    differs from this one by g's bf16 rounding.)  dW is computed, and X
    kept, only when W needs a gradient: a frozen base weight costs no dW
    GEMM."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None,
                              w if ctx.needs_input_grad[0] else None)
        return _mm_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _mm_f32(g.to(w.dtype), w.t()).to(w.dtype)
        if ctx.needs_input_grad[1]:
            dw = _mm_f32(x.t(), g.to(x.dtype)).to(x.dtype)
        return dx, dw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., i] @ w [i, o]`` with fp32 accumulation and an fp32 result
    (the JAX package's ``preferred_element_type=float32``).

    A bf16 product rounded to bf16 before a later add or cast would lose
    mantissa the JAX path keeps, so operands of one half type go through
    ``_MatmulF32`` (the fp32-output GEMM on the card, with its own
    backward); fp32 or mixed operands are plain (upcast) products.
    """
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    if x.dtype == w.dtype and x.dtype in _route.HALF:
        y = _MatmulF32.apply(x.reshape(-1, x.shape[-1]), w)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


def quantize_int8(w: torch.Tensor, axis: int = -2) -> Dict[str, torch.Tensor]:
    """Symmetric int8 over ``axis`` (the contraction axis for weights, the
    vector axis for the KV cache), one fp32 scale per remaining index.
    Both come out contiguous whatever ``w``'s strides (a weight converted
    from the HF layout is a transposed view), the layout K5 reads."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(amax / 127.0, 1e-8).contiguous()
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q.contiguous(), "scale": scale}


def dequant_matmul_reference(x: torch.Tensor, wq: Dict[str, torch.Tensor],
                             out_dtype=None) -> torch.Tensor:
    """y = x @ dequant(wq), fp32-accumulated; the per-column scale is an
    epilogue multiply.  ``out_dtype`` keeps the fp32 result when the
    consumer wants it (logits, the adapter add).  Differentiable through x
    only: an int8 weight is frozen.  Plain PyTorch: ``q.to(x.dtype)``
    writes a converted copy of the weight, which the GEMM reads."""
    y = matmul_f32(x, wq["q"].to(x.dtype)) * wq["scale"][..., 0, :]
    return y.to(out_dtype or x.dtype)


K5_MAX_ROWS = 8  # rows of x (its leading axes flattened) that K5 takes
K5_GROUP_ROWS = 2  # rows at which products that share x are one launch
K5_GROUP_MAX = 3  # weights one grouped launch takes (q/k/v)
_K_STEP = 16  # the depth of K5's mma: a block's K range is whole steps
_BLOCK_ROWS = 2048  # the most K rows of one tensor-core block (kMaxRows)
# The column tiles of the tensor-core kernel and the rates (TB/s) at which
# each streamed the lm_head's weight at two rows on an H100 (HBM3, 700 W;
# the tile sweep of scripts/torch_kernel_ab.py --only K5): a wider tile
# reads longer runs of each weight row.
_TILE_RATES = {64: 1.67, 128: 1.97, 256: 2.28}
_SMS = 132  # the H100's SMs
_MIN_BLOCKS = 128  # a grid that keeps (nearly) every SM streaming
_BLOCK_START = 16 * 1024  # a block's start-up (x staged, the first box's
#                           latency), in bytes of the weight stream
_PART_SHARE = 8  # the split partials at most 1/8 of the weight's bytes
_LAST_READ = 32 * 1024  # the most partial bytes the last block of a tile reads
# The streaming kernel (1-2 rows): 512-column tiles (kSTile), a block's K
# range in whole 64-row steps (8 rows a warp), at most 32 splits (the
# partials a tile's last block reads: 64 KB a row of x).  The split rule
# and the cost of the choice at two rows are fitted to the split sweep and
# the tensor-core tile sweep of scripts/torch_kernel_ab.py --only K5 (H100,
# HBM3, 700 W) at every main-path shape, tp 2 / tp 4 shard and group: the
# rule picked the fastest split in each of the 40 cases.
_STREAM_TILE = 512
_STREAM_STEP = 64
_STREAM_MAX_SPLITS = 32
_STREAM_PAIR_ROWS = 192  # two blocks an SM only if each streams this many
_TWO_ROW_US = {"stream": (6.99, 3.12), "mma": (5.97, 2.52)}  # us, TB/s
_OUT_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _stream_plan(K: int, tiles: int):
    """(rows, n_splits) of the streaming kernel over ``tiles`` 512-column
    tiles (of one weight, or of every weight of a group): K split to fill
    the card with two blocks an SM (at most 264) where a block then still
    streams 192 rows or more (three rounds of loads a warp), else with one
    (at most 132: fewer, longer blocks and fewer partials beat a second
    block of short ones); at most 32 splits, whole 64-row steps."""
    steps = -(-K // _STREAM_STEP)
    for blocks in (2 * _SMS, _SMS):
        splits = max(1, min(blocks // tiles, _STREAM_MAX_SPLITS, steps))
        rows = -(-steps // splits) * _STREAM_STEP
        if rows >= _STREAM_PAIR_ROWS:
            break
    return rows, -(-K // rows)


def _two_row_us(kernel: str, K: int, N: int) -> float:
    """A kernel's estimated time (us) for two rows of x @ q [K, N]: its
    fixed cost and the weight's bytes at its rate (fitted; the streaming
    kernel starts slower and streams faster)."""
    start, rate = _TWO_ROW_US[kernel]
    return start + K * N / (rate * 1e6)


def _mma_plan(M: int, K: int, N: int, tile: int):
    """(cost, rows, n_splits, n_tiles) of the tensor-core kernel at one
    column tile: the split count minimises the time of the busiest SM,
    ``ceil(blocks / 132)`` blocks of ``rows x tile`` weight bytes and a
    start-up each at the tile's streaming rate, plus the partials (written
    by every split, spread over the SMs, and read by the last block of a
    tile); ties go to fewer splits.  A grid of at least 128 blocks (about
    one for each SM) comes first where one is possible.  It stays within
    what the combine can afford: at most ``K / (32 M)`` splits (fp32
    partials under 1/8 of the weight's bytes) and as many as keep a tile's
    last block under 32 KB of partials to read, and at least enough that
    no block takes more than 2048 rows."""
    tiles = -(-N // tile)
    lo = -(-K // _BLOCK_ROWS)
    hi = max(lo, min(K // (4 * _PART_SHARE * M),
                     _LAST_READ // (4 * M * tile), -(-K // _K_STEP)))
    best = None
    for s in range(lo, hi + 1):
        per_split = -(-K // s)
        rows = -(-per_split // _K_STEP) * _K_STEP
        splits = -(-K // rows)
        cost = -(-tiles * splits // _SMS) * (rows * tile + _BLOCK_START)
        if splits > 1:
            cost += splits * M * 4 * (tile + 2 * N // _SMS)
        cost = (tiles * splits < _MIN_BLOCKS, cost / _TILE_RATES[tile])
        if best is None or cost < best[0]:
            best = (cost, rows, splits, tiles)
    return best


def _k5_plan(M: int, K: int, N: int):
    """K5's grid for x [M, K] @ q [K, N]: (tile, rows, n_splits, n_tiles),
    the column tile, the K range of one block, the blocks of a tile, and
    the tiles.  A tile of 512 is the streaming kernel: always at one row,
    at two rows where its estimated time is at most the tensor-core
    kernel's (the wide products; the narrow tp shards keep the tensor
    cores); 3-8 rows take the tensor-core kernel at the tile (64, 128 or
    256 columns) whose plan costs least."""
    tiles = -(-N // _STREAM_TILE)
    if M == 1 or M == 2 and _two_row_us("stream", K, N) \
            <= _two_row_us("mma", K, N):
        return (_STREAM_TILE,) + _stream_plan(K, tiles) + (tiles,)
    plans = {tile: _mma_plan(M, K, N, tile) for tile in _TILE_RATES}
    tile = min(plans, key=lambda t: plans[t][0])
    return (tile,) + plans[tile][1:]


def _k5_group_plan(M: int, K: int, Ns):
    """The grid of one grouped launch (1-2 rows; the streaming kernel):
    (512, rows, n_splits, n_tiles) over every member's 512-column tiles."""
    tiles = sum(-(-N // _STREAM_TILE) for N in Ns)
    return (_STREAM_TILE,) + _stream_plan(K, tiles) + (tiles,)


def _scratch_sizes(M: int, Ns, plan):
    """(fp32 partials, counters) of a launch with ``plan``: the streaming
    kernel's [tiles][splits][M][512], the tensor-core kernel's [splits][M]
    [N] and a counter per column tile."""
    tile, _, splits, tiles = plan
    if tile == _STREAM_TILE:
        return tiles * splits * M * _STREAM_TILE, tiles
    return splits * M * Ns[0], tiles


class _Scratch:
    """K5's split-K scratch: the fp32 partials and the int32 counters of
    the fused combine, one per column tile, which the kernel leaves at
    zero.  It grows to the largest launch it serves.  Launches on one
    stream run one after another, so they share one; ``keep`` also holds
    the outgrown buffers (a capture's launches keep their addresses)."""

    def __init__(self, keep: bool = False):
        self.part = self.counters = None
        self.outgrown = [] if keep else None

    def _retire(self, old):
        if old is not None and self.outgrown is not None:
            self.outgrown.append(old)

    def get(self, device, n_part: int, n_tiles: int):
        if self.part is None or self.part.numel() < n_part:
            self._retire(self.part)
            self.part = torch.empty(n_part, dtype=torch.float32,
                                    device=device)
        if self.counters is None or self.counters.numel() < n_tiles:
            self._retire(self.counters)
            self.counters = torch.zeros(n_tiles, dtype=torch.int32,
                                        device=device)
        return self.part, self.counters


# K5's scratch, one per (device, CUDA stream).  A launch captured into a
# CUDA graph takes its scratch from the capture's record instead
# (``capturing``): a buffer outgrown here would be freed under the graph.
_SCRATCH = {}


class CaptureRecord:
    """The K5 (``launches``), K6 (``gemm``) and K7 (``dx``) launches of one
    CUDA-graph capture: each launch's (M, K, N) in order (a replay re-runs
    them with no Python call, so the graph's owner counts them), and K5's
    split scratch, which lives as long as this record: the graph's owner
    keeps the record as long as the graph.  The decode layer's fused
    passes (ops/decode_fused) record their launches here too: K8
    (``norm``), K9 (``rope``) and K10 (``silu``), each launch's shape, and
    K5's launches with K8 in their prologue (``norm_group``) or with K8 and
    K9 (``norm_rope``), and with K10 in their prologue (``silu_group``),
    each also one of ``launches``."""

    def __init__(self):
        self.launches = []
        self.gemm = []
        self.dx = []
        self.norm = []
        self.rope = []
        self.silu = []
        self.norm_group = []
        self.norm_rope = []
        self.silu_group = []
        self.scratch = _Scratch(keep=True)


_CAPTURE = threading.local()
_BY_STREAM = {}  # capturing stream handle -> its record, for other threads


@contextlib.contextmanager
def capturing(stream: Optional[torch.cuda.Stream] = None):
    """Record the K5, K6 and K7 launches captured into a CUDA graph while
    the block runs, on this thread and, given the capturing ``stream``, on
    any thread that launches into it (autograd's: a layer's remat
    recompute runs K6 in the backward, and every dL/dx runs K7 there);
    yields the ``CaptureRecord``.  A K5, K6 or K7 launch made while its
    stream captures, outside every such block, raises: its replays would go
    uncounted and its scratch unowned."""
    previous = getattr(_CAPTURE, "record", None)
    record = _CAPTURE.record = CaptureRecord()
    if stream is not None:  # one capture at a time on a stream
        _BY_STREAM[stream.cuda_stream] = record
    try:
        yield record
    finally:
        _CAPTURE.record = previous
        if stream is not None:
            _BY_STREAM.pop(stream.cuda_stream, None)


def _capture_record(name: str) -> Optional[CaptureRecord]:
    """The record a launch of kernel ``name`` goes into: None when the
    current stream is not capturing; this thread's record, else the
    capturing stream's; raises when there is neither."""
    if not torch.cuda.is_current_stream_capturing():
        return None
    record = getattr(_CAPTURE, "record", None)
    if record is None:
        record = _BY_STREAM.get(torch.cuda.current_stream().cuda_stream)
    if record is None:
        raise RuntimeError(
            f"{name} captured into a CUDA graph outside quant.capturing(): "
            "its replays would not be counted")
    return record


def _check_cuda_inputs(x2, q, scale):
    """Raise on what K5 does not take: x [M, K] bf16/fp16 with unit column
    stride; q [K, N] int8, N % 16 == 0; scale fp32 with N values; q and
    scale contiguous and 16-byte aligned, all on one device."""
    M, K = x2.shape
    if x2.dtype not in _route.HALF:
        raise TypeError(f"K5 takes bf16 or fp16 activations, got {x2.dtype}")
    if x2.stride(1) != 1:
        raise ValueError(f"K5 takes activations with unit column stride, "
                         f"got strides {x2.stride()}")
    if q.dtype != torch.int8 or q.dim() != 2 or q.shape[0] != K:
        raise ValueError(f"K5 takes an int8 [{K}, N] weight, got "
                         f"{q.dtype} {tuple(q.shape)}")
    N = q.shape[1]
    if N % 16:
        raise ValueError(f"K5 takes a multiple of 16 columns, got {N}")
    if scale.dtype != torch.float32 or scale.numel() != N:
        raise ValueError(f"K5 takes {N} fp32 scales, got {scale.dtype} "
                         f"{tuple(scale.shape)}")
    for name, t in (("q", q), ("scale", scale)):
        if t.device != x2.device:
            raise ValueError(f"{name} is on {t.device}, x on {x2.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _ptr(t) -> Optional[int]:
    """A tensor's address for a C entry, or None (a null pointer)."""
    return None if t is None else t.data_ptr()


def _pointers(ts):
    """A ctypes array of the tensors' addresses (null for None)."""
    return (ctypes.c_void_p * len(ts))(*[_ptr(t) for t in ts])


def _split_scratch(device, stream, record, M: int, Ns, plan):
    """(part, counters) of a K5 launch with ``plan`` on ``stream``: None
    without a split; else the capture record's scratch, or the stream's."""
    if plan[2] == 1:
        return None, None
    scratch = record.scratch if record is not None \
        else _SCRATCH.setdefault((device, stream), _Scratch())
    return scratch.get(device, *_scratch_sizes(M, Ns, plan))


def _k5(x2, weights, out_dtype):
    """Kernel K5 on x2 [M, K] (M <= K5_MAX_ROWS): ``[(x2 @ q) * scale]`` in
    ``out_dtype`` for one weight, or for up to K5_GROUP_MAX weights that
    share x2 at 1-2 rows, one launch either way."""
    for wq in weights:
        _check_cuda_inputs(x2, wq["q"], wq["scale"])
    M, K = x2.shape
    Ns = [wq["q"].shape[1] for wq in weights]
    n = len(weights)
    plan = _k5_plan(M, K, Ns[0]) if n == 1 else _k5_group_plan(M, K, Ns)
    tile, rows, _, _ = plan
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    record = _capture_record("dequant_matmul")
    part, counters = _split_scratch(x2.device, stream, record, M, Ns, plan)
    kind = out_dtype if out_dtype in (torch.float32, x2.dtype) \
        else torch.float32
    outs = [torch.empty((M, N), dtype=kind, device=x2.device) for N in Ns]
    err = _build.load("w8a16_gemv").mc_w8a16_gemv(
        x2.data_ptr(), n, _pointers([wq["q"] for wq in weights]),
        _pointers([wq["scale"] for wq in weights]), _pointers(outs),
        (ctypes.c_int * n)(*Ns), _ptr(part), _ptr(counters),
        M, K, x2.stride(0) if M > 1 else K, rows, tile,
        int(x2.dtype == torch.bfloat16), _OUT_TYPES[kind], stream)
    _build.check(err, "w8a16_gemv")
    if record is not None:  # recorded, not run: each replay runs it
        record.launches.append((M, K, Ns[0] if n == 1 else tuple(Ns)))
    else:
        dequant_matmul.launches += 1
    return [out.to(out_dtype) for out in outs]


# K6 (csrc/w8a16_gemm.cu): persistent blocks of 128 weight columns by 256,
# 128 or 64 rows of x, in clusters of 1, 2 or 4 blocks that split a tile's
# K, and the rate (TFLOP/s, for 132 SMs) each (rows, split) kept within a
# round of units (one unit a block) on an H100 (80GB HBM3, 700 W; the
# median over the Vicuna-7B layer products at 256-8,192 rows,
# scripts/torch_k6_blocks.py): a plan's time is its rounds of whole units
# and of split units, each unit's flops over its rate.  A split unit does
# 1/split of a tile's steps and its part of the sum of the partials.  The
# conversion is paid once a 64-deep tile whatever the rows, so wider blocks
# keep more of the tensor cores.
_K6_RATES = {(256, 1): 719.1, (256, 2): 572.7, (256, 4): 440.3,
             (128, 1): 532.7, (128, 2): 418.1, (128, 4): 345.2,
             (64, 1): 330.6, (64, 2): 270.1, (64, 4): 221.2}
_K6_COLS = 128  # weight columns a block
_K6_STEP = 64  # the depth of a stage: a split's K ranges are whole steps
_K6_GROUP = 8  # row tiles of a raster group (the units in flight share L2)
# The most K a split takes.  The tensor cores' fp32 sum of a whole tile's
# K is the plain product's (cuBLAS's) bit for bit; a split adds partial
# sums of shorter chains, which moves an fp32 output by a share of max |y|
# that grows linearly with K: at K = 4,096 up to 3.2e-6 (split 2) and
# 4.0e-6 (split 4), at 11,008 up to 8.5e-6 and 1.12e-5
# (scripts/torch_k6_blocks.py, ``rel_err``), against the 1e-5 the fp32
# result is held to.  A split stays within about half of that: down's
# K = 11,008 is never split.
_K6_SPLIT_MAX_K = {2: 6144, 4: 4608}
# The clusters of each (rows, split) an H100 80GB HBM3 ran at once
# (cudaOccupancyMaxActiveClusters; its GPCs hold 30, not 33, clusters of
# 4): the plan's default off the card; on the card the kernel's own query
# (``_k6_active``) replaces it.
_K6_ACTIVE = {(rows, split): {1: 132, 2: 66, 4: 30}[split]
              for rows, split in _K6_RATES}


class K6Plan(NamedTuple):
    """K6's launch: the block's rows of x (by 128 weight columns), the
    blocks of a cluster (``split``: 1, 2 or 4), the row and column tiles of
    y (the last of each masked at M and N), the row tiles of a raster
    group, the clusters launched, and the tiles, first in the raster, that
    are whole units; the rest are split along K over a cluster."""
    rows: int
    split: int
    m_tiles: int
    n_tiles: int
    group: int
    clusters: int
    whole: int


def _k6_plan(M: int, K: int, N: int, active=None, blocks=None) -> K6Plan:
    """K6's schedule for x [M, K] @ q [K, N] on a card that runs
    ``active[rows, split]`` clusters at once (default ``_K6_ACTIVE``), over
    the (rows, split) of ``blocks`` (default every one of ``_K6_RATES``).
    Split 1: every tile whole, over min(tiles, active) blocks.  Split 2 or
    4 over P = active * split blocks, at K up to ``_K6_SPLIT_MAX_K``: the
    whole waves of P tiles whole, the tail (at least one tile) split, a
    tile a cluster in turn.  The cost is the rounds of units each block
    takes at the rate of its kind; the least wins, ties to the wider block
    and the smaller split.  Raises on a K or N that TMA cannot read
    (K % 8, N % 16: 16-byte row strides), and where none of ``blocks``
    takes the shape."""
    if M <= 0 or K <= 0 or K % 8 or N <= 0 or N % 16:
        raise ValueError(f"K6 takes M > 0, K % 8 == 0 and N % 16 == 0, got "
                         f"M {M}, K {K}, N {N}")
    active = active or _K6_ACTIVE
    n_tiles = -(-N // _K6_COLS)
    n_k = -(-K // _K6_STEP)
    best = None
    for rows, split in sorted(blocks or _K6_RATES,
                              key=lambda b: (-b[0], b[1])):
        m_tiles = -(-M // rows)
        tiles = m_tiles * n_tiles
        clusters = active[rows, split]
        unit = rows / _K6_RATES[rows, 1]
        if split == 1:
            cost = -(-tiles // clusters) * unit
            plan = K6Plan(rows, 1, m_tiles, n_tiles,
                          min(_K6_GROUP, m_tiles), min(tiles, clusters),
                          tiles)
        else:
            wave = clusters * split
            whole = tiles // wave * wave
            if whole == tiles or n_k < split or K > _K6_SPLIT_MAX_K[split]:
                continue
            cost = whole // wave * unit + -(-(tiles - whole) // clusters) \
                * rows / (split * _K6_RATES[rows, split])
            plan = K6Plan(rows, split, m_tiles, n_tiles,
                          min(_K6_GROUP, m_tiles),
                          clusters if whole else min(tiles, clusters), whole)
        if best is None or cost < best[0]:
            best = (cost, plan)
    if best is None:
        raise ValueError(f"K6: no schedule of {sorted(blocks)} takes "
                         f"M {M}, K {K}, N {N}")
    return best[1]


def _k6_tile(t: int, plan: K6Plan):
    """The (row tile, column tile) of tile t of the grouped raster: groups
    of ``plan.group`` row tiles, the group's row tiles walked under each
    column tile (``Units::at`` in the kernel)."""
    per_group = plan.group * plan.n_tiles
    first = t // per_group * plan.group
    here = min(plan.m_tiles - first, plan.group)
    r = t % per_group
    return first + r % here, r // here


def _k6_schedule(plan: K6Plan, K: int):
    """Each block's units in the order it runs them, as the kernel builds
    them (``Units``): ``(row tile, column tile, k0, k1, part)`` with the
    64-deep steps [k0, k1) and ``part`` None for a whole tile, else the
    block's rank in its cluster (its k range's place in the sum)."""
    n_k = -(-K // _K6_STEP)
    tiles = plan.m_tiles * plan.n_tiles
    blocks = plan.clusters * plan.split
    out = []
    for b in range(blocks):
        cluster, rank = divmod(b, plan.split)
        units = [_k6_tile(t, plan) + (0, n_k, None)
                 for t in range(b, plan.whole, blocks)]
        units += [_k6_tile(t, plan) + (rank * n_k // plan.split,
                                       (rank + 1) * n_k // plan.split, rank)
                  for t in range(plan.whole + cluster, tiles,
                                 plan.clusters)]
        out.append(units)
    return out


# The card's clusters of each (rows, split), by device index, asked once
# (``mc_w8a16_gemm_clusters``, which also sets each instantiation's shared
# memory): at the first K6 call on the device, an eager one on every path
# (each graph's capture follows an eager run of its step).
_K6_ACTIVE_ON = {}


def _k6_active(device) -> Dict:
    """``{(rows, split): clusters}`` the card of ``device`` runs at once."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    found = _K6_ACTIVE_ON.get(index)
    if found is None:
        lib = _build.load("w8a16_gemm")
        found = {}
        with torch.cuda.device(index):
            for rows, split in _K6_RATES:
                n = lib.mc_w8a16_gemm_clusters(rows, split)
                if n <= 0:
                    raise RuntimeError(f"w8a16_gemm: no cluster of {split} "
                                       f"blocks of {rows} rows fits the "
                                       f"card ({n})")
                found[rows, split] = n
        _K6_ACTIVE_ON[index] = found
    return found


def _check_k6_inputs(x2, q, scale):
    """Raise on what K6 does not take: x [M, K] bf16/fp16, K % 8 == 0;
    q [K, N] int8 contiguous and 16-byte aligned, N % 16 == 0; scale fp32
    with N values, contiguous and 16-byte aligned; all on one device."""
    M, K = x2.shape
    if x2.dtype not in _route.HALF:
        raise TypeError(f"K6 takes bf16 or fp16 activations, got {x2.dtype}")
    if q.dtype != torch.int8 or q.dim() != 2 or q.shape[0] != K:
        raise ValueError(f"K6 takes an int8 [{K}, N] weight, got "
                         f"{q.dtype} {tuple(q.shape)}")
    N = q.shape[1]
    if K % 8 or N % 16:
        raise ValueError(f"K6 takes K % 8 == 0 and N % 16 == 0 (TMA's "
                         f"16-byte row strides), got K {K}, N {N}")
    if scale.dtype != torch.float32 or scale.numel() != N:
        raise ValueError(f"K6 takes {N} fp32 scales, got {scale.dtype} "
                         f"{tuple(scale.shape)}")
    for name, t in (("q", q), ("scale", scale)):
        if t.device != x2.device:
            raise ValueError(f"{name} is on {t.device}, x on {x2.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _k6(x2, weights, out_dtype):
    """Kernel K6 on x2 [M, K] and one weight: ``[(x2 @ q) * scale]`` in
    ``out_dtype``, one launch on ``_k6_plan``'s schedule for the card's
    clusters.  x2 goes to the kernel as whole, 16-byte
    aligned rows (TMA's tiles): a row-strided or misaligned view is copied
    first."""
    (wq,) = weights
    q, scale = wq["q"], wq["scale"]
    _check_k6_inputs(x2, q, scale)
    M, K = x2.shape
    N = q.shape[1]
    plan = _k6_plan(M, K, N, _k6_active(x2.device))
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        x2 = x2.clone(memory_format=torch.contiguous_format)
    record = _capture_record("w8a16_gemm")
    kind = out_dtype if out_dtype in (torch.float32, x2.dtype) \
        else torch.float32
    out = torch.empty((M, N), dtype=kind, device=x2.device)
    err = _build.load("w8a16_gemm").mc_w8a16_gemm(
        x2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), M, K,
        N, plan.rows, plan.group, plan.split, plan.clusters, plan.whole,
        int(x2.dtype == torch.bfloat16), _OUT_TYPES[kind],
        torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(err, "w8a16_gemm")
    if record is not None:  # recorded, not run: each replay runs it
        record.gemm.append((M, K, N))
    else:
        w8a16_gemm.launches += 1
    return [out.to(out_dtype)]


def _scale_cotangent(g, scale, dtype):
    """The cotangent times the scale in fp32, rounded once to x's type:
    K7's first pass, and the first line of its plain version."""
    return (g.float() * scale.reshape(-1)).to(dtype)


def _dequant_matmul_dx(g, q, scale, dtype):
    """dL/dx of ``dequant_matmul``: (g * scale) @ q^T in the arithmetic of
    the plain version's autograd (the fp32 cotangent rounded to x's type,
    an fp32-accumulated product, cast to x's type), which is what JAX's
    autodiff of its ``dequant_matmul`` computes.  K7's plain version."""
    gs = _scale_cotangent(g, scale, dtype)
    return _mm_f32(gs, q.to(dtype).t()).to(dtype)


# K7 (csrc/w8a16_dx.cu), its product pass: blocks of 128 dx columns by 256
# or 128 rows of the scaled cotangent, and the rate (TFLOP/s) each kept
# within a wave on an H100 (80GB HBM3, 700 W; the median over phase 4d's
# layer products at 8,192 rows and the lm_head's at 1,024 and 256,
# scripts/torch_k7_parts.py); a raster group of 8 row tiles walked under
# each column tile (K6's).
_K7_RATES = {256: 721.0, 128: 497.0}
_K7_COLS = 128  # dx columns (q rows) a block
_K7_GROUP = 8
_G_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _k7_plan(M: int, K: int, N: int):
    """K7's product grid for dx [M, K] = gs [M, N] @ q [K, N]^T: (rows,
    m_tiles, k_tiles, group), the block's rows of gs (by 128 dx columns),
    its row and column tiles (the last of each masked at M and K) and the
    row tiles of a raster group.  The block is the one whose waves over the
    132 SMs cost least at its rate: 256 rows at the train sizes, 128 where
    they fill the card better (the lm_head's 512-row loss chunk at B=2,
    scripts/bench_train_pipeline.py's per-device batch: one wave of 128
    blocks, not half a wave of 64).
    Raises on a K or N that TMA cannot read (K % 8: dx's 16-byte rows;
    N % 16: q's)."""
    if M <= 0 or K <= 0 or K % 8 or N <= 0 or N % 16:
        raise ValueError(f"K7 takes M > 0, K % 8 == 0 and N % 16 == 0, got "
                         f"M {M}, K {K}, N {N}")
    k_tiles = -(-K // _K7_COLS)

    def cost(rows):
        waves = -(-(-(-M // rows) * k_tiles) // _SMS)
        return waves * rows / _K7_RATES[rows]
    rows = min(_K7_RATES, key=cost)
    m_tiles = -(-M // rows)
    return rows, m_tiles, k_tiles, min(_K7_GROUP, m_tiles)


def _check_k7_inputs(g2, q, scale, dtype):
    """Raise on what K7 does not take: g [M, N] fp32/bf16/fp16; x's type
    ``dtype`` bf16/fp16; q [K, N] int8 contiguous and 16-byte aligned,
    K % 8 == 0, N % 16 == 0; scale fp32 with N values, contiguous and
    16-byte aligned; all on one device.  A pass alone passes None for the
    operand it does not read (q for the first, scale for the second)."""
    if dtype not in _route.HALF:
        raise TypeError(f"K7 writes bf16 or fp16 dx, got {dtype}")
    if g2.dtype not in _G_TYPES:
        raise TypeError(f"K7 takes an fp32, bf16 or fp16 cotangent, got "
                        f"{g2.dtype}")
    M, N = g2.shape
    if N % 16:
        raise ValueError(f"K7 takes N % 16 == 0 (TMA's 16-byte row "
                         f"strides), got N {N}")
    if q is not None:
        if q.dtype != torch.int8 or q.dim() != 2 or q.shape[1] != N:
            raise ValueError(f"K7 takes an int8 [K, {N}] weight, got "
                             f"{q.dtype} {tuple(q.shape)}")
        if q.shape[0] % 8:
            raise ValueError(f"K7 takes K % 8 == 0 (dx's 16-byte rows), "
                             f"got K {q.shape[0]}")
    if scale is not None and (scale.dtype != torch.float32
                              or scale.numel() != N):
        raise ValueError(f"K7 takes {N} fp32 scales, got {scale.dtype} "
                         f"{tuple(scale.shape)}")
    for name, t in (("q", q), ("scale", scale)):
        if t is None:
            continue
        if t.device != g2.device:
            raise ValueError(f"{name} is on {t.device}, g on {g2.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _whole_rows(g2):
    """g2, or a contiguous copy where it is not contiguous and 16-byte
    aligned (the rows K7's first pass reads in 16-byte vectors)."""
    if not g2.is_contiguous() or g2.data_ptr() % 16:
        return g2.clone(memory_format=torch.contiguous_format)
    return g2


def _k7(g2, q, scale, dtype):
    """Kernel K7 on the cotangent g2 [M, N] of ``(x @ q) * scale``: dx
    [M, K] in ``dtype`` (x's), one C call that runs both passes' entries
    (``_k7_scale``'s, then ``_k7_product``'s) on the current stream: the
    scaled cotangent gs [M, N] in ``dtype`` (scratch, from
    ``torch.empty``: a capture's comes from the graph's pool), then the
    product.  g2 goes to the kernel as whole, 16-byte aligned rows: a
    strided or misaligned cotangent is copied first (autograd's are
    contiguous on the train path)."""
    _check_k7_inputs(g2, q, scale, dtype)
    M, N = g2.shape
    K = q.shape[0]
    rows, _, _, group = _k7_plan(M, K, N)
    g2 = _whole_rows(g2)
    record = _capture_record("w8a16_dx")
    gs = torch.empty((M, N), dtype=dtype, device=g2.device)
    dx = torch.empty((M, K), dtype=dtype, device=g2.device)
    err = _build.load("w8a16_dx").mc_w8a16_dx(
        g2.data_ptr(), q.data_ptr(), scale.data_ptr(), gs.data_ptr(),
        dx.data_ptr(), M, K, N, rows, group, _G_TYPES[g2.dtype],
        int(dtype == torch.bfloat16),
        torch.cuda.current_stream(g2.device).cuda_stream)
    _build.check(err, "w8a16_dx")
    if record is not None:  # recorded, not run: each replay runs it
        record.dx.append((M, K, N))
    else:
        w8a16_dx.launches += 1
    return dx


def _k7_scale(g2, scale, dtype):
    """K7's first pass alone (``mc_w8a16_dx_scale``, the first half of
    ``_k7``'s call) on a CUDA cotangent: gs = ``_scale_cotangent``.  Not
    counted: for measuring and testing the passes one by one."""
    _check_k7_inputs(g2, None, scale, dtype)
    M, N = g2.shape
    g2 = _whole_rows(g2)
    gs = torch.empty((M, N), dtype=dtype, device=g2.device)
    err = _build.load("w8a16_dx").mc_w8a16_dx_scale(
        g2.data_ptr(), scale.data_ptr(), gs.data_ptr(), M, N,
        _G_TYPES[g2.dtype], int(dtype == torch.bfloat16),
        torch.cuda.current_stream(g2.device).cuda_stream)
    _build.check(err, "w8a16_dx_scale")
    return gs


def _k7_product(gs, q):
    """K7's second pass alone (``mc_w8a16_dx_product``, the second half of
    ``_k7``'s call): dx = gs @ q^T on the plan's block, gs [M, N] in x's
    type, contiguous and 16-byte aligned.  Not counted: for measuring and
    testing the passes one by one."""
    _check_k7_inputs(gs, q, None, gs.dtype)
    if not gs.is_contiguous() or gs.data_ptr() % 16:
        raise ValueError("gs must be contiguous and 16-byte aligned")
    M, N = gs.shape
    K = q.shape[0]
    rows, _, _, group = _k7_plan(M, K, N)
    dx = torch.empty((M, K), dtype=gs.dtype, device=gs.device)
    err = _build.load("w8a16_dx").mc_w8a16_dx_product(
        gs.data_ptr(), q.data_ptr(), dx.data_ptr(), M, K, N, rows, group,
        int(gs.dtype == torch.bfloat16),
        torch.cuda.current_stream(gs.device).cuda_stream)
    _build.check(err, "w8a16_dx_product")
    return dx


def w8a16_dx(g: torch.Tensor, wq: Dict[str, torch.Tensor],
             dtype) -> torch.Tensor:
    """dL/dx of ``dequant_matmul(x, wq)`` for its cotangent g [..., N], in
    x's type ``dtype``: ``(g * scale) @ q^T``, the product of g scaled and
    rounded to ``dtype`` with the exact int8 weight, fp32-accumulated.  On a
    CUDA tensor kernel K7 (the scaled cotangent, then the product), on a
    CPU tensor its plain version ``_dequant_matmul_dx``.  The backward of
    every kernel product of ``dequant_matmul`` calls it."""
    N = g.shape[-1]
    g2 = g.reshape(-1, N)
    if _route.on_card(g2, "products"):
        dx = _k7(g2, wq["q"], wq["scale"], dtype)
    else:
        dx = _dequant_matmul_dx(g2, wq["q"], wq["scale"], dtype)
    return dx.reshape(*g.shape[:-1], dx.shape[-1])


class _DequantMatmul(torch.autograd.Function):
    """A kernel's forward (``kernel``: K5 on one weight or a group that
    shares x, or K6) and its backward through x (the weights are frozen):
    each member's dL/dx through ``w8a16_dx`` (K7 on the card), summed in
    the members' order.  ``flat`` is q, scale of each weight in turn."""

    @staticmethod
    def forward(ctx, x2, out_dtype, kernel, *flat):
        ctx.save_for_backward(*flat)
        ctx.x_dtype = x2.dtype
        weights = [{"q": q, "scale": s} for q, s in zip(flat[::2], flat[1::2])]
        return tuple(kernel(x2, weights, out_dtype))

    @staticmethod
    def backward(ctx, *grads):
        flat = ctx.saved_tensors
        dx = None
        for g, q, scale in zip(grads, flat[::2], flat[1::2]):
            d = w8a16_dx(g, {"q": q, "scale": scale}, ctx.x_dtype)
            dx = d if dx is None else dx + d
        return (dx, None, None) + (None,) * len(flat)


def _rows(x: torch.Tensor) -> int:
    """x's rows with its leading axes flattened."""
    K = x.shape[-1]
    return x.numel() // K if K else 0


def _launch(kernel, x, weights, out_dtype):
    """``kernel`` (``_k5`` or ``_k6``) on x [..., K] and ``weights``,
    differentiable through x; outputs [..., N] each."""
    K = x.shape[-1]
    x2 = x.reshape(_rows(x), K)
    out_dtype = out_dtype or x.dtype
    if torch.is_grad_enabled() and x.requires_grad:
        flat = [t for wq in weights for t in (wq["q"], wq["scale"])]
        ys = _DequantMatmul.apply(x2, out_dtype, kernel, *flat)
    else:
        ys = kernel(x2, weights, out_dtype)
    return [y.reshape(*x.shape[:-1], y.shape[-1]) for y in ys]


def _k5_call(x, weights, out_dtype):
    """K5 on x [..., K] and ``weights`` (one, or a group)."""
    return _launch(_k5, x, weights, out_dtype)


def w8a16_gemm(x: torch.Tensor, wq: Dict[str, torch.Tensor],
               out_dtype=None) -> torch.Tensor:
    """Kernel K6 on a CUDA tensor x [..., K] of any number of rows:
    ``(x @ q) * scale``, fp32-accumulated, in ``out_dtype`` (default
    x.dtype); differentiable through x.  ``dequant_matmul`` calls it above
    K5_MAX_ROWS rows."""
    return _launch(_k6, x, [wq], out_dtype)[0]


def dequant_matmul(x: torch.Tensor, wq: Dict[str, torch.Tensor],
                   out_dtype=None, impl: str = "auto") -> torch.Tensor:
    """y = x @ dequant(wq), fp32-accumulated, in ``out_dtype`` (default
    x.dtype).

    impl "auto": on a CUDA tensor of bf16 or fp16 with 1..K5_MAX_ROWS
    rows (x's leading axes flattened; every decode-time product) kernel K5,
    which streams the int8 weight; with more rows (prefill, chunks, the
    train forward on an int8 base) kernel K6, the tensor-core GEMM that
    converts each int8 tile on its way to the tensor cores.  Either one's
    gradient through x is kernel K7 (``w8a16_dx``).  A CPU tensor, and x of
    any other float type (fp32) on every device, takes
    ``dequant_matmul_reference`` (the convert and the fp32-output GEMM),
    differentiated by autograd: the routing rule by dtype, not a fallback
    (a bf16 or fp16 x that a kernel refuses raises).  impl "reference":
    the plain version everywhere.  Differentiable through x."""
    if impl == "reference":
        return dequant_matmul_reference(x, wq, out_dtype)
    if impl != "auto":
        raise ValueError(f"unknown dequant_matmul impl {impl!r}")
    rows = _rows(x)
    if not _route.on_card(x, "products") or not _route.kernel_dtype(x) \
            or rows == 0:
        return dequant_matmul_reference(x, wq, out_dtype)
    if rows <= K5_MAX_ROWS:
        return _k5_call(x, [wq], out_dtype)[0]
    return w8a16_gemm(x, wq, out_dtype)


def k5_groups(x: torch.Tensor, n: int) -> bool:
    """Whether ``n`` int8 products of x run as one K5 launch: on a CUDA
    tensor of bf16 or fp16 of 1..K5_GROUP_ROWS rows (batch-1 decode, the
    vision pair), 2 to K5_GROUP_MAX weights."""
    return _route.on_card(x, "products") and _route.kernel_dtype(x) \
        and 1 < n <= K5_GROUP_MAX \
        and 0 < _rows(x) <= min(K5_GROUP_ROWS, K5_MAX_ROWS)


def dequant_matmul_group(x: torch.Tensor, weights, out_dtype=None,
                         impl: str = "auto"):
    """``[dequant_matmul(x, wq, out_dtype, impl) for wq in weights]``: the
    products of int8 weights that share x (q/k/v, gate/up), each in its own
    output.  impl "auto" where ``k5_groups`` says so: one K5 launch whose
    grid covers every weight's column tiles, differentiable through x.
    Anywhere else (3-8 rows, K6's larger products, CPU tensors, impl
    "reference") each weight runs as ``dequant_matmul`` runs it alone."""
    if impl == "auto" and k5_groups(x, len(weights)):
        return _k5_call(x, list(weights), out_dtype)
    return [dequant_matmul(x, wq, out_dtype, impl) for wq in weights]


# Launches of K5 (``dequant_matmul.launches``: one per call that ran it, a
# grouped call one), of K6 (``w8a16_gemm.launches``) and of K7
# (``w8a16_dx.launches``); a replayed graph adds the launches its capture
# recorded (core/decode_graph).
dequant_matmul.launches = 0
w8a16_gemm.launches = 0
w8a16_dx.launches = 0


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "q" in w


def quantize_backbone(params: Dict[str, Any],
                      quantize_lm_head: bool = True) -> Dict[str, Any]:
    """Quantize the dense base weights of a core/llama.py param tree; LoRA
    stacks, norms and the embedding stay as they are."""
    out = dict(params)
    layers = dict(params["layers"])
    for grp in ("attn", "mlp"):
        group = {}
        for name, p in layers[grp].items():
            p2 = dict(p)
            p2["w"] = quantize_int8(p["w"], axis=-2)
            group[name] = p2
        layers[grp] = group
    out["layers"] = layers
    if quantize_lm_head:
        out["lm_head"] = quantize_int8(params["lm_head"], axis=-2)
    return out
