"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface.  On first use it is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``_build/`` (listed in .gitignore), keyed by a hash of the source, of every
``csrc/*.cuh`` it includes and of the flags, and loaded with ``ctypes``.
Nothing here runs at import time: a machine without ``nvcc`` imports the
package and uses the kernels' plain PyTorch versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

# C signature of every entry point: (argtypes, restype).  A pointer or the
# stream passed as a 32-bit int would be cut, so every one is c_void_p.
SIGNATURES = {
    "decode_fused": {
        "mc_add_rms_norm": (
            [_P, _P, _P, _P, _P,          # x y w sum out
             _I, _I, _F, _I, _P], _I),    # M H eps x_bf16 stream
        "mc_rope_kv_write": (
            [_P, _P, _P, _P, _P, _P,      # q k v cos sin q_out
             _P, _P, _P, _P, _P, _I,      # cache_k cache_v scale_k scale_v
             #                              pos pos64
             _I, _I, _I, _I, _I,          # B S H Hkv D
             _I, _I, _I, _P], _I),        # layer int8 x_bf16 stream
        "mc_silu_mul": (
            [_P, _P, _P, _L, _I, _P], _I),  # gate up out n x_bf16 stream
    },
    "flash_attention_fwd": {
        "mc_flash_attention_fwd": (
            [_P, _P, _P, _P, _P, _P, _P,  # q k v q_seg kv_seg out lse
             _I, _I, _I, _I, _I, _I,      # B H Hkv Lq S D
             _F, _I, _I, _I, _P], _I),    # sm_scale causal q_offset dtype
        #                                   stream
        "mc_flash_attention_fwd_mask_all": (
            [_P, _P, _P, _P, _P, _P, _P,  # q k v q_seg kv_seg out lse
             _I, _I, _I, _I, _I, _I,      # B H Hkv Lq S D
             _F, _I, _I, _I, _P], _I),    # sm_scale causal q_offset dtype
        #                                   stream
        "mc_flash_attention_fwd_smem": ([_I, _I], _I),  # D dtype
    },
    "flash_attention_bwd": {
        **{f"mc_flash_attention_bwd_dq{tail}": (
            [_P, _P, _P, _P, _P, _P,      # q k v dout lse di
             _P, _P, _P,                  # q_seg kv_seg dq
             _I, _I, _I, _I, _I, _I,      # B H Hkv Lq S D
             _F, _I, _I, _I, _P], _I)     # sm_scale causal q_offset dtype
           #                                stream
           for tail in ("", "_mask_all")},
        **{f"mc_flash_attention_bwd_dkv{tail}": (
            [_P, _P, _P, _P, _P, _P,      # q k v dout lse di
             _P, _P, _P, _P,              # q_seg kv_seg dk dv
             _I, _I, _I, _I, _I, _I,      # B H Hkv Lq S D
             _F, _I, _I, _I, _P], _I)     # sm_scale causal q_offset dtype
           #                                stream
           for tail in ("", "_mask_all")},
        "mc_flash_attention_bwd_smem": ([_I, _I, _I], _I),  # dkv D dtype
    },
    "flash_decode": {
        "mc_flash_decode_split_len": ([], _I),
        "mc_flash_decode_smem": ([_I, _I, _I], _I),  # D quantized dtype
        "mc_flash_decode": (
            [_P, _P, _P, _P, _P, _P,      # q kc vc ks vs kv_len
             _P, _P, _P, _P, _P,          # part_m part_l part_acc counters out
             _I, _I, _I, _I, _I, _I,      # NL B H Hkv S D
             _I, _I, _I,                  # layer quantized dtype
             _F, _P], _I),                # sm_scale stream
    },
    "w8a16_gemm": {
        "mc_w8a16_gemm": (
            [_P, _P, _P, _P,              # x q scale out
             _I, _I, _I, _I, _I,          # M K N rows group
             _I, _I, _I,                  # split clusters whole
             _I, _I, _P], _I),            # x_bf16 out_type stream
        "mc_w8a16_gemm_clusters": ([_I, _I], _I),  # rows split
        "mc_w8a16_gemm_smem": ([_I], _I),  # rows
    },
    "w8a16_dx": {
        "mc_w8a16_dx": (
            [_P, _P, _P, _P, _P,          # g q scale gs dx
             _I, _I, _I, _I, _I,          # M K N rows group
             _I, _I, _P], _I),            # g_type x_bf16 stream
        "mc_w8a16_dx_scale": (
            [_P, _P, _P,                  # g scale gs
             _I, _I,                      # M N
             _I, _I, _P], _I),            # g_type x_bf16 stream
        "mc_w8a16_dx_product": (
            [_P, _P, _P,                  # gs q dx
             _I, _I, _I, _I, _I,          # M K N rows group
             _I, _P], _I),                # x_bf16 stream
        "mc_w8a16_dx_smem": ([_I], _I),   # rows
    },
    "w8a16_gemv": {
        "mc_w8a16_gemv": (
            [_P, _I, _P, _P, _P, _P,      # x n_members q[] scale[] out[] N[]
             _P, _P,                      # part counters
             _I, _I, _I, _I, _I,          # M K ldx rows tile
             _I, _I, _P], _I),            # x_bf16 out_type stream
        "mc_w8a16_gemv_norm": (
            [_P, _P, _P, _P, _P, _F,      # x y norm_w sum h eps
             _I, _P, _P, _P, _P,          # n_members q[] scale[] out[] N[]
             _P, _P,                      # part counters
             _I, _I, _I, _I, _I, _I,      # M K rows x_bf16 out_type head_dim
             _P, _P, _P, _P, _P, _P, _P,  # cos sin cache_k cache_v scale_k
             #                              scale_v pos
             _I, _I, _I, _I, _P], _I),    # pos64 S Hkv layer stream
        "mc_w8a16_gemv_silu": (
            [_P, _P, _P, _P, _P, _P,      # gate up h q scale out
             _I, _P, _P,                  # N part counters
             _I, _I, _I, _I, _I, _P], _I),  # M K rows x_bf16 out_type
        #                                     stream
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(src: Path):
    """``src`` and every ``csrc`` header it includes, transitively."""
    seen, todo = [], [src]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        todo += [CSRC / h.decode() for h in _INCLUDE.findall(path.read_bytes())]
    return seen


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; raise on failure."""
    if name in _libs:
        return _libs[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(b"".join(f.read_bytes() for f in _sources(src))
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{digest}.so"
    t0 = time.perf_counter()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        build_log[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{build_log[name]}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    lib = ctypes.CDLL(str(out))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    build_seconds[name] = time.perf_counter() - t0
    _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
