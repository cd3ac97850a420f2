"""Rotary position embeddings, HF-Llama convention (counterpart of
modelcompose_tpu/ops/rope.py): cos/sin over ``t * inv_freq`` with the
frequency vector duplicated, and the rotate-half pairing."""

import torch


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0, dtype=torch.float32):
    """positions: [...] int absolute positions -> (cos, sin) [..., head_dim]."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=positions.device)
        / head_dim))
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(q, k, cos, sin):
    """q: [B, L, H, hd]; k: [B, L, Hkv, hd]; cos/sin: [B, L, hd].
    The products run in fp32 (cos/sin are fp32) and cast back."""
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    q_rot = q * cos + _rotate_half(q) * sin
    k_rot = k * cos + _rotate_half(k) * sin
    return q_rot.to(q.dtype), k_rot.to(k.dtype)
