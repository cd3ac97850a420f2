"""PointBERT v1.2 point-cloud encoder (counterpart of
modelcompose_tpu/models/point_bert.py).

8192 x 6 points (xyz rgb) -> farthest-point sampling of 512 group centers
-> 32-nearest-neighbour groups (xyz centered on the center, rgb appended)
-> a mini-PointNet group encoder (1x1 convs, eval-mode BatchNorm, two
max-pools; 6 -> 256) -> reduce_dim to 384 -> [CLS] + 512 tokens through a
12-layer pre-LN ViT whose positional MLP (3 -> 128 -> GELU -> 384) of the
centers is re-added before every block -> final LayerNorm -> [B, 513, 384]
(or, with ``use_max_pool``, [B, 1, 768]: CLS beside the max over tokens).

Farthest-point sampling starts at index 0 (the reference seeds it at
random) and is a loop of ``npoint`` argmax steps, with fp32 distances
summed x, y, z in order and ties going to the first index, so its indices
are the JAX package's bit for bit.  The kNN is a top-k over squared
distances; the order of equal distances may differ, which the max-pools
after it do not see.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..devices import resolve_device
from ..tree import numpy_to_torch
from .vision_clip import _ln, _proj, stacked_ln_from


@dataclasses.dataclass(frozen=True)
class PointBertConfig:
    trans_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    group_size: int = 32
    num_group: int = 512
    encoder_dims: int = 256
    point_dims: int = 6
    npoints: int = 8192
    mlp_ratio: float = 4.0
    use_max_pool: bool = False

    @property
    def hidden_size(self) -> int:
        return self.trans_dim * 2 if self.use_max_pool else self.trans_dim


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distance over the last axis (3), summed in index order."""
    d = (a - b).square()
    return d[..., 0] + d[..., 1] + d[..., 2]


def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          start_index: int = 0) -> torch.Tensor:
    """xyz: [B, N, 3] -> [B, npoint] int32 indices."""
    B, N, _ = xyz.shape
    rows = torch.arange(B, device=xyz.device)
    centroids = torch.zeros((B, npoint), dtype=torch.int64, device=xyz.device)
    distance = torch.full((B, N), 1e10, dtype=torch.float32,
                          device=xyz.device)
    farthest = torch.full((B,), start_index, dtype=torch.int64,
                          device=xyz.device)
    for i in range(npoint):
        centroids[:, i] = farthest
        dist = _sq_dist(xyz, xyz[rows, farthest][:, None, :])
        distance = torch.minimum(distance, dist)
        farthest = distance.argmax(-1)  # the first index among ties
    return centroids.to(torch.int32)


def knn_point(nsample: int, xyz: torch.Tensor,
              new_xyz: torch.Tensor) -> torch.Tensor:
    """[B, N, 3] x [B, S, 3] -> [B, S, nsample] nearest-point indices."""
    sqr = _sq_dist(new_xyz[:, :, None, :], xyz[:, None, :, :])
    return torch.topk(-sqr, nsample, dim=-1).indices


def group_points(points: torch.Tensor, cfg: PointBertConfig,
                 start_index: int = 0):
    """points: [B, N, C>=3] -> (neighborhood [B, G, M, C], centers
    [B, G, 3]), xyz centered per group."""
    xyz = points[..., :3]
    fps_idx = farthest_point_sample(xyz, cfg.num_group, start_index).long()
    rows = torch.arange(points.shape[0], device=points.device)[:, None]
    center = xyz[rows, fps_idx]                        # [B, G, 3]
    idx = knn_point(cfg.group_size, xyz, center)       # [B, G, M]
    neighborhood = points[rows[..., None], idx]        # [B, G, M, C]
    neighborhood = torch.cat([neighborhood[..., :3] - center[:, :, None],
                              neighborhood[..., 3:]], dim=-1)
    return neighborhood, center


def _bn(p, x):
    """BatchNorm in eval mode: the running statistics, never the batch's."""
    return (x - p["mean"]) * torch.rsqrt(p["var"] + 1e-5) * p["scale"] \
        + p["bias"]


def init_point_bert(cfg: PointBertConfig, generator: torch.Generator,
                    dtype=torch.float32, device=None) -> Dict[str, Any]:
    D, E, L = cfg.trans_dim, cfg.encoder_dims, cfg.depth
    I = int(D * cfg.mlp_ratio)

    def normal(shape, std=0.02):
        return (torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device) * std).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def dense(d_in, d_out):
        return {"w": normal((d_in, d_out)), "b": zeros(d_out)}

    def stacked(d_in, d_out):
        return {"w": normal((L, d_in, d_out)), "b": zeros(L, d_out)}

    def stacked_ln(d):
        return {"scale": ones(L, d), "bias": zeros(L, d)}

    def bn(d):
        return {"scale": ones(d), "bias": zeros(d), "mean": zeros(d),
                "var": ones(d)}

    return {
        "encoder": {"conv1": dense(cfg.point_dims, 128), "bn1": bn(128),
                    "conv2": dense(128, 256), "conv3": dense(512, 512),
                    "bn2": bn(512), "conv4": dense(512, E)},
        "reduce_dim": dense(E, D),
        "cls_token": zeros(D),
        "cls_pos": normal((D,), 1.0),
        "pos_embed": {"fc1": dense(3, 128), "fc2": dense(128, D)},
        "blocks": {"ln1": stacked_ln(D), "qkv": stacked(D, 3 * D),
                   "proj": stacked(D, D), "ln2": stacked_ln(D),
                   "fc1": stacked(D, I), "fc2": stacked(I, D)},
        "norm": {"scale": ones(D), "bias": zeros(D)},
    }


def _mini_pointnet(enc, groups: torch.Tensor) -> torch.Tensor:
    """groups: [B, G, M, C] -> [B, G, encoder_dims]."""
    B, G, M, C = groups.shape
    x = groups.reshape(B * G, M, C)
    f = F.relu(_bn(enc["bn1"], _proj(enc["conv1"], x)))
    f = _proj(enc["conv2"], f)                          # [BG, M, 256]
    g = f.amax(dim=1, keepdim=True)
    f = torch.cat([g.expand_as(f), f], dim=-1)
    f = F.relu(_bn(enc["bn2"], _proj(enc["conv3"], f)))
    f = _proj(enc["conv4"], f)
    return f.amax(dim=1).reshape(B, G, -1)


def point_bert_features(params: Dict[str, Any], cfg: PointBertConfig,
                        points: torch.Tensor,
                        fps_start_index: int = 0) -> torch.Tensor:
    """points: [B, N, point_dims] -> [B, num_group + 1, trans_dim]."""
    neighborhood, center = group_points(points, cfg, fps_start_index)
    tokens = _proj(params["reduce_dim"],
                   _mini_pointnet(params["encoder"], neighborhood))
    B, G, D = tokens.shape
    cls = params["cls_token"].expand(B, 1, D)
    cls_pos = params["cls_pos"].expand(B, 1, D)
    pos = _proj(params["pos_embed"]["fc2"],
                F.gelu(_proj(params["pos_embed"]["fc1"], center)))
    x = torch.cat([cls, tokens], dim=1)
    pos = torch.cat([cls_pos, pos], dim=1)

    nh = cfg.num_heads
    hd = cfg.trans_dim // nh
    blocks = params["blocks"]
    for li in range(cfg.depth):
        bp = {k: {n: t[li] for n, t in v.items()} for k, v in blocks.items()}
        x = x + pos  # re-added before every block
        qkv = _proj(bp["qkv"], _ln(bp["ln1"], x, 1e-5)).view(B, -1, 3, nh,
                                                              hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
            * (hd ** -0.5)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
        x = x + _proj(bp["proj"], ctx.reshape(B, -1, nh * hd).to(x.dtype))
        h = F.gelu(_proj(bp["fc1"], _ln(bp["ln2"], x, 1e-5)))
        x = x + _proj(bp["fc2"], h)
    x = _ln(params["norm"], x, 1e-5)
    if cfg.use_max_pool:
        return torch.cat([x[:, 0], x[:, 1:].amax(dim=1)], dim=-1)[:, None]
    return x


def convert_point_bert(state: Dict[str, np.ndarray], cfg: PointBertConfig,
                       dtype=torch.float32, device=None) -> Dict[str, Any]:
    """A PointBERT v1.2 state dict (numpy) -> the stacked tree, as tensors
    of ``dtype`` on ``device``.  The ViT blocks have no qkv bias
    (``qkv_bias=False``): a missing bias is zero."""
    def g(k):
        return np.asarray(state[k], np.float32)

    L = cfg.depth

    def conv1x1(prefix):  # torch Conv1d weight [out, in, 1] -> [in, out]
        return {"w": g(f"{prefix}.weight")[..., 0].T,
                "b": g(f"{prefix}.bias")}

    def bn(prefix):
        return {"scale": g(f"{prefix}.weight"), "bias": g(f"{prefix}.bias"),
                "mean": g(f"{prefix}.running_mean"),
                "var": g(f"{prefix}.running_var")}

    def bias_or_zero(prefix, d_out):
        key = f"{prefix}.bias"
        return g(key) if key in state else np.zeros(d_out, np.float32)

    def dense(prefix):
        w = g(f"{prefix}.weight")
        return {"w": w.T, "b": bias_or_zero(prefix, w.shape[0])}

    def stack_dense(fmt):
        ds = [dense(fmt.format(i=i)) for i in range(L)]
        return {"w": np.stack([d["w"] for d in ds]),
                "b": np.stack([d["b"] for d in ds])}

    def stack_ln(fmt):
        return stacked_ln_from(g, fmt, L)

    params = {
        "encoder": {
            "conv1": conv1x1("encoder.first_conv.0"),
            "bn1": bn("encoder.first_conv.1"),
            "conv2": conv1x1("encoder.first_conv.3"),
            "conv3": conv1x1("encoder.second_conv.0"),
            "bn2": bn("encoder.second_conv.1"),
            "conv4": conv1x1("encoder.second_conv.3"),
        },
        "reduce_dim": dense("reduce_dim"),
        "cls_token": g("cls_token")[0, 0],
        "cls_pos": g("cls_pos")[0, 0],
        "pos_embed": {"fc1": dense("pos_embed.0"),
                      "fc2": dense("pos_embed.2")},
        "blocks": {
            "ln1": stack_ln("blocks.blocks.{i}.norm1"),
            "qkv": stack_dense("blocks.blocks.{i}.attn.qkv"),
            "proj": stack_dense("blocks.blocks.{i}.attn.proj"),
            "ln2": stack_ln("blocks.blocks.{i}.norm2"),
            "fc1": stack_dense("blocks.blocks.{i}.mlp.fc1"),
            "fc2": stack_dense("blocks.blocks.{i}.mlp.fc2"),
        },
        "norm": {"scale": g("norm.weight"), "bias": g("norm.bias")},
    }
    return numpy_to_torch(params, dtype, device)


class PointCloudProcessor:
    """npy path(s) or arrays [N, C] -> [B, N, C] float32; loads and stacks,
    as the reference's processor does."""

    def __call__(self, pc_files):
        if isinstance(pc_files, (str, np.ndarray)):
            pc_files = [pc_files]
        arrays = [np.load(p) if isinstance(p, str) else np.asarray(p)
                  for p in pc_files]
        return np.stack(arrays).astype(np.float32)

    @staticmethod
    def pc_norm(pc: np.ndarray) -> np.ndarray:
        """Unit-sphere normalization of the xyz columns.  Not applied in the
        data path: the released clouds are pre-normalized."""
        xyz, rest = pc[:, :3], pc[:, 3:]
        xyz = xyz - xyz.mean(axis=0)
        m = np.sqrt((xyz ** 2).sum(axis=1)).max()
        return np.concatenate([xyz / m, rest], axis=1)


class PointBertTower:
    modality = "point"

    def __init__(self, spec: str, model_cfg=None,
                 generator: Optional[torch.Generator] = None,
                 params: Optional[Dict[str, Any]] = None,
                 dtype=torch.float32, device=None):
        if spec.startswith("test:"):
            h, l = spec.split(":")[1].split("x")
            self.cfg = PointBertConfig(trans_dim=int(h), depth=int(l),
                                       num_heads=2, group_size=4,
                                       num_group=8, encoder_dims=16,
                                       npoints=64)
        else:
            self.cfg = PointBertConfig()
        self.spec = spec
        if params is None:
            device = resolve_device(device)
            if os.path.isfile(spec):
                params = self.load_model(dtype, device)
            else:
                if generator is None:
                    generator = torch.Generator(device=device)
                    generator.manual_seed(0)
                params = init_point_bert(self.cfg, generator, dtype, device)
        self.params = params

    def load_model(self, dtype=torch.float32, device=None) -> Dict[str, Any]:
        """A PointBERT ``.pt`` (optionally under 'state_dict', keys
        optionally prefixed ``module.point_encoder.``)."""
        ckpt = torch.load(self.spec, map_location="cpu", weights_only=False)
        state = ckpt.get("state_dict", ckpt)
        state = {k.replace("module.point_encoder.", ""): v.float().numpy()
                 for k, v in state.items()}
        return convert_point_bert(state, self.cfg, dtype, device)

    @property
    def hidden_size(self) -> int:
        return self.cfg.hidden_size

    @property
    def feature_len(self) -> int:
        return 1 if self.cfg.use_max_pool else self.cfg.num_group + 1

    @property
    def modal_processor(self):
        return PointCloudProcessor()

    def encode(self, points) -> torch.Tensor:
        device = self.params["cls_token"].device
        return point_bert_features(self.params, self.cfg,
                                   torch.as_tensor(points, device=device))
