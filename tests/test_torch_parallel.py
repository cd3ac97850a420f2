"""The port's ``parallel/`` against the JAX package's (one process, CPU).

- ``local_batch_slice`` against the JAX arithmetic with its process index
  and count patched;
- the data width of ``mesh_for_batch`` against JAX ``mesh_for_batch`` on
  the conftest's 8 virtual devices, for B in 1..16 and both
  ``allow_partial`` values;
- ``param_pspecs`` leaf for leaf;
- ``shard_params``: each model rank's shard equal to the
  ``addressable_shards`` of JAX ``shard_params`` on a (1, tp) mesh, for tp
  2 and 4, bf16 and int8 (where the JAX package replicates an int8 leaf's
  scale, the port holds a column-split leaf's scale columns);
- the ZeRO-1 axis of every moment leaf against JAX ``shard_opt_state`` on
  (2, 2) and (4, 1) meshes, and ``shard_encoder_features``;
- the single-process paths: a mesh of one process runs no collective, and
  a one-process optimizer step with a mesh is bit-equal to one without.

Exact equality throughout (integer plans and copied tensors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import modelcompose_tpu.parallel.distributed as jdist
from modelcompose_tpu.config import tiny_test_config as jax_tiny
from modelcompose_tpu.core.llama import init_params as jax_init_params
from modelcompose_tpu.ops.quant import quantize_backbone as jax_quantize
from modelcompose_tpu.parallel import mesh as jmesh

from modelcompose_tpu_torch.config import tiny_test_config
from modelcompose_tpu_torch.convert import params_from_jax
from modelcompose_tpu_torch.parallel import distributed, mesh, tp
from modelcompose_tpu_torch.tree import tree_leaves


def _jax_params(quantized, dtype="bfloat16"):
    cfg = jax_tiny(local_prefix_tokens=1, local_suffix_tokens=2,
                   mm_vision_encoder="test:32x2", mm_hidden_size=32,
                   dtype=dtype)
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda a: jnp.asarray(
        rng.normal(0, 0.1, a.shape), a.dtype), params)
    if quantized:
        params = jax_quantize(params)
    return jax.tree.map(np.asarray, params)


def _flat_specs(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_specs(v, path + (k,)))
        return out
    return {path: tuple(tree)}


@pytest.mark.parametrize("count,batch", [(1, 8), (2, 8), (4, 16), (3, 9),
                                         (8, 16)])
def test_local_batch_slice_matches_jax(monkeypatch, count, batch):
    for index in range(count):
        monkeypatch.setattr(jax, "process_index", lambda: index)
        monkeypatch.setattr(jax, "process_count", lambda: count)
        assert distributed.local_batch_slice(batch, index, count) \
            == jdist.local_batch_slice(batch)
    # no process group: world 1, rank 0
    assert distributed.local_batch_slice(batch) == slice(0, batch)
    assert distributed.world_size() == 1 and distributed.is_primary()


@pytest.mark.parametrize("allow_partial", [False, True])
@pytest.mark.parametrize("model", [1, 2])
def test_mesh_for_batch_data_width_matches_jax(allow_partial, model):
    n = len(jax.devices())
    assert n == 8
    for batch in range(1, 17):
        try:
            want = jmesh.mesh_for_batch(batch, model=model,
                                        allow_partial=allow_partial)
        except ValueError:
            with pytest.raises(ValueError, match="does not divide"):
                mesh.data_width_for_batch(batch, n, model, allow_partial)
            continue
        assert mesh.data_width_for_batch(batch, n, model, allow_partial) \
            == want.shape["data"], batch


def test_mesh_for_batch_names_the_idle_ranks():
    """One process: the whole world is the mesh; more than the world
    raises as JAX ``make_mesh`` does."""
    got = mesh.mesh_for_batch(3)
    assert (got.data, got.model, got.data_rank, got.data_group) == \
        (1, 1, 0, None)
    with pytest.raises(ValueError, match="need 2 processes, have 1"):
        mesh.make_mesh(data=2, model=1)
    with pytest.raises(ValueError):
        jmesh.make_mesh(data=16, model=1)


@pytest.mark.parametrize("quantized", [False, True])
def test_param_pspecs_match_jax(quantized):
    params = _jax_params(quantized)
    want = _flat_specs(jmesh.param_pspecs(params))
    got = _flat_specs(mesh.param_pspecs(params))
    assert got == want
    assert got[("layers", "attn", "q", "lora_b")] == (None, None, None,
                                                     "model")
    assert got[("layers", "mlp", "down", "w")] == (None, "model", None)


def _shard_of(leaf, jm, j):
    """The data of the JAX leaf's shard on model position j."""
    dev = jm.devices[0, j]
    return next(np.asarray(s.data) for s in leaf.addressable_shards
                if s.device == dev)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("tp_size", [2, 4])
def test_shard_params_match_jax_addressable_shards(quantized, tp_size):
    params = _jax_params(quantized)
    jm = jmesh.make_mesh(data=1, model=tp_size,
                         devices=jax.devices()[:tp_size])
    want = dict(tree_leaves(jmesh.shard_params(params, jm)))
    full = params_from_jax(params, "cpu")
    specs = mesh.leaf_specs(full)
    for j in range(tp_size):
        got = dict(tree_leaves(mesh.shard_params(full, j, tp_size)))
        assert sorted(got) == sorted(want)
        for path, leaf in got.items():
            jshard = _shard_of(want[path], jm, j)
            g = leaf.float().numpy() if leaf.dtype == torch.bfloat16 \
                else leaf.numpy()
            if path[-1] == "scale" and mesh.split_axis(specs[path]) is None \
                    and mesh.split_axis(specs[path[:-1] + ("q",)]) \
                    is not None:
                # a row-split int8 leaf: its scale whole, as in JAX
                assert g.shape == jshard.shape
            elif path[-1] == "scale":
                axis = mesh.split_axis(specs[path])
                n = jshard.shape[axis] // tp_size
                jshard = np.take(jshard, np.arange(j * n, (j + 1) * n), axis)
            np.testing.assert_array_equal(g, np.asarray(jshard, g.dtype),
                                          err_msg=str(path))
    # tp 1 keeps every tensor
    one = mesh.shard_params(full, 0, 1)
    assert all(a is b for (_, a), (_, b) in zip(tree_leaves(one),
                                                tree_leaves(full)))


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_zero_axis_matches_jax_shard_opt_state(shape):
    data, model = shape
    params = _jax_params(False, dtype="float32")
    jm = jmesh.make_mesh(data=data, model=model,
                         devices=jax.devices()[:data * model])
    specs = jmesh.param_pspecs(params)
    port_specs = mesh.leaf_specs(params_from_jax(params, "cpu"))
    leaves = dict(tree_leaves(params))
    flat_specs = _flat_specs(specs)
    moments = {"/".join(p): jax.device_put(
        np.zeros(a.shape, np.float32), NamedSharding(jm, P(*flat_specs[p])))
        for p, a in leaves.items()}
    out = jmesh.shard_opt_state(moments, jm)
    for path, a in leaves.items():
        spec = tuple(out["/".join(path)].sharding.spec)
        want = spec.index("data") if "data" in spec else None
        got = mesh.zero_axis(a.shape, port_specs[path], data)
        assert got == want, (path, spec)


@pytest.mark.parametrize("data", [2, 4])
def test_shard_encoder_features_matches_jax(data):
    jm = jmesh.make_mesh(data=data, model=1, devices=jax.devices()[:data])
    feats = {"vision": np.arange(4 * 3 * 2, dtype=np.float32).reshape(4, 3,
                                                                      2),
             "audio": np.arange(3 * 2, dtype=np.float32).reshape(3, 2)}
    want = jmesh.shard_encoder_features(feats, jm)
    for i in range(data):
        got = mesh.shard_encoder_features(
            {k: torch.from_numpy(v) for k, v in feats.items()},
            mesh.Mesh(data, 1, i, 0))
        for modal, leaf in want.items():
            dev = jm.devices[i, 0]
            shard = next(np.asarray(s.data) for s in leaf.addressable_shards
                         if s.device == dev)
            np.testing.assert_array_equal(got[modal].numpy(), shard)


def test_one_process_runs_no_collective():
    """Without a process group the model group is None: every
    tensor-parallel function is the plain operation."""
    assert tp.model_group() is None and tp.model_size() == 1
    x = torch.randn(2, 3, 8)
    table = torch.randn(10, 8)
    ids = torch.tensor([[1, 9, 0]])
    assert tp.copy_to_model(x) is x and tp.reduce_from_model(x) is x
    assert tp.gather_vocab(x) is x
    assert torch.equal(tp.vocab_embedding(table, ids), table[ids])
    assert tp.slice_rows(x, -1, 4) is x
    assert tp.group_sum(x, None) is x


def test_initialize_needs_an_address(monkeypatch):
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize()
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        distributed.initialize("localhost:1234")
    assert distributed._init_method("h:5") == "tcp://h:5"
    assert distributed._init_method("file:///tmp/x") == "file:///tmp/x"


def test_check_tp_divides():
    cfg = tiny_test_config(num_attention_heads=4, num_key_value_heads=2)
    mesh.check_tp_divides(cfg, 2)
    with pytest.raises(ValueError, match="num_key_value_heads 2"):
        mesh.check_tp_divides(cfg, 4)


def test_one_process_mesh_step_is_bit_equal():
    """An optimizer with a one-process mesh (no groups) steps exactly as
    one without: ZeRO needs data > 1, and the loss divides by the same
    count."""
    from modelcompose_tpu_torch.models.model import MultimodalLM
    from modelcompose_tpu_torch.train.trainer import (
        TrainConfig, init_train_state, make_optimizer, make_train_step)
    from modelcompose_tpu_torch.train.train_multimodal import make_batch
    from modelcompose_tpu_torch.constants import MODAL_TOKEN_INDEXES
    cfg = tiny_test_config(mm_vision_encoder="test:32x2", mm_hidden_size=32,
                           local_prefix_tokens=1, local_suffix_tokens=1)
    img = MODAL_TOKEN_INDEXES["vision"]
    pixels = np.random.default_rng(0).normal(size=(2, 28, 28, 3)).astype(
        np.float32)
    out = []
    for m in (None, mesh.make_mesh(1, 1)):
        model = MultimodalLM.random_init(cfg, torch.Generator().manual_seed(
            0), "cpu")
        batch, layout = make_batch(model, {
            "input_ids": [np.array([1, img, 9, 10]), np.array([1, 5, img])],
            "labels": [np.array([-100, -100, 9, 10]),
                       np.array([-100, 5, -100])],
            "modal_inputs": {"vision": pixels}}, buckets=(16,))
        tc = TrainConfig(warmup_ratio=0.0, max_grad_norm=1.0)
        tx, _ = make_optimizer(cfg, tc, {"backbone": model.params,
                                         "projectors": model.projectors}, m)
        state = init_train_state(cfg, tc, model.params, model.projectors,
                                 tx=tx)
        step = make_train_step(cfg, tc, tx)
        losses = [float(step(state, batch, layout)[1]) for _ in range(2)]
        out.append((losses, dict(tree_leaves(state.params))))
    assert out[0][0] == out[1][0]
    for path, t in out[0][1].items():
        assert torch.equal(t, out[1][1][path]), path


def test_tp_scope_is_per_block_and_per_thread():
    """A model group holds only inside its ``tp.scope`` block, on the
    thread that entered it; the outer scope comes back after the block."""
    import threading
    outer, inner = object(), object()
    seen = []
    with tp.scope(outer):
        assert tp.model_group() is outer
        with tp.scope(inner):
            assert tp.model_group() is inner
            worker = threading.Thread(
                target=lambda: seen.append(tp.model_group()))
            worker.start()
            worker.join()
        assert tp.model_group() is outer
    assert tp.model_group() is None and seen == [None]


def test_sharded_weights_outside_their_scope_raise():
    """A tp-2 rank's weights run with no model group would compute half of
    every sum: the layer refuses them."""
    from modelcompose_tpu_torch.core.llama import forward, init_params
    cfg = tiny_test_config(num_attention_heads=4, num_key_value_heads=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shard = mesh.shard_params(params, 0, 2)
    embeds = torch.zeros(1, 3, cfg.hidden_size,
                         dtype=params["embed_tokens"].dtype)
    forward(params, cfg, embeds)  # whole weights run as before
    with pytest.raises(RuntimeError, match="tp.scope"):
        forward(shard, cfg, embeds)
