"""The port's training against the JAX package (tiny configs, fp32, CPU).

- (b) gradients of ``routed_lora_matmul``, ``causal_lm_loss`` and
  ``MultimodalLM.loss`` (LoRA, projector, soft tokens) against
  ``jax.grad``, within 1e-5 of max |JAX grad|: the same fp32 math in
  another summation order; and of ``matmul_f32`` on bf16 operands, to a
  bf16 tolerance;
- (c) the hand-written optimizer against the optax chain of the JAX
  ``make_optimizer`` on the same tree and gradients, one case per label
  group (weight decay with nodecay leaves, the clip, adapter-row rates,
  bf16 first moments, the tower's layerwise decay, set_to_zero), within
  1e-6 relative in fp32;
- (d) ``adapter_row_lrs``, the labels and the schedule against the JAX
  package (the schedule to one float32 ulp of its cosine: XLA's own
  cosine differs by as much between jit and eager);
- (e) two train steps of the tiny vision model against JAX
  ``make_train_step`` (Pallas attention in interpret mode; the port's
  flash path, K1/K3/K4's plain versions), stage 2, stage 1, full finetune
  and stage 2 with the vision tower training (CLIP forward inside the
  step): loss and every trainable leaf within 1e-4 relative, frozen leaves
  bit for bit;
- (f) port-internal: remat equals no remat, ``loss_chunk`` equals the
  plain loss, two B=1 micro-batches accumulated equal one B=2 batch.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from modelcompose_tpu.config import tiny_test_config
from modelcompose_tpu.constants import IGNORE_INDEX, MODAL_TOKEN_INDEXES
from modelcompose_tpu.models import model as jmodel
from modelcompose_tpu.models.towers import ClipVisionTower as JaxClipTower
from modelcompose_tpu.ops.routed_lora import routed_lora_matmul as j_rlm
from modelcompose_tpu.train import train_multimodal as jentry
from modelcompose_tpu.train import trainer as jtrainer

from modelcompose_tpu_torch.config import ModelConfig as PortConfig
from modelcompose_tpu_torch.config import tiny_test_config as port_tiny_config
from modelcompose_tpu_torch.convert import (model_from_jax, params_from_jax,
                                            params_to_numpy)
from modelcompose_tpu_torch.core.llama import reinit_lora_a
from modelcompose_tpu_torch.models.model import MultimodalLM, causal_lm_loss
from modelcompose_tpu_torch.ops.routed_lora import routed_lora_matmul
from modelcompose_tpu_torch.train import train_multimodal as entry
from modelcompose_tpu_torch.train import trainer

IMG = MODAL_TOKEN_INDEXES["vision"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and the suite runs
    several workers side by side: keep torch to one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _port(cfg):
    """The port's config from the JAX config's dict: each package gets
    its own config class."""
    return PortConfig.from_dict(cfg.to_dict())



def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _cfg(**overrides):
    kw = dict(mm_vision_encoder="test:32x2", mm_hidden_size=32,
              mm_projector_type="mlp2x_gelu", local_prefix_tokens=1,
              local_suffix_tokens=1)
    kw.update(overrides)
    return tiny_test_config(**kw)


def _jax_model(cfg, seed=0):
    """A tiny model for both packages as numpy trees, made by the port's
    random init (the JAX one compiles every op eagerly, seconds on the
    CPU), with nonzero LoRA B and soft tokens so every trainable leaf gets
    a gradient; ``jax_encoders`` are JAX towers on the same weights."""
    tm = MultimodalLM.random_init(_port(cfg),
                                  torch.Generator().manual_seed(seed), "cpu")
    rng = np.random.default_rng(seed)
    params = params_to_numpy(tm.params)
    for grp in ("attn", "mlp"):
        for p in params["layers"][grp].values():
            p["lora_b"] = rng.normal(0, 0.05, p["lora_b"].shape).astype(
                np.float32)
    for key in ("prefix_tokens", "suffix_tokens"):
        for m in params.get(key, {}):
            params[key][m] = rng.normal(0, 0.05, params[key][m].shape) \
                .astype(np.float32)
    tower = params_to_numpy(tm.encoders["vision"].params)
    spec = cfg.encoder_spec("vision")
    jax_tower = JaxClipTower(spec, cfg, params=jax.tree.map(jnp.asarray,
                                                            tower))
    encoders = {"vision": types.SimpleNamespace(spec=spec, params=tower,
                                                cfg=jax_tower.cfg)}
    return types.SimpleNamespace(cfg=cfg, params=params,
                                 projectors=params_to_numpy(tm.projectors),
                                 encoders=encoders,
                                 jax_encoders={"vision": jax_tower})


def _jax_lm(nm):
    return jmodel.MultimodalLM(nm.cfg, jax.tree.map(jnp.asarray, nm.params),
                               nm.jax_encoders,
                               jax.tree.map(jnp.asarray, nm.projectors))


def _collated(B=2, seed=0):
    """Image + text samples with the same number of labelled positions."""
    rs = np.random.RandomState(seed)
    ids = [np.array([1, IMG, 7, 8, 9]), np.array([1, 5, IMG, 10, 11, 12])][:B]
    labels = [np.array([IGNORE_INDEX, IGNORE_INDEX, 7, 8, 9]),
              np.array([IGNORE_INDEX, IGNORE_INDEX, IGNORE_INDEX, 10, 11,
                        12])][:B]
    return {"input_ids": ids, "labels": labels,
            "modal_inputs": {"vision": rs.rand(B, 28, 28, 3).astype(
                np.float32)}}


# ---------------------------------------------------------------------------
# (b) gradients
# ---------------------------------------------------------------------------

def test_routed_lora_grads_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    w = rng.normal(size=(16, 12)).astype(np.float32)
    a = rng.normal(size=(3, 16, 4)).astype(np.float32)
    b = rng.normal(size=(3, 4, 12)).astype(np.float32)
    route = rng.uniform(size=(2, 5, 3)).astype(np.float32)
    c = rng.normal(size=(2, 5, 12)).astype(np.float32)
    want = jax.grad(lambda *t: (j_rlm(*t, jnp.asarray(route)) * c).sum(),
                    argnums=(0, 1, 2, 3))(*map(jnp.asarray, (x, w, a, b)))
    ts = [torch.from_numpy(t).requires_grad_() for t in (x, w, a, b)]
    loss = (routed_lora_matmul(*ts, torch.from_numpy(route))
            * torch.from_numpy(c)).sum()
    got = torch.autograd.grad(loss, ts)
    for name, g, wnt in zip("x w A B".split(), got, want):
        assert _rel_max(g.numpy(), wnt) <= 1e-5, name


@pytest.mark.parametrize("cotangent", ["fp32", "bf16_exact"])
def test_matmul_f32_bf16_grads_match_jax(cotangent):
    """bf16 operands, fp32 product: dX and dW against ``jax.grad`` of the
    JAX package's fp32-output einsum.  The port rounds the fp32 cotangent
    to bf16 on every device (a TPU's DEFAULT-precision dot does too; XLA
    on a CPU does not), so a general cotangent agrees to a bf16 tolerance,
    and a cotangent that bf16 holds exactly to the bf16 rounding of the
    result."""
    from modelcompose_tpu_torch.ops.quant import matmul_f32
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 40, 64)).astype(jnp.bfloat16)
    w = rng.normal(size=(64, 48)).astype(jnp.bfloat16)
    c = rng.normal(size=(3, 40, 48)).astype(np.float32)
    if cotangent == "bf16_exact":
        c = c.astype(jnp.bfloat16).astype(np.float32)
    _, vjp = jax.vjp(lambda x, w: jnp.einsum(
        "...i,io->...o", x, w, preferred_element_type=jnp.float32),
        jnp.asarray(x), jnp.asarray(w))
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(c))]
    xt, wt = (torch.from_numpy(a.astype(np.float32)).bfloat16()
              .requires_grad_() for a in (x, w))
    matmul_f32(xt, wt).backward(torch.from_numpy(c))
    tol = 1e-2 if cotangent == "fp32" else 2.0 ** -7  # one bf16 ulp
    for name, t, wnt in (("dx", xt, want[0]), ("dw", wt, want[1])):
        assert t.grad.dtype == torch.bfloat16, name
        assert _rel_max(t.grad.float().numpy(), wnt) <= tol, name


def test_causal_lm_loss_and_grad_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, size=(2, 7)).astype(np.int32)
    labels[0, :3] = IGNORE_INDEX
    labels[1, 5:] = IGNORE_INDEX
    want_loss, want_g = jax.value_and_grad(jmodel.causal_lm_loss)(
        jnp.asarray(logits), jnp.asarray(labels))
    t = torch.from_numpy(logits).requires_grad_()
    loss = causal_lm_loss(t, torch.from_numpy(labels))
    (g,) = torch.autograd.grad(loss, t)
    loss = float(loss.detach())
    assert abs(loss - float(want_loss)) <= 1e-6 * abs(float(want_loss))
    assert _rel_max(g.numpy(), want_g) <= 1e-5


def test_multimodal_loss_grads_match_jax():
    """The projector and the soft tokens are in the graph (the tower is
    not), as in the JAX package."""
    cfg = _cfg()
    nm = _jax_model(cfg, seed=1)
    col = _collated()
    args = (col["input_ids"], col["labels"], col["modal_inputs"])

    def jloss(params, projectors):
        lm = jmodel.MultimodalLM(cfg, params, nm.jax_encoders, projectors)
        return lm.loss(*args, bucket_len=16, attn_impl="xla")

    want_loss, (gp, gproj) = jax.jit(jax.value_and_grad(jloss,
                                                        argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, nm.params),
        jax.tree.map(jnp.asarray, nm.projectors))

    tm = model_from_jax(nm, device="cpu")
    la = tm.params["layers"]["attn"]["q"]
    leaves = {"lora_a": la["lora_a"], "lora_b": la["lora_b"],
              "prefix": tm.params["prefix_tokens"]["vision"],
              "suffix": tm.params["suffix_tokens"]["vision"],
              "proj_w0": tm.projectors["vision"]["layers"][0]["w"],
              "proj_b1": tm.projectors["vision"]["layers"][1]["b"]}
    for t in leaves.values():
        t.requires_grad_()
    loss = tm.loss(*args, bucket_len=16, attn_impl="reference")
    got = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    loss = float(loss.detach())
    assert abs(loss - float(want_loss)) <= 1e-5 * float(want_loss)
    jq = gp["layers"]["attn"]["q"]
    want = {"lora_a": jq["lora_a"], "lora_b": jq["lora_b"],
            "prefix": gp["prefix_tokens"]["vision"],
            "suffix": gp["suffix_tokens"]["vision"],
            "proj_w0": gproj["vision"]["layers"][0]["w"],
            "proj_b1": gproj["vision"]["layers"][1]["b"]}
    for name in leaves:
        assert np.abs(np.asarray(want[name])).max() > 0, name
        assert _rel_max(got[name].numpy(), want[name]) <= 1e-5, name


# ---------------------------------------------------------------------------
# (c) the optimizer against optax
# ---------------------------------------------------------------------------

OPT_CASES = {
    "stage2_decay_clip": (dict(), dict(
        learning_rate=3e-3, mm_projector_lr=1e-3, mm_language_lr=2e-4,
        weight_decay=0.1, max_grad_norm=0.5, warmup_ratio=0.25,
        total_steps=8)),
    "bf16_mu": (dict(), dict(learning_rate=1e-3, adam_mu_dtype="bfloat16",
                             total_steps=5, warmup_ratio=0.0)),
    "tower_layerwise": (dict(lora_strategy="modal"), dict(
        learning_rate=1e-3, mm_vision_tower_lr=2e-3,
        mm_vision_tower_layerwise_lr_decay=0.5, max_grad_norm=1.0,
        total_steps=6, warmup_ratio=0.0)),
    "full_finetune": (dict(lora_strategy=None), dict(
        learning_rate=1e-3, weight_decay=0.05, total_steps=4,
        warmup_ratio=0.0)),
    "stage1_frozen": (dict(), dict(learning_rate=1e-3,
                                   tune_mm_mlp_adapter=True, total_steps=4,
                                   warmup_ratio=0.0)),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_matches_optax(case):
    cfg_kw, tc_kw = OPT_CASES[case]
    cfg = _cfg(**cfg_kw)
    nm = _jax_model(cfg, seed=2)
    tree = {"backbone": nm.params, "projectors": nm.projectors}
    if "mm_vision_tower_lr" in tc_kw:
        tree["towers"] = {"vision": nm.encoders["vision"].params}
    jtc = jtrainer.TrainConfig(**tc_kw)
    jtx, _ = jtrainer.make_optimizer(cfg, jtc, tree)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jtx.init(jparams)
    tparams = params_from_jax(tree)
    tx, labels = trainer.make_optimizer(_port(cfg),
                                        trainer.TrainConfig(**tc_kw),
                                        tparams)
    tstate = tx.init(tparams)
    assert set(trainer.tree_leaves(tstate["mu"])) or case == "stage1_frozen"
    rng = np.random.default_rng(3)

    @jax.jit
    def jax_step(grads, state, params):
        updates, state = jtx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    for _ in range(3):
        grads = jax.tree.map(
            lambda p: rng.normal(0, 2.0, p.shape).astype(np.float32), tree)
        jparams, jstate = jax_step(jax.tree.map(jnp.asarray, grads), jstate,
                                   jparams)
        tgrads = {path: torch.from_numpy(g)
                  for path, g in trainer.tree_leaves(grads)
                  if tx.trains(path)}
        tstate = tx.step(tparams, tgrads, tstate)
    frozen = {path for path, lbl in trainer.tree_leaves(labels)
              if not tx.trains(path)}
    for (path, got), (jpath, w) in zip(
            trainer.tree_leaves(params_to_numpy(tparams)),
            jax.tree_util.tree_leaves_with_path(jparams)):
        assert len(path) == len(jpath)
        if path in frozen:
            np.testing.assert_array_equal(got, np.asarray(w), str(path))
        else:
            np.testing.assert_allclose(got, np.asarray(w), rtol=1e-6,
                                       atol=1e-7, err_msg=str(path))
    if tc_kw.get("adam_mu_dtype"):
        assert all(m.dtype == torch.bfloat16 for m in tstate["mu"].values())


# ---------------------------------------------------------------------------
# (d) rates, schedule, labels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["modal+language", "modal", "same",
                                      "none", None])
def test_adapter_row_lrs_match_jax(strategy):
    cfg = tiny_test_config(
        mm_vision_encoder="x", mm_hidden_size=8, mm_audio_encoder="x",
        mm_audio_hidden_size=8, lora_strategy=strategy,
        reset_scaling_weights="default-vision=0.5,default-audio=0.5")
    for kw in (dict(learning_rate=1e-3, mm_language_lr=1e-5),
               dict(tune_mm_mlp_adapter=True)):
        got = trainer.adapter_row_lrs(_port(cfg), trainer.TrainConfig(**kw))
        want = jtrainer.adapter_row_lrs(cfg, jtrainer.TrainConfig(**kw))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_schedule_matches_jax():
    for warmup, total in ((0, 1000), (30, 1000), (10, 100), (3, 7)):
        got = trainer.normalized_warmup_cosine(warmup, total)
        want = jtrainer.normalized_warmup_cosine(warmup, total)
        steps = np.arange(total + 3)
        g = np.array([got(int(s)) for s in steps], np.float32)
        w = np.array([np.float32(want(int(s))) for s in steps])
        assert g[0] == w[0] and (warmup == 0) == (g[0] == 1.0)
        # one float32 ulp of a cosine in [0.5, 1)
        assert np.abs(g - w).max() <= 2.0 ** -24, (warmup, total)


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_labels_match_jax(case):
    """Equal to the JAX labels, except where the port's explicit norm-key
    set differs from the JAX substring rule on purpose: the tower's
    ln1/ln2 scales are not decayed (HF's grouping)."""
    cfg_kw, tc_kw = OPT_CASES[case]
    tc_kw = dict(tc_kw, weight_decay=0.1)
    cfg = _cfg(**cfg_kw)
    nm = _jax_model(cfg)
    tree = {"backbone": nm.params, "projectors": nm.projectors,
            "towers": {"vision": nm.encoders["vision"].params}}
    _, got = trainer.make_optimizer(_port(cfg),
                                    trainer.TrainConfig(**tc_kw),
                                    params_from_jax(tree))
    _, want = jtrainer.make_optimizer(cfg, jtrainer.TrainConfig(**tc_kw),
                                      tree)
    got_leaves = list(trainer.tree_leaves(got))
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(got_leaves) == len(want_leaves)
    deviations = 0
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        if g != w:
            assert path[:4] == ("towers", "vision", "layers", path[3]) \
                and path[3] in ("ln1", "ln2") and path[4] == "scale", path
            assert (g, w) == ("tower:nodecay", "tower"), path
            deviations += 1
    assert deviations == (2 if "mm_vision_tower_lr" in tc_kw else 0)


# ---------------------------------------------------------------------------
# (e) train steps against the JAX package
# ---------------------------------------------------------------------------

# Adam divides each gradient element by its own magnitude plus eps: an
# element whose gradient nearly cancels to ~eps moves by a step set by the
# summation order.  The full finetune's base leaves have such elements, so
# it runs with eps 1e-6 (they are in Adam's linear range) and lr 1e-3.
STEP_CASES = {
    "stage2": (dict(), dict(weight_decay=0.01, max_grad_norm=0.05)),
    "stage1": (dict(), dict(tune_mm_mlp_adapter=True)),
    "full_finetune": (dict(lora_strategy=None), dict(learning_rate=1e-3,
                                                     adam_eps=1e-6)),
    # the vision tower trains too: CLIP forward in the step, layerwise lr
    "tower": (dict(), dict(mm_vision_tower_lr=2e-3,
                           mm_vision_tower_layerwise_lr_decay=0.5,
                           adam_eps=1e-6)),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_steps_match_jax(case):
    cfg_kw, tc_kw = STEP_CASES[case]
    cfg = _cfg(**cfg_kw)
    nm = _jax_model(cfg, seed=4)
    tc_kw = dict(dict(learning_rate=5e-3, mm_projector_lr=2e-3,
                      mm_language_lr=1e-3, total_steps=10, warmup_ratio=0.0),
                 **tc_kw)
    col = _collated()
    tower = "mm_vision_tower_lr" in tc_kw

    jm = _jax_lm(nm)
    jbatch, jlayout = jentry.make_batch(jm, col, buckets=(16,),
                                        tower_train=tower)
    jtc = jtrainer.TrainConfig(**tc_kw)
    jtowers = {"vision": jm.encoders["vision"].params} if tower else None
    jtx, jlabels = jtrainer.make_optimizer(cfg, jtc, {
        "backbone": jm.params, "projectors": jm.projectors,
        **({"towers": jtowers} if tower else {})})
    jstate = jtrainer.init_train_state(cfg, jtc, jm.params, jm.projectors,
                                       tower_params=jtowers, tx=jtx)
    jstep = jtrainer.make_train_step(
        cfg, jtc, jtx, attn_impl="pallas", donate=False,
        vision_tower_cfg=jm.encoders["vision"].cfg if tower else None)

    tm = model_from_jax(nm, device="cpu")
    batch, layout = entry.make_batch(tm, col, buckets=(16,),
                                     tower_train=tower)
    assert layout == jlayout
    assert set(batch) == set(jbatch)
    for key in ("token_ids", "feat_idx", "is_feat", "route_ids", "labels",
                "segment_ids"):
        np.testing.assert_array_equal(batch[key].numpy(),
                                      np.asarray(jbatch[key]), key)
    tc = trainer.TrainConfig(**tc_kw)
    towers = {"vision": tm.encoders["vision"].params} if tower else None
    tx, labels = trainer.make_optimizer(_port(cfg), tc, {
        "backbone": tm.params, "projectors": tm.projectors,
        **({"towers": towers} if tower else {})})
    state = trainer.init_train_state(_port(cfg), tc, tm.params,
                                     tm.projectors,
                                     tower_params=towers, tx=tx)
    step = trainer.make_train_step(
        _port(cfg), tc, tx,
        vision_tower_cfg=tm.encoders["vision"].cfg if tower else None)

    for _ in range(2):
        jstate, jloss = jstep(jstate, jbatch, jlayout)
        state, loss = step(state, batch, layout)
        assert abs(float(loss) - float(jloss)) <= 1e-4 * float(jloss)
    assert state.step == 2 and int(jstate.step) == 2

    want = jax.tree_util.tree_leaves_with_path(jstate.params)
    got = list(trainer.tree_leaves(params_to_numpy(state.params)))
    assert len(got) == len(want)
    n_trained = 0
    for (path, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        if path[0] == "towers" and path[-2:] == ("k", "b"):
            # The key bias adds q.b_k to a whole softmax row: its gradient
            # is zero but for rounding, which each package moves it by.
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-8, path
            n_trained += 1
        elif tx.trains(path):
            assert _rel_max(g, w) <= 1e-4, (path, _rel_max(g, w))
            n_trained += 1
        else:
            np.testing.assert_array_equal(g, w, str(path))
    # the tower case trains the 20 stage-2 leaves and all 21 tower leaves
    assert n_trained == {"stage2": 20, "stage1": 4, "full_finetune": 32,
                         "tower": 41}[case]


# ---------------------------------------------------------------------------
# (f) port-internal
# ---------------------------------------------------------------------------

def _port_grads(cfg, nm, col, tc, buckets=(16,)):
    tm = model_from_jax(nm, device="cpu")
    tm.cfg = cfg = _port(cfg)
    tx, _ = trainer.make_optimizer(cfg, tc, {"backbone": tm.params,
                                             "projectors": tm.projectors})
    state = trainer.init_train_state(cfg, tc, tm.params, tm.projectors,
                                     tx=tx)
    grad_fn, apply_fn, accumulate, grad_accum_fn = \
        trainer.make_grad_and_apply(cfg, tc, tx)
    batch, layout = entry.make_batch(tm, col, buckets=buckets)
    return grad_fn(state.params, batch, layout), tm, state, (
        grad_fn, apply_fn, accumulate, grad_accum_fn)


def test_remat_and_chunked_loss_match_plain():
    nm = _jax_model(_cfg(), seed=5)
    tc = trainer.TrainConfig()
    (loss, grads), *_ = _port_grads(_cfg(), nm, _collated(), tc)
    (loss_r, grads_r), *_ = _port_grads(_cfg(remat=True), nm, _collated(),
                                        tc)
    (loss_c, grads_c), *_ = _port_grads(
        _cfg(), nm, _collated(), trainer.TrainConfig(loss_chunk=4))
    assert len(grads) == 20  # 14 LoRA leaves, 2 soft tokens, 4 projector
    for other_loss, other in ((loss_r, grads_r), (loss_c, grads_c)):
        assert abs(float(other_loss) - float(loss)) <= 1e-6 * float(loss)
        for path, g in grads.items():
            assert _rel_max(other[path].numpy(), g.numpy()) <= 1e-5, path


def test_grad_accumulation_matches_big_batch():
    nm = _jax_model(_cfg(), seed=6)
    tc = trainer.TrainConfig(learning_rate=1e-3, warmup_ratio=0.0)
    col = _collated()
    (loss_b, grads_b), tm, state, fns = _port_grads(_cfg(), nm, col, tc)
    grad_fn, apply_fn, accumulate, grad_accum_fn = fns
    micro = []
    for i in range(2):
        one = {"input_ids": col["input_ids"][i:i + 1],
               "labels": col["labels"][i:i + 1],
               "modal_inputs": {"vision": col["modal_inputs"]["vision"][
                   i:i + 1]}}
        micro.append(entry.make_batch(tm, one, buckets=(16,)))
    loss0, acc = grad_fn(state.params, *micro[0])
    loss1, acc = grad_accum_fn(state.params, acc, *micro[1])
    acc = trainer.scale_grads(acc, 0.5)
    assert abs(0.5 * (float(loss0) + float(loss1)) - float(loss_b)) <= 1e-5
    for path, g in grads_b.items():
        assert _rel_max(acc[path].numpy(), g.numpy()) <= 1e-5, path
    # accumulate() is the weighted form of the same sum
    acc2 = {p: torch.zeros_like(g) for p, g in acc.items()}
    for mb in micro:
        accumulate(acc2, grad_fn(state.params, *mb)[1], 0.5)
    for path, g in acc.items():
        assert _rel_max(acc2[path].numpy(), g.numpy()) <= 1e-6, path
    before = tm.projectors["vision"]["layers"][0]["w"].detach().clone()
    state = apply_fn(state, acc)
    assert state.step == 1
    assert not torch.equal(before, tm.projectors["vision"]["layers"][0]["w"])


def test_reinit_lora_a():
    cfg = _cfg()
    nm = _jax_model(cfg)
    params = params_from_jax(nm.params)
    out = reinit_lora_a(params, torch.Generator().manual_seed(0))
    for grp in ("attn", "mlp"):
        for name, p in out["layers"][grp].items():
            old = params["layers"][grp][name]
            a = p["lora_a"]
            assert a.shape == old["lora_a"].shape and a.std() > 0
            assert float(a.abs().max()) <= a.shape[-2] ** -0.5
            assert p["lora_b"] is old["lora_b"] and p["w"] is old["w"]
    assert out["embed_tokens"] is params["embed_tokens"]


def test_build_model_and_entry_flags():
    args = entry.build_arg_parser().parse_args([
        "--model_name_or_path", "none", "--data_path", "-",
        "--output_dir", "-", "--random_init_backbone",
        "--mm_vision_encoder", "test:32x2", "--mm_projector_type",
        "mlp2x_gelu", "--lora_strategy", "modal+language", "--lora_r", "4",
        "--lora_alpha", "8", "--local_prefix_tokens", "1",
        "--local_suffix_tokens", "1", "--gradient_checkpointing", "True",
        "--quantize_frozen_base", "True", "--bf16", "False"])
    jargs = jentry.build_arg_parser().parse_args([
        "--model_name_or_path", "none", "--data_path", "-",
        "--output_dir", "-"])
    assert {a.dest for a in entry.build_arg_parser()._actions} == \
        {a.dest for a in jentry.build_arg_parser()._actions}
    cfg = entry.build_model_config(args)
    assert cfg.remat and cfg.lora_r == 4 and jargs.lora_r == 64
    cfg = port_tiny_config(**{k: getattr(cfg, k) for k in (
        "mm_vision_encoder", "mm_projector_type", "lora_strategy", "lora_r",
        "lora_alpha", "local_prefix_tokens", "local_suffix_tokens",
        "remat")})
    model = entry.build_model(args, cfg, "cpu")
    assert cfg.mm_hidden_size == 32
    assert model.params["layers"]["attn"]["q"]["w"]["q"].dtype == torch.int8
    assert model.encoders["vision"].params["class_embedding"].dtype == \
        torch.bfloat16
    batch, layout = entry.make_batch(model, _collated())
    assert layout == (("vision", 2, model.feature_span_len("vision")),)
    assert batch["token_ids"].shape == (2, 512)  # the smallest train bucket
    # a trained tower keeps fp32 weights and runs inside the step
    args.mm_vision_tower_lr = 1e-4
    model = entry.build_model(args, cfg, "cpu")
    assert all(t.dtype == torch.float32 for _, t in trainer.tree_leaves(
        model.encoders["vision"].params))
    batch, layout2 = entry.make_batch(model, _collated(), tower_train=True)
    assert layout2 == layout and batch["encoder_features"] == {}
    assert batch["tower_pixels"]["vision"].shape == (2, 28, 28, 3)
    args.random_init_backbone = False
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        entry.build_model(args, cfg, "cpu")


@pytest.mark.parametrize("vision_trains", [True, False])
def test_build_model_tower_dtypes_match_jax(vision_trains):
    """A vision + audio config: with --mm_vision_tower_lr only the vision
    tower is fp32 and the frozen audio tower beside it keeps --tower_dtype
    (bf16), floating leaf for floating leaf as the JAX entry builds them."""
    argv = ["--model_name_or_path", "none", "--data_path", "-",
            "--output_dir", "-", "--random_init_backbone",
            "--mm_vision_encoder", "test:32x2", "--mm_audio_encoder",
            "test:16x2", "--lora_strategy", "modal+language", "--lora_r", "4",
            "--lora_alpha", "8"]
    if vision_trains:
        argv += ["--mm_vision_tower_lr", "1e-4"]
    keys = dict(mm_vision_encoder="test:32x2", mm_audio_encoder="test:16x2",
                lora_strategy="modal+language", lora_r=4, lora_alpha=8)
    model = entry.build_model(entry.build_arg_parser().parse_args(argv),
                              port_tiny_config(**keys), "cpu")
    jm = jentry.build_model(jentry.build_arg_parser().parse_args(argv),
                            tiny_test_config(**keys))
    want_dtype = {"vision": "float32" if vision_trains else "bfloat16",
                  "audio": "bfloat16"}
    for modal, want in want_dtype.items():
        got = [str(t.dtype).replace("torch.", "") for _, t in
               trainer.tree_leaves(model.encoders[modal].params)
               if t.is_floating_point()]
        jax_dtypes = [str(a.dtype) for a in jax.tree.leaves(
            jm.encoders[modal].params) if jnp.issubdtype(a.dtype,
                                                         jnp.floating)]
        assert sorted(got) == sorted(jax_dtypes), modal
        assert set(got) == {want}, modal
