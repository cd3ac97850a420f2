"""The train steps through their graphs (``train/step_graph``) on the CPU,
where a graph runs its step eagerly through its static buffers, as the
decode and prefill graphs' CPU tests run theirs (tiny configs, fp32).

- the graph path against the eager path (``graphs=False``), bit for bit:
  the fused step over 3 steps (the clip on and off, weight decay with
  ``:nodecay`` leaves, the per-row LoRA rates, the tower label) and
  accumulation windows of 2 and 3 micro-batches (``grad_fn`` ->
  ``grad_accum_fn`` -> ``apply_fn``), losses, leaves and moments;
- the graph path against the JAX package's ``make_train_step`` and
  ``make_grad_and_apply``, within ``tests/test_torch_train.py``'s 1e-4
  relative (the Pallas attention in interpret mode);
- state and keys: parameters and moments keep their addresses; a restored
  step checkpoint continues to the losses and leaves of an uninterrupted
  run; a graph is reused for the same shapes and made anew for another
  bucket, feature count or ``feat_layout``, under the LRU bound; the step
  copies no host data after its first call;
- groups: under a gloo mesh of one process the graphs run the group's
  collectives and equal the eager steps under it bit for bit; a graph is
  keyed by the mesh's groups, so one made under no mesh is never replayed
  under a mesh, nor the reverse; ``train()`` under a mesh takes the
  steps' default (graphs on the card, eager on the CPU) and its losses
  through the graphs (forced on the CPU) equal its eager run's;
  ``train()``'s losses through the graphs are each step's own and equal
  to its eager run's.
"""

import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax

from modelcompose_tpu.train import train_multimodal as jentry
from modelcompose_tpu.train import trainer as jtrainer

from modelcompose_tpu_torch.compose.state_io import load_state
from modelcompose_tpu_torch.convert import model_from_jax, params_to_numpy
from modelcompose_tpu_torch.parallel import distributed, tp
from modelcompose_tpu_torch.parallel.mesh import make_mesh
from modelcompose_tpu_torch.train import checkpoint as tckpt
from modelcompose_tpu_torch.train import step_graph
from modelcompose_tpu_torch.train import train_multimodal as entry
from modelcompose_tpu_torch.train import trainer
from modelcompose_tpu_torch.tree import tree_leaves
from tests.fake_tokenizer import FakeLlamaTokenizer
from tests.test_torch_train import (_cfg, _collated, _jax_lm, _jax_model,
                                    _port, _rel_max)
from tests.test_torch_train_entry import (  # noqa: F401 (fixtures)
    STAGE2, _argv, _fixed_word_ids, files)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BASE_TC = dict(learning_rate=5e-3, mm_projector_lr=2e-3, mm_language_lr=1e-3,
               total_steps=10, warmup_ratio=0.0)
# clip on (the tiny model's gradient norm is far above 0.05) and off, decay
# with the projector biases and norms under ':nodecay', the LoRA leaves at
# their per-row rates; the vision tower at its layerwise rates
CASES = {
    "clip_on_decay": (dict(), dict(weight_decay=0.01, max_grad_norm=0.05)),
    "clip_off": (dict(), dict(max_grad_norm=1e3)),
    "tower": (dict(), dict(mm_vision_tower_lr=2e-3,
                           mm_vision_tower_layerwise_lr_decay=0.5,
                           weight_decay=0.01, adam_eps=1e-6)),
}


def _setup(cfg, nm, tc_kw, graphs, tower=False):
    """A fresh port model on ``nm``'s weights, its state and step
    functions: (model, state, tx, make_train_step's, make_grad_and_apply's,
    tower config)."""
    tm = model_from_jax(nm, device="cpu")
    tc = trainer.TrainConfig(**dict(BASE_TC, **tc_kw))
    towers = {"vision": tm.encoders["vision"].params} if tower else None
    tree = {"backbone": tm.params, "projectors": tm.projectors}
    if tower:
        tree["towers"] = towers
    tx, _ = trainer.make_optimizer(_port(cfg), tc, tree)
    state = trainer.init_train_state(_port(cfg), tc, tm.params, tm.projectors,
                                     tower_params=towers, tx=tx)
    vcfg = tm.encoders["vision"].cfg if tower else None
    step = trainer.make_train_step(_port(cfg), tc, tx, graphs=graphs,
                                   vision_tower_cfg=vcfg)
    accum = trainer.make_grad_and_apply(_port(cfg), tc, tx, graphs=graphs,
                                        vision_tower_cfg=vcfg)
    return tm, state, tx, step, accum


def _moments(state):
    return [t for m in ("mu", "nu") for t in state.opt_state[m].values()]


def _assert_states_equal(a, b):
    """Every leaf and moment of two train states bit-equal."""
    la, lb = list(tree_leaves(a.params)), list(tree_leaves(b.params))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert torch.equal(x, y), path
    for x, y in zip(_moments(a), _moments(b)):
        assert torch.equal(x, y)
    assert a.step == b.step and a.opt_state["count"] == b.opt_state["count"]


def _micro_batches(tm, n, tower=False):
    """``n`` B=1 micro-batches, alternating the two samples of
    ``_collated`` over pixel seeds."""
    out = []
    for i in range(n):
        col = _collated(seed=i // 2)
        j = i % 2
        one = {"input_ids": col["input_ids"][j:j + 1],
               "labels": col["labels"][j:j + 1],
               "modal_inputs": {"vision": col["modal_inputs"]["vision"][
                   j:j + 1]}}
        out.append(entry.make_batch(tm, one, buckets=(16,),
                                    tower_train=tower))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_step_graph_is_bit_equal_to_eager(case):
    cfg_kw, tc_kw = CASES[case]
    cfg = _cfg(**cfg_kw)
    nm = _jax_model(cfg, seed=4)
    tower = "mm_vision_tower_lr" in tc_kw
    runs = []
    for graphs in (False, True):
        tm, state, tx, step, _ = _setup(cfg, nm, tc_kw, graphs, tower)
        batch, layout = entry.make_batch(tm, _collated(), buckets=(16,),
                                         tower_train=tower)
        losses = []
        for _ in range(3):
            state, loss = step(state, batch, layout)
            losses.append(loss)
        runs.append((losses, state, tx, step))
    (eager, s_eager, tx, _), (graph, s_graph, _, gstep) = runs
    assert len(gstep.graphs) == 1
    assert all(torch.equal(a, b) for a, b in zip(eager, graph)), \
        (eager, graph)
    _assert_states_equal(s_eager, s_graph)
    labels = set(tx.labels.values())
    assert "lora" in labels
    if tc_kw.get("weight_decay"):
        assert "proj:nodecay" in labels
    if tower:
        assert {"tower", "tower:nodecay"} <= labels
    if "max_grad_norm" in tc_kw:  # the clip took the branch the case names
        tm, state, tx, step, (grad_fn, *_) = _setup(cfg, nm, tc_kw, False)
        batch, layout = entry.make_batch(tm, _collated(), buckets=(16,))
        _, grads = grad_fn(state.params, batch, layout)
        norm = float(torch.sqrt(sum(g.square().sum()
                                    for g in grads.values())))
        assert (norm > tc_kw["max_grad_norm"]) == (case == "clip_on_decay")


@pytest.mark.parametrize("window", [2, 3])
def test_accumulation_window_graph_is_bit_equal_to_eager(window):
    cfg = _cfg()
    nm = _jax_model(cfg, seed=6)
    tc_kw = dict(weight_decay=0.01, max_grad_norm=0.05)
    runs = []
    for graphs in (False, True):
        tm, state, tx, _, (grad_fn, apply_fn, _, grad_accum_fn) = _setup(
            cfg, nm, tc_kw, graphs)
        micro = _micro_batches(tm, window)
        losses = []
        for _ in range(2):  # two windows: the graphs' second calls replay
            loss, acc = grad_fn(state.params, *micro[0])
            losses.append(loss)
            for mb in micro[1:]:
                loss, acc = grad_accum_fn(state.params, acc, *mb)
                losses.append(loss)
            state = apply_fn(state, acc, scale=1.0 / window)
        runs.append((losses, state, grad_fn))
    (eager, s_eager, _), (graph, s_graph, gfn) = runs
    # a write and an add graph (one per shape) and the update
    assert len(gfn.graphs) == 3
    assert all(torch.equal(a, b) for a, b in zip(eager, graph))
    assert s_graph.step == 2
    _assert_states_equal(s_eager, s_graph)


def test_apply_fn_scale_is_scale_grads():
    """``apply_fn(state, grads, scale=c)`` is ``scale_grads`` then the
    step, on both paths."""
    cfg = _cfg()
    nm = _jax_model(cfg, seed=7)
    states = []
    for how in ("scale_grads", "scale"):
        tm, state, _, _, (grad_fn, apply_fn, _, _) = _setup(cfg, nm, {},
                                                             False)
        batch, layout = entry.make_batch(tm, _collated(), buckets=(16,))
        _, grads = grad_fn(state.params, batch, layout)
        if how == "scale":
            state = apply_fn(state, grads, scale=1.0 / 3)
        else:
            state = apply_fn(state, trainer.scale_grads(grads, 1.0 / 3))
        states.append(state)
    _assert_states_equal(*states)


def test_graph_step_and_window_match_jax():
    """The graph path's fused steps and accumulation window against the
    JAX package's (Pallas attention in interpret mode; the port's K1/K3/K4
    plain versions), within test_torch_train.py's 1e-4 relative."""
    cfg = _cfg()
    nm = _jax_model(cfg, seed=4)
    tc_kw = dict(BASE_TC, weight_decay=0.01, max_grad_norm=0.05)
    col = _collated()
    jm = _jax_lm(nm)
    jtc = jtrainer.TrainConfig(**tc_kw)

    def jax_state():
        jtx, _ = jtrainer.make_optimizer(cfg, jtc, {
            "backbone": jm.params, "projectors": jm.projectors})
        return jtx, jtrainer.init_train_state(cfg, jtc, jm.params,
                                              jm.projectors, tx=jtx)

    def assert_close(state, jstate):
        want = jax.tree_util.tree_leaves_with_path(jstate.params)
        got = list(tree_leaves(params_to_numpy(state.params)))
        assert len(got) == len(want)
        for (path, g), (_, w) in zip(got, want):
            assert _rel_max(g, np.asarray(w)) <= 1e-4, path

    # the fused step, 3 steps
    jtx, jstate = jax_state()
    jstep = jtrainer.make_train_step(cfg, jtc, jtx, attn_impl="pallas",
                                     donate=False)
    jbatch, jlayout = jentry.make_batch(jm, col, buckets=(16,))
    tm, state, _, step, _ = _setup(cfg, nm, tc_kw, True)
    batch, layout = entry.make_batch(tm, col, buckets=(16,))
    for _ in range(3):
        jstate, jloss = jstep(jstate, jbatch, jlayout)
        state, loss = step(state, batch, layout)
        assert abs(float(loss) - float(jloss)) <= 1e-4 * float(jloss)
    assert len(step.graphs) == 1
    assert_close(state, jstate)

    # a window of two micro-batches
    jtx, jstate = jax_state()
    jgrad, japply, _, jaccum = jtrainer.make_grad_and_apply(
        cfg, jtc, jtx, attn_impl="pallas", donate=False)
    tm, state, _, _, (grad_fn, apply_fn, _, grad_accum_fn) = _setup(
        cfg, nm, tc_kw, True)
    micro = _micro_batches(tm, 2)
    jm_micro = []
    for i in range(2):
        one = {"input_ids": col["input_ids"][i:i + 1],
               "labels": col["labels"][i:i + 1],
               "modal_inputs": {"vision": col["modal_inputs"]["vision"][
                   i:i + 1]}}
        jm_micro.append(jentry.make_batch(jm, one, buckets=(16,)))
    jl0, jacc = jgrad(jstate.params, *jm_micro[0])
    jl1, jacc = jaccum(jstate.params, jacc, *jm_micro[1])
    jstate = japply(jstate, jtrainer.scale_grads(jacc, 0.5))
    l0, acc = grad_fn(state.params, *micro[0])
    l1, acc = grad_accum_fn(state.params, acc, *micro[1])
    state = apply_fn(state, acc, scale=0.5)
    for got, want in ((l0, jl0), (l1, jl1)):
        assert abs(float(got) - float(want)) <= 1e-4 * float(want)
    assert_close(state, jstate)


@pytest.mark.parametrize("graphs", [False, True])
def test_params_and_moments_keep_their_addresses(graphs):
    cfg = _cfg()
    nm = _jax_model(cfg, seed=8)
    tm, state, _, step, (grad_fn, apply_fn, _, grad_accum_fn) = _setup(
        cfg, nm, dict(max_grad_norm=0.05), graphs)
    batch, layout = entry.make_batch(tm, _collated(), buckets=(16,))
    micro = _micro_batches(tm, 2)

    def addresses():
        return ([p.data_ptr() for _, p in tree_leaves(state.params)],
                [t.data_ptr() for t in _moments(state)])
    before = addresses()
    for _ in range(3):
        state, _ = step(state, batch, layout)
    _, acc = grad_fn(state.params, *micro[0])
    _, acc = grad_accum_fn(state.params, acc, *micro[1])
    state = apply_fn(state, acc, scale=0.5)
    assert addresses() == before
    assert state.step == 4 and state.opt_state["count"] == 4


def test_restored_checkpoint_continues_like_an_uninterrupted_run(tmp_path):
    cfg = _cfg()
    nm = _jax_model(cfg, seed=9)
    tc_kw = dict(max_grad_norm=0.05, weight_decay=0.01)
    tm, whole, _, step, _ = _setup(cfg, nm, tc_kw, True)
    batch, layout = entry.make_batch(tm, _collated(), buckets=(16,))
    want = []
    for _ in range(4):
        whole, loss = step(whole, batch, layout)
        want.append(loss)

    tm, first, tx, step, _ = _setup(cfg, nm, tc_kw, True)
    for _ in range(2):
        first, _ = step(first, batch, layout)
    path = tckpt.save_step_checkpoint(str(tmp_path), 2, first, tx)

    tm, state, tx, step, _ = _setup(cfg, nm, tc_kw, True)
    moments = [t.data_ptr() for t in _moments(state)]
    state = tckpt.restore_step_checkpoint(path, state, tx)
    assert [t.data_ptr() for t in _moments(state)] == moments
    assert state.step == 2 and state.opt_state["count"] == 2
    for x, y in zip(_moments(state), _moments(first)):
        assert torch.equal(x, y)
    got = []
    for _ in range(2):
        state, loss = step(state, batch, layout)
        got.append(loss)
    assert all(torch.equal(a, b) for a, b in zip(got, want[2:]))
    _assert_states_equal(state, whole)


def test_graphs_are_keyed_by_shape_layout_and_state():
    cfg = _cfg()
    nm = _jax_model(cfg, seed=10)
    tm, state, _, step, _ = _setup(cfg, nm, {}, True)
    lru = step.graphs
    col = _collated()
    batch, layout = entry.make_batch(tm, col, buckets=(16,))
    state, _ = step(state, batch, layout)
    state, _ = step(state, batch, layout)
    (graph,) = lru.values()
    assert graph.calls == 2 and len(lru) == 1  # the same shapes: reused
    longer = entry.make_batch(tm, col, buckets=(32,))  # another bucket
    one = entry.make_batch(tm, {  # one image: another feature count
        "input_ids": col["input_ids"][:1], "labels": col["labels"][:1],
        "modal_inputs": {"vision": col["modal_inputs"]["vision"][:1]}},
        buckets=(16,))
    text = entry.make_batch(tm, {  # no image: another feat_layout
        "input_ids": [np.array([1, 5, 6, 7]), np.array([1, 8, 9])],
        "labels": [np.array([-100, 5, 6, 7]), np.array([-100, 8, 9])]},
        buckets=(16,))
    assert longer[1] == layout and one[1] != layout and text[1] == ()
    for b in (longer, one, text):
        state, _ = step(state, *b)
    assert len(lru) == 4 and graph in lru.values()
    lru.limit = 2  # the bound: the least recently used go first
    state, _ = step(state, batch, layout)  # a hit: now the most recent
    assert len(lru) == 4 and lru.values()[-1] is graph
    state, _ = step(state, *entry.make_batch(tm, col, buckets=(64,)))
    assert len(lru) == 2 and lru.values()[0] is graph
    # new moments (a new state): a new graph
    state = trainer.init_train_state(_port(cfg), trainer.TrainConfig(),
                                     tm.params, tm.projectors,
                                     tx=trainer.make_optimizer(
                                         _port(cfg), trainer.TrainConfig(),
                                         {"backbone": tm.params,
                                          "projectors": tm.projectors})[0])
    state, _ = step(state, batch, layout)
    assert graph not in lru.values()


@pytest.mark.parametrize("graphs", [False, True])
def test_train_step_copies_no_host_data_after_its_first_call(monkeypatch,
                                                             graphs):
    """Once a step has run, the next ones make no tensor from host data:
    the routing table and the optimizer's per-row rates are on the device
    from the first step on, its scalars are made once (constants) or
    refilled in place (the step's bias corrections and schedule
    multiplier).  A copy from the host at each step waits for the card, and
    a capture refuses it."""
    cfg = _cfg()
    nm = _jax_model(cfg, seed=11)
    tm, state, _, step, _ = _setup(
        cfg, nm, dict(weight_decay=0.01, max_grad_norm=0.05), graphs)
    batch, layout = entry.make_batch(tm, _collated(), buckets=(16,))
    state, _ = step(state, batch, layout)
    made = []
    for name in ("tensor", "as_tensor", "from_numpy"):
        fn = getattr(torch, name)

        def counting(data, *a, _fn=fn, _name=name, **kw):
            if not isinstance(data, torch.Tensor):
                made.append(_name)
            return _fn(data, *a, **kw)
        monkeypatch.setattr(torch, name, counting)
    for _ in range(2):
        state, _ = step(state, batch, layout)
    assert made == []


@pytest.fixture
def gloo_mesh(tmp_path):
    """A (1, 1) mesh over a gloo process group of this one process."""
    made = not dist.is_initialized()
    if made:
        distributed.initialize(f"file://{tmp_path}/rendezvous", 1, 0,
                               backend="gloo",
                               timeout=datetime.timedelta(seconds=60))
    yield make_mesh(1, 1)
    if made:
        distributed.shutdown()


def test_train_graphs_refuse_a_data_or_model_group(gloo_mesh):
    """A train graph belongs to the mesh it was made under: under a gloo
    mesh of one process the fused step and the accumulation window run
    through graphs of their own (not the no-mesh run's, whose key names no
    group), with the mesh's collectives, bit-equal to the eager steps
    under it and to the no-mesh graphs; the graphs are the default on a
    CUDA device under a mesh or a model group, and never on the CPU."""
    cfg = _cfg()
    nm = _jax_model(cfg, seed=12)
    runs = {}
    for graphs in (False, True):
        tm, state, tx, step, (grad_fn, apply_fn, _, grad_accum_fn) = \
            _setup(cfg, nm, dict(max_grad_norm=0.05), graphs)
        batch, layout = entry.make_batch(tm, _collated(), buckets=(16,))
        losses = []
        for mesh in (None, gloo_mesh, gloo_mesh):
            tx.mesh = mesh
            state, loss = step(state, batch, layout)
            losses.append(loss)
        loss, acc = grad_fn(state.params, batch, layout)
        losses.append(loss)
        loss, acc = grad_accum_fn(state.params, acc, batch, layout)
        losses.append(loss)
        state = apply_fn(state, acc, scale=0.5)
        runs[graphs] = (losses, state, step.graphs, grad_fn.graphs, tx)
    (eager, e_state, *_), (graph, g_state, steps, accum, tx) = \
        runs[False], runs[True]
    assert [float(x) for x in graph] == [float(x) for x in eager]
    _assert_states_equal(g_state, e_state)
    # the no-mesh step's graph and the mesh's: two keys, two graphs
    assert len(steps) == 2 and len(accum) == 3
    assert [g.calls for g in steps.values()] == [1, 2]
    params, opt = g_state.params, g_state.opt_state
    assert step_graph.params_key(params, opt) \
        != step_graph.params_key(params, opt, gloo_mesh)
    assert step_graph.leaves_key(params, gloo_mesh)[-2:] == 2 * (
        (id(gloo_mesh.data_group), (0,)),)
    assert step_graph.use_graphs(None, "cuda", tx)  # tx.mesh: the mesh
    with tp.scope(gloo_mesh.model_group):
        assert step_graph.use_graphs(None, "cuda", tx)
    assert not step_graph.use_graphs(None, "cpu", tx)
    assert not step_graph.use_graphs(False, "cuda", tx)


def _train(files, out, **over):
    args = entry.build_arg_parser().parse_args(_argv(files, out, **over))
    return entry.train(args, tokenizer=FakeLlamaTokenizer(), device="cpu")


def _force_graphs(monkeypatch):
    """The steps' default (``graphs=None``) takes the graph path on the CPU
    too, as it does on the card; an explicit ``graphs=`` stays as given."""
    real = step_graph.use_graphs
    monkeypatch.setattr(trainer, "use_graphs", lambda graphs, device, tx:
                        real(True if graphs is None else graphs, device, tx))


@pytest.mark.parametrize("accum", [1, 2])
def test_train_losses_through_graphs_are_each_steps_own(files, tmp_path,
                                                        monkeypatch, accum):
    """``train()`` through the graphs (forced on the CPU) against its eager
    run: the same losses bit for bit, each step's own value (not a shared
    buffer the next step rewrites), and the same export."""
    res = {}
    for graphs in (False, True):
        if graphs:
            _force_graphs(monkeypatch)
        res[graphs] = _train(files, tmp_path / f"g{graphs}",
                             gradient_accumulation_steps=accum, **STAGE2)
    eager, graph = res[False]["losses"], res[True]["losses"]
    assert len(graph) == 3 * accum and graph == eager
    assert len(set(graph)) == len(graph)
    a = load_state(str(tmp_path / "gFalse" / "adapter_model.bin"))
    b = load_state(str(tmp_path / "gTrue" / "adapter_model.bin"))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], k)


def test_train_under_a_mesh_builds_eager_steps(files, tmp_path, monkeypatch,
                                               capsys):
    """In a process group (gloo, one rank) ``train()`` takes the data mesh
    and builds its steps with the steps' default (``graphs=None``): on the
    CPU they run eagerly, and nothing is printed; where the default takes
    the graphs (forced on the CPU, as on the card) the steps run through
    them under the mesh, ``train()`` says so once, and the losses equal the
    eager run's bit for bit."""
    made = []
    real = entry.make_train_step

    def spy(*a, **kw):
        made.append(kw.get("graphs"))
        step = real(*a, **kw)
        steps.append(step)
        return step
    monkeypatch.setattr(entry, "make_train_step", spy)
    distributed.initialize(f"file://{tmp_path}/rendezvous", 1, 0,
                           backend="gloo")
    res = {}
    try:
        for forced in (False, True):
            steps = []
            if forced:
                _force_graphs(monkeypatch)
            res[forced] = _train(files, tmp_path / f"mesh{forced}",
                                 max_steps=2, **STAGE2)
            assert len(res[forced]["losses"]) == 2
            assert bool(len(steps[0].graphs)) == forced
            out = capsys.readouterr().out
            assert out.count("graphed under the 1-rank data mesh") \
                == int(forced)
        assert made == [None, None]
        assert res[True]["losses"] == res[False]["losses"]
    finally:
        distributed.shutdown()