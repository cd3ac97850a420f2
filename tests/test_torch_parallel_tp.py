"""Tensor-parallel serving on gloo (CPU): ``load_pretrained_model(tp=N)``
in N processes of ``scripts/torch_dryrun_multirank.py`` (case ``tp``),
against the same checkpoint loaded at tp 1 in this process and by the JAX
loader with its ``tp`` on the conftest's virtual devices.

The checkpoint is the JAX exporters' (``tests/test_torch_compose.py``'s
writers): a vision DAMC composition at fp32 (the JAX fixture's dtype: a
row-split sum changes the reduction order, and at bf16 near ties would
part), 4 heads, so it splits 2 and 4 ways, the CLIP tower from a file of
the working directory.  Greedy ids bit-exact, fp32 logits within 1e-5;
with and without int8 + the dense fold; at tp 2 also the chunked prefill,
the slot decoder's schedule (rank 0 leads, rank 1 follows its calls) and
the model worker's wire chunks with both engines.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from modelcompose_tpu_torch.compose.state_io import save_state
from modelcompose_tpu_torch.config import ModelConfig as PortConfig
from modelcompose_tpu_torch.models.towers import ClipVisionTower

from tests.test_torch_compose import (_unimodal_cfg, _write_base,
                                      _write_unimodal, jloader)
from tests.test_torch_towers import _clip_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "torch_dryrun_multirank.py")
VARIANTS = {"fp32": {}, "int8_fold": {"load_8bit": True,
                                      "fold_decode_dense": True}}
LAUNCH_TIMEOUT = 120  # seconds a launch may take (alone it takes ~10-20)


def _dryrun():
    spec = importlib.util.spec_from_file_location("torch_dryrun", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


dryrun = _dryrun()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tp"))
    ckpt = os.path.join(root, "vision-multimodal")
    os.rename(_write_unimodal(root, "vision", 3), ckpt)
    base, _ = _write_base(root, _unimodal_cfg("vision"), seed=20)
    tower = ClipVisionTower("test:32x2", PortConfig.load(
        os.path.join(ckpt, "config.json")), device="cpu").cfg
    os.makedirs(os.path.join(root, "test:32x2"))
    save_state(_clip_state(tower, np.random.default_rng(4)),
               os.path.join(root, "test:32x2", "pytorch_model.bin"))
    spec = {"ckpt": ckpt, "base": base, "variants": VARIANTS}
    paths = {}
    for name, extra in (("full", {"slot": True, "worker": True}),
                        ("ids", {})):
        paths[name] = os.path.join(root, f"spec-{name}.json")
        with open(paths[name], "w") as f:
            json.dump(dict(spec, **extra), f)
    return {"root": root, "spec": spec, "paths": paths}


@pytest.fixture(scope="module")
def tp1(files):
    """The tp 1 run in this process (no process group)."""
    cwd = os.getcwd()
    os.chdir(files["root"])
    try:
        return dryrun.case_tp(dict(files["spec"], slot=True, worker=True))
    finally:
        os.chdir(cwd)


def _launch(files, world, spec):
    return dryrun.launch("tp", world, os.path.join(files["root"],
                                                   f"out-tp{world}"),
                         files["paths"][spec], timeout=LAUNCH_TIMEOUT,
                         cwd=files["root"])


@pytest.fixture(scope="module")
def tp2(files):
    return _launch(files, 2, "full")


@pytest.fixture(scope="module")
def tp4(files):
    return _launch(files, 4, "ids")


@pytest.fixture(scope="module")
def jax_ids(files):
    """The JAX loader's greedy ids at tp 2 and 4 (its GSPMD mesh over the
    virtual devices) for both variants."""
    cwd = os.getcwd()
    os.chdir(files["root"])
    try:
        prompts, inputs = dryrun._requests()
        out = {}
        for tp in (1, 2, 4):
            for name, kw in VARIANTS.items():
                _, jm, _, _ = jloader.load_pretrained_model(
                    files["spec"]["ckpt"], files["spec"]["base"],
                    load_tokenizer_fn=lambda _: None, tp=tp, **kw)
                out[tp, name] = jm.generate(prompts, inputs,
                                            max_new_tokens=6)
        return out
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("world", [2, 4])
def test_tp_greedy_ids_equal_tp1(tp1, tp2, tp4, world, variant):
    ranks = {2: tp2, 4: tp4}[world]
    assert len(ranks) == world
    for rank in ranks:  # every rank decodes the same ids
        assert rank[variant] == tp1[variant]
    assert all(len(row) == 6 for row in tp1[variant])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("world", [2, 4])
def test_tp_greedy_ids_equal_jax_tp_load(tp1, tp2, tp4, jax_ids, world,
                                         variant):
    ranks = {2: tp2, 4: tp4}[world]
    assert jax_ids[world, variant] == jax_ids[1, variant]
    assert ranks[0][variant] == jax_ids[world, variant]
    assert tp1[variant] == jax_ids[1, variant]


def test_tp2_chunked_prefill_and_slot_schedule_equal_tp1(tp1, tp2):
    """The chunked prefill's last-position logits at tp 2 within 1e-5 of
    tp 1's on both ranks; the slot decoder's schedule (one-shot and chunked
    admissions, ticks between chunks, a release and readmission) gives the
    same ids and cache lengths at every tick on the leader."""
    want = np.asarray(tp1["chunked_logits"])
    for rank in tp2:
        got = np.asarray(rank["chunked_logits"])
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert tp2[0]["schedule"] == tp1["schedule"]
    # 7 ticks outside the admissions; the rest ran between chunks
    assert len(tp1["schedule"]) > 7 + 2


def test_tp2_worker_wire_chunks_equal_tp1(tp1, tp2):
    """``ModelWorker.generate_stream`` at ``--tp 2`` (rank 0 serving, rank 1
    following) streams the same wire chunks as at ``--tp 1``, through the
    continuous-batching engine and the micro-batching one."""
    got, want = tp2[0]["worker"], tp1["worker"]
    assert got == want
    for engine in ("continuous", "micro"):
        assert len(want[engine]) == 2
        for chunks in want[engine]:
            last = json.loads(chunks[-1].rstrip("\0"))
            assert last["error_code"] == 0 and last["text"].count("t") >= 5
