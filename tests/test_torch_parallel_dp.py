"""Data-parallel training on gloo (CPU): ``train()`` in 2 and 4 processes
of ``scripts/torch_dryrun_multirank.py`` (case ``train``) against one
process at the same global batch, and the DP x TP step with its collective
audit (the script's own run, case ``dpxtp``, at 2 x 2).

The tiny stage-2 run (vision DAMC, fp32, LoRA r=4, global batch 4, three
steps, a checkpoint at step 2) trains at world 2 with 2 samples a rank and
at world 4 with 1, the ranks holding different numbers of valid targets.
Tolerances: losses and exported tensors within 1e-5 relative (fp32, Adam
eps 1e-2 as in ``tests/test_torch_train_entry.py``: the gradient sums of
the ranks reorder the one process's sum); each rank's moments 1/N of the
one process's bytes; only rank 0 writes; a checkpoint of one world size
resumes at another to the one-process run.
"""

import importlib.util
import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from modelcompose_tpu_torch.compose.state_io import load_state

from tests.test_torch_train_entry import TINY

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "torch_dryrun_multirank.py")
TOL = 1e-5
GLOBAL_B = 4
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


def _rel_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A tiny base directory (its config.json sets the sizes; the weights
    are random from the seed) and 8 image samples with answers of 1 to 6
    words."""
    root = tmp_path_factory.mktemp("dp")
    base = root / "vicuna-tiny"
    base.mkdir()
    with open(base / "config.json", "w") as f:
        json.dump(dict(TINY, model_type="llama"), f)
    rs = np.random.RandomState(0)
    data = []
    for i in range(8):
        img = str(root / f"img{i}.png")
        Image.fromarray((rs.rand(32, 32, 3) * 255).astype(np.uint8)).save(img)
        answer = " ".join(f"word{j}" for j in range(1 + (5 * i) % 6))
        data.append({"id": i, "conversations": [
            {"from": "human", "value": "<image>\nwhat is it"},
            {"from": "gpt", "value": answer}],
            "modal_inputs": {"vision": [img]}})
    with open(root / "train.json", "w") as f:
        json.dump(data, f)
    return root


def _argv(files, out, per_device):
    flags = dict(model_name_or_path=files / "vicuna-tiny", version="v1",
                 data_path=files / "train.json", output_dir=out,
                 mm_vision_encoder="test:32x2",
                 mm_projector_type="mlp2x_gelu", mm_vision_select_layer=-2,
                 lora_strategy="modal+language", lora_r=4, lora_alpha=8,
                 local_prefix_tokens=1, local_suffix_tokens=1,
                 per_device_train_batch_size=per_device, max_steps=3,
                 learning_rate=1e-3, bf16="False", tower_dtype="float32",
                 save_steps=2, logging_steps=1, dataloader_num_workers=1,
                 warmup_ratio=0.0)
    return [a for k, v in flags.items() for a in (f"--{k}", str(v))] + [
        "--random_init_backbone"]


def _spec(files, name, runs):
    path = files / f"spec-{name}.json"
    with open(path, "w") as f:
        json.dump({"adam_eps": 1e-2, "runs": [{"argv": argv}
                                             for argv in runs]}, f)
    return str(path)


@pytest.fixture(scope="module")
def one(files):
    """The one-process run at the global batch."""
    return dryrun.case_train({"runs": [{"argv": _argv(
        files, files / "one", GLOBAL_B)}]})[0]


@pytest.fixture(scope="module")
def world2(files, one):
    """World 2: a run from scratch, then the one-process run's checkpoint-2
    resumed to step 3."""
    shutil.copytree(files / "one" / "checkpoint-2",
                    files / "resume2" / "checkpoint-2")
    spec = _spec(files, "w2", [_argv(files, files / "dp2", GLOBAL_B // 2),
                               _argv(files, files / "resume2",
                                     GLOBAL_B // 2)])
    return dryrun.launch("train", 2, str(files / "out-w2"), spec,
                         timeout=LAUNCH_TIMEOUT, cwd=str(files))


@pytest.fixture(scope="module")
def world4(files):
    spec = _spec(files, "w4", [_argv(files, files / "dp4", GLOBAL_B // 4)])
    return dryrun.launch("train", 4, str(files / "out-w4"), spec,
                         timeout=LAUNCH_TIMEOUT, cwd=str(files))


def _export(path):
    return load_state(str(path / "adapter_model.bin"))


def _assert_exports_close(got_dir, want_dir):
    got, want = _export(got_dir), _export(want_dir)
    assert sorted(got) == sorted(want)
    for k in want:
        assert _rel_max(got[k], want[k]) <= TOL, k


@pytest.mark.parametrize("world", [2, 4])
def test_dp_losses_and_trained_leaves_match_one_process(files, one, world2,
                                                        world4, world):
    ranks = {2: world2, 4: world4}[world]
    assert one["steps"] == 3 and len(ranks) == world
    for rank in ranks:
        got = rank[0]["losses"]
        assert len(got) == 3
        for g, w in zip(got, one["losses"]):
            assert abs(g - w) <= TOL * abs(w), (got, one["losses"])
    _assert_exports_close(files / f"dp{world}", files / "one")


@pytest.mark.parametrize("world", [2, 4])
def test_dp_ranks_hold_different_valid_targets(world2, world4, world):
    ranks = {2: world2, 4: world4}[world]
    per_step = list(zip(*[r[0]["positions"] for r in ranks]))
    assert len(per_step) == 3
    assert any(len(set(step)) > 1 for step in per_step), per_step


@pytest.mark.parametrize("world", [2, 4])
def test_dp_moments_are_one_nth_per_rank(one, world2, world4, world):
    """ZeRO-1: every trainable leaf of this config has a free axis that the
    data width divides, so each rank keeps exactly 1/N of the moments."""
    ranks = {2: world2, 4: world4}[world]
    assert one["moment_bytes"] > 0
    for rank in ranks:
        assert rank[0]["moment_bytes"] * world == one["moment_bytes"]


def test_only_the_primary_rank_writes(files, world2, world4):
    for ranks in (world2, world4):
        assert {"train_params.pt", "opt_state.pt",
                "adapter_model.bin"} <= set(ranks[0][0]["saved"])
        for rank in ranks[1:]:
            assert rank[0]["saved"] == [], rank
    ckpt = files / "dp4" / "checkpoint-2"
    assert sorted(os.listdir(ckpt)) == ["opt_state.pt", "train_params.pt",
                                        "trainer_state.json"]
    # whole moments: the world-4 checkpoint holds the one process's shapes
    got = torch.load(ckpt / "opt_state.pt", weights_only=True)
    want = torch.load(files / "one" / "checkpoint-2" / "opt_state.pt",
                      weights_only=True)
    for m in ("mu", "nu"):
        assert {k: v.shape for k, v in got[m].items()} == \
            {k: v.shape for k, v in want[m].items()}


def test_one_process_checkpoint_resumes_at_world2(files, one, world2):
    for rank in world2:
        run = rank[1]
        assert run["start_step"] == 2 and run["steps"] == 3
        assert abs(run["losses"][-1] - one["losses"][2]) \
            <= TOL * abs(one["losses"][2])
    _assert_exports_close(files / "resume2", files / "one")


def test_world2_checkpoint_resumes_at_world1(files, one, world2):
    shutil.copytree(files / "dp2" / "checkpoint-2",
                    files / "resume1" / "checkpoint-2")
    run = dryrun.case_train({"runs": [{"argv": _argv(
        files, files / "resume1", GLOBAL_B)}]})[0]
    assert run["start_step"] == 2 and run["steps"] == 3
    assert abs(run["losses"][-1] - one["losses"][2]) \
        <= TOL * abs(one["losses"][2])
    _assert_exports_close(files / "resume1", files / "one")


# ---------------------------------------------------------------------------
# DP x TP and the audit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dpxtp(tmp_path_factory):
    return dryrun.launch("dpxtp", 4, str(tmp_path_factory.mktemp("dpxtp")),
                         timeout=LAUNCH_TIMEOUT)


def test_dpxtp_step_matches_one_process_on_every_rank(dpxtp):
    """2 x 2: the loss, every trainable gradient (a column-split LoRA B's
    shard against its slice) and the parameters after the ZeRO-1 update
    equal the one-process step within 1e-5 on every rank; the TP decode's
    greedy ids equal the unsharded model's."""
    assert dryrun.dryrun_checks(dpxtp) == []
    assert [(r["data"], r["model"]) for r in dpxtp] == [(2, 2)] * 4
    # the two data rows hold different numbers of valid targets
    assert dpxtp[0]["valid_targets"] != dpxtp[2]["valid_targets"]
    for r in dpxtp:
        assert r["loss_err"] <= TOL and r["grad_err"] <= TOL \
            and r["param_err"] <= TOL


def test_tp_step_rebuilds_a_serving_backbone_made_before(dpxtp):
    """A model whose serving backbone was made before the TP step gets a
    new one over its model group after it, mirrored at world 4: a kept
    one would run the leader unmirrored while the followers wait."""
    assert [r["serving_rebuilt"] for r in dpxtp] == [True] * 4


def test_collectives_are_bounded_by_activations_and_gradients(dpxtp):
    """The recorder around every ``torch.distributed`` call of the DP x TP
    train step and of one TP decode step: collectives happen, none moves a
    tensor the size of a layer's slice of a frozen base weight, and each is
    within 1.5x the largest activation ([B, L, max(H, V)] fp32: the
    gathered logits) or trainable gradient."""
    cfg = dryrun.audit_config()
    H, V = cfg.hidden_size, cfg.vocab_size
    for r in dpxtp:
        per_layer = r["min_frozen_bytes"] // r["layers"]
        train_bound = 3 * max(2 * r["bucket"] * max(H, V) * 4,
                              cfg.intermediate_size * 2 * 4 * 4) // 2
        decode_bound = 2 * 2 * V * 4  # B=2 rows of fp32 logits, twice
        assert train_bound < per_layer and decode_bound < per_layer
        for log, bound in ((r["train_audit"], train_bound),
                           (r["decode_audit"], decode_bound)):
            assert log, "no collectives"
            kinds = {name for name, _ in log}
            assert {"all_reduce", "all_gather"} <= kinds, kinds
            assert max(b for _, b in log) <= bound, log
