"""The port's own training run, ``tools.train.main`` with ``--device cpu``
and the tiny configuration by ``--cfg-options``: 2 epochs of 1 step, a
checkpoint and a validation every epoch. Finite losses; the frozen stages
unmoved and the rest moved; each validation leaves the training model's
parameters float32, unchanged, and in train mode; ``init_inference`` on
the last ``step_N`` gives the detections, exactly, of a session built
from the trained model in memory.

Part (e) of ``tests/test_torch_train_entry.py``'s plan, in files of at most
3 tests, which xdist hands out late (ROADMAP's test-time budget): the
command line is in ``test_torch_train_cli_tool.py``.
"""

import copy
import json
import math
import os
import shutil

import pytest
import torch

from monorun_tpu_torch import train as ttrain
from monorun_tpu_torch.apis import inference as tinf
from monorun_tpu_torch.apis import train as tapi
from monorun_tpu_torch.tools import train as ttools

from test_torch_train_loop import write_small_kitti
from torch_share import cpu_share  # noqa: F401

H, W = 64, 128
# narrow widths for the port-only training tests (the bring-up rule's narrow
# widths; the paths and their branches stay): neck and RPN 256 -> 64, the
# FCs 1024 -> 128, the NOC convolutions 256 -> 64, CARAFE 64 -> 16, the score
# head's last FC 256 -> 64
NARROW_OPTIONS = [
    "neck.out_channels=64", "rpn.feat_channels=64", "bbox_head.fc_out_channels=128",
    "global_head.fc_out_channels=128", "noc_head.conv_out_channels=64",
    "noc_head.carafe_compressed_channels=16", "score_head.reg_fc_out_channels=128",
    "score_head.pose_fc_out_channels=128", "score_head.fc_out_channels=64",
]


TINY_OPTIONS = [
    "compute_dtype='float32'", "backbone.depth=26", "rpn.nms_pre=32", "rpn.nms_post=32",
    "rpn.train_nms_pre=32", "train.rcnn_num_samples=32", "train.max_pos=8",
    "train.rpn_num_samples=32", "test.rpn_nms_pre=32", "test.rpn_nms_post=32",
    "test.max_per_img=4", "global_head.mc_samples=2", "pose_head.ransac_hypotheses=2",
    "pose_head.lm_iters=2", f"data.pad_height={H}", f"data.pad_width={W}", "data.max_gt=8",
    "train.samples_per_device=2", "train.total_epochs=2", "train.checkpoint_interval=1",
    "train.eval_interval=1", "train.log_interval=1", "train.tensorboard=False",
    *NARROW_OPTIONS,
]


@pytest.fixture(scope="module")
def own_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("own_kitti")
    write_small_kitti(str(root), 3, seed=4)
    workdir = str(root / "work")
    made, vals = [], []
    run_val = tapi._run_val

    def create(*args, **kw):
        made.append(ttrain.create_train_state(*args, **kw))
        made.append({k: v.clone() for k, v in made[0][0].state_dict().items()})
        return made[0]

    def checked_run_val(cfg, model, val_ds):
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        ap = run_val(cfg, model, val_ds)
        vals.append(dict(
            ap=ap, training=model.training,
            fp32=all(p.dtype == torch.float32 for p in model.parameters()),
            unchanged=all(torch.equal(p, before[n]) for n, p in model.named_parameters())))
        return ap

    argv = ["kitti_multiclass_lidar_supv", "--work-dir", workdir, "--device", "cpu",
            "--cfg-options", f"data.train_root='{root}'", "data.train_list='train_list.txt'",
            "data.val_list='train_list.txt'", *TINY_OPTIONS]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "create_train_state", create)
        mp.setattr(tapi, "_run_val", checked_run_val)
        model, state = ttools.main(argv)
    with open(os.path.join(workdir, "train_log.jsonl")) as f:
        log = [json.loads(ln) for ln in f]
    yield dict(root=root, workdir=workdir, model=model, state=state, init=made[1],
               vals=vals, log=log, cfg=model.cfg)
    shutil.rmtree(workdir)          # its checkpoints


def test_own_run_trains(own_run):
    log, model, init = own_run["log"], own_run["model"], own_run["init"]
    assert [(r["step"], r["epoch"]) for r in log] == [(1, 0), (2, 1)]
    assert own_run["state"].step == 2
    for r in log:
        assert all(math.isfinite(v) for v in r.values()), r
    assert sorted(n for n in os.listdir(own_run["workdir"]) if n.startswith("step_")) \
        == ["step_1", "step_2"]
    with open(os.path.join(own_run["workdir"], "config.txt")) as f:
        assert f.read() == repr(own_run["cfg"])
    params = dict(model.named_parameters())
    frozen = [n for n in params if ttrain._is_frozen(n)]
    assert frozen and all(torch.equal(params[n], init[n]) for n in frozen)
    for n in ("backbone.layer2.0.conv1.weight", "neck.lateral_convs.0.conv.weight",
              "rpn_head.rpn_reg.weight"):
        assert not torch.equal(params[n], init[n]), n


def test_run_val_leaves_the_training_model_fp32_in_train_mode(own_run):
    vals = own_run["vals"]
    assert len(vals) == 2
    for v in vals:
        assert v["training"] and v["fp32"] and v["unchanged"]
        assert v["ap"] and all(math.isfinite(x) for x in v["ap"].values())


def test_init_inference_serves_a_port_checkpoint(own_run):
    """``init_inference`` on the run's last ``step_N`` gives the detections
    of a session built from the trained model in memory, exactly."""
    cfg, root = own_run["cfg"], own_run["root"]
    from monorun_tpu_torch.data.kitti import KITTI3DDataset
    from monorun_tpu_torch.data.pipeline import collate, prepare_test_sample

    ds = KITTI3DDataset(str(root), "train_list.txt")
    batch = collate([prepare_test_sample(ds, i, cfg.data) for i in range(2)])
    sess = tinf.init_inference(cfg, os.path.join(own_run["workdir"], "step_2"),
                               batch_size=2, device="cpu")
    ref = tinf.InferenceSession(cfg, copy.deepcopy(own_run["model"]), 2, torch.device("cpu"))
    got_det, want_det = (s.run(batch["images"], batch["cam"], batch["img_shapes"], seed=3)
                         for s in (sess, ref))
    for name, want in want_det._asdict().items():
        if name != "extras":
            assert torch.equal(getattr(got_det, name), want), name
    with pytest.raises(FileNotFoundError):
        tinf.init_inference(cfg, os.path.join(own_run["workdir"], "step_3"), device="cpu")
