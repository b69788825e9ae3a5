"""The port's VidSTG evaluation and training over the data path against
vgqa_tpu's, on the CPU, over one synthetic set (a copy per package; both
datasets read frames from the port's ``synthetic.frame_reader``, so no case
decodes a video or builds the native decoder).

- ``VidSTGEvaluator.summarize`` on one set of predictions: 1e-6 (the same
  float64 host arithmetic);
- ``do_eval`` on ``configs/grounding_vidstg_tiny.yaml``, one random
  parameter tree carried into both models (``state_dict_from_jax``), the
  kernel routes on (JAX's plain routes on the CPU, the port's kernels'
  plain versions): each metric 1e-4. The test first asserts that every
  predicted span and keyframe choice is the same in both, so an argmax that
  flipped would fail there, by name;
- one ``Trainer`` step on a loader batch against the JAX step on the same
  batch, dropout off: loss terms rtol 1e-4, parameters after the step as in
  ``test_torch_train_step``;
- ``vgqa_tpu_torch.tools.train`` then ``.evaluate`` on the CPU write
  ``model_final_params`` and print the JAX tool's metric keys, also with
  jax, flax, optax, yaml, cv2 and vgqa_tpu unimportable.
"""

import io
import json
import os
import random
import subprocess
import sys
import textwrap
from contextlib import redirect_stdout

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_modules import random_params
from test_torch_train_step import _lr_bound, _port_name
from vgqa_tpu.config import build_default_cfg as jcfg_default
from vgqa_tpu.data import dataset as jdataset
from vgqa_tpu.data import synthetic as jsynthetic
from vgqa_tpu.data.loader import make_data_loader as jmake_loader
from vgqa_tpu.data.metrics import evaluator as jmetrics
from vgqa_tpu.models import GroundingConfig as JConfig
from vgqa_tpu.models import VSTGNet as JNet
from vgqa_tpu.models import build_model as jbuild_model
from vgqa_tpu.training import create_train_state, make_optimizer
from vgqa_tpu.training import make_train_step as jmake_train_step
from vgqa_tpu.training import evaluator as jeval
from vgqa_tpu.utils import boxes as jboxes
from vgqa_tpu.utils.containers import TextBatch as JText
from vgqa_tpu.utils.containers import VideoBatch as JVideo
from vgqa_tpu_torch.config import build_default_cfg as tcfg_default
from vgqa_tpu_torch.data import dataset as tdataset
from vgqa_tpu_torch.data import synthetic as tsynthetic
from vgqa_tpu_torch.data.loader import make_data_loader as tmake_loader
from vgqa_tpu_torch.data.metrics import evaluator as tmetrics
from vgqa_tpu_torch.models.convert_jax import state_dict_from_jax
from vgqa_tpu_torch.ops.dropout import DropoutRng
from vgqa_tpu_torch.training import evaluator as teval
from vgqa_tpu_torch.training.trainer import Trainer
from vgqa_tpu_torch.utils import boxes as tboxes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "grounding_vidstg_tiny.yaml")
FRAMES, SIZE, VIDEOS = 24, (96, 64), 2
METRIC_ATOL = 1e-4
SUMMARY_ATOL = 1e-6
LOSS_RTOL = 1e-4


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    root = tmp_path_factory.mktemp("vidstg_eval")
    jdir, tdir = str(root / "jax"), str(root / "port")
    jsynthetic.make_synthetic_dataset(jdir, num_videos=VIDEOS, frames_per_video=FRAMES,
                                      size=SIZE)
    tsynthetic.make_synthetic_dataset(tdir, num_videos=VIDEOS, frames_per_video=FRAMES,
                                      size=SIZE, write_videos=False)
    return jdir, tdir


@pytest.fixture
def frames_read(monkeypatch):
    reader = tsynthetic.frame_reader(FRAMES, SIZE)
    monkeypatch.setattr(jdataset, "read_frames", reader)
    monkeypatch.setattr(tdataset, "read_frames", reader)


def _cfgs(jdir, tdir, **opts):
    out = []
    for build, d in ((jcfg_default, jdir), (tcfg_default, tdir)):
        cfg = build()
        cfg.merge_from_file(TINY)
        cfg.DATA_DIR = d
        cfg.OUTPUT_DIR = ""
        for k, v in opts.items():
            cfg.merge_from_list([k, v])
        out.append(cfg)
    return out


# ---- metrics ----------------------------------------------------------------

def test_np_box_iou_matches():
    rng = np.random.RandomState(0)
    a = np.sort(rng.rand(5, 2, 2) * 50, axis=1).reshape(5, 4)
    b = np.sort(rng.rand(3, 2, 2) * 50, axis=1).reshape(3, 4)
    b[0] = a[0]
    got, want = tboxes.np_box_iou(a, b), jboxes.np_box_iou(a, b)
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == pytest.approx(1.0)
    with pytest.raises(ValueError):
        tboxes.np_box_area(a[0])


def _predictions(gt, seed):
    """Random boxes near the ground truth, random spans, keyframe P/R."""
    rng = np.random.RandomState(seed)
    boxes, video, kf = {}, {}, {}
    for item in gt:
        iid = item["item_id"]
        b0, b1 = item["gt_temp_bound"]
        s = int(b0 + rng.randint(-3, 4))
        e = int(b1 + rng.randint(-3, 4))
        boxes[iid] = {int(f): [list(np.asarray(box) + rng.randn(4) * 6)]
                      for f, box in item["bboxs"].items()}
        video[iid] = {"sted": [min(s, e), max(s, e) + 1], "qtype": item["qtype"]}
        kf[iid] = list(rng.rand(2))
    return boxes, video, kf


@pytest.mark.parametrize("seed", [0, 1])
def test_summarize_matches(sets, seed, tmp_path):
    jdir, tdir = sets
    ev_t = tmetrics.VidSTGEvaluator(None, tdir, "test", save_pred=True, save_dir=str(tmp_path))
    ev_j = jmetrics.VidSTGEvaluator(None, jdir, "test")
    boxes, video, kf = _predictions(jmetrics.load_eval_annotations(jdir, "test"), seed)
    for ev in (ev_t, ev_j):
        ev.update(boxes)
        ev.video_update(video)
        ev.update_kf_pr(kf)
        ev.synchronize_between_processes()
    got, want = ev_t.summarize(), ev_j.summarize()
    assert list(got) == list(want) and len(got) == 2 * 9
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=SUMMARY_ATOL), k
    saved = json.loads((tmp_path / "test_results.json").read_text())
    assert saved["declar_viou"] == pytest.approx(got["declar_viou"])


def test_merge_gathered_matches():
    payload = [{"predictions": {"3": {"7": [[1, 2, 3, 4]]}}, "att": {"3": {"7": [0.5]}},
                "video": {"3": {"sted": [1, 9], "qtype": "inter"}}, "kf": {"3": [0.5, 1.0]}}]
    ev_t = tmetrics.VidSTGEvaluator.__new__(tmetrics.VidSTGEvaluator)
    ev_j = jmetrics.VidSTGEvaluator.__new__(jmetrics.VidSTGEvaluator)
    for ev in (ev_t, ev_j):
        ev.predictions, ev.att_predictions, ev.video_predictions, ev.kf_pred = {}, {}, {}, {}
        ev._merge_gathered(json.loads(json.dumps(payload)))
    assert (ev_t.predictions, ev_t.att_predictions, ev_t.video_predictions, ev_t.kf_pred) == (
        ev_j.predictions, ev_j.att_predictions, ev_j.video_predictions, ev_j.kf_pred)


def test_interpolation_matches():
    boxes = {0: [[0.0, 0.0, 2.0, 2.0]], 4: [[4.0, 4.0, 6.0, 10.0]], 5: [[1.0, 1, 1, 1]]}
    conf = {0: [0.1], 3: [0.9], 4: [0.2], 9: [0.7]}
    assert teval.linear_interp(dict(boxes)) == jeval.linear_interp(dict(boxes))
    assert teval.linear_interp_conf(dict(conf)) == jeval.linear_interp_conf(dict(conf))
    assert teval.precision_recall([1, 2, 5], [2, 5, 6, 7]) == jmetrics.precision_recall(
        [1, 2, 5], [2, 5, 6, 7])


# ---- do_eval ----------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_params(sets):
    """One random parameter tree of the tiny model (shapes from a JAX
    loader batch; nothing compiles)."""
    jcfg, _ = _cfgs(*sets)
    batch = next(iter(jmake_loader(jcfg, "test", global_batch=1)))
    video = batch["video"]
    video = type(video)(video.frames.astype(jnp.float32), video.pixel_mask, video.time_mask)
    return random_params(JNet(JConfig.from_cfg(jcfg)), video, batch["text"], seed=7)


def _port_model(tcfg, params):
    from vgqa_tpu_torch.models import GroundingConfig as TConfig
    from vgqa_tpu_torch.models import VSTGNet as TNet

    tnet = TNet(TConfig.from_cfg(tcfg))
    tnet.load_state_dict(state_dict_from_jax(params, tnet))
    return tnet.eval()


def test_do_eval_matches_jax(sets, frames_read, tiny_params, monkeypatch):
    monkeypatch.setenv("VGQA_PALLAS_INTERPRET", "0")
    jcfg, tcfg = _cfgs(*sets)
    jev = jmetrics.build_evaluator(jcfg, None, mode="test")
    tev = tmetrics.build_evaluator(tcfg, None, mode="test")
    want = jeval.do_eval(jcfg, "test", None, JNet(JConfig.from_cfg(jcfg)), tiny_params,
                         jmake_loader(jcfg, "test", global_batch=1), jev)
    got = teval.do_eval(tcfg, "test", None, _port_model(tcfg, tiny_params),
                        tmake_loader(tcfg, "test"), tev)
    # the decisions first: spans and the merged predictions' frames per item
    assert tev.video_predictions == jev.video_predictions
    assert {k: sorted(v) for k, v in tev.predictions.items()} == {
        k: sorted(v) for k, v in jev.predictions.items()}
    assert list(got) == list(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=METRIC_ATOL), k
    for vid, per in jev.predictions.items():
        for f, box in per.items():
            np.testing.assert_allclose(tev.predictions[vid][f], box, atol=1e-2)


def test_do_eval_takes_params(sets, frames_read, tiny_params):
    """``params`` stands in for the model's own: a model with other weights
    evaluated with the tree's gives the tree's metrics."""
    _, tcfg = _cfgs(*sets)
    model = _port_model(tcfg, tiny_params)
    want = teval.do_eval(tcfg, "test", None, model, tmake_loader(tcfg, "test"),
                         tmetrics.build_evaluator(tcfg, None, "test"))
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.5)
    got = teval.do_eval(tcfg, "test", None, model, tmake_loader(tcfg, "test"),
                        tmetrics.build_evaluator(tcfg, None, "test"), params=params)
    assert list(got) == list(want)
    for k in want:      # the same float32 model; the convolutions may pick other kernels
        assert got[k] == pytest.approx(want[k], abs=1e-6), k


# ---- one trainer step on a loader batch -------------------------------------

def test_trainer_step_on_a_loader_batch_matches_jax(sets, frames_read, tiny_params,
                                                    monkeypatch):
    monkeypatch.setenv("VGQA_PALLAS_INTERPRET", "0")
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)
    monkeypatch.setattr(DropoutRng, "dropout", lambda self, x, rate: x)
    jcfg, tcfg = _cfgs(*sets, **{"MODEL.VSTG.DROPOUT": 0.0})
    trainer = Trainer(tcfg, device="cpu", seed=0)
    trainer.setup()
    assert trainer.max_iter == 2 * VIDEOS      # one epoch of the train split, batch 1
    trainer.state.model.load_state_dict(state_dict_from_jax(tiny_params, trainer.state.model))
    for n, p in trainer.state.model.named_parameters():
        trainer.state.ema[n].copy_(p.detach())
    batch = next(iter(tmake_loader(tcfg, "train")))
    b = {"video": batch["video"], "text": batch["text"], "targets": batch["targets"]}
    metrics_t = trainer.step_fn(trainer.state, b["video"], b["text"], b["targets"], 0)

    model, loss_fn, wd = jbuild_model(jcfg)
    tx, labels_j = make_optimizer(jcfg, tiny_params, trainer.max_iter)
    state = create_train_state(tiny_params, tx, use_ema=True)
    step = jax.jit(jmake_train_step(model, loss_fn, wd, tx, jcfg.MODEL.EMA_DECAY,
                                    pixel_stats=(jcfg.INPUT.PIXEL_MEAN, jcfg.INPUT.PIXEL_STD)))
    v, t = b["video"], b["text"]
    video_j = JVideo(*(jnp.asarray(x.numpy()) for x in (v.frames, v.pixel_mask, v.time_mask)))
    text_j = JText(jnp.asarray(t.token_ids.numpy().astype(np.int32)), jnp.asarray(t.mask.numpy()))
    targets_j = {k: jnp.asarray(x.numpy().astype(np.int32) if x.dtype == torch.int64
                                else x.numpy()) for k, x in b["targets"].items()}
    state, metrics_j = step(state, video_j, text_j, targets_j, jax.random.PRNGKey(0))
    for k in metrics_j:
        np.testing.assert_allclose(float(metrics_t[k]), float(metrics_j[k]), rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=k)
    labels = {_port_name(p): lab for p, lab in
              jax.tree_util.tree_flatten_with_path(labels_j)[0]}
    new_ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.params))
    lr = _lr_bound(labels, tcfg)
    for name, p in trainer.state.model.named_parameters():
        # the sign of Adam's first step may differ where the gradient is noise: 2 x lr
        err = np.abs(p.detach().numpy() - new_ref[name].numpy())
        assert (err <= 5e-7 + 2 * lr[name]).all(), name
    assert trainer.state.step == int(state.step) == 1


# ---- the tools --------------------------------------------------------------

def _jax_tool_keys(jdir):
    """The metric keys ``tools/evaluate.py`` prints for this test split (in
    the order of a set of question types, which the hash seed decides)."""
    ev = jmetrics.VidSTGEvaluator(None, jdir, "test")
    boxes, video, kf = _predictions(jmetrics.load_eval_annotations(jdir, "test"), 0)
    ev.update(boxes)
    ev.video_update(video)
    ev.update_kf_pr(kf)
    return list(ev.summarize())


def _last_json(stdout: str) -> dict:
    lines = stdout.splitlines()
    start = max(i for i, line in enumerate(lines) if line == "{")
    return json.loads("\n".join(lines[start:]))


def test_tools_train_then_evaluate(sets, frames_read, tmp_path):
    from vgqa_tpu_torch.tools import evaluate as tool_eval
    from vgqa_tpu_torch.tools import train as tool_train

    jdir, tdir = sets
    out = str(tmp_path / "out")
    common = ["--device", "cpu", "--config-file", TINY, "DATA_DIR", tdir, "OUTPUT_DIR", out]
    assert tool_train.main(common + ["SOLVER.CHECKPOINT_PERIOD", "2"]) == 0
    for name in ("model_final", "model_final_params", "model_000002", "model_000002_params",
                 "config.yml", "log.txt"):
        assert os.path.exists(os.path.join(out, name)), name
    with open(os.path.join(out, "last_checkpoint")) as f:
        assert f.read().strip().endswith("model_final")
    params = torch.load(os.path.join(out, "model_final_params"), weights_only=True)
    final = torch.load(os.path.join(out, "model_final"), weights_only=True)
    assert set(params) == set(final["model"])
    assert any(not torch.equal(params[n], final["model"][n]) for n in final["ema"])
    assert all(torch.equal(params[n], final["ema"][n]) for n in final["ema"])

    buf = io.StringIO()
    with redirect_stdout(buf):
        assert tool_eval.main(common + ["MODEL.WEIGHT_EVAL",
                                        os.path.join(out, "model_final_params")]) == 0
    results = _last_json(buf.getvalue())
    assert sorted(results) == sorted(_jax_tool_keys(jdir))
    assert all(np.isfinite(v) for v in results.values())
    assert "Loaded eval weights" in buf.getvalue()

    with pytest.raises(ValueError, match="export_torch_checkpoint"):
        tool_eval.main(common + ["MODEL.WEIGHT_EVAL", out])


def test_trainer_resumes_and_warm_starts(sets, frames_read, tmp_path):
    _, tcfg = _cfgs(*sets)
    tcfg.OUTPUT_DIR = str(tmp_path / "a")
    tcfg.SOLVER.TO_VAL = False
    first = Trainer(tcfg, device="cpu", seed=1)
    first.setup()
    first.fit()
    assert first.state.step == first.max_iter == 2 * VIDEOS
    assert [s for s, _, _ in first.step_log] == list(range(1, first.max_iter + 1))
    again = Trainer(tcfg, device="cpu", seed=1)
    again.setup()
    assert again.state.step == first.max_iter
    assert again.fit() == [] and again.state.step == first.max_iter

    tcfg.OUTPUT_DIR = str(tmp_path / "b")
    tcfg.MODEL.WEIGHT = os.path.join(str(tmp_path / "a"), "model_final_params")
    warm = Trainer(tcfg, device="cpu", seed=5)
    warm.setup()
    want = torch.load(tcfg.MODEL.WEIGHT, weights_only=True)
    for n, p in warm.state.model.named_parameters():
        assert torch.equal(p.detach(), want[n]) and torch.equal(warm.state.ema[n], want[n]), n
    assert warm.state.step == 0
    tcfg.MODEL.WEIGHT = str(tmp_path / "a")
    with pytest.raises(ValueError, match="export_torch_checkpoint"):
        Trainer(tcfg, device="cpu").setup()


def test_validate_inside_fit(sets, frames_read, tmp_path):
    _, tcfg = _cfgs(*sets, **{"SOLVER.VAL_PERIOD": 2, "SOLVER.TO_VAL": True})
    trainer = Trainer(tcfg, device="cpu", seed=3)
    trainer.setup()
    seen = []
    real = trainer.validate
    trainer.validate = lambda: seen.append(trainer.state.step) or real()
    trainer.fit()
    assert seen == [2, 4]


_BLOCKED = textwrap.dedent("""
    import importlib.abc, io, json, runpy, sys
    from contextlib import redirect_stdout

    BLOCKED = {"jax", "jaxlib", "flax", "optax", "yaml", "cv2", "vgqa_tpu"}

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is not installed on the card machine")
            return None

    sys.meta_path.insert(0, Refuse())
    from vgqa_tpu_torch.data import dataset, synthetic

    data, out, tiny = sys.argv[1:4]
    synthetic.make_synthetic_dataset(data, num_videos=2, frames_per_video=24,
                                     write_videos=False)
    dataset.read_frames = synthetic.frame_reader(24, (96, 64))
    common = ["--device", "cpu", "--config-file", tiny, "DATA_DIR", data, "OUTPUT_DIR", out]
    sys.argv = ["train"] + common
    try:
        runpy.run_module("vgqa_tpu_torch.tools.train", run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, e.code
    sys.argv = ["evaluate"] + common + ["MODEL.WEIGHT_EVAL", out + "/model_final_params"]
    buf = io.StringIO()
    with redirect_stdout(buf):
        try:
            runpy.run_module("vgqa_tpu_torch.tools.evaluate", run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
    lines = buf.getvalue().splitlines()
    start = max(i for i, line in enumerate(lines) if line == "{")
    keys = list(json.loads("\\n".join(lines[start:])))
    assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    print("KEYS", json.dumps(keys))
""")


def test_train_and_evaluate_without_jax_yaml_cv2(sets, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _BLOCKED, str(tmp_path / "data"),
                           str(tmp_path / "out"), TINY], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-2000:]
    keys = json.loads(proc.stdout.split("KEYS ", 1)[1])
    assert sorted(keys) == sorted(_jax_tool_keys(sets[0]))   # set order: hash-seeded
    assert os.path.exists(tmp_path / "out" / "model_final_params")
