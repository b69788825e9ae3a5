"""The port's VidSTG data path against vgqa_tpu's, on the CPU.

Each package gets its own copy of one synthetic set (the annotation caches
are written into the data dir), and both datasets read their frames from
the port's ``synthetic.frame_reader`` in place of ``read_frames``, so no
case decodes a video or builds the native decoder. Tolerances:
- text, annotations, items, clip sampling, loader order: exact;
- frames in [0, 1] after a resize: 1e-4 absolute (the port resizes with
  torch's bilinear, the JAX package with OpenCV's INTER_LINEAR; 6.8e-5 was
  the largest difference measured on the sizes the pipeline sees);
- uint8 canvases: within 1 level on at most 0.5% of the elements (a value
  that lands on a rounding edge);
- boxes: 1e-4 relative;
- the random decisions: equal (both ``random.Random`` states equal after
  the same calls).
"""

import copy
import json
import os
import random

import numpy as np
import pytest
import torch

from vgqa_tpu.config import build_default_cfg as jcfg_default
from vgqa_tpu.data import annotations as jann
from vgqa_tpu.data import clip_sampling as jclip
from vgqa_tpu.data import dataset as jdataset
from vgqa_tpu.data import loader as jloader
from vgqa_tpu.data import synthetic as jsynthetic
from vgqa_tpu.data import transforms as jtr
from vgqa_tpu.data import words as jwords
from vgqa_tpu_torch.config import build_default_cfg as tcfg_default
from vgqa_tpu_torch.data import annotations as tann
from vgqa_tpu_torch.data import clip_sampling as tclip
from vgqa_tpu_torch.data import dataset as tdataset
from vgqa_tpu_torch.data import loader as tloader
from vgqa_tpu_torch.data import synthetic as tsynthetic
from vgqa_tpu_torch.data import transforms as ttr
from vgqa_tpu_torch.data import words as twords

FRAMES, SIZE, VIDEOS = 30, (96, 64), 3
FRAME_ATOL = 1e-4
BOX_RTOL = 1e-4


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """(JAX copy, port copy) of one synthetic set: the JAX package writes
    its own (with mp4s), the port writes annotations only."""
    root = tmp_path_factory.mktemp("vidstg_pair")
    jdir, tdir = str(root / "jax"), str(root / "port")
    jsynthetic.make_synthetic_dataset(jdir, num_videos=VIDEOS, frames_per_video=FRAMES,
                                      size=SIZE)
    tsynthetic.make_synthetic_dataset(tdir, num_videos=VIDEOS, frames_per_video=FRAMES,
                                      size=SIZE, write_videos=False)
    return jdir, tdir


@pytest.fixture
def synthetic_frames_read(monkeypatch):
    reader = tsynthetic.frame_reader(FRAMES, SIZE)
    monkeypatch.setattr(jdataset, "read_frames", reader)
    monkeypatch.setattr(tdataset, "read_frames", reader)


def _cfgs(jdir, tdir, **opts):
    out = []
    for build, d in ((jcfg_default, jdir), (tcfg_default, tdir)):
        cfg = build()
        cfg.DATA_DIR = d
        cfg.INPUT.RESOLUTION = 64
        cfg.INPUT.TRAIN_SAMPLE_NUM = 8
        cfg.INPUT.MAX_QUERY_LEN = 16
        cfg.DATALOADER.NUM_WORKERS = 0
        cfg.MODEL.TEXT_MODEL.VOCAB_DIR = ""
        cfg.DATASET.APP_NUM, cfg.DATASET.MOT_NUM = 5, 7
        for key, value in opts.items():
            node = cfg
            *path, leaf = key.split(".")
            for p in path:
                node = node[p]
            node[leaf] = value
        out.append(cfg)
    return out


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)
    else:
        assert a == b, path


# ---- text -------------------------------------------------------------------

_SENTENCES = ["Whtie Dog, runs LEFT!", "a baby_seat next_to it",
              "frame 42 shows 1another man", "  The  woamn inisde the hoome. ", ""]


@pytest.mark.parametrize("group", range(4))
def test_clean_description_matches(group):
    """Every entry of the correction table, in four groups, plus sentences
    that split, drop digits and expand underscore compounds: exact."""
    assert twords.REPLACE_WORDS == jwords.REPLACE_WORDS
    typos = sorted(jwords.REPLACE_WORDS)[group::4]
    cases = typos + [f"the {t} is {t.upper()}, near a {t}!" for t in typos] + _SENTENCES
    for s in cases:
        assert twords.clean_description(s) == jwords.clean_description(s), s


def test_load_corrections_extends_the_table(tmp_path):
    path = tmp_path / "fix.json"
    path.write_text(json.dumps({"grene": "green"}))
    twords.load_corrections(str(path))
    try:
        assert twords.clean_description("a grene square") == "a green square"
    finally:
        twords._extra.clear()


# ---- the synthetic set ------------------------------------------------------

def test_synthetic_annotations_equal(sets):
    jdir, tdir = sets
    names = []
    for sub in ("sent_annos", "bbox_annos", "annos"):
        for name in sorted(os.listdir(os.path.join(jdir, sub))):
            with open(os.path.join(jdir, sub, name)) as f, \
                    open(os.path.join(tdir, sub, name)) as g:
                assert json.load(f) == json.load(g), f"{sub}/{name}"
            names.append(name)
    assert len(names) >= 2 * VIDEOS + 2
    assert len(os.listdir(os.path.join(jdir, "videos"))) == 2 * VIDEOS
    assert not os.listdir(os.path.join(tdir, "videos"))


def test_synthetic_frames_are_what_the_jax_writer_encodes(monkeypatch):
    """The port's renderer gives, frame for frame, the RGB pixels the JAX
    writer hands to OpenCV (captured from a stand-in VideoWriter)."""
    written = []

    class Capture:
        def __init__(self, *a, **kw):
            pass

        def isOpened(self):
            return True

        def write(self, frame_bgr):
            written.append(frame_bgr[..., ::-1].copy())

        def release(self):
            pass

    monkeypatch.setattr(jsynthetic.cv2, "VideoWriter", Capture)
    boxes_j = jsynthetic.write_synthetic_video("unused.mp4", 12, (40, 30), seed=3)
    frames, boxes_t = tsynthetic.synthetic_frames(12, (40, 30), seed=3)
    assert boxes_t == boxes_j
    np.testing.assert_array_equal(frames, np.stack(written))
    read = tsynthetic.frame_reader(12, (40, 30), seed=1)
    np.testing.assert_array_equal(read("/x/train_vid002.mp4", [11, 0, 5]), frames[[11, 0, 5]])


# ---- annotations ------------------------------------------------------------

@pytest.mark.parametrize("split", ["train", "test"])
def test_make_data_pairs_and_items_equal(sets, split, monkeypatch):
    jdir, tdir = sets
    pairs = tann.make_data_pairs(tdir, split)
    assert pairs == jann.make_data_pairs(jdir, split)
    items_t, items_j = tann.load_items(tdir, split), jann.load_items(jdir, split)
    assert len(items_t) == 2 * VIDEOS
    _assert_tree_equal(items_t, items_j)
    assert tann.load_eval_annotations(tdir, split) == jann.load_eval_annotations(jdir, split)
    assert tann.load_meta(tdir, split) == jann.load_meta(jdir, split)

    # the second call reads the caches: the raw annotations are not opened
    real_open = open

    def guarded(path, *a, **kw):
        if "sent_annos" in str(path) or "bbox_annos" in str(path):
            raise AssertionError(f"cache not reused: opened {path}")
        return real_open(path, *a, **kw)

    monkeypatch.setattr("builtins.open", guarded)
    assert tann.make_data_pairs(tdir, split) == pairs
    _assert_tree_equal(tann.load_items(tdir, split), items_j)


def test_load_meta_without_files_is_empty(tmp_path):
    assert tann.load_meta(str(tmp_path), "test") == jann.load_meta(str(tmp_path), "test") == {}


# ---- clip sampling ----------------------------------------------------------

@pytest.mark.parametrize("split,seed,budget", [("train", 0, 8), ("train", 5, 8),
                                              ("train", 9, 64), ("test", 1, 8)])
def test_sample_clip_equal(sets, split, seed, budget):
    jdir, _ = sets
    rj, rt = random.Random(seed), random.Random(seed)
    for item in jann.load_items(jdir, split):
        a = tclip.sample_clip(item, split, budget, 0.5, rt)
        b = jclip.sample_clip(item, split, budget, 0.5, rj)
        _assert_tree_equal(a, b)
    assert rt.getstate() == rj.getstate()


# ---- transforms -------------------------------------------------------------

def _sample(seed, t=6, h=72, w=128):
    rng = np.random.RandomState(seed)
    boxes = np.sort(rng.rand(3, 2, 2) * [w, h], axis=1).reshape(3, 4)[:, [0, 1, 2, 3]]
    boxes = np.stack([boxes[:, 0], boxes[:, 1], boxes[:, 0] + 5 + boxes[:, 2] / 3,
                      boxes[:, 1] + 5 + boxes[:, 3] / 3], 1).astype(np.float32)
    return {"frames": rng.rand(t, h, w, 3).astype(np.float32), "boxes": boxes,
            "text": "the man on the left walks right", "actioness": np.ones(t, np.float32),
            "letterbox": np.array([0.5, 0.5, 0.0, 0.0], np.float32)}


MEAN, STD = np.float32([0.485, 0.456, 0.406]), np.float32([0.229, 0.224, 0.225])


def _ties(float_sample):
    """Elements of the uint8 canvas whose value x 255 sits on a rounding
    edge (within 1e-3 of k + 0.5), from the float canvas of the same
    sample: an exact 2x downscale of uint8 pixels lands a quarter of its
    outputs there, and a one-ulp difference of the resize rounds them apart."""
    t = (float_sample["frames"] * STD + MEAN) * 255.0
    return np.abs(t - np.floor(t) - 0.5) < 1e-3


def _assert_samples_close(a, b, ties=None):
    assert set(a) == set(b)
    assert a["text"] == b["text"]
    assert a["frames"].shape == b["frames"].shape and a["frames"].dtype == b["frames"].dtype
    if a["frames"].dtype == np.uint8:
        d = np.abs(a["frames"].astype(np.int16) - b["frames"].astype(np.int16))
        off = (d > 0) if ties is None else (d > 0) & ~ties
        assert d.max() <= 1 and off.mean() <= 5e-3, (d.max(), off.mean(), (d > 0).mean())
    else:
        np.testing.assert_allclose(a["frames"], b["frames"], atol=FRAME_ATOL, rtol=0)
    np.testing.assert_allclose(a["boxes"], b["boxes"], rtol=BOX_RTOL, atol=1e-6)
    np.testing.assert_allclose(a["letterbox"], b["letterbox"], rtol=1e-6, atol=1e-6)
    if "pixel_mask" in a:
        np.testing.assert_array_equal(a["pixel_mask"], b["pixel_mask"])


def _pair(name):
    """(port, jax) transforms of one kind, each with its own Random(7)."""
    rt, rj = random.Random(7), random.Random(7)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    make = {
        "flip": lambda m, r: m.RandomHorizontalFlip(0.5, rng=r),
        "resize": lambda m, r: m.RandomResize([40, 56, 64], max_size=90, rng=r),
        "resize_up": lambda m, r: m.RandomResize([400, 500, 600], rng=r),
        "size_crop": lambda m, r: m.Compose([m.RandomResize([400, 500, 600], rng=r),
                                             m.RandomSizeCrop(384, 600, rng=r)]),
        "select": lambda m, r: m.RandomSelect(m.RandomResize([48], rng=r),
                                              m.RandomHorizontalFlip(1.0, rng=r), rng=r),
        "pad_float": lambda m, r: m.NormalizeAndPad(mean, std, 64, rng=r),
        "pad_translate": lambda m, r: m.NormalizeAndPad(mean, std, (64, 96), True, rng=r),
        "pad_uint8": lambda m, r: m.NormalizeAndPad(mean, std, 64, rng=r, emit_uint8=True),
    }[name]
    return make(ttr, rt), make(jtr, rj), rt, rj


@pytest.mark.parametrize("name", ["flip", "resize", "resize_up", "size_crop", "select",
                                  "pad_float", "pad_translate", "pad_uint8"])
def test_transform_equal(name):
    t_tr, j_tr, rt, rj = _pair(name)
    for seed in range(4):
        s = _sample(seed)
        a, b = t_tr(copy.deepcopy(s)), j_tr(copy.deepcopy(s))
        if name.startswith("pad") and a["frames"].dtype != np.uint8:
            a, b = {**a, "frames": a["frames"] * STD}, {**b, "frames": b["frames"] * STD}
        _assert_samples_close(a, b)
    assert rt.getstate() == rj.getstate()


@pytest.mark.parametrize("size", [(360, 640, 420, 747), (64, 96, 420, 630),
                                  (420, 747, 211, 376), (72, 128, 64, 114), (64, 96, 64, 96)])
def test_resize_frames_matches_opencv(size):
    h, w, nh, nw = size
    frames = np.random.RandomState(h).rand(2, h, w, 3).astype(np.float32)
    a, b = ttr.resize_frames(frames, nh, nw), jtr.resize_frames(frames, nh, nw)
    assert a.shape == b.shape == (2, nh, nw, 3) and a.dtype == np.float32
    np.testing.assert_allclose(a, b, atol=FRAME_ATOL, rtol=0)


@pytest.mark.parametrize("is_train,uint8", [(True, True), (True, False), (False, True)])
def test_build_transforms_equal(sets, is_train, uint8):
    jcfg, tcfg = _cfgs(*sets, **{"TPU.UINT8_FEED": uint8, "INPUT.AUG_TRANSLATE": is_train})
    rt, rj = random.Random(3), random.Random(3)
    t_tr, j_tr = ttr.build_transforms(tcfg, is_train, rng=rt), jtr.build_transforms(
        jcfg, is_train, rng=rj)
    assert ttr.canvas_hw(tcfg) == jtr.canvas_hw(jcfg) == (64, 64)
    for seed in range(6):
        s = _sample(seed, h=64, w=96)
        a, b = t_tr(copy.deepcopy(s)), j_tr(copy.deepcopy(s))
        if not uint8:
            a, b = {**a, "frames": a["frames"] * STD}, {**b, "frames": b["frames"] * STD}
        _assert_samples_close(a, b)
    assert rt.getstate() == rj.getstate()


# ---- dataset and loader -----------------------------------------------------

def _datasets(jcfg, tcfg, split, seed=0):
    return (tdataset.build_dataset(tcfg, split, rng=random.Random(seed)),
            jdataset.build_dataset(jcfg, split, rng=random.Random(seed)))


@pytest.mark.parametrize("split", ["train", "test"])
def test_dataset_items_equal(sets, synthetic_frames_read, split):
    """``dataset[i]`` of every item, uint8 canvases (the default feed) and
    float ones from the same draws. The train split's resize ladder at 64 px
    includes 32 px, an exact 2x downscale: its rounding ties may round apart
    (counted, and exempt from the 0.5% bound)."""
    out = {}
    for uint8 in (True, False):
        jcfg, tcfg = _cfgs(*sets, **{"TPU.UINT8_FEED": uint8})
        dt, dj = _datasets(jcfg, tcfg, split)
        assert len(dt) == len(dj) == 2 * VIDEOS
        out[uint8] = [(dt[i], dj[i]) for i in range(len(dt))]
        assert dt.rng.getstate() == dj.rng.getstate()
    for (a, b), (af, bf) in zip(out[True], out[False]):
        _assert_samples_close({**af, "frames": af["frames"] * STD},
                              {**bf, "frames": bf["frames"] * STD})
        _assert_samples_close(a, b, ties=_ties(bf))
        for k in ("item_id", "vid", "frame_ids", "qtype", "ori_size", "verb_index_list",
                  "adj_index_list"):
            assert a[k] == b[k], k
        for k in ("actioness", "start_heatmap", "end_heatmap", "sted"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _batch_close(a, b):
    v, w = a["video"], b["video"]
    for x, y in ((v.pixel_mask, w.pixel_mask), (v.time_mask, w.time_mask),
                 (a["text"].token_ids, b["text"].token_ids), (a["text"].mask, b["text"].mask)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    np.testing.assert_allclose(v.frames.numpy() * STD, np.asarray(w.frames) * STD,
                               atol=FRAME_ATOL, rtol=0)
    for k in a["targets"]:
        np.testing.assert_allclose(a["targets"][k].numpy(), np.asarray(b["targets"][k]),
                                   rtol=BOX_RTOL, atol=1e-6, err_msg=k)
    assert len(a["info"]) == len(b["info"])
    for x, y in zip(a["info"], b["info"]):
        assert x["item_id"] == y["item_id"] and x["frame_ids"] == y["frame_ids"]
        np.testing.assert_allclose(x["letterbox"], y["letterbox"], rtol=1e-6)
    assert a["iteration"] == b["iteration"]


@pytest.mark.parametrize("case", ["shuffle", "resume", "process_1_of_2", "ratio_buckets"])
def test_loader_batches_equal(sets, synthetic_frames_read, case):
    """Float canvases (the uint8 feed's rounding is held by the dataset test)."""
    jcfg, tcfg = _cfgs(*sets, **{"SOLVER.MAX_EPOCH": 2, "TPU.UINT8_FEED": False,
                                 "DATALOADER.ASPECT_RATIO_GROUPING": case == "ratio_buckets"})
    dt, dj = _datasets(jcfg, tcfg, "train", seed=4)
    if case == "ratio_buckets":             # portrait items among landscape ones
        for d in (dt, dj):
            for it in d.items[::3]:
                it["height"] = 200
    kw = {"shuffle": True, "global_batch": 2, "num_workers": 0, "seed": 11,
          "start_iter": 3 if case == "resume" else 0,
          "process_index": 1 if case == "process_1_of_2" else 0,
          "process_count": 2 if case == "process_1_of_2" else 1}
    lt = tloader.IterationBasedLoader(dt, tcfg, "train", **kw)
    lj = jloader.IterationBasedLoader(dj, jcfg, "train", **kw)
    assert len(lt) == len(lj) == 2 * 3
    orders = [(lt._indices_for_iter(i), lj._indices_for_iter(i)) for i in range(len(lt))]
    assert all(a == b for a, b in orders)
    if case == "ratio_buckets":
        assert any(a != list(range(len(a))) for a, _ in orders)
    got = 0
    for a, b in zip(lt, lj):
        _batch_close(a, b)
        assert a["video"].frames.shape[0] == lt.local_batch
        got += 1
    assert got == len(lt) - kw["start_iter"]


def test_loader_threads_keep_the_order_and_raise(sets, synthetic_frames_read, monkeypatch):
    """The threaded prefetch yields the iterations in order, and an error in
    a worker reaches the consumer (the loop does not hang)."""
    jcfg, tcfg = _cfgs(*sets)
    dt = tdataset.build_dataset(tcfg, "test", rng=random.Random(0))
    loader = tloader.IterationBasedLoader(dt, tcfg, "test", 1, shuffle=False,
                                          total_iters=len(dt), num_workers=3, prefetch=2)
    assert [b["iteration"] for b in loader] == list(range(len(dt)))

    def broken(*a, **kw):
        raise OSError("unreadable video")

    monkeypatch.setattr(tdataset, "read_frames", broken)
    with pytest.raises(OSError, match="unreadable"):
        list(loader)


def test_make_data_loader_pins_and_walks_the_test_split_once(sets, synthetic_frames_read):
    jcfg, tcfg = _cfgs(*sets)
    lt = tloader.make_data_loader(tcfg, "test")
    lj = jloader.make_data_loader(jcfg, "test", global_batch=1)
    assert len(lt) == len(lj) == 2 * VIDEOS and not lt.shuffle and not lj.shuffle
    assert lt.process_index == 0 and lt.process_count == 1
    with pytest.raises(ValueError):
        tloader.make_data_loader(tcfg, "eval")
    if torch.cuda.is_available():      # page-locked host memory needs a CUDA runtime
        pinned = tloader.make_data_loader(tcfg, "test", pin_memory=True)
        assert next(iter(pinned))["video"].frames.is_pinned()
