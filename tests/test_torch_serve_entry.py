"""The port's serving entry points against the JAX package's, on the CPU.

* The chain from a reference checkpoint: ``python -m
  vgqa_tpu_torch.tools.convert_weights grounding`` on a reference-shaped
  state dict (the tiny geometry, weights rescaled to fan-in so the heads'
  outputs spread), served by the port, against the JAX package serving
  ``convert_grounding_reference``'s tree of the same dict. Both in float32.
* ``VGQA_GROUND_COALESCE=1``: ``predict_many`` on two ``frames`` requests runs
  one V = 4 forward and answers as JAX ``_run_group`` does on the same
  frames, and as the port's own pipelined path; groups form by (format,
  frame count); a bad request fails its own slot.
* ``predict_many`` by config path takes ``device``: ``"cpu"`` serves on the
  CPU, and without a card and without ``device`` it raises.
* The CLIs: ``tools.infer_grounding`` (two videos, coalesced) and
  ``tools.infer_qa`` print the JAX tools' JSON on the same video and weights.
* The four entry points run with jax, flax, optax, PyYAML, OpenCV and
  ``vgqa_tpu`` import-blocked, as on the card machine, with the decode
  replaced by rendered frames (the card machine has no decoder).

Tolerances (the serving parity of ``test_torch_serving.py``): temporal span
and tube frame ids equal, scores within 1e-4, boxes within 1e-3 of the
original frame size (float32 summation order over the whole forward).
"""

import importlib.util
import io
import json
import os
import subprocess
import sys
import textwrap
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgqa_tpu.inference import grounding as jgrounding
from vgqa_tpu.models import VSTGNet as JNet
from vgqa_tpu.models import convert_grounding as jcg
from vgqa_tpu.models.reference_shapes import build_reference_state_dict
from vgqa_tpu_torch.config import build_default_cfg
from vgqa_tpu_torch.inference import grounding
from vgqa_tpu_torch.tools import convert_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORI = (120, 160)
FPS = 10.0
DEPTHS = dict(enc_layers=2, dec_layers=2, resnet_depths=(1, 1, 1, 1), swin_depths=(1, 1, 1, 1),
              roberta_layers=2)


def _fan_in_scaled(sd):
    """The reference-shaped dict with every kernel rescaled to std
    fan_in^-1/2 (``build_reference_state_dict``'s 0.02 keeps the heads' outputs nearly flat)."""
    out = {}
    for k, v in sd.items():
        if k.endswith("weight") and v.ndim >= 2 and v.std() > 0:
            v = v / v.std() * float(np.prod(v.shape[1:])) ** -0.5
        out[k] = v.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(tiny float32 config path, port checkpoint, JAX loaded model, port
    loaded model) serving one reference-shaped checkpoint."""
    root = tmp_path_factory.mktemp("serve")
    grounding._load_cached.cache_clear()
    cfg = build_default_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "grounding_vidstg_tiny.yaml"))
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg_path = str(root / "tiny_f32.yaml")
    with open(cfg_path, "w") as f:
        f.write(cfg.dump())
    sd = _fan_in_scaled(build_reference_state_dict())
    src, ckpt = str(root / "vidstg.pth"), str(root / "vidstg.pt")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, src)
    with redirect_stdout(io.StringIO()):
        convert_weights.main(["grounding", "--src", src, "--dst", ckpt, "--config", cfg_path])
    params = jcg.convert_grounding_reference(sd, **DEPTHS)

    class Preset(JNet):
        def init(self, *args, **kwargs):
            return params

    orig = jgrounding.VSTGNet
    jgrounding.VSTGNet = Preset
    try:
        jloaded = jgrounding._load_model(cfg_path, "")       # cached for the module
    finally:
        jgrounding.VSTGNet = orig
    tloaded = grounding._load_model(cfg_path, ckpt, "cpu")
    yield cfg_path, ckpt, jloaded, tloaded
    jgrounding._load_model.cache_clear()
    grounding._load_cached.cache_clear()


def _frames_requests(cfg, n, t2=None, seed=1):
    res, t2 = cfg.INPUT.RESOLUTION, t2 or 2 * cfg.INPUT.TRAIN_SAMPLE_NUM
    rng = np.random.RandomState(seed)
    return [{"frames": rng.randint(0, 256, (t2, res, res, 3), np.uint8),
             "frame_ids": np.arange(0, 3 * t2, 3), "fps": FPS, "ori_size": ORI,
             "query": f"a green square moves right {i}"} for i in range(n)]


def _assert_same_response(out_t, out_j):
    assert out_t["temporal"] == pytest.approx(out_j["temporal"], abs=1e-6)
    assert [e["frame"] for e in out_t["tube"]] == [e["frame"] for e in out_j["tube"]]
    np.testing.assert_allclose([e["score"] for e in out_t["tube"]],
                               [e["score"] for e in out_j["tube"]], atol=1e-4)
    np.testing.assert_allclose([e["bbox"] for e in out_t["tube"]],
                               [e["bbox"] for e in out_j["tube"]], atol=1e-3 * max(ORI))


def _count_forwards(monkeypatch):
    """Rows of each forward the port's ``predict_many`` launches (both
    policies launch through ``dispatch_forward``)."""
    rows = []
    real_dispatch = grounding.dispatch_forward

    def dispatch(fwd, video, *a, **kw):
        rows.append(2 * video.frames.shape[0])
        return real_dispatch(fwd, video, *a, **kw)

    monkeypatch.setattr(grounding, "dispatch_forward", dispatch)
    return rows


def test_coalesced_forward_matches_jax_run_group(served, monkeypatch):
    cfg_path, _, jloaded, tloaded = served
    reqs = _frames_requests(tloaded.cfg, 2)
    monkeypatch.setenv("VGQA_GROUND_COALESCE", "1")
    rows = _count_forwards(monkeypatch)
    out_t = grounding.predict_many(reqs, loaded=tloaded)
    assert rows == [4]                        # one V = 2N forward for the pair
    jobs = [{"frames": jnp.asarray(r["frames"]), "frame_ids": r["frame_ids"], "yuv": False,
             "full_range": 0.0, "fps": FPS, "ori_size": ORI, "query": r["query"]}
            for r in reqs]
    jgrounding._run_group(jloaded, jobs)
    for t, j in zip(out_t, jobs):
        _assert_same_response(t, j["out"])
    # the spans and boxes are not flat: the check has something to compare
    assert len({tuple(e["bbox"]) for e in out_t[0]["tube"]}) > 1


def test_coalesced_matches_pipelined(served, monkeypatch):
    _, _, _, tloaded = served
    reqs = _frames_requests(tloaded.cfg, 2, seed=2)
    rows = _count_forwards(monkeypatch)
    piped = grounding.predict_many(reqs, loaded=tloaded)
    assert rows == [2, 2]                     # the default: one V = 2 forward per video
    monkeypatch.setenv("VGQA_GROUND_COALESCE", "1")
    coalesced = grounding.predict_many(reqs, loaded=tloaded)
    assert rows == [2, 2, 4]
    for c, p in zip(coalesced, piped):
        _assert_same_response(c, p)
    # a caller's own policy (the server's, read once at its start) wins over the variable
    grounding.predict_many(reqs, loaded=tloaded, coalesce=False)
    assert rows == [2, 2, 4, 2, 2]


def test_coalesce_groups_by_frame_count(served, monkeypatch):
    _, _, _, tloaded = served
    cfg = tloaded.cfg
    reqs = (_frames_requests(cfg, 2, seed=3) + _frames_requests(cfg, 1, t2=8, seed=4)
            + [{"frames": np.zeros((4, 8, 8, 3), np.uint8), "fps": FPS, "ori_size": ORI,
                "query": "a bad request"}])
    monkeypatch.setenv("VGQA_GROUND_COALESCE", "1")
    rows = _count_forwards(monkeypatch)
    out = grounding.predict_many(reqs, loaded=tloaded)
    assert sorted(rows) == [2, 4]
    assert isinstance(out[3], ValueError)
    assert all(set(o) == {"temporal", "tube"} for o in out[:3])
    assert len(out[2]["tube"]) == 8 * 3 - 2        # frame ids 0, 3, ..., 21


def test_predict_many_takes_device(served, monkeypatch):
    cfg_path, ckpt, _, tloaded = served
    req = _frames_requests(tloaded.cfg, 1, seed=5)
    out = grounding.predict_many(req, cfg_path, ckpt, device="cpu")
    assert set(out[0]) == {"temporal", "tube"}
    assert grounding._load_cached.cache_info().currsize == 1      # the fixture's model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        grounding.predict_many(req, cfg_path, ckpt)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        grounding.predict("/any.mp4", "q", cfg_path, ckpt)
    # one cache entry for the card however it is named
    keys = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(grounding, "_load_cached", lambda *k: keys.append(k))
    grounding._load_model(cfg_path, ckpt)
    grounding._load_model(cfg_path, ckpt, "cuda")
    assert keys == [(cfg_path, ckpt, "cuda")] * 2


def _jax_tool(name, monkeypatch):
    monkeypatch.setenv("VGQA_COMPILE_CACHE", "0")
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv, monkeypatch, as_argv=False):
    buf = io.StringIO()
    if as_argv:
        monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    with redirect_stdout(buf):
        main() if as_argv else main(argv)
    return json.loads(buf.getvalue())


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    from vgqa_tpu_torch.data.synthetic import write_synthetic_video

    root = tmp_path_factory.mktemp("videos")
    paths = [str(root / f"v{i}.mp4") for i in range(2)]
    for i, p in enumerate(paths):
        write_synthetic_video(p, 24, (64, 48), seed=10 + i)
    return paths


def test_infer_grounding_cli_matches_jax(served, videos, monkeypatch, tmp_path):
    cfg_path, ckpt, _, _ = served
    monkeypatch.setenv("VGQA_GROUND_COALESCE", "1")
    pairs = [a for v, q in zip(videos, ("a square", "a green box")) for a in
             ("--video", v, "--query", q)]
    want = _run(_jax_tool("infer_grounding", monkeypatch).main,
                pairs + ["--config", cfg_path, "--checkpoint", ""], monkeypatch, as_argv=True)
    from vgqa_tpu_torch.tools import infer_grounding

    out = str(tmp_path / "out.json")
    got = _run(infer_grounding.main, pairs + ["--config", cfg_path, "--checkpoint", ckpt,
                                              "--device", "cpu", "--output", out], monkeypatch)
    assert json.loads(open(out).read()) == got and len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_same_response(g, w)


def test_infer_qa_cli_matches_jax(videos, monkeypatch):
    """Both CLIs on one float32 tiny tree (greedy, an id-printing tokenizer):
    equal JSON. The engines are built from the tree directly; the model-dir
    loaders are covered by ``test_torch_checkpoint_export.py``."""
    import jax

    from test_torch_qa_serving import _hf_state_dict
    from vgqa_tpu.inference import qa as jqa
    from vgqa_tpu.qa import engine as jeng_mod
    from vgqa_tpu.qa.llm import LLMConfig as JLLMConfig
    from vgqa_tpu.qa.vit import ViTConfig as JViTConfig
    from vgqa_tpu_torch.inference import qa as tqa
    from vgqa_tpu_torch.qa.convert import convert_internvideo
    from vgqa_tpu_torch.qa.engine import QAEngine
    from vgqa_tpu_torch.qa.llm import LLMConfig
    from vgqa_tpu_torch.qa.vit import ViTConfig
    from vgqa_tpu_torch.tools import infer_qa

    class IdTokenizer(jeng_mod.ByteTokenizer):
        def decode(self, ids):
            return ",".join(str(int(i)) for i in ids)

    sd = {k: v.numpy() for k, v in _hf_state_dict(LLMConfig.tiny(), ViTConfig.tiny(), 4).items()}
    tree = convert_internvideo(sd, LLMConfig.tiny(), ViTConfig.tiny())
    tok = IdTokenizer()
    jeng = jeng_mod.QAEngine(JLLMConfig.tiny(), JViTConfig.tiny(),
                             jax.tree.map(jnp.asarray, tree), tokenizer=tok)
    teng = QAEngine.init_random(LLMConfig.tiny(), ViTConfig.tiny(), device="cpu", tokenizer=tok,
                                use_kernels=False).load_tree(tree)
    monkeypatch.setattr(jqa, "_load_engine", lambda model_dir: jeng)
    monkeypatch.setattr(tqa, "_load_engine", lambda model_dir, device=None: teng)
    argv = ["--video", videos[0], "--question", "what moves?", "--model-dir", "m",
            "--num-frames", "2", "--max-new-tokens", "6", "--temperature", "0"]
    want = _run(_jax_tool("infer_qa", monkeypatch).main, argv, monkeypatch, as_argv=True)
    got = _run(infer_qa.main, argv + ["--device", "cpu"], monkeypatch)
    assert got == want and len(got["answer"].split(",")) == 6
    # repeated pairs: one batched decode, the solo answer in its slot
    two = _run(infer_qa.main, argv + ["--video", videos[1], "--question", "and?",
                                      "--device", "cpu"], monkeypatch)
    assert len(two) == 2 and two[0] == got


_NO_JAX = textwrap.dedent("""
    import importlib.abc, io, json, os, sys, threading, urllib.request
    from contextlib import redirect_stdout

    BLOCKED = {"jax", "jaxlib", "flax", "optax", "yaml", "cv2", "vgqa_tpu"}

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is not installed on the card machine")
            return None

    sys.meta_path.insert(0, Refuse())
    import numpy as np
    from vgqa_tpu_torch.app import server
    from vgqa_tpu_torch.data import video_io
    from vgqa_tpu_torch.data.synthetic import synthetic_frames
    from vgqa_tpu_torch.inference import grounding, qa
    from vgqa_tpu_torch.qa.llm import LLMConfig
    from vgqa_tpu_torch.qa.vit import ViTConfig
    from vgqa_tpu_torch.tools import convert_weights, infer_grounding, infer_qa

    root, tiny, ref_pth, hf_pth = sys.argv[1:5]
    # no decoder: every video is 40 rendered frames of 96x72 at 10 fps
    info = lambda path: (40, 10.0, 96, 72)
    def read_frames(path, ids, *a, size=None, **kw):
        return synthetic_frames(40, size or (96, 72), seed=0)[0][np.asarray(ids)]
    def tiles(path, bound=None, input_size=448, max_num=1, num_segments=32):
        ids = video_io.frame_indices_with_bound(bound, 10.0, 39, num_segments)
        return read_frames(path, ids, size=(input_size, input_size)), [1] * len(ids)
    video_io.video_info = grounding.video_info = info
    grounding.read_frames, grounding.read_frames_yuv = read_frames, lambda *a, **k: None
    qa.load_video_tiles, qa.load_video_tiles_yuv = tiles, lambda *a, **k: None

    video = os.path.join(root, "clip.mp4")
    open(video, "wb").write(b"placeholder")
    server.VIDEOS_ROOT = server.Path(root)
    server.GROUNDING_CONFIG, server.GROUNDING_CKPT = tiny, os.path.join(root, "vidstg.pt")
    server.QA_MODEL_DIR, server.DEVICE = "__tiny__", "cpu"
    LLMConfig.internlm2_5_7b = classmethod(lambda c: c.tiny())
    ViTConfig.internvit_300m = classmethod(lambda c: c.tiny())
    with redirect_stdout(io.StringIO()):
        convert_weights.main(["grounding", "--src", ref_pth, "--dst", server.GROUNDING_CKPT,
                              "--config", tiny])
        convert_weights.main(["qa", "--src", hf_pth, "--dst", os.path.join(root, "qa"),
                              "--quantize", "--wq", "int4", "--device", "cpu"])

    srv = server.make_server(0, "127.0.0.1")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    def call(path, body=None):
        req = urllib.request.Request(base + path, method="POST" if body else "GET",
                                     data=json.dumps(body).encode() if body else None)
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())
    assert call("/api/health") == {"ok": True}
    assert call("/api/videos")["files"] == ["clip.mp4"]
    assert call("/api/meta?video=clip.mp4")["total_frames"] == 40
    pred = call("/api/predict", {"video": "clip.mp4", "query": "a green square"})
    ans = call("/api/qa", {"video": "clip.mp4", "question": "what moves?", "num_frames": 2,
                           "max_tokens": 3})
    srv.shutdown()
    buf = io.StringIO()
    with redirect_stdout(buf):
        infer_grounding.main(["--video", video, "--query", "a green square", "--config", tiny,
                              "--checkpoint", server.GROUNDING_CKPT, "--device", "cpu"])
    cli = json.loads(buf.getvalue())
    assert cli["temporal"] == pred["result"]["temporal"], (cli, pred)
    buf = io.StringIO()
    with redirect_stdout(buf):
        infer_qa.main(["--video", video, "--question", "what moves?", "--model-dir",
                       os.path.join(root, "qa"), "--num-frames", "2", "--max-new-tokens", "3",
                       "--device", "cpu"])
    assert isinstance(json.loads(buf.getvalue())["answer"], str)
    assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    print("SERVED", pred["result"]["temporal"], repr(ans["answer"]))
""")


def test_entry_points_without_jax_yaml_cv2(tmp_path):
    from test_torch_qa_serving import _hf_state_dict

    from vgqa_tpu_torch.qa.llm import LLMConfig
    from vgqa_tpu_torch.qa.vit import ViTConfig

    cfg = build_default_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "grounding_vidstg_tiny.yaml"))
    cfg.TPU.COMPUTE_DTYPE = "float32"
    tiny = str(tmp_path / "tiny.yaml")
    with open(tiny, "w") as f:
        f.write(cfg.dump())
    ref, hf = str(tmp_path / "vidstg.pth"), str(tmp_path / "internvideo.pth")
    torch.save({k: torch.from_numpy(v) for k, v in build_reference_state_dict().items()}, ref)
    torch.save(_hf_state_dict(LLMConfig.tiny(), ViTConfig.tiny(), 5), hf)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, str(tmp_path), tiny, ref, hf],
                          capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SERVED" in proc.stdout
