"""Data-parallel training of the port (2 gloo processes on the CPU) against
the JAX package's ``dp = 2`` mesh, and the train tool under torchrun.

- **One step at dp = 2.** One random tiny tree (``random_params``) goes into
  both packages (``state_dict_from_jax``). JAX takes the loss and the
  gradients of a V = 2 batch sharded over a ``dp = 2`` mesh of the
  conftest's virtual CPU devices; the port runs 2 processes
  (``tests/torch_ddp_worker.py step``), each on its video (V = 1), whose
  gradients ``average_gradients`` averages before the clip. Every dropout
  is off on both sides. Two batches: clips with different valid-frame
  counts (6 and 5 of 6), and one where rank 1 has no box and the group has
  one (N_global = 1 < W = 2, where the reference's ``max(N / W, 1)`` would
  halve the box terms). Compared, float32: each loss term and the total as
  the ranks' mean, 1e-5 relative (1e-7 absolute near 0); the averaged
  gradient of every trainable leaf, within 1e-4 of the leaf's max |g|, and
  of 1e-3 where that is smaller (leaves whose gradient is zero in exact
  arithmetic, such as the key biases of a softmax, hold f32 rounding noise
  of ~5e-9), bit-equal on both ranks; the global norm before the clip and
  after it, 1e-4 relative.
- **Ranks stay bit-equal**: 2 steps with every dropout on; the two ranks
  draw different masks, and their parameters, moments and EMA are
  bit-equal and have moved.
- **``python -m torch.distributed.run --nproc_per_node 2``** runs the train
  tool's ``main`` (through the worker, which only replaces the decoder by
  the renderer's frames) with ``--device cpu`` on the tiny config over
  ``make_synthetic_dataset``: ``max_iter`` = ceil(items / 2), one
  ``log.txt`` and one write of ``model_final``, a second launch with a
  second epoch resumes from ``last_checkpoint`` on both ranks, the ranks'
  parameters bit-equal, and the merged test metrics equal on both ranks
  and equal (1e-6: the ranks run one thread each, this process more) to one
  process's ``test`` of every item from the same checkpoint.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from test_torch_modules import random_params
from test_torch_parallel import TIMEOUT, collect, free_port, launch
from test_torch_train_step import _batch, _cfgs, _losses, _port_name
from vgqa_tpu.models import GroundingConfig as JConfig
from vgqa_tpu.models import VSTGNet as JNet
from vgqa_tpu.models.loss import build_weight_dict as jweights
from vgqa_tpu.parallel import build_mesh as jbuild_mesh
from vgqa_tpu.training import make_optimizer
from vgqa_tpu.utils.containers import TextBatch as JText
from vgqa_tpu.utils.containers import VideoBatch as JVideo
from vgqa_tpu.utils.containers import normalize_uint8_video as jnormalize
from vgqa_tpu_torch.data import dataset as tdataset
from vgqa_tpu_torch.data import synthetic as tsynthetic
from vgqa_tpu_torch.models import GroundingConfig as TConfig
from vgqa_tpu_torch.models import VSTGNet as TNet
from vgqa_tpu_torch.models.convert_jax import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_ddp_worker.py")
TINY = os.path.join(REPO, "configs", "grounding_vidstg_tiny.yaml")
MAX_ITER = 100
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-7
GRAD_ATOL = 1e-4                 # of the leaf's max |g|, at least 1e-3 (see the docstring)
NORM_RTOL = 1e-4
METRIC_ATOL = 1e-6
FRAMES, SIZE, VIDEOS = 24, (96, 64), 2


def _cases():
    """name -> (frames, pixel_mask, time_mask, ids, text_mask, targets), V = 2."""
    frames_case = _batch()          # valid frames 6 and 5; boxes on both videos
    f, pm, tm, ids, tmask, targets = _batch()
    tm = tm.copy()
    tm[1, 3:] = False
    act = np.zeros_like(targets["actioness"])
    act[0, 2] = 1                   # one box in the group, on rank 0
    empty = (f, pm, tm, ids, tmask, {**targets, "actioness": act, "time_mask": tm,
                                     "sted": np.array([[2, 2], [0, 1]], np.int32)})
    return {"frames": frames_case, "one_empty": empty}


def _save_npz(path, b):
    frames, pm, tm, ids, tmask, targets = b
    np.savez(path, frames=frames, pixel_mask=pm, time_mask=tm, ids=ids, text_mask=tmask,
             **{f"t_{k}": v for k, v in targets.items()})


def _jax_grads():
    """The jitted loss and gradients of the tiny model, every dropout off
    (one compile for both batches)."""
    jcfg, _ = _cfgs()
    stats = (tuple(jcfg.INPUT.PIXEL_MEAN), tuple(jcfg.INPUT.PIXEL_STD))
    net = JNet(dataclasses.replace(JConfig.tiny_test(), dropout=0.0,
                                   use_pallas_attention=False))
    loss_fn, _ = _losses()
    wd = jweights(jcfg)

    def loss_of(p, video, text, tg):
        out = net.apply(p, jnormalize(video, stats), text, train=True,
                        rngs={"dropout": jax.random.PRNGKey(0)})
        losses = loss_fn(out, tg)
        return sum(losses[k] * wd[k] for k in losses if k in wd), losses

    return jax.jit(jax.value_and_grad(loss_of, has_aux=True))


def _sharded(mesh, params, b):
    """The step's arguments: the V = 2 batch split over ``dp``, the
    parameters replicated."""
    frames, pm, tm, ids, tmask, targets = b
    dp = NamedSharding(mesh, P("dp"))
    put = lambda x: jax.device_put(jnp.asarray(x), dp)  # noqa: E731
    return (jax.device_put(params, NamedSharding(mesh, P())),
            JVideo(put(frames), put(pm), put(tm)), JText(put(ids), put(tmask)),
            {k: put(v) for k, v in targets.items()})


def _jax_steps(params, cases, mesh, labels, max_norm):
    """name -> (losses, gradients, the trainable global norm before and after
    optax's clip) of each V = 2 batch sharded over ``dp``. One compile for
    both batches, at XLA's lowest backend optimisation level (the test
    compares results, not speed)."""
    grad_fn = _jax_grads()
    with mesh:
        compiled = grad_fn.lower(*_sharded(mesh, params, cases["frames"])).compile(
            {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})
        outs = {name: compiled(*_sharded(mesh, params, b)) for name, b in cases.items()}
    want = {}
    for name, ((total, losses), grads) in outs.items():
        grads = jax.tree_util.tree_map(np.asarray, grads)
        trainable = [g for g, lab in zip(jax.tree_util.tree_leaves(grads),
                                         jax.tree_util.tree_leaves(labels)) if lab != "frozen"]
        norm = float(np.sqrt(sum(np.sum(np.square(g, dtype=np.float64)) for g in trainable)))
        flat = jnp.asarray(np.concatenate([g.ravel() for g in trainable]))
        clipped, _ = optax.clip_by_global_norm(max_norm).update({"g": flat}, None)
        want[name] = ({"total": float(total), **{k: float(v) for k, v in losses.items()}},
                      state_dict_from_jax(grads), norm,
                      float(np.linalg.norm(np.asarray(clipped["g"], np.float64))))
    return want


@pytest.fixture(scope="module")
def dp_step(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp_step")
    b0 = _batch()
    video = JVideo(jnp.asarray(b0[0]).astype(jnp.float32), jnp.asarray(b0[1]),
                   jnp.asarray(b0[2]))
    params = random_params(JNet(JConfig.tiny_test()), video, JText(jnp.asarray(b0[3]),
                                                                  jnp.asarray(b0[4])), seed=5)
    tnet = TNet(dataclasses.replace(TConfig.tiny_test(), dropout=0.0))
    weights = str(tmp / "tiny.pt")
    torch.save(state_dict_from_jax(params, tnet), weights)
    cases = _cases()
    paths = {}
    for name, b in cases.items():
        paths[name] = str(tmp / f"{name}.npz")
        _save_npz(paths[name], b)
    # the ranks run while JAX computes the same steps here
    procs, prefix = launch("step", {"weights": weights, "cases": paths}, tmp)
    try:
        jcfg, _ = _cfgs()
        _, labels = make_optimizer(jcfg, params, MAX_ITER)
        mesh = jbuild_mesh(dp=2, devices=jax.devices()[:2])
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(flax.linen.Dropout, "__call__",
                       lambda self, x, deterministic=None, rng=None: x)
            want = _jax_steps(params, cases, mesh, labels, jcfg.SOLVER.MAX_GRAD_NORM)
    finally:
        ranks = collect(procs, prefix)
    label_by_name = {_port_name(p): lab for p, lab in
                     jax.tree_util.tree_flatten_with_path(labels)[0]}
    return {"ranks": ranks, "want": want, "prefix": prefix, "labels": label_by_name,
            "cases": cases}


@pytest.mark.parametrize("case", ["frames", "one_empty"])
def test_dp2_losses_match_jax_mesh(dp_step, case):
    targets = dp_step["cases"][case][5]
    n_boxes = float((targets["actioness"] * targets["time_mask"]).sum())
    assert n_boxes == (1.0 if case == "one_empty" else 6.0)
    want = dp_step["want"][case][0]
    ranks = [r["cases"][case] for r in dp_step["ranks"]]
    assert set(ranks[0]["losses"]) | {"total"} == set(want)
    for k, v in want.items():
        got = np.mean([r["total"] if k == "total" else r["losses"][k] for r in ranks])
        np.testing.assert_allclose(got, v, rtol=LOSS_RTOL, atol=LOSS_ATOL, err_msg=k)


@pytest.mark.parametrize("case", ["frames", "one_empty"])
def test_dp2_averaged_gradients_match_jax_mesh(dp_step, case):
    ranks = [r["cases"][case] for r in dp_step["ranks"]]
    assert ranks[0]["grad_digest"] == ranks[1]["grad_digest"]
    got = torch.load(f"{dp_step['prefix']}.{case}.rank0.pt", weights_only=True)
    want = dp_step["want"][case][1]
    labels = dp_step["labels"]
    assert set(got) == {n for n, lab in labels.items() if lab != "frozen"}
    assert len(got) > 100
    for name, g in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL * max(np.abs(w).max(), 1e-3),
                                   err_msg=name)


@pytest.mark.parametrize("case", ["frames", "one_empty"])
def test_dp2_clip_norm_matches_jax_mesh(dp_step, case):
    _, _, norm, clipped = dp_step["want"][case]
    for r in dp_step["ranks"]:
        got = r["cases"][case]
        assert got["norm"] == pytest.approx(norm, rel=NORM_RTOL)
        assert got["clipped_norm"] == pytest.approx(clipped, rel=NORM_RTOL)
    a, b = (r["cases"][case]["params_digest"] for r in dp_step["ranks"])
    assert a == b


def test_ranks_bit_equal_with_dropout(dp_step):
    r0, r1 = (r["dropout"] for r in dp_step["ranks"])
    assert r0["first_mask"] != r1["first_mask"]
    assert r0["after"] == r1["after"] != r0["before"] == r1["before"]
    assert r0["moments"] == r1["moments"] and r0["ema"] == r1["ema"]
    assert r0["losses"] != r1["losses"] and all(np.isfinite(r0["losses"] + r1["losses"]))


# ---- the train tool under torchrun ----------------------------------------------

def _torchrun(tmp, name, argv):
    job_path, prefix = str(tmp / f"{name}.json"), str(tmp / name)
    job = {"argv": argv, "frames": FRAMES, "size": list(SIZE)}
    with open(job_path, "w") as f:
        json.dump(job, f)
    env = {k: v for k, v in os.environ.items() if not k.startswith("VGQA_")}
    env["PYTHONPATH"] = REPO
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc_per_node",
           "2", "--master_addr", "localhost", "--master_port", str(free_port()), WORKER,
           "train", job_path, prefix]
    proc = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-4000:]
    ranks = []
    for r in range(2):
        with open(f"{prefix}.rank{r}.json") as f:
            ranks.append(json.load(f))
    return ranks, proc.stdout + proc.stderr


@pytest.fixture(scope="module")
def torchrun(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp_train")
    data, out = str(tmp / "data"), str(tmp / "out")
    tsynthetic.make_synthetic_dataset(data, num_videos=VIDEOS, frames_per_video=FRAMES,
                                      size=SIZE, write_videos=False)
    argv = ["--device", "cpu", "--config-file", TINY, "DATA_DIR", data, "OUTPUT_DIR", out]
    first = _torchrun(tmp, "first", argv)
    files = sorted(os.listdir(out))
    # one process's test of every item, from the first launch's checkpoint
    from vgqa_tpu_torch.config import build_default_cfg
    from vgqa_tpu_torch.training.trainer import Trainer

    cfg = build_default_cfg()
    cfg.merge_from_file(TINY)
    cfg.merge_from_list(["DATA_DIR", data, "OUTPUT_DIR", out])
    cfg.freeze()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdataset, "read_frames", tsynthetic.frame_reader(FRAMES, SIZE))
        single = Trainer(cfg, device="cpu")
        single.setup()
        single_step = single.state.step
        single_metrics = single.test()
    second = _torchrun(tmp, "second", argv + ["SOLVER.MAX_EPOCH", "2"])
    from vgqa_tpu_torch.data.dataset import build_dataset

    n_items = len(build_dataset(cfg, "train"))
    return {"first": first, "second": second, "files": files, "out": out, "n_items": n_items,
            "single": single_metrics, "single_step": single_step}


def test_torchrun_max_iter(torchrun):
    ranks, _ = torchrun["first"]
    want = math.ceil(torchrun["n_items"] / 2)
    assert torchrun["n_items"] == 2 * VIDEOS
    for r in ranks:
        assert (r["code"], r["world"], r["dp"]) == (0, 2, 2)
        assert r["max_iter"] == r["final_step"] == want
        assert r["resumed_at"] == 0
    assert [r["rank"] for r in ranks] == [0, 1]


def test_torchrun_writes_once(torchrun):
    ranks, logs = torchrun["first"]
    assert torchrun["files"] == ["config.yml", "last_checkpoint", "log.txt", "model_final",
                                 "model_final_params"]
    with open(os.path.join(torchrun["out"], "log.txt")) as f:
        log = f.read()
    # rank 0's lines only; the second launch appended its own
    assert log.count("Mesh: dp=2, sp=1, tp=1") == 2
    assert logs.count("Mesh: dp=2, sp=1, tp=1") == 1
    assert ranks[0]["saved"] == ["model_final.tmp", "model_final_params.tmp"]
    assert ranks[1]["saved"] == []
    assert ranks[0]["params_digest"] == ranks[1]["params_digest"]
    assert ranks[0]["ema_digest"] == ranks[1]["ema_digest"]


def test_torchrun_resumes_on_every_rank(torchrun):
    first, _ = torchrun["first"]
    second, _ = torchrun["second"]
    for r in second:
        assert r["resumed_at"] == first[0]["final_step"]
        assert r["max_iter"] == r["final_step"] == 2 * first[0]["max_iter"]
    assert second[0]["params_digest"] == second[1]["params_digest"]
    assert second[0]["params_digest"] != first[0]["params_digest"]
    assert torchrun["single_step"] == first[0]["final_step"]


def test_torchrun_metrics_merged(torchrun):
    ranks, _ = torchrun["first"]
    m0, m1 = (r["metrics"] for r in ranks)
    assert m0 == m1
    single = torchrun["single"]
    assert sorted(m0) == sorted(single) and len(single) == 18
    for k, v in single.items():
        assert m0[k] == pytest.approx(v, abs=METRIC_ATOL), k
