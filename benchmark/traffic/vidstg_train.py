"""Grounding training over the VidSTG data path, as ``tools/train`` runs it.

Parameters: ``videos`` synthetic VidSTG videos of ``frames_per_video``
frames at ``video_size`` (w, h), written from the seed with their
annotations (two items each); ``schedule_iters``, the ``max_iter`` the
optimizer's schedule is built for (the window trains inside its warm-up);
``warmup_epochs`` epochs of the set trained in set-up before the window;
``trace_steps`` steps of the window profiled when traced, after
``trace_after`` steps; ``check_steps`` steps the reference follows.

Set-up writes the set under ``TMPDIR`` (annotations only: the card has no
video decoder, so the dataset module's ``read_frames`` seam serves the
frames of ``data/synthetic.frame_reader``, rendered in set-up), writes the
seeded weights where ``MODEL.WEIGHT`` names them, builds
``Trainer(cfg).setup()``, and trains ``warmup_epochs`` epochs with
``fit()``; its first ``check_steps`` steps are recorded for the check
(their batches, losses, the optimizer's first moments after step 1, the
parameters and the EMA after the last). The window is one more ``fit()``
over as many further epochs as the warm-up's rate says fill ``--seconds``
(and another for the rest if it falls short), timed to a device
synchronisation after it returns.
"""

from __future__ import annotations

import math
import os
import shutil
import tempfile
import time

import torch

from harness import Check, DeviceTrace, log
from vstg_common import program_cfg, reference_cfg, reference_model, reference_module


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    if hasattr(tree, "__dataclass_fields__"):
        return type(tree)(**{k: _clone(getattr(tree, k)) for k in tree.__dataclass_fields__})
    return tree


def _leaf_norms(tensors):
    return torch.stack(torch._foreach_norm([t.detach().float() for t in tensors])).cpu()


def setup(ctx):
    import vgqa_tpu_torch.data.dataset as dataset_mod
    from vgqa_tpu_torch.data import synthetic
    from vgqa_tpu_torch.training.trainer import Trainer

    p = ctx.params
    t_setup = time.time()
    root = tempfile.mkdtemp(prefix="vgqa_bench_train_")
    data = os.path.join(root, "vidstg")
    size = tuple(p["video_size"])
    synthetic.make_synthetic_dataset(data, num_videos=p["videos"],
                                     frames_per_video=p["frames_per_video"], size=size,
                                     splits=("train",), seed=ctx.seed, write_videos=False)
    reader = synthetic.frame_reader(p["frames_per_video"], size, ctx.seed)
    for i in range(p["videos"]):
        reader(os.path.join(data, "videos", f"train_vid{i:03d}.mp4"), [0])
    dataset_mod.read_frames = reader

    ref, weights = reference_model(ctx.cfg_values, ctx.seed, ctx.device)
    del ref
    weight_path = os.path.join(root, "weights.pt")
    torch.save(weights, weight_path)
    items = 2 * p["videos"]
    cfg = program_cfg(ctx.cfg_values, DATA_DIR=data, OUTPUT_DIR="", TENSORBOARD_DIR="",
                      **{"MODEL.WEIGHT": weight_path,
                         "SOLVER.MAX_EPOCH": p["warmup_epochs"]})
    trainer = Trainer(cfg, ctx.device, seed=ctx.seed)
    trainer.setup(max_iter=p["schedule_iters"])
    os.remove(weight_path)

    record = {"batches": [], "loss": [], "m1": None, "params": None, "ema": None}
    state = {"root": root, "trainer": trainer, "cfg": cfg, "weights": weights,
             "record": record, "items": items, "steps": 0, "times": []}
    inner = trainer.step_fn
    opt = trainer.state.optimizer
    names = [n for n, _ in opt.trainable()]
    state["trainable"] = names

    def step_fn(st, video, text, targets, seed):
        k = state["steps"]
        state["times"].append(time.perf_counter())
        if k < p["check_steps"]:
            record["batches"].append(_clone((video, text, targets)))
        hook = state.get("hook")
        if hook is not None:
            hook(k)
        with torch.profiler.record_function("train.step"):
            metrics = inner(st, video, text, targets, seed)
        state["steps"] = k + 1
        if k < p["check_steps"]:
            record["loss"].append(metrics["loss"].detach().clone())
            if k == 0:
                record["m1"] = _leaf_norms([opt.m[n] for n in names])
            if k == p["check_steps"] - 1:
                record["params"] = _leaf_norms(
                    [dict(st.model.named_parameters())[n] - weights[n] for n in names])
                if st.ema is not None:
                    record["ema"] = _leaf_norms([st.ema[n] - weights[n] for n in names])
        return metrics

    trainer.step_fn = step_fn
    ctx.plant(state)
    trainer.fit()
    _sync(ctx)
    # the rate of the warm-up's second half (its first steps run slower)
    times = state["times"]
    half = len(times) // 2
    state["rate"] = (len(times) - 1 - half) / max(times[-1] - times[half], 1e-6)
    log(f"set-up: {len(times)} warm-up steps, {state['rate']:.3f} steps/s over the last "
        f"{len(times) - half}, {time.time() - t_setup:.1f} s of set-up in the driver")
    return state


def _sync(ctx):
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()


def window(ctx, state):
    """``fit()`` over as many more epochs as the warm-up's rate says fill
    ``--seconds``, and again for the rest if the window falls short."""
    p = ctx.params
    trainer, cfg = state["trainer"], state["cfg"]
    done = state["steps"]
    traced = {}
    if ctx.trace:
        first = done + p["trace_after"]
        last = first + p["trace_steps"]

        def hook(k):
            if k == first:
                traced["log0"] = len(trainer.step_log)
                traced["cm"] = DeviceTrace().__enter__()
            elif k == last:
                cm = traced.pop("cm")
                cm.__exit__(None, None, None)
                traced["data"] = cm.data
                traced["log1"] = len(trainer.step_log)

        state["hook"] = hook
    t0 = time.perf_counter()
    fits = 0
    while fits == 0 or time.perf_counter() - t0 < ctx.seconds:
        left = ctx.seconds - (time.perf_counter() - t0)
        want = max(1, math.ceil(state["rate"] * left * 1.05))
        cfg.defrost()
        cfg.SOLVER.MAX_EPOCH = math.ceil((state["steps"] + want) / state["items"])
        cfg.freeze()
        trainer.fit()
        _sync(ctx)
        fits += 1
    span = time.perf_counter() - t0
    state.pop("hook", None)
    steps = state["steps"] - done
    log(f"window: {steps} steps in {span:.3f} s, {fits} fit call(s)")
    out = {"metrics": {"train_clips_per_s": steps / span}, "attempted": steps, "failed": 0}
    if ctx.trace:
        tr = traced["data"]
        rows = trainer.step_log[traced["log0"]:traced["log1"]]
        tr.counters["steps"] = len(rows)
        tr.counters["loader_wait_s"] = sum(r[1] for r in rows)
        tr.counters["batch"] = state["record"]["batches"][0]
        out["trace"] = tr
    return out


def release(ctx, state):
    state.pop("trainer", None)
    shutil.rmtree(state["root"], ignore_errors=True)


def _follow(ctx, state, control: bool):
    """The reference's first ``check_steps`` steps from the seeded weights
    over the recorded batches and seeds: (losses, first-gradient leaf norms,
    parameter-change leaf norms, EMA-change leaf norms or None, leaf mask of
    the reference's non-negligible gradients). ``control``: TF32 products."""
    from reference.precision import float32, tf32
    from reference.vstg.containers import normalize_uint8_video
    from reference.vstg.dropout import DropoutRng
    from reference.vstg.loss import build_loss, build_weight_dict
    from reference.vstg.optimizer import ADAM_B1, GroupedAdamW, update_ema

    p = ctx.params
    rec = state["record"]
    values = ctx.cfg_values
    ns = reference_cfg(values)
    model = reference_module(values)
    p0 = state["weights"]
    model.load_state_dict({n: t.clone() for n, t in p0.items()}, assign=True)
    model.train()
    opt = GroupedAdamW(ns, model, p["schedule_iters"])
    ema = ({n: t.detach().clone() for n, t in model.named_parameters()}
           if values["MODEL.EMA"] else None)
    loss_fn, wd = build_loss(ns), build_weight_dict(ns)
    stats = (tuple(values["INPUT.PIXEL_MEAN"]), tuple(values["INPUT.PIXEL_STD"]))
    names = state["trainable"]
    losses, m1 = [], None
    with tf32() if control else float32():
        for k in range(len(rec["batches"])):
            video, text, targets = rec["batches"][k]
            video = normalize_uint8_video(video, stats, dtype=torch.float32)
            rng = DropoutRng((int(ctx.seed) * 1_000_003 + k) % (1 << 62), video.frames.device)
            for prm in model.parameters():
                prm.grad = None

            out = model(video, text, train=True, rng=rng)
            ls = loss_fn(out, targets)
            total = sum(ls[n] * wd[n] for n in ls if n in wd)
            total.backward()
            del out, ls
            opt.step(k)
            if ema is not None:
                update_ema(dict(model.named_parameters()), ema, values["MODEL.EMA_DECAY"])
            losses.append(float(total.detach()))
            if k == 0:
                m1 = _leaf_norms([opt.m[n] / (1.0 - ADAM_B1) for n in names])
    named = dict(model.named_parameters())
    params = _leaf_norms([named[n] - p0[n] for n in names])
    ema_n = _leaf_norms([ema[n] - p0[n] for n in names]) if ema is not None else None
    del model, opt, ema, named
    return losses, m1, params, ema_n


def check(ctx, state, control: bool = False):
    """The reference follows the first ``check_steps`` steps from the same
    weights, batches and seeds. Compared, over the leaves whose reference
    gradient is above a thousandth of the median leaf's (the rest, such as
    biases under a softmax, move by round-off alone): the first step's
    relative loss gap; the worst leaf's gap of the first gradient's norm as
    the optimizer got it (from its first moments after step 1); and the
    median leaf's gap of the parameters' change and of the EMA's change
    after the last checked step. Each leaf's gap is over the larger of that
    leaf's and the median leaf's reference norm. The later steps' loss gaps
    and the worst leaf's change gaps are logged beside them: AdamW's first
    update moves every element by the learning rate times the sign of its
    gradient, so elements whose gradient is near zero move by the sign of
    their round-off, and those numbers swing from seed to seed. With
    ``control`` the steps judged are the reference's own with TF32 products
    instead of the program's."""
    from reference.vstg.optimizer import ADAM_B1

    rec = state["record"]
    losses, m1, params, ema_ref = _follow(ctx, state, False)
    if control:
        got_loss, got_m1, got_params, got_ema = _follow(ctx, state, True)
    else:
        got_loss = [float(x) for x in rec["loss"]]
        got_m1 = rec["m1"] / (1.0 - ADAM_B1)
        got_params, got_ema = rec["params"], rec["ema"]
    keep = m1 > 1e-3 * m1.median()

    def leaf_gaps(got, ref):
        if got is None or ref is None:
            return torch.tensor([float("inf")])
        got, ref = got[keep], ref[keep]
        return (got - ref).abs() / torch.clamp(ref, min=float(ref.median()))

    if not losses or len(got_loss) != len(losses):
        loss_gaps = [float("inf")]
    else:
        loss_gaps = [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(got_loss, losses)]
    param, ema = leaf_gaps(got_params, params), leaf_gaps(got_ema, ema_ref)
    log(f"check{' (control)' if control else ''}: losses {got_loss} reference {losses}; "
        f"loss gaps {loss_gaps}; worst leaf's parameter change gap {float(param.max()):.3g}, "
        f"EMA change gap {float(ema.max()):.3g}; {int(keep.sum())} of {len(keep)} leaves")
    lim = ctx.workload["limits"]
    return [Check("loss1_gap", loss_gaps[0], lim["loss1_gap"]),
            Check("grad_gap", float(leaf_gaps(got_m1, m1).max()), lim["grad_gap"]),
            Check("param_gap", float(param.median()), lim["param_gap"]),
            Check("ema_gap", float(ema.median()), lim["ema_gap"])]
