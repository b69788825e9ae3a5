"""One rank of the port's data-parallel CPU tests (gloo), started by
``tests/test_torch_parallel.py`` and ``tests/test_torch_ddp.py``:

    python tests/torch_ddp_worker.py JOB JOB_JSON OUT_PREFIX          (VGQA_* contract)
    python -m torch.distributed.run --nproc_per_node 2 tests/torch_ddp_worker.py train ...

It imports torch and the port only (no jax, no vgqa_tpu), joins the group
with ``parallel.initialize_multihost(device="cpu")`` and writes its results
to ``OUT_PREFIX.rank<R>.json`` (and ``.pt`` for tensors). Jobs:

- ``parallel``: the collectives and helpers of ``parallel/`` in a real
  group (object gather at 1,000 and 50,000 bytes, barrier, mesh, gradient
  average, metric mean, the loss's global normalisers);
- ``step``: one train step of the tiny model per case, each rank on its
  video of a V = 2 batch, dropout off (the losses, the averaged gradients,
  the norm before and after the clip), then 2 steps with dropout on (the
  first dropout mask drawn and a digest of the parameters);
- ``train``: ``vgqa_tpu_torch.tools.train.main`` over a synthetic VidSTG set
  whose frames come from the renderer (no decoder), recording what each
  rank's trainer saw;
- ``card``: two ranks on card 0, gloo or NCCL (see :func:`job_card`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vgqa_tpu_torch.parallel import distributed  # noqa: E402

MAX_ITER = 100          # the schedule length of the step job (as test_torch_train_step)
LOSSES = ["boxes", "sted", "logits_f_m", "logits_f_a", "logits_r_a", "logits_r_m", "actioness"]


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _write(prefix: str, result) -> None:
    path = f"{prefix}.rank{result['rank']}.json"
    with open(f"{path}.tmp", "w") as f:
        json.dump(result, f)
    os.replace(f"{path}.tmp", path)


# ---- parallel ---------------------------------------------------------------

def job_parallel(job, prefix):
    from vgqa_tpu_torch.models.loss import VideoSTGLoss
    from vgqa_tpu_torch.parallel import build_mesh

    rank, world = distributed.get_rank(), distributed.get_world_size()
    out = {"rank": rank, "world": world, "main": distributed.is_main_process()}
    payload = {"rank": rank, "blob": "x" * job["sizes"][rank], "kf": (0.5, rank),
               "keys": {rank: [rank, rank + 1]}}
    gathered = distributed.all_gather_objects(payload)
    out["gather_ranks"] = [g["rank"] for g in gathered]
    out["gather_sizes"] = [len(g["blob"]) for g in gathered]
    out["gather_kf"] = [g["kf"] for g in gathered]
    out["gather_keys"] = [g["keys"] for g in gathered]

    if rank == 1:
        time.sleep(job["barrier_delay"])
    t0 = time.perf_counter()
    distributed.synchronize()
    out["barrier_wait_s"] = time.perf_counter() - t0

    mesh = build_mesh(0, 1, 1)
    out["mesh"] = [mesh.dp, mesh.sp, mesh.tp]
    try:
        build_mesh(world + 1)
    except ValueError as e:
        out["mesh_mismatch"] = str(e)

    a = torch.nn.Parameter(torch.zeros(3))
    a.grad = torch.full((3,), float(rank + 1))
    b = torch.nn.Parameter(torch.zeros(2, 2))            # no gradient on rank 0
    if rank == 1:
        b.grad = torch.full((2, 2), 4.0)
    c = torch.nn.Parameter(torch.zeros(5))
    c.grad = torch.arange(5.0) * (rank + 1)
    distributed.BUCKET_NUMEL = 6                      # three buckets: [a], [b], [c]
    sent = distributed.average_gradients([a, b, c])
    out["grads"] = [a.grad.tolist(), b.grad.tolist(), c.grad.tolist()]
    out["grad_bytes"] = sent
    out["mean"] = distributed.reduce_mean({"loss": torch.tensor(float(rank + 1)),
                                           "zero": torch.tensor(0.0)})

    # the loss's normalisers: rank 0 holds both boxes of the group, rank 1 none
    rng = np.random.RandomState(3)
    V, T = 1, 6
    outputs = {"pred_boxes": torch.from_numpy(rng.rand(V, T, 4).astype(np.float32) * 0.5 + 0.2),
               "pred_sted": torch.from_numpy(rng.randn(V, T, 2).astype(np.float32)),
               "logits_f_m": torch.from_numpy(rng.randn(V, T).astype(np.float32)),
               "logits_f_a": torch.from_numpy(rng.randn(V, T).astype(np.float32))}
    act = torch.zeros(V, T)
    if rank == 0:
        act[0, 2:4] = 1
    tm = torch.ones(V, T, dtype=torch.bool)
    tm[0, 4 + rank:] = False
    targets = {"boxes": torch.full((V, T, 4), 0.3), "actioness": act, "time_mask": tm,
               "sted": torch.tensor([[2, 3]])}
    loss = VideoSTGLoss(losses=["boxes", "sted", "logits_f_m"], use_aux_loss=False)
    out["loss"] = {k: float(v) for k, v in loss(outputs, targets).items()}
    _write(prefix, out)


# ---- step -------------------------------------------------------------------

def _tiny(dropout: float):
    from vgqa_tpu_torch.config import build_default_cfg
    from vgqa_tpu_torch.models import GroundingConfig, VSTGNet

    cfg = build_default_cfg()
    cfg.MODEL.VSTG.DROPOUT = dropout
    cfg.MODEL.VSTG.DEC_LAYERS = 2
    net = VSTGNet(dataclasses.replace(GroundingConfig.tiny_test(), dropout=dropout,
                                      use_pallas_attention=False))
    return cfg, net


def _rank_batch(batch, rank):
    from vgqa_tpu_torch.utils.containers import TextBatch, VideoBatch

    r = slice(rank, rank + 1)
    t = {k: torch.from_numpy(v[r]) for k, v in batch.items() if k.startswith("t_")}
    targets = {k[2:]: v for k, v in t.items()}
    targets["sted"] = targets["sted"].long()
    return (VideoBatch(torch.from_numpy(batch["frames"][r]), torch.from_numpy(batch["pixel_mask"][r]),
                       torch.from_numpy(batch["time_mask"][r])),
            TextBatch(torch.from_numpy(batch["ids"][r]).long(), torch.from_numpy(batch["text_mask"][r])),
            targets)


def _train_state(cfg, net, weights):
    from vgqa_tpu_torch.models.loss import VideoSTGLoss, build_weight_dict
    from vgqa_tpu_torch.training.optimizer import GroupedAdamW
    from vgqa_tpu_torch.training.train_step import create_train_state, make_train_step

    net.load_state_dict(torch.load(weights, weights_only=True))
    state = create_train_state(net, GroupedAdamW(cfg, net, MAX_ITER), use_ema=True)
    loss = VideoSTGLoss(sigma=2.0, eos_coef=0.1, losses=LOSSES)
    step = make_train_step(loss, build_weight_dict(cfg), cfg.MODEL.EMA_DECAY,
                           pixel_stats=(cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD))
    return state, step


def job_step(job, prefix):
    from vgqa_tpu_torch.ops.dropout import DropoutRng

    rank = distributed.get_rank()
    out = {"rank": rank, "cases": {}}
    real_dropout = DropoutRng.dropout
    DropoutRng.dropout = lambda self, x, rate: x       # every dropout off
    for name, batch_path in job["cases"].items():
        batch = dict(np.load(batch_path))
        cfg, net = _tiny(0.0)
        state, step = _train_state(cfg, net, job["weights"])
        video, text, targets = _rank_batch(batch, rank)
        total, losses = step.loss_and_grads(state, video, text, targets, seed=0)
        trainable = [(n, p) for n, p in net.named_parameters() if p.requires_grad]
        grads = {n: p.grad.detach().clone() for n, p in trainable}
        norm = state.optimizer.step(0)
        clipped = torch.linalg.vector_norm(torch.stack([p.grad.norm() for _, p in trainable]))
        torch.save(grads, f"{prefix}.{name}.rank{rank}.pt")
        out["cases"][name] = {"total": float(total),
                              "losses": {k: float(v) for k, v in losses.items()},
                              "norm": float(norm), "clipped_norm": float(clipped),
                              "grad_digest": digest(grads.values()),
                              "params_digest": digest(net.parameters())}
    DropoutRng.dropout = real_dropout

    # two steps with every dropout on: the masks differ between the ranks,
    # the parameters do not
    masks = []

    def recording(self, x, rate):
        y = real_dropout(self, x, rate)
        if rate > 0 and len(masks) < 1:
            masks.append(digest([y != 0]))
        return y

    DropoutRng.dropout = recording
    batch = dict(np.load(next(iter(job["cases"].values()))))
    cfg, net = _tiny(0.1)
    state, step = _train_state(cfg, net, job["weights"])
    before = digest(net.parameters())
    video, text, targets = _rank_batch(batch, rank)
    metrics = [step(state, video, text, targets, seed=0) for _ in range(2)]
    DropoutRng.dropout = real_dropout
    out["dropout"] = {"first_mask": masks[0], "before": before,
                      "after": digest(net.parameters()),
                      "moments": digest(list(state.optimizer.m.values())
                                        + list(state.optimizer.v.values())),
                      "ema": digest(state.ema.values()),
                      "losses": [float(m["loss"]) for m in metrics]}
    _write(prefix, out)


# ---- train ------------------------------------------------------------------

def job_train(job, prefix):
    from vgqa_tpu_torch.data import dataset, synthetic
    from vgqa_tpu_torch.tools import train as train_tool
    from vgqa_tpu_torch.training.trainer import Trainer

    dataset.read_frames = synthetic.frame_reader(job["frames"], tuple(job["size"]))
    seen = {}
    real_setup, real_test = Trainer.setup, Trainer.test

    def setup(self, *a, **kw):
        real_setup(self, *a, **kw)
        seen.update(rank=distributed.get_rank(), world=distributed.get_world_size(),
                    max_iter=self.max_iter, resumed_at=self.state.step, dp=self.mesh.dp)
        seen["trainer"] = self

    def test(self):
        seen["metrics"] = real_test(self)
        return seen["metrics"]

    saved, real_save = [], torch.save

    def save(obj, f, *a, **kw):
        saved.append(os.path.basename(str(f)))
        return real_save(obj, f, *a, **kw)

    Trainer.setup, Trainer.test, torch.save = setup, test, save
    code = train_tool.main(job["argv"])
    trainer = seen.pop("trainer")
    _write(prefix, {"code": code, **seen, "saved": saved, "final_step": trainer.state.step,
                    "params_digest": digest(trainer.state.model.parameters()),
                    "ema_digest": digest(trainer.state.ema.values())})


# ---- card -------------------------------------------------------------------

def job_card(job, prefix):
    """Two ranks on card 0 (``tests/test_torch_kernels_cuda.py``): over gloo
    the tiny config takes 2 steps with K3 on (the tiny Swin's widths are not
    K1's: its plain route), each rank on its own synthetic video; over NCCL
    the group refuses to form."""
    from vgqa_tpu_torch.config import build_default_cfg
    from vgqa_tpu_torch.data.synthetic_batch import synthetic_batch
    from vgqa_tpu_torch.ops.kernels.flash_train import flash_mha_train
    from vgqa_tpu_torch.training.trainer import Trainer

    rank = int(os.environ["VGQA_PROCESS_ID"])
    try:
        distributed.initialize_multihost(backend=job["backend"], device=job["device"])
    except RuntimeError as e:
        _write(prefix, {"rank": rank, "error": str(e)})
        return
    cfg = build_default_cfg()
    cfg.merge_from_file(job["config"])
    cfg.OUTPUT_DIR = ""
    cfg.freeze()
    trainer = Trainer(cfg, device=job["device"], seed=0)
    trainer.setup(max_iter=10)
    trainer.state.model.vid.use_kernels = False
    before = digest(trainer.state.model.parameters())
    logged = trainer.fit([synthetic_batch(cfg, seed=rank)], steps=2)
    _write(prefix, {"rank": rank, "before": before,
                    "after": digest(trainer.state.model.parameters()),
                    "losses": [x["loss"] for x in logged],
                    "k3": [flash_mha_train.fwd_launches, flash_mha_train.bwd_launches]})


JOBS = {"parallel": job_parallel, "step": job_step, "train": job_train, "card": job_card}


def main(argv) -> int:
    name, job_path, prefix = argv[:3]
    with open(job_path) as f:
        job = json.load(f)
    if name in ("parallel", "step"):      # train: tools.train joins; card: the job does
        distributed.initialize_multihost(device="cpu")
    JOBS[name](job, prefix)
    distributed.destroy()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
