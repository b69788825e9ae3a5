"""The port's ``parallel/`` package (``torch.distributed``, gloo on the CPU)
against the JAX package's contract:

- the rendezvous environment in both spellings (the JAX package's
  ``VGQA_*`` variables and torchrun's), and none;
- ``build_mesh``: dp = 0 is the world size, another dp must equal it, tp or
  sp above 1 raise, as ``TPU.MESH_*`` read by the trainer;
- the device of a rank, the rank folded into the dropout seeds, the check
  that refuses two NCCL ranks on one card;
- in a real group of 2 processes (``tests/torch_ddp_worker.py parallel``,
  started with the ``VGQA_*`` contract): ``all_gather_objects`` with
  payloads of 1,000 and 50,000 bytes (the sizes ``tests/test_multihost.py``
  gathers through the JAX package) and its JSON contract, rank and world
  size, a barrier that waits for the late rank, the gradient average over
  several buckets with a leaf that has no gradient on one rank, the metric
  mean, and the loss's global normalisers (rank 0 holds every box, rank 1
  none: the group's mean equals the loss of the whole batch in one process,
  1e-6 relative, float32).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from vgqa_tpu_torch.models.loss import VideoSTGLoss
from vgqa_tpu_torch.ops.dropout import DropoutRng, rank_seed
from vgqa_tpu_torch.parallel import Mesh, build_mesh, distributed
from vgqa_tpu_torch.utils.device import rank_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_ddp_worker.py")
SIZES = [1000, 50000]
BARRIER_DELAY = 1.0
LOSS_RTOL = 1e-6
TIMEOUT = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(job_name, job, tmp, world=2):
    """Start ``world`` ranks of the worker with the ``VGQA_*`` contract;
    returns the processes and the results' prefix."""
    job_path, prefix = str(tmp / f"{job_name}.json"), str(tmp / job_name)
    with open(job_path, "w") as f:
        json.dump(job, f)
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, VGQA_COORDINATOR=f"localhost:{port}",
                   VGQA_NUM_PROCESSES=str(world), VGQA_PROCESS_ID=str(rank),
                   VGQA_SHUTDOWN_TIMEOUT=str(TIMEOUT), OMP_NUM_THREADS="2")
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            env.pop(k, None)
        procs.append(subprocess.Popen([sys.executable, WORKER, job_name, job_path, prefix],
                                      env=env, cwd=REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs, prefix


def collect(procs, prefix):
    """Wait for the ranks (each with a timeout) and read their results."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("\n".join(f"== rank {r} (exit {p.returncode}) ==\n{log[-4000:]}"
                                       for r, (p, log) in enumerate(zip(procs, logs))))
    out = []
    for r in range(len(procs)):
        with open(f"{prefix}.rank{r}.json") as f:
            out.append(json.load(f))
    return out


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    return collect(*launch("parallel", {"sizes": SIZES, "barrier_delay": BARRIER_DELAY}, tmp))


# ---- no group -----------------------------------------------------------------

_CONTRACT_KEYS = ("VGQA_COORDINATOR", "VGQA_NUM_PROCESSES", "VGQA_PROCESS_ID",
                  "VGQA_SHUTDOWN_TIMEOUT", "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                  "MASTER_PORT")


@pytest.mark.parametrize("spelling", ["vgqa", "torchrun", "none"])
def test_env_contract(spelling, monkeypatch):
    for k in _CONTRACT_KEYS:
        monkeypatch.delenv(k, raising=False)
    if spelling == "vgqa":
        monkeypatch.setenv("VGQA_COORDINATOR", "host0:1234")
        monkeypatch.setenv("VGQA_NUM_PROCESSES", "4")
        monkeypatch.setenv("VGQA_PROCESS_ID", "3")
        monkeypatch.setenv("VGQA_SHUTDOWN_TIMEOUT", "850")
        want = ("tcp://host0:1234", 3, 4, 3, 850)
    elif spelling == "torchrun":
        monkeypatch.setenv("RANK", "5")
        monkeypatch.setenv("WORLD_SIZE", "8")
        monkeypatch.setenv("LOCAL_RANK", "1")
        monkeypatch.setenv("MASTER_ADDR", "host1")
        monkeypatch.setenv("MASTER_PORT", "29500")
        want = ("env://", 5, 8, 1, 300)
    env = distributed._env_contract()
    if spelling == "none":
        assert env is None
        assert distributed.initialize_multihost(device="cpu") is False
        assert (distributed.get_rank(), distributed.get_world_size()) == (0, 1)
        assert distributed.is_main_process()
        assert distributed.all_gather_objects({"a": 1}) == [{"a": 1}]
        distributed.synchronize()
        return
    got = (env["url"], env["rank"], env["world"], env["local_rank"],
           env["timeout"].total_seconds())
    assert got == want


@pytest.mark.parametrize("case", ["dp0", "dp_equal", "dp_mismatch", "tp", "sp"])
def test_build_mesh(case):
    """Without a group the world is one process (the group of 2: the
    ``parallel`` job below)."""
    if case == "dp0":
        assert build_mesh(0, 1, 1) == Mesh(dp=1, sp=1, tp=1)
    elif case == "dp_equal":
        assert build_mesh(1).dp == 1
    elif case == "dp_mismatch":
        with pytest.raises(ValueError, match="TPU.MESH_DP 2 needs 2 processes"):
            build_mesh(2)
    else:
        kw = {"tp": 2} if case == "tp" else {"sp": 2}
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 9"):
            build_mesh(0, **kw)


def test_trainer_refuses_tensor_parallel():
    from vgqa_tpu_torch.config import build_default_cfg
    from vgqa_tpu_torch.training.trainer import Trainer

    cfg = build_default_cfg()
    cfg.TPU.MESH_TP = 2
    with pytest.raises(NotImplementedError, match="tensor and sequence parallelism"):
        Trainer(cfg, device="cpu").setup(max_iter=1)


def test_rank_device(monkeypatch):
    assert rank_device("cpu", 3) == torch.device("cpu")
    assert rank_device("cuda:0", 1) == torch.device("cuda", 0)   # as given: gloo only
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device=\"cpu\""):
        rank_device(None, 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert rank_device(None, 1) == torch.device("cuda", 1)
    assert rank_device("cuda", 1) == torch.device("cuda", 1)
    with pytest.raises(RuntimeError, match="local rank 2 has no card"):
        rank_device(None, 2)


def test_duplicate_cards():
    assert distributed.duplicate_cards(["h/a", "h/b", "g/a"]) == []
    assert distributed.duplicate_cards(["h/a", "h/b", "h/a", "h/b", "h/c"]) == [[0, 2], [1, 3]]


def test_rank_seeds():
    assert rank_seed(1234, 0) == 1234
    assert len({rank_seed(7, r) for r in range(8)}) == 8
    a, b = DropoutRng(5, "cpu"), DropoutRng(5, "cpu", rank=0)
    assert a.seed() == b.seed()
    c = DropoutRng(5, "cpu", rank=1)
    x = torch.ones(64)
    assert not torch.equal(DropoutRng(5, "cpu").dropout(x, 0.5), c.dropout(x, 0.5))


# ---- a group of 2 -------------------------------------------------------------

def test_rank_and_world(group):
    assert [(r["rank"], r["world"], r["main"]) for r in group] == [(0, 2, True), (1, 2, False)]
    assert [r["mesh"] for r in group] == [[2, 1, 1]] * 2
    assert all("TPU.MESH_DP 3 needs 3 processes" in r["mesh_mismatch"] for r in group)


def test_all_gather_objects_sizes(group):
    for r in group:
        assert r["gather_ranks"] == [0, 1]
        assert r["gather_sizes"] == SIZES
        # the JSON contract: tuples arrive as lists, int keys as strings
        assert r["gather_kf"] == [[0.5, 0], [0.5, 1]]
        assert r["gather_keys"] == [{"0": [0, 1]}, {"1": [1, 2]}]


def test_synchronize_waits_for_the_late_rank(group):
    assert group[0]["barrier_wait_s"] >= 0.5 * BARRIER_DELAY
    assert group[1]["barrier_wait_s"] < group[0]["barrier_wait_s"]


def test_average_gradients(group):
    want = [[1.5] * 3, [[2.0, 2.0], [2.0, 2.0]], [1.5 * i for i in range(5)]]
    for r in group:
        assert r["grads"] == want
        assert r["grad_bytes"] == 4 * (3 + 4 + 5)


def test_reduce_mean(group):
    assert all(r["mean"] == {"loss": 1.5, "zero": 0.0} for r in group)


def test_loss_normalisers_are_global(group):
    """The mean over the two ranks of each term equals one process's loss on
    both videos; the box terms with N_global = 2 boxes, all on rank 0."""
    rng = np.random.RandomState(3)
    V, T = 1, 6
    outputs = {"pred_boxes": torch.from_numpy(rng.rand(V, T, 4).astype(np.float32) * 0.5 + 0.2),
               "pred_sted": torch.from_numpy(rng.randn(V, T, 2).astype(np.float32)),
               "logits_f_m": torch.from_numpy(rng.randn(V, T).astype(np.float32)),
               "logits_f_a": torch.from_numpy(rng.randn(V, T).astype(np.float32))}
    whole = {k: torch.cat([v, v]) for k, v in outputs.items()}
    act = torch.zeros(2, T)
    act[0, 2:4] = 1
    tm = torch.ones(2, T, dtype=torch.bool)
    tm[0, 4:] = False
    tm[1, 5:] = False
    targets = {"boxes": torch.full((2, T, 4), 0.3), "actioness": act, "time_mask": tm,
               "sted": torch.tensor([[2, 3], [2, 3]])}
    loss = VideoSTGLoss(losses=["boxes", "sted", "logits_f_m"], use_aux_loss=False)
    want = {k: float(v) for k, v in loss(whole, targets).items()}
    assert group[1]["loss"]["loss_bbox"] == 0.0
    for k, v in want.items():
        got = (group[0]["loss"][k] + group[1]["loss"][k]) / 2
        assert got == pytest.approx(v, rel=LOSS_RTOL), k
