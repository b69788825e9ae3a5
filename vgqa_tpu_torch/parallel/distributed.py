"""Processes of a data-parallel run (counterpart of
``vgqa_tpu/parallel/distributed.py``): one process per card over
``torch.distributed``, NCCL on the card and gloo on the CPU.

Where the JAX package runs one program over a mesh and lets XLA insert the
collectives, each process here holds its own copy of the train state and
its slice of every global batch, and the port makes the collectives
itself: the loss's global normalisers (``models/loss.py``), the gradient
average before the clip (:func:`average_gradients`, called by the train
step), the metrics' mean on the trainer's log cadence (:func:`reduce_mean`),
barriers around the files that rank 0 writes (:func:`synchronize`), and the
evaluator's merge (:func:`all_gather_objects`).

On the gloo backend every collective runs on a CPU copy of its tensor, so
gloo also serves ranks that share one card (NCCL refuses two ranks on one
card, and :func:`initialize_multihost` says so before any collective).

Nothing here touches CUDA or the process group at import time.
"""

from __future__ import annotations

import datetime
import json
import os
import socket
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils import trace
from ..utils.device import rank_device

BUCKET_NUMEL = 1 << 25          # elements per flat gradient bucket (128 MiB in float32)


def _env_contract() -> Optional[Dict[str, Any]]:
    """The rendezvous the environment asks for, or None.

    The JAX package's contract first: ``VGQA_COORDINATOR`` (host:port of
    process 0), ``VGQA_NUM_PROCESSES``, ``VGQA_PROCESS_ID`` and
    ``VGQA_SHUTDOWN_TIMEOUT`` (seconds a rank waits in a collective or a
    barrier; default 300, as JAX's shutdown barrier). Else torchrun's
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``. The
    local rank, which picks the rank's card, is ``LOCAL_RANK`` where set,
    else the process id."""
    timeout = int(os.environ.get("VGQA_SHUTDOWN_TIMEOUT", "300"))
    coord = os.environ.get("VGQA_COORDINATOR")
    if coord:
        rank = int(os.environ["VGQA_PROCESS_ID"])
        world = int(os.environ["VGQA_NUM_PROCESSES"])
        url = f"tcp://{coord}"
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        url = "env://"
    else:
        return None
    local = int(os.environ.get("LOCAL_RANK", rank))
    return {"url": url, "rank": rank, "world": world, "local_rank": local,
            "timeout": datetime.timedelta(seconds=timeout)}


def initialize_multihost(backend: Optional[str] = None, device=None) -> bool:
    """Join the process group that the environment describes (see
    :func:`_env_contract`); nothing when it describes none or a group is
    already initialised. Call it before any CUDA call of the process.
    Returns whether this call formed the group (its caller then leaves it
    with :func:`destroy`).

    ``device`` is the entry point's ``--device``: None puts the rank on
    card ``LOCAL_RANK``, ``"cpu"`` keeps it on the CPU, an explicit card
    (``"cuda:0"``) is taken as given. ``backend`` defaults to NCCL on a
    card and gloo on the CPU; gloo on a card runs the collectives on CPU
    copies. The rank's card becomes the current device before the group
    forms, and one all-reduce of a one-element tensor warms the
    communicator right after it (the counterpart of JAX's
    ``_warm_all_device_communicator``)."""
    if dist.is_initialized():
        return False
    env = _env_contract()
    if env is None:
        return False
    dev = rank_device(device, env["local_rank"])
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a card: pass backend='gloo' on the CPU")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store, rank, world = next(dist.rendezvous(env["url"], rank=env["rank"],
                                              world_size=env["world"],
                                              timeout=env["timeout"]))
    if backend == "nccl":
        _check_one_rank_per_card(store, rank, world, _card_key(dev))
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=env["timeout"])
    warm = torch.ones(1, device=_comm_device())
    dist.all_reduce(warm)
    if int(warm.item()) != world:
        raise RuntimeError(f"the warm-up all-reduce gave {warm.item()}, not {world}")
    return True


def _card_key(dev: torch.device) -> str:
    props = torch.cuda.get_device_properties(dev)
    return f"{socket.gethostname()}/{getattr(props, 'uuid', dev.index)}"


def duplicate_cards(keys: List[str]) -> List[List[int]]:
    """The groups of ranks whose card keys are equal (ranks sharing a card)."""
    by_key: Dict[str, List[int]] = {}
    for rank, key in enumerate(keys):
        by_key.setdefault(key, []).append(rank)
    return [ranks for ranks in by_key.values() if len(ranks) > 1]


def _check_one_rank_per_card(store, rank: int, world: int, key: str) -> None:
    """Raise, through the rendezvous store and so before any NCCL
    collective, when two ranks hold the same card: NCCL would fail later
    with "Duplicate GPU"."""
    store.set(f"vgqa_card/{rank}", key)
    keys = [store.get(f"vgqa_card/{r}").decode() for r in range(world)]
    shared = duplicate_cards(keys)
    if shared:
        raise RuntimeError(
            f"ranks {shared} share one card ({keys[shared[0][0]]}): NCCL takes one rank per "
            "card. Give each rank its own card (LOCAL_RANK, CUDA_VISIBLE_DEVICES) or pass "
            "backend='gloo'")


# warmup_mesh_communicators (vgqa_tpu/parallel/distributed.py:91-154) has no
# counterpart: it serialises the formation of XLA-CPU gloo communicators of a
# (dp, sp) mesh, whose interleaved handshakes deadlock inside one XLA program.
# Here there is one communicator, the default group's, formed and warmed in
# initialize_multihost.
#
# put_global_batch has no counterpart either: no global array exists in
# PyTorch. Each rank uploads its loader slice with data/collate.batch_to.


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def get_rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def _comm_device() -> torch.device:
    """Where the group's collectives take their tensors: the current card on
    NCCL, the CPU on gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def synchronize() -> None:
    """A barrier of every rank (around files that rank 0 writes)."""
    if not is_distributed() or dist.get_world_size() <= 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the group in place (on gloo through a CPU copy) and
    return it; ``t`` as it is without a group."""
    if not is_distributed():
        return t
    dev = _comm_device()
    if t.device == dev:
        dist.all_reduce(t)
    else:
        buf = t.to(dev)
        dist.all_reduce(buf)
        t.copy_(buf)
    return t


@torch.no_grad()
def average_gradients(params: Iterable[torch.nn.Parameter]) -> int:
    """Replace the ``.grad`` of every parameter by its mean over the group
    (a sum, then a division by the world size: gloo has no AVG) in flat
    buckets of at most ``BUCKET_NUMEL`` elements; a parameter without a
    gradient takes part as zeros, so every rank's buckets have one layout.
    Returns the bytes all-reduced; 0 without a group. Traced as
    ``vgqa.train.allreduce`` (``utils/trace``)."""
    if not is_distributed():
        return 0
    with trace.span("vgqa.train.allreduce"):
        params = list(params)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        world, sent = dist.get_world_size(), 0
        buckets, current, size = [], [], 0
        for p in params:
            if current and (size + p.numel() > BUCKET_NUMEL
                            or p.grad.dtype != current[0].grad.dtype):
                buckets.append(current)
                current, size = [], 0
            current.append(p)
            size += p.numel()
        if current:
            buckets.append(current)
        for bucket in buckets:
            flat = torch.cat([p.grad.reshape(-1) for p in bucket])
            all_reduce_(flat)
            flat.div_(world)
            sent += flat.numel() * flat.element_size()
            offset = 0
            for p in bucket:
                n = p.numel()
                p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
                offset += n
        return sent


def reduce_mean(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The group's mean of each scalar in ``metrics``, on the host: one
    all-reduce and one device sync (the trainer calls it on its log
    cadence only)."""
    names = sorted(metrics)
    if not names:
        return {}
    stacked = torch.stack([metrics[k].detach().float().reshape(()) for k in names])
    all_reduce_(stacked)
    with trace.sync("reduce_mean"):
        values = (stacked / get_world_size()).tolist()
    return dict(zip(names, values))


def _json_default(o):
    """Encode numpy scalars and arrays and other iterables; anything else
    is the caller's to convert (see :func:`all_gather_objects`)."""
    if isinstance(o, np.generic):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    return list(o)


def all_gather_objects(obj: Any) -> List[Any]:
    """``obj`` of every rank, in rank order, through a JSON round-trip (not
    pickle): dict keys become strings, tuples, sets and numpy arrays lists,
    numpy scalars Python numbers, as in the JAX package's contract; the
    caller re-keys what it receives (``VidSTGEvaluator._merge_gathered``).
    The payload sizes are gathered first, so payloads of any size, and of
    different sizes per rank, gather whole."""
    if not is_distributed() or dist.get_world_size() <= 1:
        return [obj]
    world, dev = dist.get_world_size(), _comm_device()
    payload = json.dumps(obj, default=_json_default).encode()
    size = torch.tensor([len(payload)], dtype=torch.int64, device=dev)
    sizes = [torch.zeros_like(size) for _ in range(world)]
    dist.all_gather(sizes, size)
    sizes = [int(s.item()) for s in sizes]
    buf = torch.zeros(max(sizes), dtype=torch.uint8)
    buf[: len(payload)] = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    buf = buf.to(dev)
    bufs = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(bufs, buf)
    return [json.loads(bytes(b[:n].cpu().numpy()).decode()) for b, n in zip(bufs, sizes)]


def destroy() -> None:
    """Leave the process group (the end of an entry point's run)."""
    if is_distributed():
        dist.destroy_process_group()
