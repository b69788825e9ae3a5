"""Host data loader: iteration-based, with threaded prefetch (counterpart of
``vgqa_tpu/data/loader.py``: the same epoch order, buckets, resume and
process slices).

Takes the place of the reference's DataLoader + DistributedSampler +
IterationBasedBatchSampler stack: a fixed total-iteration schedule (epochs x
ceil(N / global_batch)), per-epoch reshuffling, resume from a start
iteration, and one video per device per step. Decode and augmentation run
in a thread pool that prefetches ahead of the device; with ``pin_memory``
the workers also copy each batch into page-locked memory, so the trainer's
upload to the card can be asynchronous.
"""

from __future__ import annotations

import math
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from queue import Queue
from typing import Any, Dict, Iterator, Optional

import torch

from .collate import collate
from .tokenizer import build_tokenizer


def _distributed() -> tuple:
    """(rank, world size) of an initialised ``torch.distributed`` group,
    else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _pinned(tree):
    if isinstance(tree, torch.Tensor):
        return tree.pin_memory()
    if isinstance(tree, dict):
        return {k: _pinned(v) for k, v in tree.items()}
    if hasattr(tree, "__dataclass_fields__"):
        return type(tree)(*(_pinned(getattr(tree, f)) for f in tree.__dataclass_fields__))
    return tree


class IterationBasedLoader:
    def __init__(
        self,
        dataset,
        cfg,
        split: str,
        global_batch: int,
        shuffle: bool = True,
        total_iters: Optional[int] = None,
        start_iter: int = 0,
        seed: int = 2021,
        num_workers: Optional[int] = None,
        prefetch: Optional[int] = None,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        pin_memory: bool = False,
    ):
        self.dataset = dataset
        self.cfg = cfg
        self.split = split
        self.global_batch = global_batch
        # Several processes: each materializes only its slice of every
        # global batch (DistributedSampler semantics); the epoch order is a
        # pure function of (seed, epoch), so all processes agree on the
        # global index list without communication.
        if process_index is None or process_count is None:
            process_index, process_count = _distributed()
        if global_batch % process_count != 0:
            raise ValueError(
                f"global_batch {global_batch} must divide evenly over "
                f"{process_count} processes"
            )
        self.process_index = process_index
        self.process_count = process_count
        self.pin_memory = pin_memory
        self.local_batch = global_batch // process_count
        self.shuffle = shuffle
        n = len(dataset)
        iters_per_epoch = max(1, math.ceil(n / global_batch))
        if total_iters is None:
            total_iters = cfg.SOLVER.MAX_EPOCH * iters_per_epoch
        self.iters_per_epoch = iters_per_epoch
        self.total_iters = total_iters
        self.start_iter = start_iter
        self.seed = seed
        self.tokenizer = build_tokenizer(cfg.MODEL.TEXT_MODEL.VOCAB_DIR)
        self.num_workers = (
            num_workers if num_workers is not None else cfg.DATALOADER.NUM_WORKERS
        )
        self.prefetch = prefetch if prefetch is not None else cfg.DATALOADER.PREFETCH

        base = cfg.INPUT.TRAIN_SAMPLE_NUM
        self.pad_t = base if split == "train" else base * 2

    def __len__(self) -> int:
        return self.total_iters

    def _epoch_order(self, epoch: int):
        order = list(range(len(self.dataset)))
        rng = random.Random(self.seed + epoch)
        if self.shuffle:
            rng.shuffle(order)
        if getattr(self.cfg.DATALOADER, "ASPECT_RATIO_GROUPING", False):
            # group portrait/landscape clips so same-shape videos batch
            # together (the reference's GroupedBatchSampler)
            def ratio_bucket(i):
                item = self.dataset.items[i]
                return 0 if item["height"] / max(item["width"], 1) < 1 else 1

            buckets: dict = {}
            for i in order:
                buckets.setdefault(ratio_bucket(i), []).append(i)
            groups = list(buckets.values())
            if self.shuffle:
                rng.shuffle(groups)
            order = [i for g in groups for i in g]
        return order

    def _indices_for_iter(self, it: int):
        epoch = it // self.iters_per_epoch
        pos = (it % self.iters_per_epoch) * self.global_batch
        order = self._epoch_order(epoch)
        idxs = [
            order[(pos + i) % len(order)] for i in range(self.global_batch)
        ]
        return idxs

    def _make_batch(self, it: int) -> Dict[str, Any]:
        idxs = self._indices_for_iter(it)
        # this process's contiguous slice of the global batch
        lo = self.process_index * self.local_batch
        idxs = idxs[lo : lo + self.local_batch]
        samples = [self.dataset[i] for i in idxs]
        batch = collate(
            samples,
            self.tokenizer,
            self.pad_t,
            self.cfg.INPUT.MAX_QUERY_LEN,
            self.cfg.DATASET.APP_NUM,
            self.cfg.DATASET.MOT_NUM,
        )
        if self.pin_memory:
            batch = {k: (v if k == "info" else _pinned(v)) for k, v in batch.items()}
        batch["iteration"] = it
        return batch

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        its = range(self.start_iter, self.total_iters)
        if self.num_workers <= 0:
            for it in its:
                yield self._make_batch(it)
            return

        q: Queue = Queue(maxsize=max(1, self.prefetch))
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    futures = []
                    for it in its:
                        if stop.is_set():
                            break
                        futures.append(pool.submit(self._make_batch, it))
                        while len(futures) >= self.num_workers + self.prefetch:
                            q.put(futures.pop(0).result())
                    for f in futures:
                        if stop.is_set():
                            break
                        q.put(f.result())
            except Exception as e:  # noqa: BLE001 - handed to the consumer, raised there
                q.put(e)
                return
            q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()


def make_data_loader(
    cfg, mode: str = "train", start_iter: int = 0, dataset=None, global_batch=None,
    pin_memory: bool = False,
) -> IterationBasedLoader:
    """The reference's make_data_loader: one video per device per step (the
    reference requires SOLVER.BATCH_SIZE 1); ``global_batch`` is the number
    of cards that train together, the data-parallel world size (the
    trainer and ``tools/evaluate`` pass it, as the JAX tool passes its
    ``dp``; default 1), of which each process materialises its slice."""
    from .dataset import build_dataset

    if mode not in ("train", "val", "test"):
        raise ValueError(f"mode {mode!r} is not train, val or test")
    is_train = mode == "train"
    if cfg.SOLVER.BATCH_SIZE != 1:
        raise ValueError("Each device should only take 1 video.")
    if dataset is None:
        dataset = build_dataset(cfg, mode)
    if global_batch is None:
        global_batch = 1
    return IterationBasedLoader(
        dataset,
        cfg,
        mode,
        global_batch,
        shuffle=is_train and cfg.SOLVER.SHUFFLE,
        # eval walks the split exactly once; the last batch wraps around to
        # the front, which is harmless because the evaluator dedupes by
        # item id (duplicate predictions overwrite identically)
        total_iters=None if is_train else math.ceil(len(dataset) / global_batch),
        start_iter=start_iter if is_train else 0,
        pin_memory=pin_memory,
    )
