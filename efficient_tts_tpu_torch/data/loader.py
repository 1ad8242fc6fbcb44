"""Epoch iterator with shuffling, sharding, length bucketing and prefetch.

Counterpart of `efficient_tts_tpu/data/loader.py`. `data_loader`,
`infinite_loader` and `background_prefetch` are copies: a worker thread
collates the next batches on the host while the card runs the current
step, and each process may take a strided shard of an epoch's order.
`device_prefetch` is the card's version of JAX's: each batch goes to
pinned host memory and to the card by non-blocking copies on a side
stream, ahead of its use; the consumer's stream waits on the batch's event
before the batch is handed over, and each handed-over tensor is recorded
on that stream, so its memory is not reused while the step still reads it.

The identity contract: `infinite_loader`'s whole-corpus batch is yielded
as the same object every epoch, `background_prefetch` keeps identity, and
`device_prefetch` uploads such a repeated batch only once. A worker
thread ends when its consumer is closed or collected, rather than staying
blocked on a full queue.
"""

from __future__ import annotations

import collections
import queue
import threading

import numpy as np
import torch

from efficient_tts_tpu_torch.utils.device import resolve_device


def _put(q: queue.Queue, item, stop: threading.Event) -> bool:
    """Put `item` unless the consumer stops first (then False), so a worker
    never stays blocked on a full queue that nobody reads."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def data_loader(
    dataset,
    batch_size: int,
    collate_fn,
    shuffle: bool = True,
    seed: int = 0,
    epoch: int = 0,
    shard_id: int = 0,
    num_shards: int = 1,
    drop_last: bool = True,
    prefetch: int = 2,
    length_fn=None,
):
    """Yields collated batches for one epoch.

    With `length_fn(index) -> approx length`, batches group utterances of
    similar length (a length sort with 5% jitter when shuffling, so bucket
    boundaries move from epoch to epoch), and the order of the batches is
    then shuffled: uniform batches padded to their longest utterance waste
    about 40% of the conv work on LJSpeech's lengths."""
    n = len(dataset)
    rng = np.random.default_rng(seed + epoch)
    if shuffle:
        order = rng.permutation(n)
    else:
        order = np.arange(n)
    order = order[shard_id::num_shards]
    if length_fn is not None:
        lengths = np.asarray([length_fn(int(i)) for i in order], np.float64)
        if shuffle:
            lengths = lengths * (1.0 + 0.05 * rng.standard_normal(len(lengths)))
        order = order[np.argsort(lengths, kind="stable")]
    if drop_last:
        usable = (len(order) // batch_size) * batch_size
        order = order[:usable]

    batches = [order[i: i + batch_size] for i in range(0, len(order), batch_size)]
    if not batches:
        return
    if length_fn is not None and shuffle:
        rng.shuffle(batches)

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        try:
            for idxs in batches:
                if stop.is_set() or not _put(q, collate_fn([dataset[int(i)] for i in idxs]), stop):
                    return
            _put(q, None, stop)
        except BaseException as e:  # handed to the consumer, which raises it
            _put(q, e, stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def device_prefetch(iterator, size: int = 2, device="cuda", dtypes: dict | None = None, mesh=None,
                    accum_steps: int = 1):
    """(epoch, batch dict of numpy arrays) -> (epoch, batch dict of tensors
    on `device`), `size` batches ahead. `dtypes` maps keys to the torch
    dtypes the consumer takes; the cast happens on the host. On the card
    the copies run on a side stream from pinned memory; on the CPU the
    batch becomes tensors in place. A batch object that repeats by identity
    is handed over again as the same tensors, not uploaded again. With a
    `mesh` (JAX :90-130) only this rank's rows of each global batch
    (`parallel/sharding.py:split_batch`: its block, or with `accum_steps`
    its block of each micro-batch) are pinned and uploaded, to the rank's
    card (`parallel/distributed.py:rank_device` of `device`)."""
    if mesh is None:
        return _device_prefetch(iterator, size, resolve_device(device), dtypes or {})
    from efficient_tts_tpu_torch.parallel.distributed import rank_device
    from efficient_tts_tpu_torch.parallel.sharding import split_batch

    return _device_prefetch(iterator, size, rank_device(device), dtypes or {},
                            lambda a: split_batch(a, mesh, accum_steps))


def _device_prefetch(iterator, size, dev, dtypes, block=None):
    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    last = (None, None)  # (source batch object, (tensors, event))

    def put(item):
        nonlocal last
        epoch, batch = item
        if batch is last[0]:
            return epoch, last[1]
        host = {k: torch.as_tensor(np.asarray(v) if block is None else block(np.asarray(v))) for k, v in batch.items()}
        host = {k: t.to(dtypes[k]) if k in dtypes else t for k, t in host.items()}
        if copy_stream is None:
            placed = (host, None)
        else:
            host = {k: t.pin_memory() for k, t in host.items()}
            with torch.cuda.stream(copy_stream):
                tensors = {k: t.to(dev, non_blocking=True) for k, t in host.items()}
                event = torch.cuda.Event()
                event.record(copy_stream)
            placed = (tensors, event)
        last = (batch, placed)
        return epoch, placed

    def hand_over(entry):
        epoch, (tensors, event) = entry
        if event is not None:
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(event)
            for t in tensors.values():
                t.record_stream(stream)
        return epoch, tensors

    pending = collections.deque()
    for item in iterator:
        pending.append(put(item))
        if len(pending) >= size:
            yield hand_over(pending.popleft())
    while pending:
        yield hand_over(pending.popleft())


def infinite_loader(dataset, batch_size, collate_fn, seed=0, **kw):
    """An endless stream of (epoch, batch) over reshuffled epochs.

    When the whole dataset is one batch (a small corpus trained at full
    batch) and the dataset declares `deterministic_items = True`, a
    reshuffle only permutes rows inside that batch, which leaves the
    gradient as it is: the batch is collated once and the same object is
    yielded every epoch, and `device_prefetch` uploads it once per run.
    A dataset whose items are random (the vocoder's segment crops) must not
    take this path, or every crop would stay at its first epoch's place."""
    whole_corpus_batch = (
        batch_size == len(dataset)
        or (batch_size > len(dataset) and not kw.get("drop_last", True))
    ) and getattr(dataset, "deterministic_items", False)
    if whole_corpus_batch:
        cached = list(data_loader(dataset, batch_size, collate_fn, seed=seed, epoch=0, **kw))
        if len(cached) == 1:
            epoch = 0
            while True:
                yield epoch, cached[0]
                epoch += 1
    epoch = 0
    while True:
        for batch in data_loader(dataset, batch_size, collate_fn, seed=seed, epoch=epoch, **kw):
            yield epoch, batch
        epoch += 1


def background_prefetch(iterator, size: int = 2):
    """Run `iterator` on a daemon thread, buffering up to `size` items, so
    the next batch is collated across epoch boundaries while the card runs
    the current step (`infinite_loader` starts a `data_loader` thread per
    epoch). The identity of the items is kept."""
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()
    done = object()

    def worker():
        try:
            for item in iterator:
                if not _put(q, item, stop):
                    return
            _put(q, done, stop)
        except BaseException as e:  # handed to the consumer, which raises it
            _put(q, e, stop)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
