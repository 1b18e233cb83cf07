"""Host-side async prefetch for the training loop.

Two small primitives, the reference's (``asr_shap/pipeline/prefetch.py``):

  * :func:`background_iterator` runs a (possibly expensive) host iterable
    in a worker thread with a bounded queue, so batch synthesis and noise
    mixing overlap the device step;
  * :func:`prefetch_to_device` also moves each batch onto the device
    ``depth`` steps ahead, from pinned host memory with a non-blocking
    copy, so the device does not wait on a host-to-device transfer.

Threads (not processes): the producers are numpy and torch host ops that
release the GIL, and batches stay in shared memory.
"""

from __future__ import annotations

import queue
import threading
import weakref
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from asr_shap_torch.core.device import resolve_device

_SENTINEL = object()


class _ProducerError:
    """Unique wrapper for producer exceptions: a plain tagged tuple could
    collide with legitimate items."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


def background_iterator(iterable: Iterable, maxsize: int = 2) -> Iterator:
    """Iterate ``iterable`` on a daemon thread, yielding through a bounded
    queue. Exceptions in the producer re-raise at the consumer. Closing or
    abandoning the returned generator (break, GC, an exception in the
    consumer's loop) signals the producer to stop, so no thread stays
    blocked on a full queue holding device batches.

    The producer starts HERE, not at the first ``next``: up to ``maxsize``
    + 1 items are taken from ``iterable`` before the consumer asks, even if
    the returned iterator is never advanced. Do not hand in an iterator
    that is also read elsewhere."""
    q: "queue.Queue" = queue.Queue(maxsize=maxsize)
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            it = iter(iterable)
            while not stop.is_set():
                try:
                    item = next(it)  # produce nothing past a stop signal
                except StopIteration:
                    break
                if not _put(item):
                    return
        except BaseException as e:  # re-raised at the consumer
            _put(_ProducerError(e))
            return
        _put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()

    def _drain() -> Iterator:
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    return
                if isinstance(item, _ProducerError):
                    raise item.exc
                yield item
        finally:
            stop.set()  # GeneratorExit or a consumer exception: release the producer
            # a put racing the stop signal may land one more item: drain
            # until the producer is dead, so that no item stays referenced
            while t.is_alive():
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break

    gen = _drain()
    # A generator collected before its first next() never runs its finally
    # block, which with the eager start above would leave the producer
    # blocked on a full queue forever; the finalizer covers that window.
    weakref.finalize(gen, stop.set)
    return gen


def to_device(batch: Dict[str, Any], device: str | torch.device = "cuda") -> Dict[str, Any]:
    """Each numpy or tensor leaf of ``batch`` on ``device`` (a CUDA copy
    from pinned memory, non-blocking); other leaves as they are."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        if isinstance(v, torch.Tensor):
            if device.type == "cuda" and v.device.type == "cpu":
                v = v.pin_memory()
            v = v.to(device, non_blocking=True)
        out[k] = v
    return out


def prefetch_to_device(
    batches: Iterable[Dict[str, Any]],
    depth: int = 2,
    mesh=None,
    put_fn: Optional[Callable] = None,
    device: str | torch.device = "cuda",
) -> Iterator[Dict[str, Any]]:
    """Yield device-resident batches ``depth`` steps ahead of consumption.

    ``put_fn(batch) -> batch`` overrides placement; the default is
    :func:`to_device` on ``device``, or with a ``mesh`` this rank's rows on
    the mesh's device (``pipeline/train.py::shard_batch``, which drops the
    host-only ``_`` keys)."""
    if put_fn is None:
        if mesh is not None:
            from asr_shap_torch.pipeline.train import shard_batch

            put_fn = lambda b: shard_batch(b, mesh)  # noqa: E731
        else:
            device = resolve_device(device)
            put_fn = lambda b: to_device(b, device)  # noqa: E731
    return background_iterator(map(put_fn, batches), maxsize=depth)
