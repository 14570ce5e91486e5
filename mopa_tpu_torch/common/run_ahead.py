"""A producer on a thread of its own, a bounded number of items ahead of
its consumer (the loader's collate thread and the device prefetch)."""

from __future__ import annotations

import queue
import threading


def run_ahead(produce, depth: int, name: str):
    """Yield the items that ``produce(put)`` puts, made up to ``depth``
    ahead on a daemon thread named ``name``.

    ``put(item)`` returns False once the consumer has stopped (it closed
    this generator), and ``produce`` then returns; closing the generator
    waits for that, so the thread has ended when ``close()`` returns. An
    exception raised in ``produce`` is raised in the consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def run():
        try:
            produce(put)
            put(done)
        except BaseException as e:  # the consumer raises it
            put(e)

    thread = threading.Thread(target=run, daemon=True, name=name)
    thread.start()
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
        # the producer ends at its next put(): a closed generator leaves
        # no thread behind
        if thread is not threading.current_thread():
            thread.join()
