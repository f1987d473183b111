"""Reader decorators — port of ``paddle_tpu/reader/decorator.py``.

A "reader creator" is a no-arg callable returning a generator of samples.
These combinators wrap reader creators; they are host-side data plumbing and
deliberately stay off the device (feeding happens at the DataLoader
boundary).
"""
from __future__ import annotations

import itertools
import multiprocessing
import queue as _queue
import random as _random
import threading

__all__ = [
    "cache", "map_readers", "buffered", "compose", "chain", "shuffle",
    "firstn", "xmap_readers", "multiprocess_reader",
]


def cache(reader):
    """Cache the reader's full output in memory on first pass (ref decorator.py:45)."""
    all_data = tuple(reader())

    def __impl__():
        for item in all_data:
            yield item

    return __impl__


def map_readers(func, *readers):
    """Yield func applied across the zipped outputs of ``readers`` (ref :85)."""

    def reader():
        rs = [r() for r in readers]
        for e in map(func, *rs):
            yield e

    return reader


def shuffle(reader, buf_size):
    """Shuffle within a sliding buffer of ``buf_size`` samples (ref :127)."""

    def data_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            _random.shuffle(buf)
            for b in buf:
                yield b

    return data_reader


def chain(*readers):
    """Concatenate readers sequentially (ref :176)."""

    def reader():
        rs = [r() for r in readers]
        for e in itertools.chain(*rs):
            yield e

    return reader


class ComposeNotAligned(ValueError):
    pass


def compose(*readers, **kwargs):
    """Zip readers into flattened tuples per sample (ref :241).

    check_alignment=True (default) raises ComposeNotAligned when the readers
    run out at different lengths.
    """
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        if isinstance(x, tuple):
            return x
        return (x,)

    def reader():
        rs = [r() for r in readers]
        if not check_alignment:
            for outputs in zip(*rs):
                yield sum(list(map(make_tuple, outputs)), ())
        else:
            for outputs in itertools.zip_longest(*rs):
                for o in outputs:
                    if o is None:
                        raise ComposeNotAligned(
                            "outputs of readers are not aligned.")
                yield sum(list(map(make_tuple, outputs)), ())

    return reader


def buffered(reader, size):
    """Prefetch up to ``size`` samples on a background thread (ref :299)."""

    class EndSignal:
        pass

    end = EndSignal()

    def read_worker(r, q):
        for d in r:
            q.put(d)
        q.put(end)

    def data_reader():
        r = reader()
        q = _queue.Queue(maxsize=size)
        t = threading.Thread(target=read_worker, args=(r, q))
        t.daemon = True
        t.start()
        e = q.get()
        while e is not end:
            yield e
            e = q.get()

    return data_reader


def firstn(reader, n):
    """Limit the reader to its first ``n`` samples (ref :361)."""

    def firstn_reader():
        for i, item in enumerate(reader()):
            if i == n:
                break
            yield item

    return firstn_reader


class XmapEndSignal:
    pass


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Apply ``mapper`` over the reader with ``process_num`` worker threads
    (ref :406). With order=True output order matches input order."""
    end = XmapEndSignal()

    def read_worker(r, q):
        for i in r():
            q.put(i)
        q.put(end)

    def order_read_worker(r, q):
        for i, d in enumerate(r()):
            q.put((i, d))
        q.put(end)

    def handle_worker(in_q, out_q, m):
        sample = in_q.get()
        while not isinstance(sample, XmapEndSignal):
            out_q.put(m(sample))
            sample = in_q.get()
        in_q.put(end)
        out_q.put(end)

    def order_handle_worker(in_q, out_q, m, order_holder):
        ins = in_q.get()
        while not isinstance(ins, XmapEndSignal):
            order_id, sample = ins
            r = m(sample)
            while order_id != order_holder[0]:
                pass
            out_q.put(r)
            order_holder[0] += 1
            ins = in_q.get()
        in_q.put(end)
        out_q.put(end)

    def xreader():
        # fresh queues/order counter per call — the reader must be re-iterable
        # across epochs (ref decorator.py xreader creates them per invocation)
        in_queue = _queue.Queue(buffer_size)
        out_queue = _queue.Queue(buffer_size)
        out_order = [0]
        target = order_read_worker if order else read_worker
        t = threading.Thread(target=target, args=(reader, in_queue))
        t.daemon = True
        t.start()
        target = order_handle_worker if order else handle_worker
        args = (in_queue, out_queue, mapper, out_order) if order else \
            (in_queue, out_queue, mapper)
        workers = []
        for _ in range(process_num):
            w = threading.Thread(target=target, args=args)
            w.daemon = True
            w.start()
            workers.append(w)

        finish = 0
        while finish < process_num:
            sample = out_queue.get()
            if isinstance(sample, XmapEndSignal):
                finish += 1
            else:
                yield sample

    return xreader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Fan-in multiple readers through worker processes (ref :502).

    Samples from all readers are interleaved; each reader runs in its own
    process, results travel back over a multiprocessing queue.
    """
    if len(readers) < 1:
        raise ValueError("multiprocess_reader needs at least one reader")

    def _read_into_queue(r, q):
        try:
            for sample in r():
                if sample is None:
                    raise ValueError("sample has None")
                q.put(sample)
            q.put(None)
        except Exception:
            q.put("")
            raise

    def queue_reader():
        q = multiprocessing.Queue(queue_size)
        workers = []
        for r in readers:
            p = multiprocessing.Process(target=_read_into_queue, args=(r, q))
            p.daemon = True
            p.start()
            workers.append(p)

        finish_num = 0
        while finish_num < len(readers):
            sample = q.get()
            if sample is None:
                finish_num += 1
            elif sample == "":
                raise ValueError("multiprocess reader raises an exception")
            else:
                yield sample

    return queue_reader
