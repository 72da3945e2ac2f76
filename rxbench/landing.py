"""Output delivery of the timed loop: a fixed pool of pinned host buffers,
the in-flight limit, and a reader thread that stamps the time each call's
outputs land in host memory.

After each call the main thread enqueues the copies of everything the call
returned (``deliver``) into a free slot of the pool and records an event
behind them; the reader waits on that event, stamps the landing time and
hands the slot's host arrays to ``on_land``, then frees the slot. Before a
call the main thread waits (``wait_room``) until fewer than ``in_flight``
calls are still on the device.
"""

import collections
import queue
import threading
import time

import torch

SPARE = 2           # slots beyond the calls in flight: the reader's, and one


class _Done:
    """A CPU run's event: the work is finished when the call returns."""

    def record(self):
        pass

    def synchronize(self):
        pass


class LandingPool:
    def __init__(self, device, in_flight, on_land):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.in_flight = in_flight
        self.on_land = on_land
        self._slots = [dict() for _ in range(in_flight + SPARE)]
        self._free = queue.Queue()
        for s in range(len(self._slots)):
            self._free.put(s)
        self._pending = queue.Queue()
        self._events = collections.deque()
        self._error = None
        self._thread = threading.Thread(target=self._reader,
                                        name="rxbench-reader", daemon=True)
        self._thread.start()

    def _event(self):
        if self.cuda:
            return torch.cuda.Event(blocking=True)
        return _Done()

    def _buffer(self, slot, name, t):
        buf = self._slots[slot].get(name)
        if buf is None:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=self.cuda)
            self._slots[slot][name] = buf
        return buf

    def wait_room(self):
        """Block until fewer than ``in_flight`` calls are on the device."""
        while len(self._events) >= self.in_flight:
            self._events.popleft().synchronize()

    def drain(self):
        """Block until every submitted call has landed on the host side."""
        while self._events:
            self._events.popleft().synchronize()

    def deliver(self, index, t_submit, leaves, info=None):
        """Enqueue the copies of ``leaves`` ((name, tensor, rows) with rows
        None for the whole tensor, or the leading rows that carry data) into
        a free slot, behind which the reader waits."""
        self._raise()
        slot = self._free.get()
        rows = {}
        for name, t, n in leaves:
            buf = self._buffer(slot, name, t)
            if n is None:
                buf.copy_(t, non_blocking=self.cuda)
            elif n:
                buf[:n].copy_(t[:n], non_blocking=self.cuda)
            rows[name] = n
        ev = self._event()
        ev.record()
        self._events.append(ev)
        self._pending.put((index, slot, t_submit, ev, rows, info))

    def close(self):
        """Wait for every delivery, stop the reader, re-raise its error."""
        self._pending.put(None)
        self._thread.join()
        self._raise()

    def _raise(self):
        if self._error is not None:
            raise RuntimeError("output reader failed") from self._error

    def _reader(self):
        while True:
            item = self._pending.get()
            if item is None:
                return
            index, slot, t_submit, ev, rows, info = item
            try:
                ev.synchronize()
                t_land = time.perf_counter()
                host = {}
                for name, buf in self._slots[slot].items():
                    if name not in rows:
                        continue
                    n = rows[name]
                    host[name] = (buf if n is None else buf[:n]).numpy()
                self.on_land(index, t_submit, t_land, host, info)
            except Exception as e:      # re-raised by the main thread
                self._error = e
            finally:
                self._free.put(slot)
