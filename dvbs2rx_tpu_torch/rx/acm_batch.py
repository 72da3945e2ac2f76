"""Multi-channel batched ACM/VCM receiver.

Port of ``dvbs2rx_tpu/rx/acm_batch.py``. ACM control flow is data-dependent
per channel (each channel's decoded-PLS chain walk decides its own frame
boundaries), but the device work (front end, dense timing metric, batched
PLSC decode, per-PLS group programs, per-PLS FEC) has the same shape across
channels and runs on a channel axis.

Each channel keeps its own ``ACMReceiver`` (host chain walk, lock state,
frequency tracking), and the channels run in lockstep worker threads. Every
device stage of a receiver is a batch function reached through its
``_call``; here ``_call`` goes through a ``CallBatcher``: when every live
thread waits on a device request, the pending requests are grouped by key
and each group runs as one call, padded to C channels by repeating its last
request (the JAX module pads so each vmapped shape compiles once; here it
keeps the pooled LDPC decode at C x ``fec_batch`` lanes). Same-PLS FEC
requests pool into one lane-major decode of (N, C*B), frames as lanes: the
reference's SIMD-lane trick (``ldpc_decoder_bb_impl.cc:309-352``) applied
across channels. Per-lane convergence freezing keeps every frame's decode
independent of the pool, so each channel's TS bytes are those of a single
``ACMReceiver``; its LDPC statistics take the pool's batch-maximum
iteration count, as in the JAX receiver.

The JAX module vmaps jitted per-channel programs; here the batch functions
take the channel axis explicitly (no ``torch.func.vmap``: the kernels'
ctypes wrappers and the host readbacks inside a stage do not trace).
"""

import threading

import numpy as np

from ..utils.runtime import resolve_device
from .receiver import ACMReceiver, RxConfig


class CallBatcher:
    """Barrier-batches device calls from lockstep worker threads.

    ``run(fns)`` executes the callables in worker threads. Inside them,
    ``submit(key, batch_fn, args)`` blocks until every live thread is
    blocked in ``submit`` (then all pending requests flush: same-key
    requests go to one ``batch_fn`` call) or a finishing thread flushes.
    ``batch_fn`` receives a list of argument tuples and returns a list of
    results in the same order.
    """

    def __init__(self):
        self._cv = threading.Condition()
        self._active = 0
        self._waiting = 0
        self._pending = []        # (key, batch_fn, args, slot)

    # -- worker side --

    def submit(self, key, batch_fn, args):
        slot = {}
        with self._cv:
            self._pending.append((key, batch_fn, args, slot))
            self._waiting += 1
            if self._waiting >= self._active:
                self._flush_locked()
            else:
                while "out" not in slot and "err" not in slot:
                    self._cv.wait()
        if "err" in slot:
            raise slot["err"]
        return slot["out"]

    def _flush_locked(self):
        """Run all pending requests, grouped by key. The caller holds the
        lock and every other live thread is blocked, so running under the
        lock is safe."""
        batch = self._pending
        self._pending = []
        self._waiting -= len(batch)
        groups = {}
        for item in batch:
            groups.setdefault(item[0], []).append(item)
        for items in groups.values():
            try:
                outs = items[0][1]([it[2] for it in items])
                for it, out in zip(items, outs):
                    it[3]["out"] = out
            except BaseException as e:  # every submitter sees it
                for it in items:
                    it[3]["err"] = e
        self._cv.notify_all()

    # -- caller side --

    def run(self, fns):
        """Run the callables in threads; returns their results in order and
        raises the first error."""
        n = len(fns)
        results = [None] * n
        errors = [None] * n
        with self._cv:
            self._active = n

        def work(i):
            try:
                results[i] = fns[i]()
            except BaseException as e:
                errors[i] = e
            finally:
                with self._cv:
                    self._active -= 1
                    if self._pending and self._waiting >= self._active > 0:
                        self._flush_locked()
                    elif self._active == 0 and self._pending:
                        for it in self._pending:
                            it[3]["err"] = RuntimeError("batcher drained")
                        self._pending = []
                        self._cv.notify_all()

        threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for e in errors:
            if e is not None:
                raise e
        return results


class BatchedACMReceiver:
    """C independent ACM/VCM channels with channel-batched device work.

    ``receive(iq, flush)``: iq (C, n) complex64, one row per channel, in
    lockstep; returns the list of per-channel TS byte arrays, each equal to
    a single ``ACMReceiver``'s on that channel. ``get_stats`` is the list
    of per-channel statistics.
    """

    def __init__(self, cfg: RxConfig, n_channels: int, device=None):
        if not cfg.acm_vcm:
            raise ValueError("BatchedACMReceiver requires acm_vcm=True")
        self.cfg = cfg
        self.n_channels = n_channels
        self.device = resolve_device(device)
        self.chans = [ACMReceiver(cfg, self.device)
                      for _ in range(n_channels)]
        self._batcher = CallBatcher()
        tables = self.chans[0]._tables      # one set of per-PLS tables
        for ch in self.chans:
            ch._tables = tables
            ch._call = self._submit

    def _submit(self, key, fn, args):
        return self._batcher.submit(key, lambda al: self._batch_call(fn, al),
                                    args)

    def _batch_call(self, fn, args_list):
        """One call for a group of requests, padded to C channels."""
        n = len(args_list)
        padded = args_list + [args_list[-1]] * (self.n_channels - n)
        return fn(padded)[:n]

    def receive(self, iq: np.ndarray, flush: bool = True):
        iq = np.asarray(iq, dtype=np.complex64)
        if iq.ndim != 2 or iq.shape[0] != self.n_channels:
            raise ValueError(f"expected ({self.n_channels}, n) iq")
        fns = [
            (lambda c=c: self.chans[c].receive(iq[c], flush=flush))
            for c in range(self.n_channels)
        ]
        return self._batcher.run(fns)

    def get_stats(self, sym_rate=None):
        """Per-channel nested statistics (list, reference shape)."""
        return [ch.get_stats(sym_rate) for ch in self.chans]
