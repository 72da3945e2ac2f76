"""What the reader thread keeps of each landed call, and the comparison
that decides ``correct`` once the window has closed.

Every call: the landing time (the window's rate and latency), each
delivered frame's channel, place and kind (the frames never delivered),
and the frames the receiver itself flags as failed (the driver's
``flagged``). A seed-drawn uniform sample of the window's frames
(``check_frames`` of them) keeps every record the driver gives (bytes,
maps) for the reference, which runs after the window. ``check_calls``
window calls, at seed-drawn moments, are the driver's checked calls
(``snap_due``): the driver keeps what its own numbers need of them.

Numbers every cell compares (an exact comparison: limit 0):

- ``wrong_frames``: sampled frames unequal to the frame their channel
  carried at that place of its stream (``reference.check``), and any
  frame delivered twice;
- ``missing_frames``: frames due in the window (every place up to the
  last one delivered of each kind, per channel) never delivered.

The driver's module adds its own numbers and their limits (``LIMITS``):
the counts of its ``flagged`` frames over the window, and what its
``numbers`` compare after the window.
"""

import numpy as np

from .reference import check as ref

LIMITS = {"wrong_frames": 0, "missing_frames": 0}


class Checker:
    def __init__(self, driver, limits, traffic, seed, first_window_call):
        self.driver = driver
        self.limits = dict(LIMITS, **limits)
        self.k = traffic["check_frames"]
        self.rng = np.random.default_rng([int(seed), 1])
        # the checked calls: seed-drawn moments of the window, as shares
        self.snap_at = sorted(np.random.default_rng([int(seed), 2]).uniform(
            0.05, 0.9, traffic.get("check_calls", 0)).tolist())
        self.first = first_window_call
        self.landed = []            # (index, t_submit, t_land)
        self.delivered = []         # (chan, place, kind) arrays, every call
        self.window_frames = 0
        self.flags = {}             # flagged frames by number, window calls
        self.bad_channels = set()   # channels with a flagged frame
        self.kept = None            # the sampled frames' records
        self.keys = None
        self.counters = {}          # stats of profiled calls, summed

    def snap_due(self, share):
        """True once for each checked call: the window's ``share`` has
        passed the next drawn moment."""
        if self.snap_at and share >= self.snap_at[0]:
            self.snap_at.pop(0)
            return True
        return False

    def on_land(self, index, t_submit, t_land, host, info):
        """Called by the reader thread for each landed call, in order (the
        only writer; the main thread reads after the pool is closed)."""
        rec = self.driver.records(index, host)
        self.delivered.append((rec["chan"], rec["place"], rec["kind"],
                               index >= self.first))
        if index < self.first:
            return
        self.landed.append((index, t_submit, t_land))
        self.window_frames += rec["chan"].size
        for name, bad in self.driver.flagged(rec).items():
            self.flags[name] = self.flags.get(name, 0) + int(bad.sum())
            self.bad_channels.update(rec["chan"][bad].tolist())
        if info and info.get("profiled"):
            for k, v in host.items():
                if k.startswith("stats.") and v.size == 1:
                    self.counters[k] = self.counters.get(k, 0) + \
                        float(v.reshape(()))
        self._sample(rec)

    def _sample(self, rec):
        """A uniform sample of k of the window's frames: each frame draws
        a key from the seeded generator and the k smallest keys stay."""
        keys = self.rng.random(rec["chan"].size)
        if self.kept is None:
            self.kept = {k: np.array(v[:0], copy=True)
                         for k, v in rec.items()}
            self.keys = np.zeros(0)
        room = self.k - self.keys.size
        if room > 0:
            take = np.arange(min(room, keys.size))
            self.keys = np.concatenate([self.keys, keys[take]])
            for k, v in rec.items():
                self.kept[k] = np.concatenate([self.kept[k], v[take]])
            keys, rec = keys[room:], {k: v[room:] for k, v in rec.items()}
        cand = np.flatnonzero(keys < self.keys.max()) if keys.size else []
        if len(cand):
            allk = np.concatenate([self.keys, keys[cand]])
            sel = np.argpartition(allk, self.k - 1)[: self.k]
            drop = np.setdiff1d(np.arange(self.k), sel[sel < self.k])
            add = cand[sel[sel >= self.k] - self.k]
            self.keys[drop] = keys[add]
            for k, v in rec.items():
                self.kept[k][drop] = v[add]

    # ------------------------------------------------------------ results

    def window(self, t_end):
        """Calls whose outputs landed by ``t_end``: (count, latencies s)."""
        lat = [t1 - t0 for _, t0, t1 in self.landed if t1 <= t_end]
        return len(lat), np.asarray(lat)

    def _missing(self):
        """Frames due in the window that never came, the count due, and
        the duplicates. Per channel the places from the first one
        delivered by a window call up to the last delivered of each kind
        (the least of those) are due; every place delivered, window or
        warm-up, counts."""
        chan = np.concatenate([d[0] for d in self.delivered])
        place = np.concatenate([d[1] for d in self.delivered])
        kind = np.concatenate([d[2] for d in self.delivered])
        win = np.concatenate([np.full(d[0].size, d[3]) for d in
                              self.delivered])
        missing = due = dup = 0
        for c in np.unique(chan):
            sel = chan == c
            if not (sel & win).any():
                continue
            lo = place[sel & win].min()
            hi = min(place[sel & (kind == k)].max()
                     for k in np.unique(kind[sel]))
            got = place[sel & (place >= lo) & (place <= hi)]
            n_due = max(0, int(hi - lo + 1))
            uniq = np.unique(got)
            due += n_due
            missing += n_due - uniq.size
            dup += got.size - uniq.size
        return missing, due, dup

    def finish(self, stim, control=False):
        """The comparison with the reference, after the window (the
        program freed). ``control``: the driver's numbers put the
        reference in lower precision in the program's place."""
        cat = self.kept or {}
        if cat and cat["chan"].size:
            wrong, _ = ref.compare_frames(
                cat["chan"], cat["place"], cat["kind"], cat["rows"],
                stim.bbframes, stim.kinds, stim.order)
            checked = int(cat["chan"].size)
        else:
            wrong, checked = np.zeros(0, bool), 0
        missing, due, dup = self._missing()
        numbers = {"wrong_frames": int(wrong.sum()) + dup,
                   "missing_frames": missing}
        numbers.update(self.flags)
        numbers.update(self.driver.numbers(self.kept, self.rng, control))
        limits = {k: {"value": v, "limit": self.limits[k]}
                  for k, v in numbers.items()}
        bad = {k: v > self.limits[k] for k, v in numbers.items()}
        failed = numbers["wrong_frames"] + missing + sum(self.flags.values())
        attempted = max(due, self.window_frames)
        correct = checked > 0 and not any(bad.values()) and \
            set(self.limits) <= set(numbers)
        wrong_ch = np.unique(cat["chan"][wrong]).tolist() if checked else []
        return {"correct": bool(correct), "attempted": int(attempted),
                "failed": int(failed), "checked": checked, "limits": limits,
                "channels_flagged": sorted(self.bad_channels)[:16],
                "channels_wrong": wrong_ch[:16]}
