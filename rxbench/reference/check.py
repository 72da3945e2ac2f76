"""The plain reference the benchmark holds the receiver's outputs to.

Pure numpy. It imports nothing of the program (and no JAX): what it knows
of the stream comes from the benchmark's own generator, the frozen
transmitter's BBFRAMEs and each channel's frame order, never from the
program. Two comparisons:

- ``compare_frames``: every delivered BBFRAME of a sample against the
  frame that the channel carried at that place of its stream. A channel's
  place in its cyclic frame order is not known after acquisition; it is
  the offset most of the channel's delivered frames agree on, and every
  frame off it, or equal to no frame of the channel, is wrong.
- ``crc8_map``: the CRC-8 validity map a receiver reports beside each
  BBFRAME (per byte position p: byte p equals the CRC-8 of the 187 bytes
  before it, of bytes 0..p-1 for p < 187; and the BBHEADER's CRC), by
  table steps over every window.
"""

import collections

import numpy as np

from ..txref.scramblers import bb_derandomizer_bytes, crc8_table

WINDOW = 187


def crc8_map(frames, window=WINDOW):
    """frames (K, n) uint8 descrambled -> (ok_packed (K, ceil(n/8)) uint8
    LSB first, hdr_ok (K,) int32)."""
    frames = np.asarray(frames, np.uint8)
    K, n = frames.shape
    table = crc8_table()
    padded = np.concatenate([np.zeros((K, window), np.uint8), frames], 1)
    crc = np.zeros((K, n), np.uint8)
    for j in range(window):
        crc = table[crc ^ padded[:, j: j + n]]
    ok = crc == frames
    hdr = np.zeros(K, np.uint8)
    for j in range(9):
        hdr = table[hdr ^ frames[:, j]]
    return (np.packbits(ok, axis=-1, bitorder="little"),
            (hdr == frames[:, 9]).astype(np.int32))


def descramble(frames):
    """BB-scrambled frames (K, n) -> their plain bytes."""
    frames = np.asarray(frames, np.uint8)
    return frames ^ bb_derandomizer_bytes(frames.shape[1])[None]


def compare_frames(chan, place, kind, rows, bbframes, kinds, order):
    """Delivered frames against the stream each channel carried.

    chan, place, kind: (K,) int: the channel, the frame's place in that
    channel's stream (consecutive frames have consecutive places) and its
    MODCOD index; rows (K, w) uint8 as delivered (zero padded past the
    frame's bytes); bbframes: the pool's frames, kinds their MODCOD index,
    order (C, R) channel c's cyclic order of pool frames (a pool frame may
    recur in it: each slot that holds it votes for an offset).

    Returns (wrong (K,) bool, offset per channel (C,) int, -1 where no
    delivered frame of the channel is a frame of its stream)."""
    chan = np.asarray(chan, np.int64)
    place = np.asarray(place, np.int64)
    kind = np.asarray(kind, np.int64)
    rows = np.asarray(rows, np.uint8)
    C, R = order.shape
    lookup = {}
    for p, bb in enumerate(bbframes):
        lookup[(int(kinds[p]), bb.tobytes())] = p
    pool_idx = np.full(chan.size, -1, np.int64)
    for i in range(chan.size):
        k = int(kind[i])
        n = bbframes[int(np.flatnonzero(kinds == k)[0])].size
        row = rows[i]
        if row[n:].any():
            continue
        pool_idx[i] = lookup.get((k, row[:n].tobytes()), -1)
    offset = np.full(C, -1, np.int64)
    for c in np.unique(chan):
        votes = collections.Counter()
        for i in np.flatnonzero((chan == c) & (pool_idx >= 0)):
            slots = np.flatnonzero(order[c] == pool_idx[i])
            votes.update(((slots - place[i]) % R).tolist())
        if votes:
            offset[c] = votes.most_common(1)[0][0]
    expect = np.where(offset[chan] >= 0,
                      order[chan, (offset[chan] + place) % R], -1)
    wrong = (pool_idx < 0) | (pool_idx != expect)
    return wrong, offset
