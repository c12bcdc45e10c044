"""Minimal pure-Python FLAC encoder.

Own copy of ``aasist_tpu/data/flac_encode.py``.

Purpose: produce genuine FLAC streams so the native C++ decoder
(``csrc/flac_decoder.cpp``) can be tested hermetically, with no reference FLAC
tooling.  Exercises the decoder's full surface:
CONSTANT / VERBATIM / FIXED(0-4) / LPC subframes, Rice residual coding
with partitions and escape codes, mono and stereo (independent or
mid-side), wasted-bit-free 16/24-bit PCM, CRC-8/CRC-16 framing.

This is an *encoder for tests*, not a compressor: predictor choice is by
exhaustive trial of the fixed orders (optionally a caller-forced mode),
Rice parameters are estimated per partition, and compression ratio is a
non-goal.  The output is spec-conformant FLAC.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, bits: int):
        if bits == 0:
            return
        value &= (1 << bits) - 1
        self.acc = (self.acc << bits) | value
        self.nbits += bits
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_signed(self, value: int, bits: int):
        self.write(value & ((1 << bits) - 1), bits)

    def write_unary(self, q: int):
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def align(self):
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def bytes(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.buf)


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 \
                else (crc << 1) & 0xFFFF
    return crc


def _utf8_number(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    out = []
    nbytes = 2
    while n >= (1 << (nbytes * 5 + 1)) and nbytes < 7:
        nbytes += 1
    lead_bits = 7 - nbytes
    shift = 6 * (nbytes - 1)
    lead = (0xFF << (lead_bits + 1)) & 0xFF | (n >> shift)
    out.append(lead)
    for i in range(nbytes - 1):
        shift -= 6
        out.append(0x80 | ((n >> shift) & 0x3F))
    return bytes(out)


_FIXED_COEF = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _fixed_residual(x: np.ndarray, order: int) -> np.ndarray:
    r = x.astype(np.int64)
    for _ in range(order):
        r = np.diff(r)
    return r


def _rice_cost(res: np.ndarray, param: int) -> int:
    u = (np.abs(2 * res) - (res < 0)).astype(np.int64)
    return int(np.sum(u >> param)) + len(res) * (param + 1)


def _best_rice_param(res: np.ndarray, max_param: int = 14) -> int:
    if len(res) == 0:
        return 0
    mean = float(np.mean(np.abs(res))) + 1e-9
    guess = max(0, min(max_param, int(np.log2(mean + 1)) ))
    best, best_cost = guess, _rice_cost(res, guess)
    for p in (guess - 1, guess + 1, guess + 2):
        if 0 <= p <= max_param:
            c = _rice_cost(res, p)
            if c < best_cost:
                best, best_cost = p, c
    return best


def _write_residual(bw: BitWriter, res: np.ndarray, order: int,
                    block_size: int, partition_order: int,
                    escape_partitions: bool = False):
    bw.write(0, 2)                      # method 0: 4-bit rice
    bw.write(partition_order, 4)
    nparts = 1 << partition_order
    idx = 0
    for p in range(nparts):
        count = (block_size >> partition_order) - (order if p == 0 else 0)
        part = res[idx:idx + count]
        idx += count
        if escape_partitions:
            nbits = int(max(2, int(np.max(np.abs(part))).bit_length() + 1)) \
                if len(part) else 2
            nbits = min(nbits, 30)
            bw.write(0xF, 4)            # escape
            bw.write(nbits, 5)
            for v in part:
                bw.write_signed(int(v), nbits)
        else:
            param = _best_rice_param(part)
            bw.write(param, 4)
            for v in part:
                # zigzag: non-negative -> even, negative -> odd
                u = 2 * int(v) if v >= 0 else -2 * int(v) - 1
                bw.write_unary(u >> param)
                bw.write(u & ((1 << param) - 1), param)


def _encode_subframe(bw: BitWriter, x: np.ndarray, bps: int,
                     mode: Optional[str], partition_order: int,
                     escape_partitions: bool):
    block_size = len(x)
    if mode is None:
        if np.all(x == x[0]):
            mode = "constant"
        else:
            mode = "fixed"
    bw.write(0, 1)                      # padding
    if mode == "constant":
        bw.write(0, 6)
        bw.write(0, 1)                  # no wasted bits
        bw.write_signed(int(x[0]), bps)
        return
    if mode == "verbatim":
        bw.write(1, 6)
        bw.write(0, 1)
        for v in x:
            bw.write_signed(int(v), bps)
        return
    if mode == "fixed":
        costs = {}
        for order in range(5):
            if order >= block_size:
                break
            r = _fixed_residual(x, order)
            costs[order] = int(np.sum(np.abs(r))) if len(r) else 0
        order = min(costs, key=costs.get)
        res = _fixed_residual(x, order)
        bw.write(8 + order, 6)
        bw.write(0, 1)
        for i in range(order):
            bw.write_signed(int(x[i]), bps)
        _write_residual(bw, res, order, block_size, partition_order,
                        escape_partitions)
        return
    if mode == "lpc2":
        # order-2 LPC with coefficients [2, -1] at shift 0 (mirrors the
        # fixed order-2 predictor, but through the LPC decode path)
        order, precision, shift = 2, 4, 0
        coef = [2, -1]
        res = np.empty(block_size - order, np.int64)
        xi = x.astype(np.int64)
        for i in range(order, block_size):
            pred = sum(c * xi[i - 1 - j] for j, c in enumerate(coef))
            res[i - order] = xi[i] - (pred >> shift)
        bw.write(32 + (order - 1), 6)
        bw.write(0, 1)
        for i in range(order):
            bw.write_signed(int(x[i]), bps)
        bw.write(precision - 1, 4)
        bw.write_signed(shift, 5)
        for c in coef:
            bw.write_signed(c, precision)
        _write_residual(bw, res, order, block_size, partition_order,
                        escape_partitions)
        return
    raise ValueError(f"unknown subframe mode {mode!r}")


def encode(x: np.ndarray, sample_rate: int = 16000, bps: int = 16,
           block_size: int = 4096, subframe_mode: Optional[str] = None,
           partition_order: int = 0, mid_side: bool = False,
           escape_partitions: bool = False) -> bytes:
    """Encode int PCM (n,) mono or (n, 2) stereo into a FLAC stream."""
    x = np.asarray(x)
    if x.ndim == 1:
        channels = 1
        total = len(x)
        chan_data = [x.astype(np.int64)]
    else:
        channels = x.shape[1]
        assert channels == 2, "only mono or stereo supported"
        total = x.shape[0]
        chan_data = [x[:, 0].astype(np.int64), x[:, 1].astype(np.int64)]

    out = bytearray(b"fLaC")
    # STREAMINFO (last metadata block)
    si = BitWriter()
    si.write(block_size, 16)            # min block size
    si.write(block_size, 16)            # max block size
    si.write(0, 24)                     # min frame size (unknown)
    si.write(0, 24)                     # max frame size (unknown)
    si.write(sample_rate, 20)
    si.write(channels - 1, 3)
    si.write(bps - 1, 5)
    si.write(total, 36)
    si.write(0, 64)                     # md5 (unset)
    si.write(0, 64)
    si_bytes = si.bytes()
    assert len(si_bytes) == 34
    out += bytes([0x80]) + len(si_bytes).to_bytes(3, "big") + si_bytes

    frame_no = 0
    pos = 0
    while pos < total:
        n = min(block_size, total - pos)
        bw = BitWriter()
        bw.write(0x3FFE, 14)            # sync
        bw.write(0, 1)                  # reserved
        bw.write(0, 1)                  # fixed blocksize strategy
        if n == block_size and block_size in (192, 576, 1152, 2304, 4608,
                                              256, 512, 1024, 2048, 4096,
                                              8192, 16384, 32768):
            if block_size == 192:
                bs_code = 1
            elif block_size in (576, 1152, 2304, 4608):
                bs_code = 2 + int(np.log2(block_size // 576))
            else:
                bs_code = 8 + int(np.log2(block_size // 256))
            bs_follow = None
        else:
            bs_code, bs_follow = 7, n - 1
        bw.write(bs_code, 4)
        bw.write(0, 4)                  # sample rate: from STREAMINFO
        if channels == 2 and mid_side:
            ch_assign = 10
        else:
            ch_assign = channels - 1
        bw.write(ch_assign, 4)
        ss_code = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}[bps]
        bw.write(ss_code, 3)
        bw.write(0, 1)                  # reserved
        for b in _utf8_number(frame_no):
            bw.write(b, 8)
        if bs_follow is not None:
            bw.write(bs_follow, 16)
        bw.align()
        header = bytes(bw.buf)
        bw.write(_crc8(header), 8)

        if ch_assign == 10:
            left = chan_data[0][pos:pos + n]
            right = chan_data[1][pos:pos + n]
            mid = (left + right) >> 1
            side = left - right
            subs = [(mid, bps), (side, bps + 1)]
        else:
            subs = [(cd[pos:pos + n], bps) for cd in chan_data]
        for sub, sub_bps in subs:
            _encode_subframe(bw, sub, sub_bps, subframe_mode,
                             partition_order, escape_partitions)
        bw.align()
        body = bytes(bw.buf)
        bw.write(_crc16(body), 16)
        out += bw.bytes()
        pos += n
        frame_no += 1
    return bytes(out)


def write_flac(path, x: np.ndarray, sample_rate: int = 16000,
               bps: int = 16, **kwargs) -> None:
    from pathlib import Path
    Path(path).write_bytes(encode(x, sample_rate, bps, **kwargs))
