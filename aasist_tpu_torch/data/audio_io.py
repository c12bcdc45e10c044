"""Audio decoding (own copy of ``aasist_tpu/data/audio_io.py``).

  * ``.wav``  -- pure NumPy RIFF reader (PCM16/24/32 + float32),
  * ``.flac`` -- the port's native C++ decoder (``csrc/flac_decoder.cpp``,
    loaded through ctypes by ``data/flac_native.py``), covering the subset
    the ASVspoof2019 corpus uses (16-bit PCM, constant/verbatim/fixed/LPC
    subframes).

All readers return float64 waveforms in [-1, 1) with int PCM scaled by
2**(bits-1), soundfile's convention, so padded or cropped inputs equal the
reference pipeline's.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Tuple

import numpy as np


def read_wav(path) -> Tuple[np.ndarray, int]:
    """Minimal RIFF/WAVE reader: PCM 16/24/32-bit and IEEE float32 mono."""
    raw = Path(path).read_bytes()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(raw):
        cid = raw[pos:pos + 4]
        size = struct.unpack("<I", raw[pos + 4:pos + 8])[0]
        body = raw[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_fmt, channels, sr, _, _, bits = fmt
    if audio_fmt == 3 and bits == 32:
        x = np.frombuffer(data, "<f4").astype(np.float64)
    elif audio_fmt == 1 and bits == 16:
        x = np.frombuffer(data, "<i2").astype(np.float64) / 32768.0
    elif audio_fmt == 1 and bits == 32:
        x = np.frombuffer(data, "<i4").astype(np.float64) / 2147483648.0
    elif audio_fmt == 1 and bits == 24:
        b = np.frombuffer(data, np.uint8).reshape(-1, 3)
        x = (b[:, 0].astype(np.int32)
             | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float64)
        x /= float(1 << 23)
    else:
        raise ValueError(f"{path}: unsupported wav format {audio_fmt}/{bits}")
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return x, sr


def write_wav(path, x: np.ndarray, sr: int) -> None:
    """Write mono PCM16 WAV (fixture generation)."""
    pcm = np.clip(np.asarray(x, np.float64), -1.0, 1.0 - 1.0 / 32768)
    pcm = (pcm * 32768.0).astype("<i2").tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
    hdr += b"data" + struct.pack("<I", len(pcm))
    Path(path).write_bytes(hdr + pcm)


def read_flac(path) -> Tuple[np.ndarray, int]:
    """Decode FLAC through the port's native decoder."""
    from aasist_tpu_torch.data import flac_native
    return flac_native.read_flac(path)


def read_audio(path) -> Tuple[np.ndarray, int]:
    p = Path(path)
    if p.suffix.lower() == ".wav":
        return read_wav(p)
    if p.suffix.lower() == ".flac":
        return read_flac(p)
    raise ValueError(f"unsupported audio container: {p.suffix}")
