"""ctypes bindings for the port's FLAC decoder (own copy of
``aasist_tpu/data/flac_native.py``).

The decoder is ``csrc/flac_decoder.cpp``, a byte-for-byte copy of the JAX
package's ``native/flac_decoder.cpp`` (a test keeps the two equal).  It is
host code: ``g++ -O2 -shared -fPIC`` builds it at first use into
``build/aasist_tpu_torch/`` beside the CUDA libraries, named by a hash of
the source and the flags, so an edited source is rebuilt.  A build or
decode failure raises ``FlacDecodeError``; there is no other decoder to
fall back to.

Waveforms come back in [-1, 1) with soundfile's int scaling
(value / 2**(bps-1)), what the reference's data layer saw.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

from aasist_tpu_torch.ops._build import BUILD_DIR, CSRC

SOURCE = CSRC / "flac_decoder.cpp"
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None


class FlacDecodeError(RuntimeError):
    pass


def _build() -> Path:
    """Compile the decoder unless a library of this source and these flags
    exists; returns its path."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libflacdec-{digest}.so"
    if out.exists():
        return out
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        res = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp),
                              str(SOURCE)], capture_output=True, text=True)
    except OSError as e:          # no g++, or an unwritable build directory
        raise FlacDecodeError(f"cannot build {SOURCE}: {e}") from e
    if res.returncode != 0:
        raise FlacDecodeError(f"g++ failed for {SOURCE}:\n"
                              f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)          # atomic: concurrent builders never see half
    return out


def _get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            outs = [ctypes.POINTER(ctypes.c_int64)] + \
                [ctypes.POINTER(ctypes.c_int32)] * 3 + \
                [ctypes.c_char_p, ctypes.c_int64]
            for suffix, sample in (("", ctypes.c_int32),
                                   ("_f32", ctypes.c_float)):
                samples = ctypes.POINTER(ctypes.POINTER(sample))
                for src, src_args in (
                        ("file", [ctypes.c_char_p]),
                        ("buffer", [ctypes.c_char_p, ctypes.c_int64])):
                    fn = getattr(lib, f"flac_decode_{src}{suffix}")
                    fn.restype = ctypes.c_int
                    fn.argtypes = [*src_args, samples, *outs]
                free = getattr(lib, f"flac_free{suffix}")
                free.restype = None
                free.argtypes = [ctypes.POINTER(sample)]
            _lib = lib
    return _lib


def _decode(fn: str, source: tuple, sample
            ) -> Tuple[np.ndarray, int, int, int]:
    """Call ``flac_decode_<fn>`` on ``source`` -> (interleaved samples,
    channels, bits per sample, sample rate)."""
    lib = _get_lib()
    suffix = "_f32" if sample is ctypes.c_float else ""
    samples_p = ctypes.POINTER(sample)()
    n_frames = ctypes.c_int64()
    sr, channels, bps = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    err = ctypes.create_string_buffer(128)
    rc = getattr(lib, f"flac_decode_{fn}{suffix}")(
        *source, ctypes.byref(samples_p), ctypes.byref(n_frames),
        ctypes.byref(sr), ctypes.byref(channels), ctypes.byref(bps),
        err, len(err))
    if rc != 0:
        raise FlacDecodeError(err.value.decode() or f"decode error {rc}")
    free = getattr(lib, f"flac_free{suffix}")
    try:
        arr = np.ctypeslib.as_array(
            samples_p, shape=(n_frames.value * channels.value,)).copy()
    finally:
        free(samples_p)
    return arr, channels.value, bps.value, sr.value


def _scaled(arr, channels, bps, sr) -> Tuple[np.ndarray, int]:
    x = arr.astype(np.float64) / float(1 << (bps - 1))
    if channels > 1:
        x = x.reshape(-1, channels)
    return x, sr


def read_flac(path) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file -> (float64 waveform, sample_rate)."""
    return _scaled(*_decode("file", (str(path).encode(),), ctypes.c_int32))


def read_flac_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode an in-memory FLAC stream -> (float64 waveform, sample_rate)."""
    return _scaled(*_decode("buffer", (data, len(data)), ctypes.c_int32))


def read_flac_f32(path) -> Tuple[np.ndarray, int]:
    """Decode to float32 in one native pass (the batcher's path).  For
    <= 24-bit PCM the conversion is exact, so the samples equal the float64
    path's cast to float32."""
    x, channels, _bps, sr = _decode("file", (str(path).encode(),),
                                    ctypes.c_float)
    if channels > 1:
        x = x.reshape(-1, channels)
    return x, sr
