"""ctypes binding for the port's native C++ audio library.

Counterpart of ``ser_tpu/_internal/utils/native_audio.py``. ``g++ -O3``
compiles ``ser_tpu_torch/native/seraudio.cpp`` at first use (never at import)
into ``build/native_audio/`` at the checkout root, named by a hash of the
source, so an edited source is rebuilt and an unchanged one reused; the
library is written under a temporary name and renamed, so processes that
build at once never load a half-written file. It exposes
:func:`decode_wav_mono_native` (WAV bytes → mono, peak-normalized float32) and
``ser_dtw_path`` (the word-timing DTW). Callers fall back to the numpy paths
when the toolchain or the build is unavailable, as in the JAX package; the
doctor's ``environment.native_audio`` finding says which one runs.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from hashlib import sha1
from pathlib import Path

import numpy as np

from ser_tpu_torch._internal.utils.logger import get_logger

logger = get_logger(__name__)

_SOURCE = Path(__file__).resolve().parents[2] / "native" / "seraudio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native_audio"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_failed = False

_ERROR_MESSAGES = {
    1: "Not a RIFF/WAVE file.",
    2: "WAV file missing fmt or data chunk.",
    3: "Unsupported WAV sample format.",
    4: "WAV file has invalid channel count or sample rate.",
    5: "Native decoder allocation failure.",
    6: "Audio file contains no samples.",
}


class NativeDecodeError(OSError):
    """Raised when the native decoder rejects a byte buffer."""


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    digest = sha1(_SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libseraudio-{digest}.so"


def _build_library() -> ctypes.CDLL | None:
    lib_path = library_path()
    if not lib_path.exists():
        compiler = shutil.which("g++")
        if compiler is None:
            logger.warning("Native audio build skipped: no g++ on PATH.")
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, staging = tempfile.mkstemp(prefix=".libseraudio-", suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            result = subprocess.run(
                [compiler, *GXX_FLAGS, str(_SOURCE), "-o", staging],
                capture_output=True,
                text=True,
                timeout=120,
            )
            if result.returncode != 0:
                logger.warning("Native audio build failed: %s", result.stderr.strip()[:400])
                return None
            os.replace(staging, lib_path)
        finally:
            Path(staging).unlink(missing_ok=True)
    library = ctypes.CDLL(str(lib_path))
    library.ser_decode_wav_mono.argtypes = [
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
    ]
    library.ser_decode_wav_mono.restype = ctypes.c_int
    library.ser_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    library.ser_free.restype = None
    library.ser_dtw_path.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
    ]
    library.ser_dtw_path.restype = ctypes.c_int
    return library


def get_native_library() -> ctypes.CDLL | None:
    """The loaded native library (builds on first use); None when unavailable."""
    return _lib if native_decoder_available() else None


def native_decoder_available() -> bool:
    """True when the native library is (or can be) built and loaded."""
    global _lib, _build_failed
    if _lib is not None:
        return True
    if _build_failed:
        return False
    with _lock:
        if _lib is None and not _build_failed:
            try:
                _lib = _build_library()
            except Exception as err:  # noqa: BLE001 - any build failure → fallback
                logger.warning("Native audio unavailable: %s", err)
                _lib = None
            if _lib is None:
                _build_failed = True
    return _lib is not None


def decode_wav_mono_native(data: bytes) -> tuple[np.ndarray, int]:
    """Decodes WAV bytes to (mono float32 peak-normalized samples, rate)."""
    if not native_decoder_available():
        raise NativeDecodeError("Native decoder not available.")
    assert _lib is not None
    samples_ptr = ctypes.POINTER(ctypes.c_float)()
    n_frames = ctypes.c_int64()
    rate = ctypes.c_int32()
    code = _lib.ser_decode_wav_mono(
        data, len(data), ctypes.byref(samples_ptr), ctypes.byref(n_frames), ctypes.byref(rate)
    )
    if code != 0:
        raise NativeDecodeError(_ERROR_MESSAGES.get(code, f"Native decode error {code}."))
    try:
        array = np.ctypeslib.as_array(samples_ptr, shape=(n_frames.value,)).copy()
    finally:
        _lib.ser_free(samples_ptr)
    return array, rate.value


__all__ = [
    "BUILD_DIR",
    "NativeDecodeError",
    "decode_wav_mono_native",
    "get_native_library",
    "library_path",
    "native_decoder_available",
]
