"""ctypes bindings for the native C++ batch loader (`native/dataloader.cpp`).

The counterpart of `conductor_tpu/data/native_loader.py` over the same C
API (`cdl_create` ... `cdl_next`, `native/dataloader.cpp:311-394`).
`NativeBatchIterator` keeps `BatchIterator`'s contract (len / iter / epoch
advance / (mel, motion, m_lens) numpy batches) but assembles batches in C++
worker threads over memory-mapped npy files, overlapping host IO with the
device's step.

The library is built with ``g++`` and the Makefile's flags into
``build/conductor_tpu_torch/`` in the checkout, under a digest of the
source and the flags, as `ops._build.library` keys the kernels: an edit of
the source rebuilds, an unchanged tree reuses the library, and ``native/``
is never written.  `make_batch_iterator` returns the native iterator where
the library builds and loads, the Python one otherwise, and says which by
the iterator's ``kind``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from ..ops._build import BUILD_DIR
from .dataset import BatchIterator, ConductorMotionDataset, host_rank
from .feature_cache import FeatureCachedDataset

SOURCE = Path(__file__).resolve().parents[2] / "native" / "dataloader.cpp"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]  # native/Makefile's
THREADS, PREFETCH = 4, 4  # worker threads, batches assembled ahead (JAX's defaults)


def library_path() -> Path:
    """Where the library built from ``SOURCE`` with ``CXX_FLAGS`` lives."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libconductor_data-{digest.hexdigest()[:16]}.so"


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the loader library; cached per process.
    Raises OSError, or RuntimeError with the compiler's output."""
    so = library_path()
    if not so.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found: the native loader cannot be built")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed:\n{(proc.stdout + proc.stderr)[-4000:]}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.cdl_create.restype = ctypes.c_void_p
    lib.cdl_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.cdl_destroy.argtypes = [ctypes.c_void_p]
    lib.cdl_destroy.restype = None
    lib.cdl_num_samples.argtypes = [ctypes.c_void_p]
    lib.cdl_num_samples.restype = ctypes.c_int
    lib.cdl_start_epoch.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.cdl_start_epoch.restype = None
    lib.cdl_num_batches.argtypes = [ctypes.c_void_p]
    lib.cdl_num_batches.restype = ctypes.c_int
    lib.cdl_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.cdl_next.restype = ctypes.c_int
    return lib


class NativeBatchIterator:
    """Drop-in counterpart of `BatchIterator` backed by the C++ loader.

    With ``host_shard`` (JAX's `native_loader.py:117-137`) ``batch_size``
    is the global batch, as the Python iterator's, and this process gets
    its contiguous rows of each; the C API takes the *local* batch (its
    global batch is ``batch_size * host_count``,
    `native/dataloader.cpp:137-141, 206-213, 319-327`), so ``batch_size``
    here becomes the local one.  The C side requires ``drop_last`` under
    sharding and slices its own permutation (not the Python iterator's)."""

    kind = "native"

    def __init__(
        self,
        dataset: ConductorMotionDataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        times: int = 1,
        host_shard: bool = False,
        process_index: int | None = None,
        process_count: int | None = None,
    ):
        lib = load_library()
        self.ds = dataset
        pidx, pcount = (host_rank(batch_size, process_index, process_count)
                        if host_shard else (0, 1))
        self.batch_size = batch_size // pcount  # the C side takes the local batch
        self.epoch = 0
        spec = dataset.spec
        # FeatureCachedDataset streams 30 Hz cached features as the
        # conditioning instead of 90 Hz mel: the same loader, another rate
        if isinstance(dataset, FeatureCachedDataset):
            cond_hz = spec.motion_hz
            cond_paths = [os.path.join(os.path.dirname(c.mel_path), dataset.feature_file)
                          for c in dataset.clips]
            width = np.load(cond_paths[0], mmap_mode="r").shape[-1]
        else:
            cond_hz = spec.mel_hz
            cond_paths = [c.mel_path for c in dataset.clips]
            width = spec.mel_bins
        self._mel_shape = (dataset.sample_length * cond_hz, width)
        self._mot_shape = (dataset.sample_length * spec.motion_hz, spec.n_joints, spec.joint_dim)
        paths = ctypes.c_char_p * len(cond_paths)
        self._lib = lib
        self._handle = lib.cdl_create(
            paths(*(p.encode() for p in cond_paths)),
            paths(*(c.motion_path.encode() for c in dataset.clips)), len(cond_paths),
            dataset.sample_length, self.batch_size,
            0 if dataset.mode == "sequential" else 1,
            1 if shuffle else 0, 1 if drop_last else 0, times,
            seed, THREADS, PREFETCH, cond_hz, pidx, pcount,
        )
        if not self._handle:
            raise RuntimeError("cdl_create failed (see stderr)")

    def __len__(self) -> int:
        # num_batches is epoch-independent; derive it without starting an epoch
        return self._lib.cdl_num_samples(self._handle) // self.batch_size

    def __iter__(self):
        lib, h = self._lib, self._handle
        lib.cdl_start_epoch(h, self.epoch)
        b = self.batch_size
        for _ in range(lib.cdl_num_batches(h)):
            mel = np.empty((b,) + self._mel_shape, np.float32)
            motion = np.empty((b,) + self._mot_shape, np.float32)
            m_lens = np.empty((b,), np.int32)
            count = lib.cdl_next(
                h,
                mel.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                motion.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                m_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
            if count == 0:
                break
            yield mel[:count], motion[:count], m_lens[:count]
        self.epoch += 1

    def close(self) -> None:
        """Stop the worker threads and unmap the files."""
        if getattr(self, "_handle", None):
            self._lib.cdl_destroy(self._handle)
            self._handle = None

    __del__ = close


def make_batch_iterator(dataset: ConductorMotionDataset, batch_size: int, *,
                        shuffle: bool = True, drop_last: bool = True, seed: int = 0,
                        times: int = 1, host_shard: bool = False,
                        process_index: int | None = None, process_count: int | None = None):
    """The native loader where it builds and loads, the Python iterator
    otherwise (JAX's rule, `conductor_tpu/data/native_loader.py:172-189`);
    the iterator's ``kind`` says which, and ``fallback_reason`` why the
    native one was not taken.  ``host_shard`` routes to either iterator's
    host sharding (``batch_size`` the global batch)."""
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=seed, times=times,
              host_shard=host_shard, process_index=process_index, process_count=process_count)
    try:
        return NativeBatchIterator(dataset, batch_size, **kw)
    except (OSError, RuntimeError) as e:
        it = BatchIterator(dataset, batch_size, **kw)
        it.fallback_reason = str(e).splitlines()[0]
        return it
