"""Memory-mapped token dataset (the offline data-efficiency storage tier).

Port of ``deepspeed_tpu/runtime/data_pipeline/data_sampling/indexed_dataset.py``:
the same on-disk format, byte for byte, so either package reads the other's
files.
Reference: ``deepspeed/runtime/data_pipeline/data_sampling/indexed_dataset.py``
(617 LoC; MMapIndexedDataset:341 + builders — itself Megatron-LM's format):
a ``.bin`` of contiguous token payloads plus a ``.idx`` carrying dtype code,
per-sample sizes and byte offsets; reads are zero-copy views into one
``np.memmap``, so a billion-token corpus costs no resident RAM.

Formulation: numpy-native (samples feed host batching; the engine moves
the collated batch to its device). The format is
self-describing (magic + version + dtype code), random-access by sample id,
and append-only buildable so analyzers/tokenizers can stream corpora through.
"""

import os
import struct
from typing import Iterable

import numpy as np

_MAGIC = b"DSTPUIDX"
_VERSION = 1

_DTYPES = {1: np.uint8, 2: np.int8, 3: np.int16, 4: np.int32, 5: np.int64,
           6: np.float32, 7: np.float64, 8: np.uint16, 9: np.uint32}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def data_file_path(prefix):
    return f"{prefix}.bin"


def index_file_path(prefix):
    return f"{prefix}.idx"


class MMapIndexedDatasetBuilder:
    """Append samples; ``finalize()`` writes the index."""

    def __init__(self, prefix: str, dtype=np.int32):
        self._prefix = prefix
        self._dtype = np.dtype(dtype)
        if self._dtype not in _CODES:
            raise ValueError(f"unsupported dtype {dtype}")
        self._data = open(data_file_path(prefix), "wb")
        self._sizes = []

    def add_item(self, tokens) -> None:
        arr = np.asarray(tokens, dtype=self._dtype)
        assert arr.ndim == 1, "samples are 1-D token arrays"
        self._data.write(arr.tobytes(order="C"))
        self._sizes.append(arr.size)

    def add_items(self, samples: Iterable) -> None:
        for s in samples:
            self.add_item(s)

    def merge_file(self, other_prefix: str) -> None:
        """Append another built dataset (reference builder.merge_file_ — the
        multi-worker reduce step concatenates shard outputs)."""
        other = MMapIndexedDataset(other_prefix)
        assert other.dtype == self._dtype
        with open(data_file_path(other_prefix), "rb") as f:
            while chunk := f.read(1 << 24):
                self._data.write(chunk)
        self._sizes.extend(int(s) for s in other.sizes)

    def finalize(self) -> None:
        self._data.close()
        sizes = np.asarray(self._sizes, np.int64)
        offsets = np.zeros(len(sizes) + 1, np.int64)
        np.cumsum(sizes * self._dtype.itemsize, out=offsets[1:])
        with open(index_file_path(self._prefix), "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<QBQ", _VERSION, _CODES[self._dtype], len(sizes)))
            f.write(sizes.tobytes())
            f.write(offsets.tobytes())


class MMapIndexedDataset:
    """Random-access reader; ``ds[i]`` is a zero-copy memmap view."""

    def __init__(self, prefix: str):
        self._prefix = prefix
        with open(index_file_path(prefix), "rb") as f:
            magic = f.read(len(_MAGIC))
            if magic != _MAGIC:
                raise ValueError(f"{index_file_path(prefix)}: bad magic {magic!r}")
            version, code, n = struct.unpack("<QBQ", f.read(17))
            if version != _VERSION:
                raise ValueError(f"unsupported index version {version}")
            self.dtype = np.dtype(_DTYPES[code])
            self.sizes = np.frombuffer(f.read(8 * n), np.int64)
            self._offsets = np.frombuffer(f.read(8 * (n + 1)), np.int64)
        self._mmap = np.memmap(data_file_path(prefix), dtype=np.uint8, mode="r")

    def __len__(self):
        return len(self.sizes)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        start, end = self._offsets[i], self._offsets[i + 1]
        return self._mmap[start:end].view(self.dtype)

    def num_tokens(self, i) -> int:
        return int(self.sizes[i])

    @staticmethod
    def exists(prefix) -> bool:
        return os.path.exists(index_file_path(prefix)) and os.path.exists(data_file_path(prefix))
