"""Binary vector-file IO, bit-compatible with the reference formats.

The reference (utils.h:85-127 in /root/reference) uses two on-disk layouts:

- **xvec** (``.bvecs``/``.fvecs``/``.ivecs``): every record is
  ``[uint32 dim | dim * sizeof(T) payload]``. ``readXvec`` validates that each
  record's dim prefix equals the expected d and exits on mismatch
  (utils.h:91-94); we raise ``ValueError`` instead.
- **length-prefixed vector** (``read_vector``/``write_vector``,
  utils.h:59-81): ``[uint32 count | count * sizeof(T) payload]`` — used inside
  the serialized index file.

All readers here are numpy-based and zero-copy where possible (memmap for
whole-file access, ``np.fromfile`` with offsets for streamed batches), because
host-side decode throughput matters at 10^9-vector scale.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

# Map file extension -> payload dtype, matching reference conventions.
XVEC_DTYPES = {
    ".bvecs": np.uint8,
    ".fvecs": np.float32,
    ".ivecs": np.int32,
}


def _xvec_dtype(d: int, dtype) -> np.dtype:
    """Structured dtype of one xvec record: [u32 dim | d payload elements]."""
    return np.dtype([("dim", "<u4"), ("vec", np.dtype(dtype), (d,))])


def infer_xvec_dim(path: str, dtype) -> int:
    """Read the first record's dim prefix."""
    with open(path, "rb") as f:
        raw = f.read(4)
    if len(raw) < 4:
        raise ValueError(f"{path}: too short for an xvec file")
    return int(np.frombuffer(raw, dtype="<u4")[0])


def xvec_count(path: str, d: int, dtype) -> int:
    """Number of records in an xvec file (validates the file size is an exact
    multiple of the record size, like base_vec_num at utils.cpp:204-220)."""
    rec = _xvec_dtype(d, dtype).itemsize
    size = os.path.getsize(path)
    if size % rec != 0:
        raise ValueError(f"{path}: size {size} not a multiple of record size {rec}")
    return size // rec


def read_xvec(path: str, d: int, n: int | None = None, offset: int = 0,
              dtype=None, mmap: bool = False) -> np.ndarray:
    """Read n records of dimension d starting at record `offset`.

    Equivalent of readXvec (utils.h:85-97). Returns [n, d] array of the
    payload dtype. dtype defaults by extension.
    """
    if dtype is None:
        dtype = XVEC_DTYPES[os.path.splitext(path)[1]]
    rec = _xvec_dtype(d, dtype)
    total = xvec_count(path, d, dtype)
    if n is None:
        n = total - offset
    if offset + n > total:
        raise ValueError(f"{path}: requested records [{offset}, {offset + n}) "
                         f"but file has {total}")
    if mmap:
        m = np.memmap(path, dtype=rec, mode="r", offset=offset * rec.itemsize,
                      shape=(n,))
        dims, vecs = m["dim"], m["vec"]
    else:
        with open(path, "rb") as f:
            f.seek(offset * rec.itemsize)
            data = np.fromfile(f, dtype=rec, count=n)
        dims, vecs = data["dim"], data["vec"]
    if n > 0 and not (dims == d).all():
        bad = int(np.argmax(dims != d))
        raise ValueError(f"{path}: record {offset + bad} has dim {dims[bad]}, expected {d}")
    return vecs


def read_xvec_fvec(path: str, d: int, n: int | None = None, offset: int = 0,
                   dtype=None) -> np.ndarray:
    """readXvecFvec equivalent (utils.h:112-127): read any xvec payload and
    promote to float32. Uses the native streaming decoder when built
    (native/ivfhnsw_native.cpp), falling back to numpy."""
    if dtype is None:
        dtype = XVEC_DTYPES[os.path.splitext(path)[1]]
    if n is None:
        n = xvec_count(path, d, dtype) - offset
    from ivfhnsw_tpu.utils import native
    out = native.xvec_read_f32(path, d, n, offset, dtype)
    if out is not None:
        return out
    return read_xvec(path, d, n, offset, dtype=dtype).astype(np.float32)


def write_xvec(path_or_file, data: np.ndarray, append: bool = False) -> None:
    """writeXvec equivalent (utils.h:100-109): write [n, d] array with a
    uint32 dim prefix per record."""
    data = np.ascontiguousarray(data)
    n, d = data.shape
    rec = np.empty(n, dtype=_xvec_dtype(d, data.dtype))
    rec["dim"] = d
    rec["vec"] = data
    if isinstance(path_or_file, (str, os.PathLike)):
        with open(path_or_file, "ab" if append else "wb") as f:
            rec.tofile(f)
    else:
        rec.tofile(path_or_file)


def iter_xvec_batches(path: str, d: int, batch: int, dtype=None,
                      limit: int | None = None) -> Iterator[np.ndarray]:
    """Stream an xvec file in batches of `batch` records (the add_batch loop
    pattern, test_ivfhnsw_sift1b.cpp:142-153)."""
    if dtype is None:
        dtype = XVEC_DTYPES[os.path.splitext(path)[1]]
    total = xvec_count(path, d, dtype)
    if limit is not None:
        total = min(total, limit)
    for off in range(0, total, batch):
        yield read_xvec(path, d, min(batch, total - off), off, dtype=dtype)


# ---------------------------------------------------------------------------
# Length-prefixed vectors (read_vector/write_vector, utils.h:59-81)
# ---------------------------------------------------------------------------

def write_len_vector(f, data: np.ndarray) -> None:
    """[uint32 count | payload]; count is the element count, not bytes."""
    data = np.ascontiguousarray(data)
    f.write(np.asarray([data.size], dtype="<u4").tobytes())
    f.write(data.tobytes())


_SERIES_SLAB: np.ndarray | None = None


def _series_slab() -> np.ndarray:
    """Process-wide reusable interleave scratch (~64 MB, touched once)."""
    global _SERIES_SLAB
    if _SERIES_SLAB is None:
        _SERIES_SLAB = np.empty(64 << 20, np.uint8)
    return _SERIES_SLAB


def read_file_u8(path: str) -> np.ndarray:
    """Whole-file byte view for the index parsers. mmap-backed: on this
    class of host np.fromfile moves ~45 MB/s while a read-only mapping
    serves page-cache-resident bytes at memory speed — and the parsers
    copy every payload they keep, so the mapping (held alive via the
    array's .base) never outlives a view of itself."""
    import mmap
    if os.path.getsize(path) == 0:
        return np.empty(0, np.uint8)
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, prot=mmap.PROT_READ)
    return np.frombuffer(mm, np.uint8)


def write_len_series(f, payload: np.ndarray, counts: np.ndarray) -> None:
    """Write a series of length-prefixed vectors ([u32 count | payload]*)
    from a FLAT payload array (records concatenated in order) and a per-
    record element-count array — the vectorized equivalent of calling
    write_len_vector once per record (the reference's write loop,
    IndexIVF_HNSW.cpp:643-654, runs 3*nc times; at nc=2^20 the per-call
    Python overhead dominates serialization). Uses the native single-pass
    interleaver when built; falls back to the per-record loop."""
    from ivfhnsw_tpu.utils import native
    flat = np.ascontiguousarray(payload).reshape(-1)
    counts = np.asarray(counts, np.int64)
    if native.available():
        # Stream through one reused ~64 MB slab: a fresh interleave buffer
        # the size of the section would pay first-touch page faults for
        # every byte (~10 s/GB on this VM class); the slab pays them once.
        esize = flat.dtype.itemsize
        slab = _series_slab()
        byte_cum = np.zeros(counts.size + 1, np.int64)
        np.cumsum(counts * esize + 4, out=byte_cum[1:])
        lo = 0
        while lo < counts.size:
            p_lo = (byte_cum[lo] - 4 * lo) // esize
            if byte_cum[lo + 1] - byte_cum[lo] > slab.size:
                # Record bigger than the slab: write prefix + payload
                # directly (no interleave copy needed for one record).
                write_len_vector(f, flat[p_lo:p_lo + int(counts[lo])])
                lo += 1
                continue
            hi = int(np.searchsorted(byte_cum, byte_cum[lo] + slab.size,
                                     side="right")) - 1
            p_hi = (byte_cum[hi] - 4 * hi) // esize
            chunk = native.lenvec_interleave(flat[p_lo:p_hi],
                                             counts[lo:hi], esize,
                                             out=slab)
            f.write(memoryview(chunk))
            lo = hi
        return
    pos = 0
    for c in counts:
        write_len_vector(f, flat[pos:pos + int(c)])
        pos += int(c)


def write_len_rows(f, rows: np.ndarray) -> None:
    """Write each row of a fixed-width 2-D array as a length-prefixed
    vector, vectorized: since every record has the same width, the
    interleaved stream is one [n, 4 + row_bytes] u8 array built with two
    numpy assignments (no native code, no per-row loop)."""
    rows = np.ascontiguousarray(rows)
    n, w = rows.shape[0], int(np.prod(rows.shape[1:]))
    row_bytes = w * rows.dtype.itemsize
    out = np.empty((n, 4 + row_bytes), np.uint8)
    out[:, :4] = np.full(n, w, "<u4")[:, None].view(np.uint8)
    out[:, 4:] = rows.reshape(n, -1).view(np.uint8)
    out.tofile(f)


def read_len_rows(buf: np.ndarray, pos: int, n: int, w: int,
                  dtype) -> tuple[np.ndarray, int]:
    """Parse n fixed-width length-prefixed records ([u32 w | w*dtype])
    from a u8 buffer in one reshape; returns ([n, w] array, end_pos).
    Validates every count prefix equals w."""
    dt = np.dtype(dtype)
    rec = 4 + w * dt.itemsize
    sect = buf[pos:pos + n * rec].reshape(n, rec)
    counts = sect[:, :4].copy().view("<u4")[:, 0]
    if not (counts == w).all():
        raise ValueError("fixed-width length-prefixed series has ragged "
                         "records")
    return sect[:, 4:].copy().view(dt).reshape(n, w), pos + n * rec


def read_len_vector(f, dtype) -> np.ndarray:
    count = int(np.frombuffer(f.read(4), dtype="<u4")[0])
    dt = np.dtype(dtype)
    return np.frombuffer(f.read(count * dt.itemsize), dtype=dt)


def write_variable(f, value, dtype) -> None:
    """write_variable equivalent (utils.h:69-71) — single POD value."""
    f.write(np.asarray([value], dtype=dtype).tobytes())


def read_variable(f, dtype):
    dt = np.dtype(dtype)
    return np.frombuffer(f.read(dt.itemsize), dtype=dt)[0]


# ---------------------------------------------------------------------------
# Random-access single-record reads (readBaseVec/readCentroidVec,
# utils.cpp:96-139) — used by the disk-rerank path.
# ---------------------------------------------------------------------------

class XvecFile:
    """Random-access view over an xvec file for exact-rerank gathers
    (searchDisk, IndexIVF_HNSW_Grouping.cpp:365-395)."""

    def __init__(self, path: str, d: int, dtype=None):
        self.path = path
        self.d = d
        self.dtype = XVEC_DTYPES[os.path.splitext(path)[1]] if dtype is None else dtype
        self._rec = _xvec_dtype(d, self.dtype)
        self.n = xvec_count(path, d, self.dtype)
        self._mm = np.memmap(path, dtype=self._rec, mode="r")

    def __len__(self) -> int:
        return self.n

    def gather(self, indices: np.ndarray) -> np.ndarray:
        """Fetch rows by id -> [len(indices), d] float32."""
        rows = self._mm["vec"][np.asarray(indices, dtype=np.int64)]
        return rows.astype(np.float32)


# ---------------------------------------------------------------------------
# Segment-file discovery for the incremental-add pipeline
# (get_files/check_files/get_index_name/base_vec_num, utils.cpp:204-276)
# ---------------------------------------------------------------------------

def base_vec_num(path: str, d: int, dtype=np.uint8) -> int:
    """Record count of an xvec file, validating exact record-size multiple
    (base_vec_num, utils.cpp:204-220)."""
    return xvec_count(path, d, dtype)


def get_files(path_dir: str, file_ext: str) -> list[str]:
    """Sorted filenames in path_dir whose name contains file_ext (and is not
    exactly file_ext) — get_files/is_ext_match semantics, utils.cpp:222-262."""
    out = [f for f in os.listdir(path_dir)
           if file_ext in f and f != file_ext]
    return sorted(out)


def check_files(file_prefix: str, file_list: list[str]) -> None:
    """Every file must start with file_prefix (check_files, utils.cpp:264-271)."""
    for f in file_list:
        if not f.startswith(file_prefix):
            raise ValueError(f"segment file {f!r} does not start with "
                             f"prefix {file_prefix!r}")


def get_index_name(path_idx: str, idx: int) -> str:
    """'{path}_NN.index' segment index naming (get_index_name, utils.cpp:273-275)."""
    return f"{path_idx}_{idx:02d}.index"


def prefetch(iterable, depth: int = 2):
    """Run a batch iterator in a background thread, keeping up to ``depth``
    items decoded ahead of the consumer.

    The reference's add loop is strictly sequential: read a 1M-vector batch
    from the .bvecs file, then encode it, then read the next
    (test_ivfhnsw_sift1b.cpp:125-162). On the accelerator the encode step runs on the
    device, so host file IO + xvec decode (native C decoder — the GIL is
    released for the duration of the call) can fully overlap with it; this
    wrapper is what the build drivers and ``StreamedIndexBuild`` consumers
    use to get that overlap. Exceptions in the producer propagate to the
    consumer at the point of the failed item; abandoning the generator
    (break / GC) stops the producer thread promptly.
    """
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    DONE = object()

    def put_stoppable(item) -> bool:
        """Stop-aware put; returns False if the consumer went away first
        (otherwise a full queue would pin this thread + its buffers forever)."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterable:
                if not put_stoppable(item):
                    return
            put_stoppable(DONE)
        except BaseException as e:  # forwarded, re-raised consumer-side
            put_stoppable(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def random_subset(data: np.ndarray, n_sub: int, seed: int = 1234) -> np.ndarray:
    """random_subset equivalent (utils.cpp:12-20): sample n_sub rows without
    replacement with a fixed default seed of 1234."""
    rng = np.random.RandomState(seed)
    idx = rng.permutation(data.shape[0])[:n_sub]
    return np.ascontiguousarray(data[idx])
