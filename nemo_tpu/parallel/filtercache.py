"""Device-resident filter cache + background cache-file writer.

The reference caches each built filter to
``diagnostics/<tile>/filter_<label>#<tile>.fits`` and reloads it for fitQ,
injection sims and forced photometry (``filters.py:154,536,691-696``).
That disk round trip is two host-device transfers: the batched engine
downloads every built filter (~10 MB/tile) to write the FITS, and fitQ
re-uploads the same bytes one tile later - at DR5 scale (282 tiles x 2
freq) several GB each way.

This module keeps the reference-filter (photFilter) arrays RESIDENT on the
devices between the filtering and Q-fit phases, and moves the FITS cache
write off the critical path into a daemon writer thread (the link is idle
while the main thread paints/filters, so the downloads overlap real work).
Readers that miss the device cache call :func:`ensure_written` first, so
the file-based idempotency contract of the reference is preserved.
"""

import atexit
import os
import queue
import threading

import numpy as np

_GiB = 1024 ** 3


class DeviceFilterCache:
    """Byte-budgeted map of filterFileName -> device filter + metadata.

    Entries hold the engine's device-resident Fourier filter (float32,
    padded half-grid layout - exactly what ``MapFilter._deviceFilt``
    would upload) plus the host-side scalars ``loadFilter`` reads from
    the FITS header (signalNorm, fRelWeights).
    """

    def __init__(self, maxBytes=None):
        self._entries = {}
        self._bytes = 0
        self._maxBytes = maxBytes
        self._lock = threading.Lock()

    def _budget(self):
        if self._maxBytes is not None:
            return self._maxBytes
        import jax
        limit = None
        try:
            stats = jax.devices()[0].memory_stats()
            if stats:
                limit = stats.get("bytes_limit")
        except Exception:
            limit = None
        # A quarter of device memory, capped at 4 GiB.  (A smaller cap
        # spills filters through the background writer DURING
        # filtering; the fitQ pressure is handled instead by
        # filtercache.release() retiring each tile's filter right after
        # fitQ consumes it.)  Generous
        # fallback on hosts that don't report a limit (CPU tests -
        # entries there are small).
        self._maxBytes = min(limit // 4, 4 * _GiB) if limit else 4 * _GiB
        return self._maxBytes

    def put(self, fileName, filtDev, signalNorm, fRelWeights):
        nbytes = int(np.prod(filtDev.shape)) * filtDev.dtype.itemsize
        with self._lock:
            if fileName in self._entries:
                self._bytes -= self._entries.pop(fileName)["nbytes"]
            if self._bytes + nbytes > self._budget():
                return False
            self._entries[fileName] = {
                "filt": filtDev, "signalNorm": float(signalNorm),
                "fRelWeights": dict(fRelWeights), "nbytes": nbytes}
            self._bytes += nbytes
            return True

    def get(self, fileName):
        with self._lock:
            return self._entries.get(fileName)

    def pop(self, fileName):
        with self._lock:
            ent = self._entries.pop(fileName, None)
            if ent is not None:
                self._bytes -= ent["nbytes"]
            return ent

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._bytes = 0


class BackgroundFITSWriter:
    """Daemon thread draining (fileName, array, header) FITS writes.

    ``np.asarray`` on a device array blocks on the device->host transfer;
    doing it here overlaps that transfer (and the disk write) with the
    main thread's staging/compute.  ``ensure_written`` lets a reader
    block until a specific file has landed; ``flush`` drains everything.
    Write errors are re-raised on the next flush/ensure call rather than
    lost in the thread.
    """

    def __init__(self, maxQueued=16):
        # Bounded: each queued item pins a ~10 MB device buffer
        # until its download+write completes; with saveFilter on every
        # scale of a DR5-sized bank an unbounded backlog could pin tens
        # of GB.  enqueue blocks when the writer falls behind - that is
        # the old synchronous behaviour, just rate-limited.
        self._q = queue.Queue(maxsize=maxQueued)
        self._pending = set()
        self._done = threading.Condition()
        self._errors = {}           # fileName -> exception
        self._thread = None

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    def _run(self):
        from ..utils import fits as nfits
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            fileName, data, header = item
            try:
                data = np.asarray(data)
                os.makedirs(os.path.dirname(fileName), exist_ok=True)
                nfits.write_image(fileName, data, header)
            except BaseException as exc:      # surfaced per file
                self._errors[fileName] = exc
            finally:
                with self._done:
                    self._pending.discard(fileName)
                    self._done.notify_all()
                self._q.task_done()

    def enqueue(self, fileName, data, header):
        with self._done:
            self._pending.add(fileName)
        self._ensure_thread()
        self._q.put((fileName, data, header))

    def ensure_written(self, fileName):
        """Block until fileName's pending write (if any) completes.
        Raises only for THIS file's write failure: a reader must never
        fall back to a silent rebuild because some other file's write
        failed (nor see another file's error charged to this one)."""
        with self._done:
            while fileName in self._pending:
                self._done.wait(timeout=60)
        exc = self._errors.pop(fileName, None)
        if exc is not None:
            raise RuntimeError("background filter-cache write of %s "
                               "failed" % fileName) from exc

    def flush(self, timeout=None):
        """Drain all pending writes.  ``timeout`` (seconds) bounds the
        wait - the atexit hook uses it so a dead device link (downloads
        hang) cannot stop the interpreter from exiting; unpersisted
        files are reported instead."""
        if self._thread is None:
            return
        if timeout is not None:
            import time
            end = time.time() + timeout
            with self._done:
                while self._pending and time.time() < end:
                    self._done.wait(timeout=5)
                if self._pending:
                    print("... WARNING: %d filter-cache write(s) still "
                          "pending at exit (device link stalled?): %s"
                          % (len(self._pending),
                             sorted(self._pending)[:3]))
                    return
        else:
            self._q.join()
        if self._errors:
            fileName, exc = next(iter(self._errors.items()))
            self._errors.pop(fileName)
            raise RuntimeError(
                "background filter-cache write of %s failed (%d write "
                "error(s) total)" % (fileName, 1 + len(self._errors))) \
                from exc


DEVICE_CACHE = DeviceFilterCache()
WRITER = BackgroundFITSWriter()

# Filters whose cache-FITS materialisation is DEFERRED: the device
# buffer + header are held here and the ~10 MB/tile download happens
# only if something actually needs the file (ensure_written) or at the
# bounded exit flush.  At DR5 scale eager background writes would move
# ~2.5 GB to the host DURING the filtering phase, competing with the
# foreground uploads/downloads; almost none of those files are ever read
# back in-process (fitQ and getFRelWeights hit the DEVICE_CACHE).
# Deferral is only registered for filters that made it into the
# byte-budgeted DEVICE_CACHE, so the device memory pinned by deferred
# buffers stays inside the cache budget.
_DEFERRED = {}
_DEF_LOCK = threading.Lock()


def register_deferred(fileName, filtDev, header):
    with _DEF_LOCK:
        _DEFERRED[fileName] = (filtDev, header)


def _materialize(fileName):
    """Move a deferred entry into the background writer (download +
    FITS write happen on the writer thread)."""
    with _DEF_LOCK:
        item = _DEFERRED.pop(fileName, None)
    if item is None:
        return False
    WRITER.enqueue(fileName, item[0], item[1])
    return True


def deferred_count():
    with _DEF_LOCK:
        return len(_DEFERRED)


def ensure_written(fileName):
    _materialize(fileName)
    WRITER.ensure_written(fileName)


def release(fileName):
    """Progressively retire a device-resident filter once its LAST
    in-process consumer is done with it (fitQ releases each tile's
    reference filter after measuring Q): the deferred FITS write is
    queued on the background writer and the device copy is dropped, so the
    resident-cache pressure falls tile by tile instead of pinning ~GBs
    until exit.  Later readers (injection reruns) reload the FITS."""
    _materialize(fileName)
    DEVICE_CACHE.pop(fileName)


def flush(timeout=None, materialize_deferred=False):
    """Drain in-flight writes.  ``materialize_deferred`` additionally
    turns every deferred filter into a real file (the exit hook uses it
    so a later process can reload the caches without a rebuild; the
    timeout bounds the downloads on a dead link)."""
    if materialize_deferred:
        with _DEF_LOCK:
            names = list(_DEFERRED)
        for name in names:
            _materialize(name)
    WRITER.flush(timeout=timeout)


atexit.register(lambda: flush(timeout=120, materialize_deferred=True))
