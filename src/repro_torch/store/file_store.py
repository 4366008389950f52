"""FileNeuronStore — the NeuronStore contract served from a NeuronPack file
with REAL positional reads.

Drop-in for `repro_torch.core.storage.NeuronStore` everywhere the engine and the
serving runtime touch a store (`read` / `fetch` / `fetch_into` /
`plan_extents` / `physical_payload`), with two differences:

  * every collapsed extent the read planner produces becomes ONE real
    positional file read (`os.pread` on a raw fd; mmap slice fallback where
    pread is unavailable) against the pack's physical-order bundle region —
    the extent plan is no longer only an accounting fiction;
  * dual accounting: the calibrated `UFSDevice` model fields of `IOStats`
    are computed by exactly the same code path as the in-memory store (so
    every stats-identity test keeps meaning), while the new `measured_ops` /
    `measured_bytes` / `measured_seconds` fields record what the filesystem
    actually did.

DRAM-side access (`fetch` / `fetch_into` — cache hits and bytes the engine
just read) is served from a lazy mmap of the bundle region: the page cache
plays the role of DRAM residency, and the preceding extent `pread`s warm it,
which is the honest analogue of "the engine computes with the very bytes it
read". int8 packs serve rows dtype-faithfully: every payload surface routes
through one `payload_dtype`-aware accessor (`_as_payload` / `_gather_into`)
that passes raw int8 through untouched when the consumer asks for the stored
dtype (the fused segment kernel and dtype-faithful staging ring) and only
dequantizes (scales indexed in physical order) when the consumer actually
needs float32.
"""
from __future__ import annotations

import itertools
import os
import time
import zlib
from typing import List, Optional, Tuple, Union

import numpy as np

from repro_torch.core.collapse import Extent
from repro_torch.core.storage import IOStats, NeuronStore, UFSDevice
from repro_torch.obs import get_tracer
from repro_torch.store.faults import (CorruptExtentError, FatalFault, FaultPlan,
                                RetryPolicy, TransientIOError, is_retryable)
from repro_torch.store.format import NeuronPack, dequantize_int8

_HAS_PREAD = hasattr(os, "pread")


class _ChecksumMismatch(Exception):
    """Internal: an extent's payload failed per-bundle CRC verification.
    Converted to a retry (transient corruption: a re-read serves clean
    bytes) or, once the budget is exhausted, to `CorruptExtentError`."""


class FileNeuronStore(NeuronStore):
    """One layer of a NeuronPack served as a placement-aware neuron store."""

    def __init__(
        self,
        pack: Union[str, os.PathLike, NeuronPack],
        layer: int = 0,
        device: Optional[UFSDevice] = None,
        reads_per_bundle: int = 1,
        bundle_bytes: Optional[int] = None,
        use_pread: bool = True,
        *,
        retry: Optional[RetryPolicy] = None,
        verify_checksums: bool = False,
        fault_plan: Optional[FaultPlan] = None,
    ) -> None:
        """`retry` bounds how many times a transient extent-read failure
        (retryable OSError, or a CRC mismatch under `verify_checksums`) is
        re-read with exponential backoff before propagating.
        `verify_checksums=True` checks every extent's bundles against the
        pack's per-bundle CRC32 table after each read (v2 packs only) —
        a detected corrupt read costs one `IOStats.corrupt_extents` and a
        re-read, never silent corruption. `fault_plan` injects a
        deterministic fault schedule BELOW the retry layer (see
        `repro_torch.store.faults`): the recoverable-chaos test hook."""
        # no super().__init__: the payload is the FILE, not a passed array.
        # Modeled accounting defaults to the pack's stored row bytes, so an
        # int8 pack is billed int8 bytes by the device model too.
        pack = NeuronPack.open(pack)
        if not 0 <= layer < pack.n_layers:
            raise ValueError(f"layer {layer} out of range for "
                             f"{pack.n_layers}-layer pack {pack.path}")
        self.pack = pack
        self.layer_index = layer
        self.n_neurons = pack.n_neurons
        self.bundle_width = pack.bundle_width
        self.placement = pack.placement(layer)
        self.device = device or UFSDevice()
        self.reads_per_bundle = reads_per_bundle
        self.quantized = pack.quantized
        self.bundle_bytes = (int(bundle_bytes) if bundle_bytes
                             else pack.row_bytes)
        self._row_bytes = pack.row_bytes          # real on-disk stride
        self._stored_dtype = pack.dtype
        self._bundles_at = pack.bundles_file_offset(layer)
        self._scales = pack.scales(layer)         # physical order, or None
        self._phys_data = pack.bundles_memmap(layer)   # raw-dtype page view
        self._fd = (os.open(pack.path, os.O_RDONLY)
                    if use_pread and _HAS_PREAD else None)
        self.retry = retry or RetryPolicy()
        self.verify_checksums = verify_checksums
        self.fault_plan = fault_plan
        self._read_counter = itertools.count()   # logical extent reads served
        self._row_crcs = None
        if verify_checksums:
            crcs = pack.row_crcs(layer)
            if crcs is None:
                raise ValueError(
                    f"{pack.path}: verify_checksums=True needs a v2 pack "
                    f"with per-bundle CRC tables (this pack is version "
                    f"{pack.version}); rebuild it with "
                    f"write_pack(..., version=2)")
            self._row_crcs = crcs

    # -- lifecycle -----------------------------------------------------------
    @property
    def closed(self) -> bool:
        return getattr(self, "_phys_data", None) is None

    def close(self) -> None:
        """Release the fd and the bundle-region memmap reference. Safe to
        call more than once; payload arrays already handed out keep their
        own reference to the mapping and stay valid."""
        if getattr(self, "_fd", None) is not None:
            os.close(self._fd)
            self._fd = None
        self._phys_data = None

    def __del__(self) -> None:  # fd hygiene; mmap closes with the array
        try:
            self.close()
        except Exception:       # noqa: BLE001 — interpreter teardown
            pass

    def __enter__(self) -> "FileNeuronStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- payload surface -----------------------------------------------------
    @property
    def payload_dtype(self) -> np.dtype:
        # the dtype `fetch` serves when the caller doesn't say otherwise;
        # kept float32 for quantized packs so legacy consumers that allocate
        # from payload_dtype keep receiving dequantized rows.
        return np.dtype(np.float32) if self.quantized else self._stored_dtype

    @property
    def stored_dtype(self) -> np.dtype:
        return self._stored_dtype

    def _as_payload(self, raw: np.ndarray, phys: Optional[np.ndarray],
                    dtype: np.dtype) -> np.ndarray:
        """Serve raw stored rows (gathered at physical positions `phys`;
        None = full physical order) at the consumer's dtype. Raw dtype passes
        through untouched; float32 out of an int8 pack dequantizes — the ONLY
        place this store turns quantized rows into floats."""
        dtype = np.dtype(dtype)
        if dtype == self._stored_dtype:
            return np.asarray(raw)
        if self.quantized and dtype == np.float32:
            scales = self._scales if phys is None else self._scales[phys]
            return dequantize_int8(np.asarray(raw), scales)
        raise ValueError(f"cannot serve {self._stored_dtype} payload as {dtype}")

    def _gather_into(self, phys: np.ndarray, out: np.ndarray) -> None:
        """`_as_payload` twin that fills a caller buffer (no allocation),
        dispatching on out.dtype: stored-dtype buffers take the raw rows
        (int8 stays int8 end-to-end), float32 buffers get the fused
        gather-dequant."""
        if out.dtype == self._stored_dtype:
            np.take(self._phys_data, phys, axis=0, out=out)
        elif self.quantized and out.dtype == np.float32:
            np.multiply(self._phys_data[phys].astype(np.float32),
                        self._scales[phys][:, None], out=out)
        else:
            raise ValueError(f"cannot serve {self._stored_dtype} payload "
                             f"into a {out.dtype} buffer")

    def physical_payload(self, dequantize: bool = True) -> np.ndarray:
        dtype = (np.float32 if self.quantized and dequantize
                 else self._stored_dtype)
        return self._as_payload(self._phys_data, None, dtype)

    def physical_scales(self) -> Optional[np.ndarray]:
        return self._scales

    def fetch(self, logical_ids: np.ndarray) -> np.ndarray:
        logical_ids = np.asarray(logical_ids, dtype=np.int64)
        if logical_ids.size == 0:
            return np.zeros((0, self.bundle_width), dtype=self.payload_dtype)
        phys = self.placement.physical_of(logical_ids)
        return self._as_payload(self._phys_data[phys], phys, self.payload_dtype)

    def fetch_into(self, logical_ids: np.ndarray, out: np.ndarray) -> np.ndarray:
        logical_ids = np.asarray(logical_ids, dtype=np.int64)
        k = logical_ids.size
        if k:
            phys = self.placement.physical_of(logical_ids)
            self._gather_into(phys, out[:k])
        return out

    def fetch_scales_into(self, logical_ids: np.ndarray, out: np.ndarray) -> np.ndarray:
        logical_ids = np.asarray(logical_ids, dtype=np.int64)
        k = logical_ids.size
        if k:
            if self._scales is None:
                raise RuntimeError("store is not quantized: no scales to fetch")
            out[:k] = self._scales[self.placement.physical_of(logical_ids)]
        return out

    # -- real extent reads ---------------------------------------------------
    def _read_extent_attempt(self, start: int, length: int,
                             read_index: int, attempt: int) -> bytes:
        """One attempt at one positional read of `length` contiguous
        bundles, as raw bytes. The fault plan (when armed) injects its
        scheduled misbehaviour HERE — below the retry loop, at the point a
        real device would fail."""
        if self.closed:
            raise ValueError(f"store for layer {self.layer_index} of "
                             f"{self.pack.path} is closed")
        events = (self.fault_plan.active(read_index, attempt)
                  if self.fault_plan is not None else ())
        inject_short = inject_corrupt = False
        for ev in events:
            if ev.kind == "latency":
                time.sleep(ev.delay_s)
            elif ev.kind == "transient":
                raise TransientIOError(
                    f"injected transient read error (read {read_index}, "
                    f"attempt {attempt}) at extent {start}+{length} of "
                    f"{self.pack.path}")
            elif ev.kind == "fatal":
                raise FatalFault(f"injected fatal fault at read "
                                 f"{read_index} of {self.pack.path}")
            elif ev.kind == "short_read":
                inject_short = True
            elif ev.kind == "corrupt":
                inject_corrupt = True
        if self._fd is not None:
            want = length * self._row_bytes
            off = self._bundles_at + start * self._row_bytes
            chunks = []
            first = True
            while want:
                chunk = os.pread(self._fd, want, off)
                if first and inject_short and len(chunk) > 1:
                    # truncate the first chunk so the continuation loop has
                    # to make follow-up preads for the remainder
                    chunk = chunk[:(len(chunk) + 1) // 2]
                first = False
                if not chunk:
                    raise IOError(f"short read at offset {off} of "
                                  f"{self.pack.path} (extent {start}"
                                  f"+{length})")
                chunks.append(chunk)
                off += len(chunk)
                want -= len(chunk)
            buf = chunks[0] if len(chunks) == 1 else b"".join(chunks)
        else:
            # mmap fallback: still a positional slice copy of the same bytes
            buf = self._phys_data[start:start + length].tobytes()
        if inject_corrupt:
            damaged = bytearray(buf)
            self.fault_plan.corrupt_payload(damaged, read_index)
            buf = bytes(damaged)
        return buf

    def _verify_extent(self, buf: bytes, start: int, length: int,
                       read_index: int) -> None:
        """Check every bundle of the extent against the pack's per-row
        CRC32 table (physical row p at table index p)."""
        rb = self._row_bytes
        crcs = self._row_crcs
        view = memoryview(buf)
        for i in range(length):
            if zlib.crc32(view[i * rb:(i + 1) * rb]) != int(crcs[start + i]):
                raise _ChecksumMismatch(
                    f"CRC mismatch at physical bundle {start + i} (extent "
                    f"{start}+{length}, read {read_index}) of "
                    f"{self.pack.path}")

    def _read_extent(self, start: int, length: int,
                     stats: Optional[IOStats] = None) -> np.ndarray:
        """One logical positional read of `length` physically-contiguous
        bundles: bounded-backoff retry for transient failures, optional
        per-bundle CRC verification with re-read on detected corruption.
        Retries and detections are recorded on `stats`; the logical read
        index advances once per call, never per attempt, so fault schedules
        address reads regardless of how many retries earlier faults cost.
        """
        read_index = next(self._read_counter)
        policy = self.retry
        attempt = 0
        while True:
            try:
                buf = self._read_extent_attempt(start, length, read_index,
                                                attempt)
                if self._row_crcs is not None:
                    self._verify_extent(buf, start, length, read_index)
                return np.frombuffer(buf, dtype=self._stored_dtype).reshape(
                    length, self.bundle_width)
            except (_ChecksumMismatch, OSError) as e:
                corrupt = isinstance(e, _ChecksumMismatch)
                if corrupt and stats is not None:
                    stats.corrupt_extents += 1
                if corrupt:
                    get_tracer().instant("corrupt_extent", start=int(start),
                                         attempt=attempt)
                if not corrupt and not is_retryable(e):
                    raise
                if attempt >= policy.max_retries:
                    if corrupt:
                        raise CorruptExtentError(
                            f"{e} — still corrupt after "
                            f"{policy.max_retries} re-reads")
                    raise
                if stats is not None:
                    stats.retries += 1
                get_tracer().instant("read_retry", start=int(start),
                                     attempt=attempt)
                delay = policy.backoff(attempt)
                if delay > 0:
                    time.sleep(delay)
                attempt += 1

    def _serve_extents(self, extents: List[Extent], phys: np.ndarray,
                       fetch_payload: bool,
                       stats: IOStats) -> Optional[np.ndarray]:
        """One REAL file read per collapsed extent (measured accounting),
        then gather the requested rows out of the extent blocks. The reads
        of one call are one `pread` span, its args the extents and bytes
        that `stats` records.

        The reads happen regardless of `fetch_payload`: the engine's
        probe/read path discards the payload (it re-gathers the full
        activated union into a staging buffer via `fetch_into`) but the flash
        traffic — and the page-cache warmth `fetch_into` then enjoys — is
        exactly these extent reads.
        """
        with get_tracer().span("pread") as sp:
            t0 = time.perf_counter()
            blocks = [self._read_extent(start, length, stats)
                      for start, length in extents]
            stats.measured_seconds = time.perf_counter() - t0
            stats.measured_ops = len(extents)
            stats.measured_bytes = sum(b.nbytes for b in blocks)
            sp.set(extents=stats.measured_ops, bytes=stats.measured_bytes)
        if not fetch_payload:
            return None
        # locate each requested physical position inside its extent block
        ext_starts = np.array([s for s, _ in extents], dtype=np.int64)
        ext_lens = np.array([l for _, l in extents], dtype=np.int64)
        base = np.concatenate([[0], np.cumsum(ext_lens)[:-1]])
        which = np.searchsorted(ext_starts, phys, side="right") - 1
        rows = base[which] + (phys - ext_starts[which])
        flat = blocks[0] if len(blocks) == 1 else np.concatenate(blocks)
        return self._as_payload(flat[rows], phys, self.payload_dtype)


def open_layer_stores(
    pack: Union[str, os.PathLike, NeuronPack],
    device: Optional[UFSDevice] = None,
    reads_per_bundle: int = 1,
    *,
    retry: Optional[RetryPolicy] = None,
    verify_checksums: bool = False,
) -> Tuple[NeuronPack, List[FileNeuronStore]]:
    """All layers of a pack as FileNeuronStores sharing one parsed header."""
    pack = NeuronPack.open(pack)
    stores = [FileNeuronStore(pack, l, device=device,
                              reads_per_bundle=reads_per_bundle,
                              retry=retry, verify_checksums=verify_checksums)
              for l in range(pack.n_layers)]
    return pack, stores
