"""NeuronPack — the on-disk artifact the offline stage produces.

The paper's thesis is that WHERE neurons live in flash determines I/O
efficiency. Until this format existed, the repo's "flash" was a numpy array
and the physical layout an in-memory permutation: nothing was ever placed on
a storage medium. A NeuronPack serializes exactly that placement decision —
per-layer neuron bundles written to disk *in physical placement order*, so a
byte offset in the file IS a physical flash position and a collapsed extent
plan maps 1:1 to positional file reads (`repro_torch.store.FileNeuronStore`).

Layout (little-endian, all regions 64-byte aligned)::

    [0:8)        magic  b"NPACK001"
    [8:16)       uint64 header-JSON byte length H
    [16:16+H)    header JSON (utf-8)
    [16+H:16+H+4) uint32 CRC32 of the header JSON          (version >= 2)
    --- data_start = align64(16 + H [+ 4]) ---
    per layer, in order:
      placement table  int64[n]       physical slot -> logical neuron id
      scales           float32[n]     per-neuron dequant scale (int8 packs)
      bundles          dtype[n, w]    payloads in PHYSICAL placement order
      bundle_crcs      uint32[n]      per-bundle CRC32       (version >= 2)

Format v2 (the default) adds integrity metadata: a CRC32 of the header
JSON (a torn header write is detected at open, not as a garbled offset
table), a per-layer whole-bundle-region CRC32 recorded in the header, and
a per-bundle CRC32 table — one checksum per physical row, what
`FileNeuronStore(verify_checksums=True)` checks after every extent read
so a corrupt flash read is detected and re-read instead of silently
corrupting decode. v1 packs (no checksums) remain fully readable; v2
packs are readable by this module only (the version gate below).
Malformed files of any kind raise `PackFormatError` naming the path and
what was expected vs found.

The header records per-layer offsets RELATIVE to data_start (so the header's
own length never feeds back into the offsets), the bundle geometry
(n_neurons, bundle_width, dtype), whether bundles are int8-quantized, the
placement search provenance (mode / edges / seconds), and a free-form `meta`
dict the packer fills with model geometry (d_model, n_mats, activation) that
load-time validation checks against the serving config.

Quantization is per-neuron symmetric int8: scale = max|row| / 127 (1.0 for
all-zero rows), row ≈ q * scale. Dequantization is deterministic, so two
readers of the same pack always serve bit-identical float32 payloads.
"""
from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.placement import PlacementResult

MAGIC = b"NPACK001"
VERSION = 2                    # written by default
READABLE_VERSIONS = (1, 2)     # v1 packs (no checksums) stay readable
_ALIGN = 64


class PackFormatError(ValueError):
    """The file is not a readable NeuronPack (truncated, wrong magic,
    unsupported version, garbled or checksum-failing header). The message
    always names the path and what was expected vs actually found."""

_DTYPES = {"float32": np.float32, "float16": np.float16, "int8": np.int8}


def _align(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def quantize_int8(rows: np.ndarray) -> tuple:
    """Per-neuron symmetric int8: returns (q [n, w] int8, scales [n] float32).

    scale = max|row| / 127 (rows of zeros get scale 1.0 so dequantization is
    exact for them too); values round to nearest and clip to [-127, 127].
    """
    rows = np.asarray(rows, dtype=np.float32)
    peak = np.abs(rows).max(axis=1)
    scales = np.where(peak > 0, peak / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(rows / scales[:, None]), -127, 127).astype(np.int8)
    return q, scales


def dequantize_int8(q: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Inverse of `quantize_int8` row-wise: float32 q * scale."""
    return q.astype(np.float32) * np.asarray(scales, np.float32)[:, None]


def _row_crc32s(rows: np.ndarray) -> np.ndarray:
    """CRC32 of every row of a C-contiguous [n, w] array, as uint32[n]."""
    rows = np.ascontiguousarray(rows)
    rb = rows.shape[1] * rows.dtype.itemsize
    view = memoryview(rows).cast("B")
    return np.array([zlib.crc32(view[i * rb:(i + 1) * rb])
                     for i in range(rows.shape[0])], dtype="<u4")


@dataclasses.dataclass(frozen=True)
class PackLayer:
    """One layer's region table (offsets relative to the pack's data_start)."""
    index: int
    placement_offset: int
    scales_offset: Optional[int]       # None unless quantized
    bundles_offset: int
    bundles_nbytes: int
    placement_mode: str
    edges_used: int
    search_seconds: float
    crcs_offset: Optional[int] = None  # per-bundle CRC table (v2 packs)
    bundles_crc32: Optional[int] = None  # whole-region CRC32 (v2 packs)


class NeuronPack:
    """Read-side handle on a NeuronPack file: header + per-layer accessors.

    Bundle payloads are exposed two ways — `bundles_memmap(l)` (the lazy
    page-cache view `FileNeuronStore` fancy-indexes for DRAM-side fetches;
    packs larger than RAM stay larger than RAM) and the absolute byte offsets
    (`bundles_file_offset(l)`) the store's `pread` extent path uses.
    """

    def __init__(self, path: Union[str, os.PathLike]) -> None:
        self.path = os.fspath(path)
        try:
            size = os.path.getsize(self.path)
        except OSError as e:
            raise PackFormatError(f"{self.path}: cannot stat pack file ({e})")
        with open(self.path, "rb") as f:
            preamble = f.read(16)
            if len(preamble) < 16:
                raise PackFormatError(
                    f"{self.path}: file is {size} bytes — too short for a "
                    f"NeuronPack (need at least the 16-byte magic + "
                    f"header-length preamble)")
            magic = preamble[:8]
            if magic != MAGIC:
                raise PackFormatError(
                    f"{self.path}: not a NeuronPack (magic {magic!r}, "
                    f"expected {MAGIC!r})")
            (hlen,) = np.frombuffer(preamble[8:16], dtype="<u8")
            hlen = int(hlen)
            if 16 + hlen > size:
                raise PackFormatError(
                    f"{self.path}: header claims {hlen} bytes but only "
                    f"{size - 16} follow the preamble — truncated pack")
            blob = f.read(hlen)
            try:
                header = json.loads(blob.decode("utf-8"))
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise PackFormatError(
                    f"{self.path}: header JSON is unreadable ({e}) — "
                    f"corrupt file or not a NeuronPack")
            if not isinstance(header, dict):
                raise PackFormatError(
                    f"{self.path}: header is {type(header).__name__}, "
                    f"expected a JSON object")
            version = header.get("version")
            if version not in READABLE_VERSIONS:
                raise PackFormatError(
                    f"{self.path}: unsupported NeuronPack version {version!r}"
                    f" (reader supports {READABLE_VERSIONS})")
            crc_bytes = 0
            if version >= 2:
                crc_raw = f.read(4)
                if len(crc_raw) < 4:
                    raise PackFormatError(
                        f"{self.path}: truncated before the v2 header "
                        f"checksum (expected 4 CRC bytes after the "
                        f"{hlen}-byte header)")
                (stored,) = np.frombuffer(crc_raw, dtype="<u4")
                actual = zlib.crc32(blob)
                if int(stored) != actual:
                    raise PackFormatError(
                        f"{self.path}: header CRC mismatch (stored "
                        f"0x{int(stored):08x}, computed 0x{actual:08x}) — "
                        f"corrupt header")
                crc_bytes = 4
        self.header = header
        self.version = int(version)
        self.data_start = _align(16 + hlen + crc_bytes)
        self.n_layers: int = header["n_layers"]
        self.n_neurons: int = header["n_neurons"]
        self.bundle_width: int = header["bundle_width"]
        self.quantized: bool = header["quantized"]
        self.dtype = np.dtype(_DTYPES[header["dtype"]])
        self.meta: dict = header.get("meta", {})
        self._layers = [
            PackLayer(index=i,
                      placement_offset=lay["placement"],
                      scales_offset=lay.get("scales"),
                      bundles_offset=lay["bundles"],
                      bundles_nbytes=lay["bundles_nbytes"],
                      placement_mode=lay.get("placement_mode", "pack"),
                      edges_used=lay.get("edges_used", 0),
                      search_seconds=lay.get("search_seconds", 0.0),
                      crcs_offset=lay.get("bundle_crcs"),
                      bundles_crc32=lay.get("bundles_crc32"))
            for i, lay in enumerate(header["layers"])
        ]
        last = self._layers[-1] if self._layers else None
        if last is not None and (self.data_start + last.bundles_offset
                                 + last.bundles_nbytes) > size:
            raise PackFormatError(
                f"{self.path}: file is {size} bytes but the header's region "
                f"table needs at least "
                f"{self.data_start + last.bundles_offset + last.bundles_nbytes}"
                f" — truncated pack data")

    @classmethod
    def open(cls, path: Union[str, os.PathLike, "NeuronPack"]) -> "NeuronPack":
        return path if isinstance(path, NeuronPack) else cls(path)

    @property
    def row_bytes(self) -> int:
        """Stored bytes of one neuron bundle (the flash 'sector' unit)."""
        return self.bundle_width * self.dtype.itemsize

    def layer(self, l: int) -> PackLayer:
        return self._layers[l]

    def placement(self, l: int) -> PlacementResult:
        lay = self._layers[l]
        placement = np.fromfile(self.path, dtype="<i8", count=self.n_neurons,
                                offset=self.data_start + lay.placement_offset)
        inverse = np.empty_like(placement)
        inverse[placement] = np.arange(self.n_neurons)
        return PlacementResult(placement=placement, inverse=inverse,
                               edges_used=lay.edges_used,
                               search_seconds=lay.search_seconds,
                               mode=lay.placement_mode)

    def scales(self, l: int) -> Optional[np.ndarray]:
        """Per-neuron dequant scales in PHYSICAL order, or None (float pack)."""
        lay = self._layers[l]
        if lay.scales_offset is None:
            return None
        return np.fromfile(self.path, dtype="<f4", count=self.n_neurons,
                           offset=self.data_start + lay.scales_offset)

    def bundles_file_offset(self, l: int) -> int:
        """Absolute byte offset of layer `l`'s first bundle — physical slot p
        lives at exactly this offset + p * row_bytes."""
        return self.data_start + self._layers[l].bundles_offset

    def bundles_memmap(self, l: int) -> np.ndarray:
        """Lazy [n, w] raw-dtype view over layer `l`'s bundle region."""
        return np.memmap(self.path, dtype=self.dtype, mode="r",
                         offset=self.bundles_file_offset(l),
                         shape=(self.n_neurons, self.bundle_width))

    def row_crcs(self, l: int) -> Optional[np.ndarray]:
        """Per-bundle CRC32 table for layer `l` (uint32[n], physical order),
        or None for a v1 pack — the verification input for
        `FileNeuronStore(verify_checksums=True)`."""
        lay = self._layers[l]
        if lay.crcs_offset is None:
            return None
        return np.fromfile(self.path, dtype="<u4", count=self.n_neurons,
                           offset=self.data_start + lay.crcs_offset)

    def verify_bundles(self, l: int) -> bool:
        """Whole-region integrity check of layer `l`'s bundles against the
        header-recorded CRC32 (v1 packs have none and trivially pass)."""
        expected = self._layers[l].bundles_crc32
        if expected is None:
            return True
        data = np.ascontiguousarray(self.bundles_memmap(l))
        return zlib.crc32(memoryview(data).cast("B")) == int(expected)

    def logical_bundles(self, l: int, dequantize: bool = True) -> np.ndarray:
        """Layer `l`'s full payload back in LOGICAL neuron-id order — the
        exact array an in-memory `NeuronStore` would be built from (the
        round-trip identity tests lean on this)."""
        pl = self.placement(l)
        phys = np.asarray(self.bundles_memmap(l))
        if self.quantized and dequantize:
            phys = dequantize_int8(phys, self.scales(l))
        return phys[pl.inverse]


def write_pack(
    path: Union[str, os.PathLike],
    bundles_per_layer: Sequence[np.ndarray],      # [L][n, w], LOGICAL order
    placements: Sequence[PlacementResult],
    *,
    quantize: str = "none",                       # "none" | "int8"
    meta: Optional[dict] = None,
    version: int = VERSION,
) -> dict:
    """Serialize an offline placement into a NeuronPack file.

    `bundles_per_layer` is given in logical neuron-id order (as produced by
    `make_bundles`); the writer applies each layer's placement so the file
    holds bundles in PHYSICAL order. Returns the header dict augmented with
    `path` and `file_bytes`. `version=2` (the default) writes the checksum
    metadata (header CRC + per-bundle CRC tables); `version=1` writes the
    legacy checksum-free layout byte-identically to older writers.
    """
    if quantize not in ("none", "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    if version not in READABLE_VERSIONS:
        raise ValueError(f"cannot write NeuronPack version {version!r} "
                         f"(writable: {READABLE_VERSIONS})")
    if len(bundles_per_layer) != len(placements):
        raise ValueError(f"{len(bundles_per_layer)} bundle arrays vs "
                         f"{len(placements)} placements")
    if not bundles_per_layer:
        raise ValueError("cannot write an empty pack")
    n, w = bundles_per_layer[0].shape
    for i, b in enumerate(bundles_per_layer):
        if b.shape != (n, w):
            raise ValueError(f"layer {i} bundle shape {b.shape} != ({n}, {w}):"
                             " packs are geometry-homogeneous across layers")
        if len(placements[i].placement) != n:
            raise ValueError(f"layer {i} placement covers "
                             f"{len(placements[i].placement)} of {n} neurons")

    quantized = quantize == "int8"
    out_dtype = np.int8 if quantized else np.asarray(bundles_per_layer[0]).dtype
    dtype_name = np.dtype(out_dtype).name
    if dtype_name not in _DTYPES:
        raise ValueError(f"unsupported bundle dtype {dtype_name}")

    # physical-order payloads (+ scales, + v2 checksum tables) per layer
    regions: List[tuple] = []   # (placement i64, scales f32|None, rows, crcs)
    for b, pl in zip(bundles_per_layer, placements):
        phys = np.ascontiguousarray(np.asarray(b)[pl.placement])
        scales = None
        if quantized:
            phys, scales = quantize_int8(phys)
        rows = np.ascontiguousarray(phys, dtype=out_dtype)
        crcs = _row_crc32s(rows) if version >= 2 else None
        regions.append((pl.placement.astype("<i8"), scales, rows, crcs))

    # layout pass: offsets relative to data_start, every region aligned
    layers = []
    cursor = 0
    for (placement, scales, rows, crcs), pl in zip(regions, placements):
        entry = {"placement": cursor, "placement_mode": pl.mode,
                 "edges_used": int(pl.edges_used),
                 "search_seconds": float(pl.search_seconds)}
        cursor = _align(cursor + placement.nbytes)
        if scales is not None:
            entry["scales"] = cursor
            cursor = _align(cursor + scales.nbytes)
        entry["bundles"] = cursor
        entry["bundles_nbytes"] = int(rows.nbytes)
        cursor = _align(cursor + rows.nbytes)
        if crcs is not None:
            entry["bundle_crcs"] = cursor
            cursor = _align(cursor + crcs.nbytes)
            entry["bundles_crc32"] = int(
                zlib.crc32(memoryview(rows).cast("B")))
        layers.append(entry)

    header = {
        "version": int(version),
        "n_layers": len(regions),
        "n_neurons": int(n),
        "bundle_width": int(w),
        "dtype": dtype_name,
        "quantized": quantized,
        "layers": layers,
        "meta": dict(meta or {}),
    }
    blob = json.dumps(header).encode("utf-8")
    crc_bytes = 4 if version >= 2 else 0
    data_start = _align(16 + len(blob) + crc_bytes)

    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(np.array(len(blob), dtype="<u8").tobytes())
        f.write(blob)
        if crc_bytes:
            f.write(np.array(zlib.crc32(blob), dtype="<u4").tobytes())
        f.write(b"\0" * (data_start - 16 - len(blob) - crc_bytes))
        cursor = 0
        for entry, (placement, scales, rows, crcs) in zip(layers, regions):
            for key, arr in (("placement", placement), ("scales", scales),
                             ("bundles", rows), ("bundle_crcs", crcs)):
                if arr is None:
                    continue
                off = entry[key]
                f.write(b"\0" * (off - cursor))
                f.write(arr.tobytes())
                cursor = off + arr.nbytes
        f.write(b"\0" * (_align(cursor) - cursor))
        total = data_start + _align(cursor)
    return dict(header, path=os.fspath(path), file_bytes=total)
