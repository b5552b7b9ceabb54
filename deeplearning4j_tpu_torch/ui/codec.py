"""Compact binary wire format for stats records.

The reference generates SBE (Simple Binary Encoding) codecs for its
listener payloads (ui/stats/sbe/, ~40 generated files;
SbeStatsReport.java). Capability = a compact, versioned, self-describing
binary mechanism — here a small struct-packed format:

  [magic u16][version u16][flags u32][i64 iteration][f64 ts]
  [f32 score][f32 etl_ms][f32 samples_per_sec][u32 n_series]
  then per series: [u16 name_len][name utf8][u32 n][f32 x n]

Scalars that don't fit the fixed header ride in the named-series section
as length-1 series. JSON in, JSON out — the binary layer is invisible to
callers (encode_record/decode_record). A copy of the JAX package's
ui/codec.py: the bytes are the same, so a record either package encodes
decodes in the other.
"""

from __future__ import annotations

import struct
import time
from typing import Dict, List

MAGIC = 0xD14C
VERSION = 1

_HEADER = struct.Struct("<HHIqdfffI")


def encode_record(rec: dict) -> bytes:
    """dict -> bytes. Numeric lists become f32 series; scalar floats under
    non-reserved keys become length-1 series; nested dicts are flattened
    with '/' separators."""
    series: List[tuple] = []

    def flatten(prefix: str, obj):
        if isinstance(obj, dict):
            for k, v in obj.items():
                flatten(f"{prefix}/{k}" if prefix else str(k), v)
        elif isinstance(obj, (list, tuple)):
            if all(isinstance(v, (int, float)) for v in obj):
                series.append((prefix, [float(v) for v in obj]))
            else:
                for i, v in enumerate(obj):
                    flatten(f"{prefix}/{i}", v)
        elif isinstance(obj, (int, float)):
            series.append((prefix, [float(obj)]))
        # non-numeric leaves are dropped (strings live in static info)

    reserved = {"iteration", "ts", "score", "etl_ms", "samples_per_sec"}
    flatten("", {k: v for k, v in rec.items() if k not in reserved})

    out = [_HEADER.pack(
        MAGIC, VERSION, 0,
        int(rec.get("iteration", -1)),
        float(rec.get("ts", time.time())),
        float(rec.get("score", float("nan"))),
        float(rec.get("etl_ms", 0.0)),
        float(rec.get("samples_per_sec", 0.0)),
        len(series),
    )]
    for name, vals in series:
        nb = name.encode()
        out.append(struct.pack("<H", len(nb)))
        out.append(nb)
        out.append(struct.pack("<I", len(vals)))
        out.append(struct.pack(f"<{len(vals)}f", *vals))
    return b"".join(out)


def decode_record(data: bytes) -> dict:
    magic, version, _flags, iteration, ts, score, etl, sps, n_series = (
        _HEADER.unpack_from(data, 0))
    if magic != MAGIC:
        raise ValueError(f"bad magic 0x{magic:x}")
    if version != VERSION:
        raise ValueError(f"unsupported stats record version {version}")
    off = _HEADER.size
    series: Dict[str, list] = {}
    for _ in range(n_series):
        (nlen,) = struct.unpack_from("<H", data, off)
        off += 2
        name = data[off:off + nlen].decode()
        off += nlen
        (n,) = struct.unpack_from("<I", data, off)
        off += 4
        vals = list(struct.unpack_from(f"<{n}f", data, off))
        off += 4 * n
        series[name] = vals
    rec = {
        "iteration": iteration,
        "ts": ts,
        "score": score,
        "etl_ms": etl,
        "samples_per_sec": sps,
    }
    # unflatten '/'-separated names back into nested dicts
    for name, vals in series.items():
        parts = name.split("/")
        d = rec
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = vals[0] if len(vals) == 1 else vals
    return rec
