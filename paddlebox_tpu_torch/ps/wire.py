"""Typed binary wire codec for the PS service — no pickle on network bytes.

Copy of ``paddlebox_tpu/ps/wire.py`` with the import paths rewritten
(host code: numpy, files, sockets and threads; no device call).

≙ the brpc PS protocol's typed request/response messages (sendrecv.proto:
VariableMessage dtype/shape/raw-bytes framing + PsService cmd ids,
ps/service/sendrecv.proto, brpc_ps_server.h): a message is a flat dict of
scalars / strings / ndarrays / one-level dicts-of-ndarrays, encoded as
tagged fields with dtype+shape headers and raw little-endian buffers.
Arrays decode with np.frombuffer (zero parsing of untrusted structure
beyond bounded headers) — a malicious peer can at worst produce a garbage
array or a clean DecodeError, never code execution.

Frame layout (all little-endian):
  u32 field count, then per field:
    u16 key-len, key utf8
    u8 tag:  0 None | 1 bool | 2 int | 3 float | 4 str | 5 ndarray | 6 dict
             | 7 quantized ndarray
    value:
      bool  -> u8
      int   -> i64
      float -> f64
      str   -> u32 len + utf8
      ndarray -> u8 dtype-len + dtype.str ascii, u8 ndim, u64*ndim shape,
                 raw C-order bytes
      dict  -> nested encoding (depth limited to 1 nesting level)
      quantized ndarray (tag 7, FLAGS_ps_wire_dtype ∈ {f16, i8}) ->
                 u8 orig-dtype-len + orig dtype.str ascii,
                 u8 enc-dtype-len + enc dtype.str ascii,
                 f64 scale, u8 ndim, u64*ndim shape, raw encoded bytes.
                 The scale is PER FIELD PER FRAME (per chunk): i8 stores
                 round(x/scale) with scale = max|x|/127; f16 stores the
                 IEEE half directly (scale 1.0).  decode() dequantizes
                 transparently back to the original float dtype, so table
                 state and caller arithmetic stay full precision.

Request ids: retryable non-idempotent requests carry a conventional
string field ``RID_FIELD`` ("rid") of the form ``<client-token>:<seq>``
(chunked verbs suffix ``.<chunk>``); the server echoes it on the matching
response and dedups resends through its bounded window (ps/service.py
_DedupWindow).  The echo also lets a client reject a stale frame that
surfaces on a reused stream after a timeout.
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np

from paddlebox_tpu_torch.utils.monitor import stat_add

MAX_FRAME = 1 << 32          # hard cap: one frame can't ask for >4 GiB
MAX_FIELDS = 4096
MAX_KEY = 1 << 16
_MAX_NDIM = 16

# exactly-once request-id field (see module docstring): service.py stamps
# it on mutating requests and echoes it on responses
RID_FIELD = "rid"

# optional Dapper-style trace-context field riding beside the rid: a
# string ``<trace_id>/<span_id>`` naming the originating client span
# (utils/trace.py).  The server parents its dispatch span to it, so one
# trace id follows a verb across the process boundary; retries resend
# the SAME context, and dedup-window replays never open a second server
# span — trace topology survives the exactly-once protocol unchanged.
TRACE_FIELD = "tctx"

# legal FLAGS_ps_wire_dtype values (f32 = exact passthrough, no tag 7)
WIRE_DTYPES = ("f32", "f16", "i8")
_F16_MAX = 65504.0


class DecodeError(ValueError):
    pass


class QuantArray:
    """A float ndarray held in its reduced-precision wire encoding (tag 7).

    Built by :func:`quantize_rows` on the SENDING side only; ``decode``
    dequantizes transparently, so receivers always see plain float
    ndarrays and never handle this type."""

    __slots__ = ("data", "orig_dtype", "scale")

    def __init__(self, data: np.ndarray, orig_dtype: np.dtype, scale: float):
        self.data = data
        self.orig_dtype = np.dtype(orig_dtype)
        self.scale = float(scale)


def quantize(a: np.ndarray, wire_dtype: str) -> QuantArray:
    """One float32 array → its wire encoding with a per-array scale."""
    a = np.ascontiguousarray(a)
    if wire_dtype == "f16":
        return QuantArray(np.clip(a, -_F16_MAX, _F16_MAX)
                          .astype(np.float16), a.dtype, 1.0)
    if wire_dtype == "i8":
        amax = float(np.max(np.abs(a))) if a.size else 0.0
        scale = (amax / 127.0) or 1.0
        q = np.clip(np.round(a / scale), -127, 127).astype(np.int8)
        return QuantArray(q, a.dtype, scale)
    raise ValueError(f"unknown wire dtype {wire_dtype!r} "
                     f"(want one of {WIRE_DTYPES})")


def quantize_rows(rows: Dict[str, Any], wire_dtype: str,
                  verb: str = "") -> Dict[str, Any]:
    """Encode the float32 fields of a rows dict for the wire.

    Only float32 payloads quantize — f64 fields (ctr_double show/click
    counters) and integer planes stay exact; ``f32`` is a counted
    passthrough.  Bumps ``ps.wire.<verb>.raw_bytes`` / ``.quant_bytes``
    so the raw-vs-encoded bandwidth win is observable per verb."""
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"unknown wire dtype {wire_dtype!r} "
                         f"(want one of {WIRE_DTYPES})")
    out: Dict[str, Any] = {}
    raw = enc = 0
    for f, v in rows.items():
        a = np.asarray(v)
        raw += a.nbytes
        if wire_dtype != "f32" and a.dtype == np.float32:
            qa = quantize(a, wire_dtype)
            enc += qa.data.nbytes
            out[f] = qa
        else:
            enc += a.nbytes
            out[f] = v
    if verb:
        stat_add(f"ps.wire.{verb}.raw_bytes", float(raw))
        stat_add(f"ps.wire.{verb}.quant_bytes", float(enc))
    return out


def _enc_value(out: list, v: Any, depth: int) -> None:
    if v is None:
        out.append(b"\x00")
    elif isinstance(v, (bool, np.bool_)):
        out.append(b"\x01" + struct.pack("<B", int(v)))
    elif isinstance(v, (int, np.integer)):
        out.append(b"\x02" + struct.pack("<q", int(v)))
    elif isinstance(v, (float, np.floating)):
        out.append(b"\x03" + struct.pack("<d", float(v)))
    elif isinstance(v, str):
        b = v.encode("utf-8")
        out.append(b"\x04" + struct.pack("<I", len(b)) + b)
    elif isinstance(v, np.ndarray):
        if v.dtype.hasobject:
            raise TypeError(
                "object-dtype arrays are not wire-safe (raw pointers); "
                "convert to a fixed-width dtype first")
        a = np.ascontiguousarray(v)
        dt = a.dtype.str.encode("ascii")
        head = struct.pack("<B", len(dt)) + dt + struct.pack("<B", a.ndim)
        head += struct.pack(f"<{a.ndim}Q", *a.shape) if a.ndim else b""
        out.append(b"\x05" + head)
        out.append(a.tobytes())
    elif isinstance(v, QuantArray):
        a = np.ascontiguousarray(v.data)
        odt = v.orig_dtype.str.encode("ascii")
        edt = a.dtype.str.encode("ascii")
        head = struct.pack("<B", len(odt)) + odt
        head += struct.pack("<B", len(edt)) + edt
        head += struct.pack("<d", v.scale) + struct.pack("<B", a.ndim)
        head += struct.pack(f"<{a.ndim}Q", *a.shape) if a.ndim else b""
        out.append(b"\x07" + head)
        out.append(a.tobytes())
    elif isinstance(v, dict):
        if depth >= 1:
            raise TypeError("wire dicts nest at most one level")
        out.append(b"\x06")
        _enc_fields(out, v, depth + 1)
    else:
        raise TypeError(f"wire cannot encode {type(v).__name__}")


def _enc_fields(out: list, msg: Dict[str, Any], depth: int) -> None:
    out.append(struct.pack("<I", len(msg)))
    for k, v in msg.items():
        kb = k.encode("utf-8")
        out.append(struct.pack("<H", len(kb)) + kb)
        _enc_value(out, v, depth)


def encode(msg: Dict[str, Any]) -> bytes:
    out: list = []
    _enc_fields(out, msg, 0)
    return b"".join(out)


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.buf):
            raise DecodeError("frame truncated")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def u8(self) -> int:
        return self.take(1)[0]

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))


def _dec_value(r: _Reader, depth: int) -> Any:
    tag = r.u8()
    if tag == 0:
        return None
    if tag == 1:
        return bool(r.u8())
    if tag == 2:
        return r.unpack("<q")[0]
    if tag == 3:
        return r.unpack("<d")[0]
    if tag == 4:
        (n,) = r.unpack("<I")
        return r.take(n).decode("utf-8")
    if tag == 5:
        dt_len = r.u8()
        dt = np.dtype(r.take(dt_len).decode("ascii"))
        if dt.hasobject:
            raise DecodeError("object dtypes are not wire-safe")
        ndim = r.u8()
        if ndim > _MAX_NDIM:
            raise DecodeError("ndim too large")
        shape = r.unpack(f"<{ndim}Q") if ndim else ()
        count = 1
        for s in shape:
            count *= s
        nbytes = count * dt.itemsize
        if nbytes > MAX_FRAME:
            raise DecodeError("array exceeds frame cap")
        raw = r.take(int(nbytes))
        return np.frombuffer(raw, dtype=dt).reshape(shape).copy()
    if tag == 6:
        if depth >= 1:
            raise DecodeError("dict nesting exceeds limit")
        return _dec_fields(r, depth + 1)
    if tag == 7:
        odt = np.dtype(r.take(r.u8()).decode("ascii"))
        edt = np.dtype(r.take(r.u8()).decode("ascii"))
        if odt.hasobject or edt.hasobject:
            raise DecodeError("object dtypes are not wire-safe")
        if odt.kind != "f":
            raise DecodeError("quantized arrays must dequantize to float")
        (scale,) = r.unpack("<d")
        ndim = r.u8()
        if ndim > _MAX_NDIM:
            raise DecodeError("ndim too large")
        shape = r.unpack(f"<{ndim}Q") if ndim else ()
        count = 1
        for s in shape:
            count *= s
        nbytes = count * edt.itemsize
        if nbytes > MAX_FRAME:
            raise DecodeError("array exceeds frame cap")
        raw = r.take(int(nbytes))
        q = np.frombuffer(raw, dtype=edt).reshape(shape)
        # dequantize HERE: receivers only ever see full-precision floats
        out = q.astype(odt)
        if scale != 1.0:
            out = out * odt.type(scale)
        return out
    raise DecodeError(f"unknown tag {tag}")


def _dec_fields(r: _Reader, depth: int) -> Dict[str, Any]:
    (n,) = r.unpack("<I")
    if n > MAX_FIELDS:
        raise DecodeError("too many fields")
    out: Dict[str, Any] = {}
    for _ in range(n):
        (klen,) = r.unpack("<H")
        if klen > MAX_KEY:
            raise DecodeError("key too long")
        k = r.take(klen).decode("utf-8")
        out[k] = _dec_value(r, depth)
    return out


def decode(buf: bytes) -> Dict[str, Any]:
    r = _Reader(buf)
    msg = _dec_fields(r, 0)
    if r.pos != len(buf):
        raise DecodeError("trailing bytes in frame")
    return msg
