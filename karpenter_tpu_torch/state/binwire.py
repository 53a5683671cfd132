"""Compact binary wire codec (``bin1``) for the cluster-store protocol.

The tagged-JSON codec (state/wire.py) is the store's lingua franca: safe,
self-describing, and slow at fleet scale — every Pod crossing the wire
pays a Python tree build plus JSON string scanning, and a watch event
fanned out to N subscribers pays the encode N times.  ``bin1`` is the
negotiated fast path (service/store_server.py `hello`): the same value
domain, encoded directly from the live objects into length-prefixed
binary with no intermediate tree.

Frame-relevant properties:

- **Length-prefixed, versioned**: every payload starts with the magic
  byte + codec version (service/codec.py `encode_payload`); every
  variable-size value carries a varint length.  An endpoint that doesn't
  recognize the version negotiates down to tagged JSON.
- **Closed schema**: only `STORE_WIRE_CLASSES` encode — the class-id
  table is positional over that static tuple, and `SCHEMA_FP` hashes the
  class list *and every field list in declaration order*.  Peers
  exchange the fingerprint at `hello`/`watch` time; any mismatch (a
  build whose dataclasses drifted) falls back to JSON instead of
  decoding garbage.  Like ``from_wire``, unknown ids are an error, never
  an attribute lookup — and no payload is ever executed.
- **Default elision**: dataclasses encode as (class-id, n, (field-idx,
  value)*) with fields still holding their declared default omitted —
  the decoder rebuilds via ``cls(**present)`` so elided fields re-take
  their defaults.  A Pod is mostly defaults; elision is where the wire
  shrinks ~5x under tagged JSON.
- **Splicing**: `Raw` wraps pre-encoded value bytes so a frame can embed
  an already-rendered event batch without re-encoding — the server
  renders each watch event once and every subscriber frame reuses the
  bytes (the fan-out win the JSON protocol structurally cannot have).

Equality contract: for every value the tagged-JSON codec accepts,
``decode_value(encode_value(v))`` is ``canonical``-equal to ``v`` (the
round-trip fuzz in tests/test_store_scale.py pins this against the JSON
codec on the same objects).

A copy of ``karpenter_tpu/state/binwire.py`` over the port's ``api/`` and
``state/wire.py``; tests/test_torch_service.py holds its bytes equal to the
reference's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import struct
from typing import Any, List, Tuple

from karpenter_tpu_torch.api.requirements import Requirement, Requirements
from karpenter_tpu_torch.api.resources import Resources
from karpenter_tpu_torch.state.wire import STORE_WIRE_CLASSES

BIN_CODEC = "bin1"
BIN_VERSION = 1

# value tags (one byte each)
_T_NONE, _T_FALSE, _T_TRUE = 0, 1, 2
_T_INT, _T_FLOAT, _T_STR = 3, 4, 5
_T_LIST, _T_TUPLE, _T_FSET, _T_DICT = 6, 7, 8, 9
_T_RES, _T_REQ, _T_REQS, _T_DC = 10, 11, 12, 13

_pack_d = struct.Struct(">d").pack
_unpack_d = struct.Struct(">d").unpack_from


class Raw:
    """Pre-encoded value bytes, spliced verbatim into an enclosing
    encode.  The bytes MUST be one complete ``encode_value`` output —
    the codec cannot re-validate them (that is the point: zero-cost
    reuse of an already-rendered event)."""

    __slots__ = ("data",)

    def __init__(self, data: bytes):
        self.data = data


def _skip_spec(f: dataclasses.Field):
    """(kind, arg) describing when a field's value may be elided, or
    None when it never may.  Elision must be exact: the decoder fills
    the declared default back in, so a value is skippable only when it
    is indistinguishable from that default (type included — a 0 on a
    None-default field must still ship)."""
    if f.default is not dataclasses.MISSING:
        d = f.default
        if d is None:
            return ("none", None)
        if isinstance(d, bool):
            return ("is", d)
        if isinstance(d, (int, float, str)):
            # floats additionally compare by repr: -0.0 == 0.0 but the
            # canonical JSON forms differ, and elision must never change
            # the canonical bytes
            return ("eq", d)
        if isinstance(d, tuple) and not d:
            return ("empty", tuple)
        return None
    if f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
        sample = f.default_factory()  # type: ignore[misc]
        if type(sample) in (list, dict, tuple, set, frozenset) and not sample:
            return ("empty", type(sample))
        return None
    return None


def _field_fp(f: dataclasses.Field) -> str:
    """The fingerprint-relevant identity of one field: its name AND its
    default.  Defaults matter because elision round-trips through them —
    a peer whose default drifted would silently fill the WRONG value
    back in for an elided field, so drifted defaults must break the
    fingerprint and negotiate down to JSON."""
    if f.default is not dataclasses.MISSING:
        return f"{f.name}={f.default!r}"
    if f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
        return f"{f.name}~{f.default_factory()!r}"  # type: ignore[misc]
    return f.name


def _build_tables(wire_classes=STORE_WIRE_CLASSES):
    classes: List[Tuple[type, List[str], list]] = []
    ids = {}
    fp = hashlib.sha256()
    fp.update(f"bin{BIN_VERSION};".encode())
    for cid, cls in enumerate(wire_classes):
        fields = dataclasses.fields(cls)
        names = [f.name for f in fields]
        skips = [_skip_spec(f) for f in fields]
        classes.append((cls, names, skips))
        ids[cls] = cid
        fp.update(
            f"{cls.__name__}:{','.join(_field_fp(f) for f in fields)};".encode()
        )
    return classes, ids, fp.hexdigest()[:16]


_CLASSES, _CLASS_IDS, SCHEMA_FP = _build_tables()


def _sorted_det(values):
    """Deterministic ordering for unordered containers, so equal sets
    encode to equal bytes regardless of PYTHONHASHSEED."""
    try:
        return sorted(values)
    except TypeError:
        return sorted(values, key=repr)


def _enc_len(v: int, out: bytearray) -> None:
    while v > 127:
        out.append((v & 127) | 128)
        v >>= 7
    out.append(v)


def _enc(value: Any, out: bytearray) -> None:
    t = type(value)
    if value is None:
        out.append(_T_NONE)
    elif t is bool:
        out.append(_T_TRUE if value else _T_FALSE)
    elif t is int:
        out.append(_T_INT)
        # zigzag, arbitrary-precision safe: negatives map to odd codes
        _enc_len((-value << 1) - 1 if value < 0 else value << 1, out)
    elif t is float:
        out.append(_T_FLOAT)
        out += _pack_d(value)
    elif t is str:
        out.append(_T_STR)
        b = value.encode()
        _enc_len(len(b), out)
        out += b
    elif t is list:
        out.append(_T_LIST)
        _enc_len(len(value), out)
        for v in value:
            _enc(v, out)
    elif t is tuple:
        out.append(_T_TUPLE)
        _enc_len(len(value), out)
        for v in value:
            _enc(v, out)
    elif t is frozenset or t is set:
        out.append(_T_FSET)
        _enc_len(len(value), out)
        for v in _sorted_det(value):
            _enc(v, out)
    elif t is dict:
        out.append(_T_DICT)
        _enc_len(len(value), out)
        for k, v in value.items():
            kb = str(k).encode()  # str keys, matching to_wire
            _enc_len(len(kb), out)
            out += kb
            _enc(v, out)
    elif t is Resources:
        out.append(_T_RES)
        d = value.to_dict()
        _enc_len(len(d), out)
        for k, v in d.items():
            kb = k.encode()
            _enc_len(len(kb), out)
            out += kb
            out += _pack_d(float(v))
    elif t is Requirements:
        out.append(_T_REQS)
        items = list(value)
        _enc_len(len(items), out)
        for r in items:
            _enc(r, out)
    elif t is Requirement:
        out.append(_T_REQ)
        _enc(value.key, out)
        out.append(1 if value.complement else 0)
        vals = _sorted_det(value.values)
        _enc_len(len(vals), out)
        for v in vals:
            _enc(v, out)
        _enc(value.greater_than, out)
        _enc(value.less_than, out)
        _enc(value.min_values, out)
        out.append(1 if value.absent_ok else 0)
    elif t is Raw:
        out += value.data
    else:
        cid = _CLASS_IDS.get(t)
        if cid is None:
            raise TypeError(f"unencodable bin1 value: {t.__name__}")
        _, names, skips = _CLASSES[cid]
        present = []
        for idx, name in enumerate(names):
            v = getattr(value, name)
            spec = skips[idx]
            if spec is not None:
                kind, arg = spec
                if kind == "none":
                    if v is None:
                        continue
                elif kind == "is":
                    if v is arg:
                        continue
                elif kind == "eq":
                    if (
                        type(v) is type(arg)
                        and v == arg
                        and (type(v) is not float or repr(v) == repr(arg))
                    ):
                        continue
                else:  # empty container of the default's type
                    if type(v) is arg and not v:
                        continue
            present.append((idx, v))
        out.append(_T_DC)
        _enc_len(cid, out)
        _enc_len(len(present), out)
        for idx, v in present:
            _enc_len(idx, out)
            _enc(v, out)


def encode_value(value: Any) -> bytes:
    out = bytearray()
    _enc(value, out)
    return bytes(out)


def _dec_len(buf: bytes, pos: int) -> Tuple[int, int]:
    shift = 0
    v = 0
    while True:
        b = buf[pos]
        pos += 1
        v |= (b & 127) << shift
        if b < 128:
            return v, pos
        shift += 7


def _dec(buf: bytes, pos: int) -> Tuple[Any, int]:
    tag = buf[pos]
    pos += 1
    if tag == _T_NONE:
        return None, pos
    if tag == _T_FALSE:
        return False, pos
    if tag == _T_TRUE:
        return True, pos
    if tag == _T_INT:
        v, pos = _dec_len(buf, pos)
        return (-((v + 1) >> 1) if v & 1 else v >> 1), pos
    if tag == _T_FLOAT:
        return _unpack_d(buf, pos)[0], pos + 8
    if tag == _T_STR:
        n, pos = _dec_len(buf, pos)
        return buf[pos : pos + n].decode(), pos + n
    if tag == _T_LIST:
        n, pos = _dec_len(buf, pos)
        out = []
        for _ in range(n):
            v, pos = _dec(buf, pos)
            out.append(v)
        return out, pos
    if tag == _T_TUPLE:
        n, pos = _dec_len(buf, pos)
        out = []
        for _ in range(n):
            v, pos = _dec(buf, pos)
            out.append(v)
        return tuple(out), pos
    if tag == _T_FSET:
        n, pos = _dec_len(buf, pos)
        out = []
        for _ in range(n):
            v, pos = _dec(buf, pos)
            out.append(v)
        return frozenset(out), pos
    if tag == _T_DICT:
        n, pos = _dec_len(buf, pos)
        d = {}
        for _ in range(n):
            kn, pos = _dec_len(buf, pos)
            k = buf[pos : pos + kn].decode()
            pos += kn
            v, pos = _dec(buf, pos)
            d[k] = v
        return d, pos
    if tag == _T_RES:
        n, pos = _dec_len(buf, pos)
        d = {}
        for _ in range(n):
            kn, pos = _dec_len(buf, pos)
            k = buf[pos : pos + kn].decode()
            pos += kn
            d[k] = _unpack_d(buf, pos)[0]
            pos += 8
        return Resources._from_raw(d), pos
    if tag == _T_REQS:
        n, pos = _dec_len(buf, pos)
        out = []
        for _ in range(n):
            v, pos = _dec(buf, pos)
            out.append(v)
        return Requirements(out), pos
    if tag == _T_REQ:
        key, pos = _dec(buf, pos)
        comp = buf[pos] == 1
        pos += 1
        n, pos = _dec_len(buf, pos)
        vals = []
        for _ in range(n):
            v, pos = _dec(buf, pos)
            vals.append(v)
        gt, pos = _dec(buf, pos)
        lt, pos = _dec(buf, pos)
        mv, pos = _dec(buf, pos)
        ao = buf[pos] == 1
        pos += 1
        return Requirement._raw(
            key, comp, frozenset(vals), gt, lt, mv, ao
        ), pos
    if tag == _T_DC:
        cid, pos = _dec_len(buf, pos)
        if cid >= len(_CLASSES):
            raise ValueError(f"unknown bin1 class id: {cid}")
        cls, names, _ = _CLASSES[cid]
        n, pos = _dec_len(buf, pos)
        kw = {}
        for _ in range(n):
            idx, pos = _dec_len(buf, pos)
            v, pos = _dec(buf, pos)
            kw[names[idx]] = v
        return cls(**kw), pos
    raise ValueError(f"unknown bin1 tag: {tag}")


def decode_value(buf: bytes, pos: int = 0) -> Any:
    value, end = _dec(buf, pos)
    if end != len(buf):
        raise ValueError(
            f"trailing bin1 bytes: decoded to {end} of {len(buf)}"
        )
    return value
