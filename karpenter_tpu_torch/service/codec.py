"""Wire codec for the solver service: JSON header + raw array blob.

Frame layout (all integers big-endian):

    [4B total header length][JSON header][binary blob]

The JSON header carries the method/status, scalar params, and an array
manifest ``[{name, dtype, shape, offset, nbytes}]`` indexing into the
blob.  Arrays travel as raw C-order bytes — no pickling (the sidecar must
never execute peer-controlled payloads), no base64 inflation.

A copy of ``karpenter_tpu/service/codec.py``: the blocking seam
`note_blocking` comes from the port's ``utils/locks.py`` (the runtime lock
sanitizer's seam, a branch when no sanitizer is enabled).
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Dict, Tuple

import numpy as np

from karpenter_tpu_torch.state.binwire import (
    BIN_VERSION,
    decode_value,
    encode_value,
)
from karpenter_tpu_torch.utils.locks import note_blocking

MAX_FRAME = 1 << 30  # 1 GiB sanity bound


def encode(meta: dict, arrays: Dict[str, np.ndarray]) -> bytes:
    manifest = []
    blob_parts = []
    offset = 0
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        shape = list(arr.shape)  # before ascontiguousarray (it promotes 0-d)
        raw = np.ascontiguousarray(arr).tobytes()
        manifest.append(
            {
                "name": name,
                "dtype": arr.dtype.str,
                "shape": shape,
                "offset": offset,
                "nbytes": len(raw),
            }
        )
        blob_parts.append(raw)
        offset += len(raw)
    header = dict(meta)
    header["arrays"] = manifest
    hbytes = json.dumps(header).encode()
    return struct.pack(">I", len(hbytes)) + hbytes + b"".join(blob_parts)


def decode(payload: bytes) -> Tuple[dict, Dict[str, np.ndarray]]:
    # bounds-check the length prefix BEFORE trusting it: a zero-length
    # or truncated payload (torn disk tail, half-written socket frame)
    # must surface as the one malformed-frame error type every reader
    # already handles (ValueError), never a stray struct.error from the
    # unpack or a JSONDecodeError from a short header slice
    if len(payload) < 4:
        raise ValueError(
            f"truncated frame: {len(payload)} bytes, need a 4-byte "
            "header length"
        )
    (hlen,) = struct.unpack(">I", payload[:4])
    if 4 + hlen > len(payload):
        raise ValueError(
            f"truncated frame: header declares {hlen} bytes, "
            f"{len(payload) - 4} present"
        )
    try:
        header = json.loads(payload[4 : 4 + hlen].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise ValueError(f"malformed frame header: {exc}") from exc
    blob = payload[4 + hlen :]
    arrays: Dict[str, np.ndarray] = {}
    for m in header.pop("arrays", []):
        raw = blob[m["offset"] : m["offset"] + m["nbytes"]]
        arrays[m["name"]] = np.frombuffer(raw, dtype=np.dtype(m["dtype"])).reshape(
            m["shape"]
        )
    return header, arrays


# ----------------------------------------------------- negotiated payloads
#
# The store protocol (service/store_server.py + state/remote.py) frames
# the SAME length-prefixed payloads but negotiates the payload codec at
# connect (`hello`): "json" is the tagged-JSON header format above (the
# compatibility baseline every endpoint speaks), "bin1" is the compact
# binary value codec (state/binwire.py) — magic byte + codec version +
# one encoded value, so a peer can reject an unknown version instead of
# misparsing it.  Arrays never ride store frames; the solver protocol
# keeps calling encode/decode directly.

CODEC_JSON = "json"
CODEC_BIN = "bin1"
_BIN_MAGIC = 0xB5


def encode_payload(header: dict, codec: str = CODEC_JSON) -> bytes:
    # payload-sized encode: sanctioned under VersionedStore.lock only
    # (bin snapshots reference live objects — the serve_watch contract);
    # any other lock held here is a runtime finding
    note_blocking("encode_payload")
    if codec == CODEC_BIN:
        return bytes((_BIN_MAGIC, BIN_VERSION)) + encode_value(header)
    return encode(header, {})


def decode_payload(payload: bytes, codec: str = CODEC_JSON) -> dict:
    if codec == CODEC_BIN:
        if len(payload) < 2 or payload[0] != _BIN_MAGIC:
            raise ValueError("not a bin1 payload (bad magic)")
        if payload[1] != BIN_VERSION:
            raise ValueError(f"unsupported bin1 version: {payload[1]}")
        try:
            return decode_value(payload, 2)
        except (IndexError, TypeError, struct.error) as exc:
            # a truncated/corrupt payload must surface as the one
            # malformed-frame error type callers already handle, not
            # kill a watch thread with a stray IndexError (or the
            # TypeError cls(**kw) raises when a corrupt frame elides a
            # REQUIRED dataclass field)
            raise ValueError(f"malformed bin1 payload: {exc}") from exc
    header, _ = decode(payload)
    return header


# ------------------------------------------------------------ socket I/O


def send_frame(sock: socket.socket, payload: bytes) -> None:
    # the blocking seam (utils/locks.py): socket frame I/O under a held
    # lock is the convoy class the sanitizer observes here
    note_blocking("send_frame")
    sock.sendall(struct.pack(">Q", len(payload)) + payload)


def recv_frame(sock: socket.socket) -> bytes:
    note_blocking("recv_frame")
    size_raw = _recv_exact(sock, 8)
    (size,) = struct.unpack(">Q", size_raw)
    if size > MAX_FRAME:
        raise ValueError(f"frame too large: {size}")
    return _recv_exact(sock, size)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    remaining = n
    while remaining:
        chunk = sock.recv(min(remaining, 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks)
