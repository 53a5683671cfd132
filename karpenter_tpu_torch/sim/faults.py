"""Deterministic wire-level fault injection for the store plane.

The shard-chaos scenario (sim/fleet.py) must prove the client survives
MALFORMED bytes, not just dead sockets: a torn length prefix, a
zero-length frame, a garbled payload, a delayed ack, a failing fsync.
Randomly yanking real sockets cannot be byte-replayed; these injectors
are scripted instead — each fault is an ``ev`` tape line, applied at a
deterministic point, producing a deterministic error on the next RPC.

`WireFaultInjector.inject(chan, fault)` swaps a `StoreChannel`'s RPC
socket for an in-memory scripted one: the next request "reaches the
server" (the send is swallowed) and the response bytes are the scripted
fault.  The client's retry loop (state/remote.py) must classify every
one as reconnect-worthy — ConnectionError for drops, ValueError for the
malformed frames (service/codec.py's hardened decoders) — close the
poisoned connection, re-dial the REAL server, and succeed on the retry.
An injected fault is therefore invisible in the byte-compared trace: it
costs one retry, never a wrong answer.

`FailingFsync` arms a one-shot OSError for a `DurableReplayLog`'s
fsync seam: the log must fail CLOSED (inert, counted in
``karpenter_store_log_failures_total``) while the store keeps serving.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional

from karpenter_tpu_torch.metrics.registry import Registry

# scripted response byte-streams, by fault name.  Each is what the
# client's recv sees after its request is swallowed:
#   drop            — connection dies before any response byte
#   zero_frame      — a length prefix declaring an empty payload
#   truncated_frame — a prefix declaring 64 bytes, then the wire dies
#   garbled_payload — a well-framed payload that is not a valid codec
#                     payload under ANY negotiated codec
WIRE_FAULTS: Dict[str, bytes] = {
    "drop": b"",
    "zero_frame": struct.pack(">Q", 0),
    "truncated_frame": struct.pack(">Q", 64) + b"torn",
    "garbled_payload": struct.pack(">Q", 3) + b"\xff\xff\xff",
}


class _ScriptedSocket:
    """A one-shot fake socket: swallows the framed request, serves the
    scripted response bytes, then reads as a dead connection.  Duck-types
    the socket surface the codec layer touches."""

    def __init__(self, response: bytes):
        self._buf = response

    def sendall(self, data: bytes) -> None:  # request swallowed
        pass

    def recv(self, n: int) -> bytes:
        if not self._buf:
            raise ConnectionError("injected wire fault: connection torn")
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def settimeout(self, t) -> None:
        pass

    def close(self) -> None:
        self._buf = b""


class _DelayedSocket:
    """Delegates to the real socket, but the first recv waits out a
    simulated delay first — the 'delayed ack' fault.  On a FakeClock the
    sleep ADVANCES simulated time instead of blocking, so the fault is
    free on the wall clock and visible to anything pacing on the clock
    (lease expiry, backoff)."""

    def __init__(self, sock, clock, delay_s: float):
        self._sock = sock
        self._clock = clock
        self._delay_s = delay_s

    def recv(self, n: int) -> bytes:
        if self._delay_s:
            delay, self._delay_s = self._delay_s, 0.0
            self._clock.sleep(delay)
        return self._sock.recv(n)

    def __getattr__(self, name):
        return getattr(self._sock, name)


class WireFaultInjector:
    """Scripted faults against a `RemoteKubeStore` shard channel."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or Registry()
        self.injected: Dict[str, int] = {}

    def inject(self, chan, fault: str) -> None:
        """Poison ``chan``'s next RPC with ``fault`` (a WIRE_FAULTS
        name).  Taken under the channel lock so an in-flight request is
        never torn mid-frame by the swap itself — the fault lands on the
        NEXT request, deterministically."""
        if fault not in WIRE_FAULTS:
            raise ValueError(
                f"unknown wire fault {fault!r}; have {sorted(WIRE_FAULTS)}"
            )
        with chan._lock:
            chan.close_sock()
            chan.sock = _ScriptedSocket(WIRE_FAULTS[fault])
        self.injected[fault] = self.injected.get(fault, 0) + 1
        self.registry.inc(
            "karpenter_sim_wire_faults_total", {"fault": fault}
        )

    def delay_ack(self, chan, clock, delay_s: float) -> None:
        """Wrap the channel's live socket so the next response is
        delayed by ``delay_s`` SIMULATED seconds."""
        with chan._lock:
            if chan.sock is not None:
                chan.sock = _DelayedSocket(chan.sock, clock, delay_s)
        self.injected["delay"] = self.injected.get("delay", 0) + 1
        self.registry.inc(
            "karpenter_sim_wire_faults_total", {"fault": "delay"}
        )


class FailingFsync:
    """An fsync seam for `DurableReplayLog` that raises once per arm:
    ``log.fsync_fn = FailingFsync()`` then ``.arm()`` at the scripted
    tick — the next append's fsync raises OSError and the log fails
    closed while the store keeps serving."""

    def __init__(self):
        self.armed = False
        self.failures = 0

    def arm(self) -> None:
        self.armed = True

    def __call__(self, fd: int) -> None:
        if self.armed:
            self.armed = False
            self.failures += 1
            raise OSError("injected fsync failure")
        # intentionally no real fsync: the simulator's logs live in a
        # tempdir and the durability claim under test is the FAILURE
        # path, not the disk platter
