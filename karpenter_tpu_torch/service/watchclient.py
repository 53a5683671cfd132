"""The shared watch-CLIENT half of the store plane's watch protocol.

Two consumers speak the client side of ``watch`` (docs/designs/
store-scale.md): ``RemoteKubeStore._watch_loop`` (an operator's mirror)
and the read replica's follower (``StoreServer._follow_loop``).  Before
this module each carried its own copy of the dial / handshake / backoff
/ resync choreography.  The choreography is subtle enough to deserve one definition:

- dial, present the handshake (codecs / schema_fp / since_seq / epoch —
  computed FRESH per attempt, because the cursor and epoch move between
  reconnects),
- adopt the ack's epoch BEFORE any payload applies (an interrupted
  handshake must never leave a new-epoch label over an old-space seq),
- handle a legacy server's inline-snapshot ack, else read the first
  sync frame under the negotiated codec,
- switch to BLOCKING reads for the steady frame loop (a short recv
  timeout could fire mid-frame and desync the stream — the consumed
  prefix is lost and the next read parses payload bytes as a length
  header; close() on the exposed live socket interrupts the recv
  instead),
- on ANY of the reconnect-worthy errors — including KeyError: a frame
  missing an expected key is a malformed or down-version peer, and must
  reconnect-and-resync, never silently kill the thread — back off
  exponentially and re-dial.

What stays with the caller: what the handshake says, how frames apply,
and the socket/byte accounting (the mirror counts wire bytes per codec;
the follower does not) — the ``tx``/``rx`` hooks carry those
differences.
"""

from __future__ import annotations

import struct
from typing import Callable, Optional

from karpenter_tpu_torch.service.codec import CODEC_JSON, decode_payload, encode_payload

# errors that mean "reconnect and resync", never "die": transport drops,
# malformed payloads (ValueError from the codec layer), missing frame
# keys from a down-version peer (KeyError), torn length prefixes
# (struct.error)
RECONNECT_ERRORS = (ConnectionError, OSError, ValueError, KeyError, struct.error)


class WatchChannelClient:
    """One watch-protocol client loop over caller-supplied transport.

    ``run()`` blocks until ``stop`` is set; it is the body the caller's
    daemon thread executes.  Hooks:

    - ``dial()`` → connected socket (timeouts set for the handshake)
    - ``hello()`` → the watch-request dict for THIS attempt
    - ``tx(sock, payload)`` / ``rx(sock, codec)`` → framed bytes out/in
    - ``on_epoch(epoch)`` → adopt/reset cursors at DETECTION time
    - ``on_legacy_snapshot(snapshot)`` → a pre-negotiation server's
      inline-snapshot ack
    - ``on_frame(frame, initial)`` → apply one pushed frame (``initial``
      marks the handshake's first sync frame)
    - ``on_live(sock_or_none)`` → expose/clear the blocking socket so
      ``close()`` elsewhere can interrupt the recv
    - ``pace(delay_s)`` → wait out one reconnect backoff; returns True
      to stop the loop.  Production's default waits the exponential
      backoff on the stop event (wall clock); the fleet simulator
      injects a deterministic pacer so scripted disconnects reconnect
      on SIMULATED time and record/replay traces stay byte-identical.
    """

    def __init__(
        self,
        *,
        dial: Callable,
        hello: Callable[[], dict],
        tx: Callable,
        rx: Callable,
        on_epoch: Callable[[str], None],
        on_legacy_snapshot: Callable[[dict], None],
        on_frame: Callable[[dict, bool], None],
        stop,  # threading.Event
        on_live: Optional[Callable] = None,
        backoff_s: float = 0.05,
        backoff_max: float = 1.0,
        pace: Optional[Callable[[float], bool]] = None,
    ):
        self.dial = dial
        self.hello = hello
        self.tx = tx
        self.rx = rx
        self.on_epoch = on_epoch
        self.on_legacy_snapshot = on_legacy_snapshot
        self.on_frame = on_frame
        self.stop = stop
        self.on_live = on_live or (lambda _sock: None)
        self.backoff_s = backoff_s
        self.backoff_max = backoff_max
        # the reconnect-backoff seam: all waiting routes through ONE
        # injectable callable (stop.wait keeps production's wall-clock
        # exponential backoff AND stays responsive to close())
        self.pace = pace or self.stop.wait

    def run(self) -> None:
        backoff = self.backoff_s
        while not self.stop.is_set():
            sock = None
            try:
                sock = self.dial()
                self.tx(sock, encode_payload(self.hello(), CODEC_JSON))
                ack = decode_payload(self.rx(sock, CODEC_JSON), CODEC_JSON)
                self.on_epoch(str(ack.get("epoch") or ""))
                if "snapshot" in ack:  # legacy server: inline snapshot
                    codec = CODEC_JSON
                    self.on_legacy_snapshot(ack["snapshot"])
                else:
                    codec = ack.get("codec", CODEC_JSON)
                    self.on_frame(
                        decode_payload(self.rx(sock, codec), codec), True
                    )
                backoff = self.backoff_s
                sock.settimeout(None)  # blocking steady-state reads
                self.on_live(sock)
                while not self.stop.is_set():
                    self.on_frame(
                        decode_payload(self.rx(sock, codec), codec), False
                    )
            except RECONNECT_ERRORS:
                if self.pace(backoff):
                    break
                backoff = min(backoff * 2, self.backoff_max)
            finally:
                self.on_live(None)
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
