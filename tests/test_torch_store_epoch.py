"""The double-restart epoch race of the port's `RemoteKubeStore`, pinned.

``tests/test_store_shards.py``'s ``TestDoubleRestartEpoch`` restarts the
server twice inside one reconnect window and expects the client's one
reconnect to be a counted snapshot resync.  It failed now and then, in
both packages, alone too: its ``wait_synced`` returned before the watch
thread had dialed (on a fresh server every rv target is 0), so the first
server could stop before the stream's first transfer, which then came from
the third incarnation as the mirror's first sync and no resync.

The cases below script that interleaving with a gated pacer and a gated
first dial, so each outcome is the same on every run: the lost transfer,
`wait_synced` waiting for the first transfer, and the reconnect after it.
"""

import socket
import threading
import time

from karpenter_tpu_torch.api import Pod, Resources
from karpenter_tpu_torch.service.store_server import StoreServer
from karpenter_tpu_torch.state import remote
from karpenter_tpu_torch.state.remote import RemoteKubeStore

WATCH_THREAD = "store-watch-"


def _wait(cond, timeout=8.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


def _gated_pacer():
    """A pacer that parks each reconnect until ``gate`` is set."""
    gate, gated = threading.Event(), threading.Event()

    def pace(_delay_s):
        gated.set()
        gate.wait(timeout=30.0)
        return False

    return gate, gated, pace


def _restart_twice(host, port):
    """Two incarnations after the first, each with one pod; returns the
    last server, its writer and the two epochs."""
    srv2 = StoreServer(host=host, port=port).start_background()
    w = RemoteKubeStore(host, port, identity="w2", start_watch=False)
    w.put_pod(Pod(name="era2", requests=Resources(cpu=1)))
    w.close()
    epoch2 = srv2.store.epoch
    srv2.stop()
    srv3 = StoreServer(host=host, port=port).start_background()
    writer = RemoteKubeStore(host, port, identity="w3", start_watch=False)
    writer.put_pod(Pod(name="era3", requests=Resources(cpu=1)))
    return srv3, writer, epoch2, srv3.store.epoch


def test_first_transfer_after_the_restarts_is_no_resync():
    """The failing interleaving: the watch's first dial comes after the
    first server stopped.  The stream's first transfer then comes from the
    newest incarnation and counts as the first sync, not as a resync."""
    srv1 = StoreServer().start_background()
    host, port = srv1.address
    gate, gated, pace = _gated_pacer()
    client = RemoteKubeStore(host, port, identity="late", watch_pace=pace,
                             start_watch=False)
    srv3 = writer = None
    try:
        client.put_pod(Pod(name="era1", requests=Resources(cpu=1)))
        epoch1 = srv1.store.epoch
        srv1.stop()
        client.start_watch()  # its first dial meets the stopped server
        _wait(gated.is_set, msg="watch parked before its first transfer")
        assert client._watch_epoch == "" and not client._channels[0].ever_synced
        srv3, writer, epoch2, epoch3 = _restart_twice(host, port)
        assert len({epoch1, epoch2, epoch3}) == 3
        gate.set()
        _wait(lambda: client._watch_epoch == epoch3, msg="newest epoch adopted")
        _wait(lambda: "default/era3" in client.pods, msg="era3 mirrored")
        assert client.watch_resyncs == {}
    finally:
        gate.set()
        client.close()
        if writer is not None:
            writer.close()
        for s in (srv1, srv3):
            if s is not None:
                s.stop()


def test_wait_synced_waits_for_the_first_transfer(monkeypatch):
    """With the watch thread's first dial held, `wait_synced` on a fresh
    server (every rv target 0) does not report a synced mirror; once the
    dial goes through it does, after the stream's first transfer."""
    srv = StoreServer().start_background()
    host, port = srv.address
    dial = threading.Event()
    real = socket.create_connection

    def gated(*a, **kw):
        if threading.current_thread().name.startswith(WATCH_THREAD):
            dial.wait(timeout=30.0)
        return real(*a, **kw)

    monkeypatch.setattr(remote.socket, "create_connection", gated)
    client = RemoteKubeStore(host, port, identity="held")
    try:
        assert client.wait_synced(timeout=0.3) is False
        assert not client._channels[0].ever_synced
        dial.set()
        assert client.wait_synced(timeout=8.0)
        assert client._channels[0].ever_synced
        assert client._watch_epoch == srv.store.epoch
    finally:
        dial.set()
        client.close()
        srv.stop()


def test_reconnect_after_the_first_transfer_is_a_snapshot_resync():
    """The interleaving the reference test means: the first transfer made
    before the first server stops (`wait_synced` waits for it), then one
    reconnect into the third incarnation, a foreign-epoch cursor and a
    counted snapshot resync; no replay, no stale pod."""
    srv1 = StoreServer().start_background()
    host, port = srv1.address
    gate, gated, pace = _gated_pacer()
    client = RemoteKubeStore(host, port, identity="survivor", watch_pace=pace)
    srv3 = writer = None
    try:
        assert client.wait_synced(timeout=8.0)
        epoch1 = srv1.store.epoch
        assert client._watch_epoch == epoch1
        client.put_pod(Pod(name="era1", requests=Resources(cpu=1)))
        srv1.stop()
        _wait(gated.is_set, msg="client parked in reconnect backoff")
        srv3, writer, epoch2, epoch3 = _restart_twice(host, port)
        gate.set()
        _wait(lambda: client._watch_epoch == epoch3, msg="newest epoch adopted")
        _wait(lambda: "default/era3" in client.pods
              and "default/era1" not in client.pods
              and "default/era2" not in client.pods,
              msg="mirror is the newest incarnation's state")
        assert client.watch_resyncs == {"snapshot": 1}
        assert epoch2 not in (client._watch_epoch, epoch1)
    finally:
        gate.set()
        client.close()
        if writer is not None:
            writer.close()
        for s in (srv1, srv3):
            if s is not None:
                s.stop()
