"""Solver sidecar client: `pack` over the wire, drop-in for run_pack.

`RemoteSolver.pack_problem(prob, ...)` matches `ops.packer.run_pack`'s
signature/result shape, so `TorchScheduler(pack_fn=remote.pack_problem)`
moves the device half of every solve into the sidecar without touching
the controller code.  A copy of ``karpenter_tpu/service/client.py``.
"""

from __future__ import annotations

import socket
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np

from karpenter_tpu_torch.obs.context import current_trace_id
from karpenter_tpu_torch.ops.packer import pad_problem
from karpenter_tpu_torch.ops.tensorize import CompiledProblem
from karpenter_tpu_torch.service.codec import decode, encode, recv_frame, send_frame
from karpenter_tpu_torch.service.server import PACK_ARG_ORDER, PACK_RESULT_FIELDS
from karpenter_tpu_torch.utils.locks import make_lock, note_blocking


class RemotePackResult(NamedTuple):
    take: np.ndarray
    leftover: np.ndarray
    node_cfg: np.ndarray
    node_pods: np.ndarray
    node_used: np.ndarray


class SolverUnavailableError(ConnectionError):
    pass


class SolverBusyError(RuntimeError):
    """The service refused the solve under backpressure (explicit
    RETRY-AFTER, never silent queuing — docs/designs/solver-service.md).
    The caller keeps last tick's plan and retries after `retry_after_s`."""

    def __init__(self, reason: str, retry_after_s: float):
        super().__init__(
            f"solver busy ({reason}); retry after {retry_after_s:.3f}s"
        )
        self.reason = reason
        self.retry_after_s = float(retry_after_s)


class RemoteSolver:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 7421,
        connect_timeout: float = 10.0,
        request_timeout: float = 300.0,
        tenant: str = "",
    ):
        # request_timeout must cover a cold solve: the sidecar's first pack
        # on the card builds the kernels' library
        self.host = host
        self.port = port
        self.connect_timeout = connect_timeout
        self.request_timeout = request_timeout
        # identity on a shared (multi-tenant) SolverService: names this
        # client's resident pool, admission quota and metrics slice;
        # empty means the server's "default" tenant (legacy sidecar)
        self.tenant = tenant
        self._sock: Optional[socket.socket] = None
        self._lock = make_lock("RemoteSolver._lock")

    # ------------------------------------------------------------- transport
    def _connect(self) -> socket.socket:
        if self._sock is None:
            try:
                self._sock = socket.create_connection(
                    (self.host, self.port), timeout=self.connect_timeout
                )
                self._sock.settimeout(self.request_timeout)
            except OSError as exc:
                raise SolverUnavailableError(
                    f"solver sidecar at {self.host}:{self.port}: {exc}"
                ) from exc
        return self._sock

    def _call(self, meta: dict, arrays: dict) -> Tuple[dict, dict]:
        note_blocking("_rpc")  # the blocking seam (utils/locks.py)
        if self.tenant:
            meta = dict(meta, tenant=self.tenant)
        # ship the caller's trace ID so the server's handling span lands
        # on this tick's cross-process timeline (store client idiom)
        trace_id = current_trace_id()
        if trace_id:
            meta = dict(meta, ctx={"trace_id": trace_id})
        with self._lock:  # one in-flight request per connection
            sock = self._connect()
            try:
                send_frame(sock, encode(meta, arrays))
                header, out = decode(recv_frame(sock))
            except (ConnectionError, OSError) as exc:
                self.close()
                raise SolverUnavailableError(str(exc)) from exc
        if header.get("status") == "retry":
            raise SolverBusyError(
                str(header.get("reason", "busy")),
                float(header.get("retry_after_s", 0.05)),
            )
        if header.get("status") != "ok":
            raise RuntimeError(f"solver error: {header.get('error')}")
        return header, out

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    # --------------------------------------------------------------- methods
    def ping(self) -> bool:
        self._call({"method": "ping"}, {})
        return True

    def info(self) -> dict:
        header, _ = self._call({"method": "info"}, {})
        return {k: v for k, v in header.items() if k != "status"}

    def pack_problem(
        self, prob: CompiledProblem, k_slots: int = 0, objective: str = "nodes"
    ) -> RemotePackResult:
        """run_pack over the wire: pad locally, solve in the sidecar."""
        args, kp = pad_problem(prob, k_slots)
        arrays = {
            name: np.asarray(val) for name, val in zip(PACK_ARG_ORDER, args)
        }
        _, out = self._call(
            {"method": "pack", "k_slots": kp, "objective": objective}, arrays
        )
        return RemotePackResult(*(out[f] for f in PACK_RESULT_FIELDS))
