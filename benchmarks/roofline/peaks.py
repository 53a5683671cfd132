"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet) at its
700 W limit, and the least time a launch could take on them."""

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound(byts: int, ops: int) -> dict:
    """``max(bytes / HBM rate, operations / float32 rate)`` in ms."""
    t_bytes, t_ops = byts / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(byts), "operations": int(ops)}
