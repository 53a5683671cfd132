"""The port's fleet pack and tenant pool against the JAX package's.

The same tenants, made from numpy seeds (`testing.fleet_tenant_arrays`:
dyadic requests, requests that binary floats hold inexactly, and
`wrap_arrays`' int32 sums that wrap), go through JAX ``fleet_pack_kernel``
+ ``fleet_unbundle`` and through the port's `fleet_pack` on CPU tensors
(its plain version, `fleet_pack_reference`), at B 1, 3 and 4 and both
objectives.  Every tenant of a case differs from the others in every array
and in its first free slot.

Tolerance: none.  ``take``, ``leftover`` and ``node_cfg`` must be equal and
``node_used`` bit-equal as int32 patterns; each row must also equal a solo
`pack_reference` of its tenant.

Then `TenantResidentPool` against the JAX package's on one seeded stream of
``get`` calls over four tenants under a small budget: the same hits,
misses, evictions in order, ``footprint()`` and ``bytes_of``.
"""

import numpy as np
import pytest
import torch

from karpenter_tpu.ops.packer import fleet_pack_kernel, fleet_unbundle
from karpenter_tpu.ops.resident import TenantResidentPool as JaxPool
from karpenter_tpu_torch.ops.fused_packer import fleet_pack
from karpenter_tpu_torch.ops.packer import pack_reference
from karpenter_tpu_torch.ops.resident import TenantResidentPool
from karpenter_tpu_torch.testing import fleet_columns, fleet_tenant_arrays

OBJECTIVES = ("nodes", "cost")
# (case, B, first seed): dyadic at every B; the other cases at B 4
CASES = [("dyadic", 1, 0), ("dyadic", 3, 10), ("dyadic", 4, 20),
         ("inexact", 3, 30), ("inexact", 4, 40), ("wrap", 4, 50)]


def _tensors(tenant: tuple) -> tuple:
    return tuple(a if isinstance(a, int) else torch.from_numpy(a) for a in tenant)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("case,B,seed", CASES)
def test_fleet_pack_matches_jax_fleet_kernel(case, B, seed, objective):
    tenants = [fleet_tenant_arrays(case, seed + b) for b in range(B)]
    assert len({t[11] for t in tenants}) > 1 or B == 1 or case == "wrap"
    K = tenants[0][8].shape[0]
    Gp, R = tenants[0][0].shape
    jax_cols = fleet_columns(
        [t[:11] + (np.int32(t[11]),) + t[12:] for t in tenants]
    )
    buf = fleet_pack_kernel(jax_cols, k_slots=K, objective=objective)
    want = fleet_unbundle(np.asarray(buf), Gp, K, R)
    take, leftover, node_cfg, node_pods, node_used = fleet_pack(
        fleet_columns([_tensors(t) for t in tenants]), k_slots=K, objective=objective
    )
    assert take.shape == (B, Gp, K) and node_used.shape == (B, K, R)
    for b, (wt, wl, wc, wu) in enumerate(want):
        np.testing.assert_array_equal(take[b].numpy(), wt, err_msg=f"take {b}")
        np.testing.assert_array_equal(leftover[b].numpy(), wl, err_msg=f"leftover {b}")
        np.testing.assert_array_equal(node_cfg[b].numpy(), wc, err_msg=f"node_cfg {b}")
        np.testing.assert_array_equal(_bits(node_used[b]), _bits(wu), err_msg=f"used {b}")
        solo = pack_reference(*_tensors(tenants[b]), objective=objective)
        for name, got, ref in zip(
            ("take", "leftover", "node_cfg", "node_pods"),
            (take[b], leftover[b], node_cfg[b], node_pods[b]), solo,
        ):
            np.testing.assert_array_equal(got.numpy(), ref.numpy(), err_msg=f"{name} {b}")
        np.testing.assert_array_equal(_bits(node_used[b]), _bits(solo[4]))


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("case,seed", [("dyadic", 60), ("wrap", 70)])
def test_fleet_pack_matches_jax_fleet_kernel_past_one_cluster(case, seed, objective):
    """Two tenants at Kp 16,384 (the shapes past which a fleet scan runs on
    the grid's fleet mode): the port's plain fleet pack equals JAX
    ``fleet_pack_kernel`` bit for bit."""
    K = 16384
    tenants = [fleet_tenant_arrays(case, seed + b, K) for b in range(2)]
    Gp, R = tenants[0][0].shape
    jax_cols = fleet_columns([t[:11] + (np.int32(t[11]),) + t[12:] for t in tenants])
    want = fleet_unbundle(np.asarray(fleet_pack_kernel(jax_cols, k_slots=K, objective=objective)),
                          Gp, K, R)
    got = fleet_pack(fleet_columns([_tensors(t) for t in tenants]), k_slots=K,
                     objective=objective)
    assert got[0].shape == (2, Gp, K)
    for b, (wt, wl, wc, wu) in enumerate(want):
        np.testing.assert_array_equal(got[0][b].numpy(), wt, err_msg=f"take {b}")
        np.testing.assert_array_equal(got[1][b].numpy(), wl, err_msg=f"leftover {b}")
        np.testing.assert_array_equal(got[2][b].numpy(), wc, err_msg=f"node_cfg {b}")
        np.testing.assert_array_equal(_bits(got[4][b]), _bits(wu), err_msg=f"used {b}")


def test_wrap_tenants_wrap():
    """The wrap case's tenants do wrap: a prefilled slot takes 2^30 pods of
    a class that requests no axis and its leftover goes negative."""
    tenants = [fleet_tenant_arrays("wrap", 50 + b) for b in range(4)]
    take, leftover, *_ = fleet_pack(
        fleet_columns([_tensors(t) for t in tenants]), k_slots=64
    )
    for b, t in enumerate(tenants):
        assert int(take[b, 0].max()) == 2**30
        assert int(leftover[b, 0]) == -(2**30)
    assert len({t[11] for t in tenants}) == 4  # four first free slots


def test_fleet_pack_checks_its_columns():
    tenants = [fleet_tenant_arrays("dyadic", b) for b in range(2)]
    cols = fleet_columns([_tensors(t) for t in tenants])
    with pytest.raises(ValueError, match="13 columns"):
        fleet_pack(cols[:12], k_slots=64)
    with pytest.raises(ValueError, match="same B"):
        fleet_pack(cols[:3] + (cols[3][:1],) + cols[4:], k_slots=64)
    with pytest.raises(ValueError, match="k_slots"):
        fleet_pack(cols, k_slots=128)
    with pytest.raises(ValueError, match="objective"):
        fleet_pack(cols, k_slots=64, objective="fastest")


def _pool_stream(seed: int):
    """A seeded stream of ``(tenant, name, array)`` gets: four tenants,
    three array names, each call re-sending the tenant's last array for
    that name or a fresh one of another size."""
    rng = np.random.default_rng(seed)
    last = {}
    for _ in range(120):
        tenant = f"t-{int(rng.integers(0, 4))}"
        name = ("req", "feas", "used0")[int(rng.integers(0, 3))]
        key = (tenant, name)
        if key in last and rng.random() < 0.5:
            arr = last[key]
        elif name == "feas":
            arr = rng.random((int(rng.integers(8, 64)), 64)) < 0.5
        else:
            arr = rng.random((int(rng.integers(8, 64)), 6)).astype(np.float32)
        last[key] = arr
        yield tenant, name, arr


@pytest.mark.parametrize("budget", [0, 3_000, 8_000])
def test_tenant_pool_matches_jax_pool(budget):
    jax_pool, pool = JaxPool(budget), TenantResidentPool(budget, device="cpu")
    for tenant, name, arr in _pool_stream(11):
        got, want = pool.get(tenant, name, arr), jax_pool.get(tenant, name, arr)
        if budget <= 0:
            assert got is arr and want is arr
        else:
            assert isinstance(got, torch.Tensor)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (pool.hits, pool.misses) == (jax_pool.hits, jax_pool.misses)
        assert pool.evictions == jax_pool.evictions
        assert pool.footprint() == jax_pool.footprint()
        for t in ("t-0", "t-1", "t-2", "t-3"):
            assert pool.bytes_of(t) == jax_pool.bytes_of(t)
    if budget > 0:
        assert pool.hits and pool.misses and pool.evictions
