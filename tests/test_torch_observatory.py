"""The port's device observatory against the JAX package's.

The same solve stream (a cold solve, a compile-cache hit, a one-pod delta,
a removal batch and a population round) goes through the JAX package's
`TensorScheduler` and the port's `TorchScheduler(device="cpu")`, each inside
a scope of its package's observatory.  The two must count the same resident
updates by kind, upload at the same set of transfer sites and the same
``resident_seed`` bytes; their tick sections must carry the same keys,
`export_device_metrics` must emit the same ``karpenter_device_*`` families
with the same label names, and with ``enabled = False`` both seams must pass
through with nothing counted and the same results.

Launch names differ by design (the reference's jit entry points against the
port's kernel wrappers), and so do the "compiles": jit-cache growth there,
new launch signatures here.
"""

import importlib

import numpy as np
import pytest

import torch_specs

PACKAGES = ("karpenter_tpu", "karpenter_tpu_torch")


def _observatory(pkg):
    return importlib.import_module(f"{pkg}.obs.device")


def _plain_pods(s, n, offset=0):
    sizes = torch_specs._sizes(s)
    return [s.Pod(requests=sizes[(i + offset) % len(sizes)]) for i in range(n)]


# the schedulers of the last stream: their resident caches stay alive (and
# in the observatory's footprint) until the next stream
_KEEP = []


def _stream(pkg, enabled=True):
    """Run the stream on one package; returns (scope, result digests).
    ``enabled`` is set on the observatory for the solves (the reference's
    catalog comes from an operator `Environment`, which sets it too)."""
    s = torch_specs.side(pkg)
    s.reset()
    obs = _observatory(pkg).OBSERVATORY
    pools = [s.pool("general")]
    inventory = s.catalog(pools, torch_specs.SMALL_SHAPES)
    pools2, inventory2, existing, cands = torch_specs.consolidation(s, 4, 10)
    scope = obs.begin_scope()
    digests = []
    obs.enabled = enabled
    _KEEP.clear()
    try:
        sched = s.scheduler(pools, inventory)
        _KEEP.append(sched)
        pods = _plain_pods(s, 60)
        digests.append(torch_specs.canonical(sched.solve(pods), s.L))  # cold
        digests.append(torch_specs.canonical(sched.solve(pods), s.L))  # hit
        pods = pods + _plain_pods(s, 1, offset=3)  # one arrival
        digests.append(torch_specs.canonical(sched.solve(pods), s.L))  # delta
        assert sched.last_delta_rows > 0
        sched = s.scheduler(pools2, inventory2, existing=existing)
        _KEEP.append(sched)
        verdicts = sched.evaluate_removals([[c] for c in cands], cands)
        digests.append([tuple(v) for v in verdicts])
        masks = np.random.default_rng(2).random((8, len(cands))) < 0.3
        verdicts = sched.evaluate_population(masks, cands)
        digests.append([tuple(v) for v in verdicts])
    finally:
        obs.enabled = True
        obs.end_scope(scope)
    return scope, digests


def test_solve_stream_counts_alike():
    (ref, ref_out), (port, port_out) = (_stream(pkg) for pkg in PACKAGES)
    assert port_out == ref_out
    assert port.resident_updates == ref.resident_updates
    assert port.resident_updates.get("seed") and port.resident_updates.get("donated")
    assert sorted(port.transfer_bytes) == sorted(ref.transfer_bytes)
    for site in ("resident_seed", "resident_delta", "removal_base",
                 "population_tensors", "removal_verdict_kernel",
                 "population_verdict_kernel"):
        assert port.transfer_bytes.get(site, 0) > 0, site
    assert port.transfer_bytes["resident_seed"] == ref.transfer_bytes["resident_seed"]
    # every launch went through the counted seam
    assert port.dispatches.get("ffd_pack", 0) >= 3
    assert port.dispatches.get("resident_delta", 0) >= 1
    assert port.dispatches.get("removal_verdicts", 0) == 1
    assert port.dispatches.get("population_verdicts", 0) == 1


def _device_families(registry):
    out = {}
    for kind in ("counters", "gauges", "histograms"):
        for name, series in getattr(registry, kind).items():
            if name.startswith("karpenter_device_"):
                out[name] = (kind, {tuple(k for k, _ in labels) for labels in series})
    return out


def test_tick_sections_and_exported_families_alike():
    families = []
    for pkg in PACKAGES:
        mod = _observatory(pkg)
        reg = importlib.import_module(f"{pkg}.metrics.registry").Registry()
        obs = mod.OBSERVATORY
        obs.begin_tick(1)
        _stream(pkg)
        section = obs.tick_section()
        assert section["dispatches"] > 0 and section["transfer_bytes"] > 0, (pkg, section)
        mod.export_device_metrics(reg, obs, None)
        families.append((set(section), _device_families(reg)))
    (ref_keys, ref_fams), (port_keys, port_fams) = families
    assert port_keys == ref_keys
    for name in ("karpenter_device_dispatches_total",
                 "karpenter_device_transfer_bytes_total",
                 "karpenter_device_resident_updates_total",
                 "karpenter_device_resident_bytes",
                 "karpenter_device_compiles_total"):
        assert name in port_fams and name in ref_fams, name
    for name, fam in port_fams.items():
        assert name in ref_fams, name
        assert fam[0] == ref_fams[name][0], (name, fam, ref_fams[name])
        assert fam[1] == ref_fams[name][1], (name, fam, ref_fams[name])


def test_library_build_exports_compile_seconds():
    """The port's one real compile (the nvcc build of a CUDA library) lands
    in the reference's compile-seconds family, labelled by fn."""
    mod = _observatory("karpenter_tpu_torch")
    reg = importlib.import_module("karpenter_tpu_torch.metrics.registry").Registry()
    obs = mod.DeviceObservatory()
    obs.record_build("ffd_pack", 12.5)
    mod.export_device_metrics(reg, obs, None)
    assert reg.histogram("karpenter_device_compile_seconds", {"fn": "ffd_pack"}) == [12.5]
    assert obs.snapshot()["compile_seconds"] == {"ffd_pack": 12.5}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_disabled_passes_through(pkg):
    _, enabled_out = _stream(pkg)
    scope, disabled_out = _stream(pkg, enabled=False)
    assert disabled_out == enabled_out
    assert not scope.dispatches and not scope.transfer_bytes
    assert not scope.resident_updates and not scope.compiles


def test_overflow_retry_uploads_the_catalog_once():
    """`torch_specs`' overflow scenario solved twice: the first pack runs
    on the resident tensors and overflows, the retry packs cold at twice
    the slots, and the second solve retries again.  Both packages upload at
    the same transfer sites, the cold packs' catalog columns once, through
    their device-constant cache (``pack_constants``), and the same
    ``resident_seed`` bytes.  ``pack_kernel_buffered`` bytes differ by
    design: the reference packs its per-solve arguments into one buffer."""
    scopes, digests = [], []
    for pkg in PACKAGES:
        s = torch_specs.side(pkg)
        pools, inventory, existing, pods = torch_specs.build(s, "overflow")
        obs = _observatory(pkg).OBSERVATORY
        scope = obs.begin_scope()
        try:
            sched = s.scheduler(pools, inventory, existing=existing)
            digests.append([torch_specs.canonical(sched.solve(pods), s.L) for _ in range(2)])
        finally:
            obs.end_scope(scope)
        scopes.append(scope)
    (ref, port), (ref_out, port_out) = scopes, digests
    assert port_out == ref_out
    assert sorted(port.transfer_bytes) == sorted(ref.transfer_bytes)
    assert {"resident_seed", "pack_constants", "pack_kernel_buffered"} <= set(port.transfer_bytes)
    assert "device_constants" not in port.transfer_bytes
    assert port.transfer_bytes["pack_constants"] == ref.transfer_bytes["pack_constants"]
    assert port.transfer_bytes["resident_seed"] == ref.transfer_bytes["resident_seed"]
    # once: one upload of the padded alloc, price and openable columns
    from karpenter_tpu_torch.ops import packer as P

    assert len(P._DEV_CONST_CACHE) >= 1
    alloc, price, openable = next(reversed(P._DEV_CONST_CACHE.values()))[1]
    once = sum(t.numel() * t.element_size() for t in (alloc, price, openable))
    assert port.transfer_bytes["pack_constants"] == once
