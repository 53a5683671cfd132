"""The port's device mesh against the JAX package's, on the CPU.

Twins of tests/test_parallel.py's five tests and of
tests/test_resident_fuzz.py's ``test_mesh_stream``: the port's sharded pack
runs on a mesh of CPU shards (`testing.cpu_mesh`: the shard kernels' plain
versions and the exchange between shards, in one process), the JAX
package's on the 8 virtual CPU devices tests/conftest.py pins.  Tolerance:
none.  The five pack outputs are compared bit for bit (``node_used`` as
float32 bit patterns), where the reference's own sharded test allows
``rtol=1e-5`` on ``node_used``.
"""

import numpy as np
import pytest
import torch

from karpenter_tpu.ops.packer import pack_kernel as jax_pack_kernel
from karpenter_tpu.parallel import mesh as jax_mesh
from karpenter_tpu_torch import testing as T
from karpenter_tpu_torch.ops import fused_packer
from karpenter_tpu_torch.ops import packer as P
from karpenter_tpu_torch.ops.tensorize import compile_problem
from karpenter_tpu_torch.parallel import mesh as port_mesh
from karpenter_tpu_torch.scheduling.solver import TorchScheduler, default_pack_fn

JAX, PORT = "karpenter_tpu", "karpenter_tpu_torch"
SHAPES = ((1, 1), (2, 1), (1, 2), (4, 2))
OBJECTIVES = ("nodes", "cost")
OUTPUTS = ("take", "leftover", "node_cfg", "node_pods", "node_used")


def _np(x) -> np.ndarray:
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _assert_equal(got, want, what="") -> None:
    for name, a, b in zip(OUTPUTS, got, want):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape, (what, name, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {name}")


@pytest.fixture(scope="module")
def jax_mesh8():
    return jax_mesh.make_mesh(8)


# ------------------------------------------------------------- the mesh
def test_mesh_shape():
    """The reference's axis rules: powers of two, (n/2, 2) from two devices
    up, (1, 1) for one; a device named more than once is one shard each."""
    mesh = port_mesh.make_mesh(8, ["cpu"] * 8)
    assert mesh.shape == (4, 2) == jax_mesh.make_mesh(8).devices.shape
    assert mesh.axis_names == ("data", "model") == jax_mesh.make_mesh(8).axis_names
    for n in range(1, 9):
        assert port_mesh.make_mesh(n, ["cpu"] * 8).shape == jax_mesh.make_mesh(n).devices.shape
    assert port_mesh.make_mesh(None, ["cpu"] * 12).shape == (4, 2)
    assert hash(T.cpu_mesh()) == hash(T.cpu_mesh()) and T.cpu_mesh() == T.cpu_mesh()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_mesh.make_mesh()
        with pytest.raises(RuntimeError, match="is_available"):
            port_mesh.make_mesh(8, ["cuda:0"] * 8)


def test_assemble_feasibility_matches_jax(jax_mesh8):
    """The dense mask from the factorized admission, whole and tile by tile
    over each mesh (each tile copied to every device's mask)."""
    p = T.mesh_step_problem()
    adm = [p[k] for k in T.MESH_STEP_ARGS[:7]]
    want = np.asarray(jax_mesh.assemble_feasibility(*adm))
    got = port_mesh.assemble_feasibility(*(torch.from_numpy(a) for a in adm))
    np.testing.assert_array_equal(got.numpy(), want)
    G, C = want.shape
    for shape in SHAPES:
        mesh = T.cpu_mesh(shape)
        plan = P.mesh_plan(mesh.devices, G, C, 32)
        tensors = {dev: tuple(torch.from_numpy(a) for a in adm) for dev in mesh.distinct()}
        for feas in fused_packer.mesh_assemble_feasibility(plan, tensors, G, C).values():
            np.testing.assert_array_equal(feas.numpy(), want)


# ------------------------------------------------- tests/test_parallel.py
@pytest.fixture(scope="module")
def step_reference(jax_mesh8):
    """The JAX package's single-device pack and its sharded step on the
    8-device mesh, on the reference fixture's problem."""
    p = T.mesh_step_problem()
    K = p["used0"].shape[0]
    feas = np.asarray(jax_mesh.assemble_feasibility(*(p[k] for k in T.MESH_STEP_ARGS[:7])))
    single = jax_pack_kernel(
        p["req"], p["cnt"], p["maxper"], p["slot"], feas, p["alloc"], p["price"],
        p["openable"], p["used0"], p["cfg0"], p["npods0"], p["next0"], p["sig0"], k_slots=K,
    )
    sharded = jax_mesh.sharded_solve_step(jax_mesh8, k_slots=K)(*(p[k] for k in T.MESH_STEP_ARGS))
    return p, single, sharded


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_matches_single_device(step_reference, shape):
    p, single, sharded = step_reference
    _assert_equal(single, sharded, "JAX single vs JAX mesh")
    K = p["used0"].shape[0]
    got = port_mesh.sharded_solve_step(T.cpu_mesh(shape), k_slots=K)(
        *(p[k] for k in T.MESH_STEP_ARGS))
    _assert_equal(got, single, f"port {shape} vs JAX single")
    _assert_equal(got, sharded, f"port {shape} vs JAX mesh")


def test_all_pods_placed_or_leftover(step_reference):
    p = step_reference[0]
    K = p["used0"].shape[0]
    out = port_mesh.sharded_solve_step(T.cpu_mesh(), k_slots=K)(*(p[k] for k in T.MESH_STEP_ARGS))
    take, leftover, cfg, _, used = (t.numpy() for t in out)
    assert int(take.sum()) + int(leftover.sum()) == int(p["cnt"].sum())
    for k in range(K):
        if cfg[k] >= 0:
            assert (used[k] <= p["alloc"][cfg[k]] + 1e-3).all()


@pytest.fixture(scope="module")
def deep_problem():
    """The reference's deep class axis (~200 request classes) compiled by
    the port, padded as `mesh_pack_fn` pads it for the (4, 2) mesh."""
    pool = T.default_node_pool()
    types = T.instance_types(pool)
    prob = compile_problem(T.deep_class_pods(), [pool], {pool.name: types})
    assert len(prob.classes) >= 150, len(prob.classes)
    args, kp = P.pad_problem(prob, max(P.node_slot_bound(prob), 8 * 4))
    return prob, args, kp


def _jax_args(args):
    return tuple(np.int32(a) if isinstance(a, int) else a for a in args)


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_sharded_deep_class_axis_parity(deep_problem, jax_mesh8, objective):
    """A deep sequential class axis: the port's sharded pack on every mesh
    shape equals the JAX package's single-device pack and its sharded pack
    on the 8-device mesh, on the same padded arrays, both objectives."""
    prob, args, kp = deep_problem
    single = jax_pack_kernel(*_jax_args(args), k_slots=kp, objective=objective)
    sharded = jax_mesh._sharded_pack(jax_mesh8, kp, objective)(*_jax_args(args))
    _assert_equal(single, sharded, "JAX single vs JAX mesh")
    plain = P.pack_reference(*P.to_device(args, torch.device("cpu")), objective=objective)
    _assert_equal(plain, single, "port single-device plain vs JAX")
    for shape in SHAPES:
        got = port_mesh._sharded_pack(T.cpu_mesh(shape), kp, objective)(*args)
        _assert_equal(got, single, f"port {shape}")


def test_mesh_pack_fn_flagship_scale_through_scheduler():
    """The production path, `TorchScheduler` with the mesh's pack_fn, on
    the flagship problem: the same decoded result as the single-device
    solve, through the mesh backend."""
    import torch_specs
    from karpenter_tpu_torch.api import labels as L

    pool, types, pods = T.flagship_problem()
    single = TorchScheduler([pool], {pool.name: types}, device="cpu")
    mesh = TorchScheduler([pool], {pool.name: types}, device="cpu",
                          pack_fn=port_mesh.mesh_pack_fn(T.cpu_mesh()))
    a, b = single.solve(pods), mesh.solve(pods)
    assert not a.unschedulable and not b.unschedulable
    assert mesh.last_kernel == "scan-sharded" and single.last_kernel == "reference"
    assert torch_specs.canonical(b, L) == torch_specs.canonical(a, L)


# ------------------------------------------------ the int32 wrap cases
WRAP_CASES = {
    "wrap-256-at-0": lambda: T.wrap_arrays(256),
    "wrap-256-straddling-128": lambda: T.wrap_arrays(256, at=126),
    "wrap-64-at-30": lambda: T.wrap_arrays(64, at=30),
    **{f"frontier-{c}-{b}": (lambda c=c, b=b: T.frontier_pack(c, b))
       for c in T.FRONTIER_CASES for b in (0, -1)},
}


@pytest.mark.parametrize("case", sorted(WRAP_CASES))
def test_wrap_and_frontier_arrays_match_pack_reference(case):
    """`testing.wrap_arrays` (int32 sums that wrap: prefixes that wrap
    negative, windows of negative length, a first free slot below 0, the
    prefilled slots across a shard boundary) and `testing.frontier_arrays`
    through the sharded pack on a (4, 2) and a (2, 1) mesh: equal to the
    unsharded plain pack and to the JAX package's ``pack_kernel``, both
    objectives."""
    args = WRAP_CASES[case]()
    K = args[8].shape[0]
    for objective in OBJECTIVES:
        want = P.pack_reference(*P.to_device(args, torch.device("cpu")), objective=objective)
        _assert_equal(want, jax_pack_kernel(*_jax_args(args), k_slots=K, objective=objective),
                      f"{case} {objective}: plain vs JAX")
        for shape in ((4, 2), (2, 1)):
            got = port_mesh._sharded_pack(T.cpu_mesh(shape), K, objective)(*args)
            _assert_equal(got, want, f"{case} {shape} {objective}")


# --------------------------------------------------- the shard kernels
def test_shard_wrappers_take_cpu_tensors_to_their_plain_versions():
    """On CPU shards every mesh wrapper runs its plain version and counts
    no launch; the whole sharded pack is `mesh_pack_reference`."""
    fused_packer.reset_launches()
    args = T.wrap_arrays(64, at=30)
    out = port_mesh._sharded_pack(T.cpu_mesh(), 64, "nodes")(*args)
    assert not any(fused_packer.LAUNCHES[k] for k in fused_packer.MESH_KERNELS)
    mesh = T.cpu_mesh()
    plan = P.mesh_plan(mesh.devices, args[0].shape[0], args[5].shape[0], 64)
    tensors = P.to_device(args, torch.device("cpu"))
    reps = {torch.device("cpu"): tensors[:8]}
    bounds = plan.k_bounds
    slots = tuple(tuple(t[bounds[d]: bounds[d + 1]] for t in tensors[8:11])
                  + (tensors[12][:, bounds[d]: bounds[d + 1]],) for d in range(4))
    _assert_equal(P.mesh_pack_reference(plan, reps, slots, args[11]), out)
    with pytest.raises(ValueError, match="one kind of device"):
        fused_packer.mesh_pack(plan._replace(tiles=((torch.device("cpu"), torch.device("meta")),)),
                               reps, slots, args[11])


@pytest.mark.parametrize("groups", ((0, 0, 1, 1), (0, 1, 2, 3), (0, 1, 1, 0)),
                         ids=lambda g: "".join(map(str, g)))
def test_exchange_between_device_buffers(groups):
    """The exchange as a mesh of several cards runs it: the data rows of one
    device share an exchange buffer and the buffers of different devices
    meet through copies (`mesh_exchange_row`).  Here each row's buffer is
    the one of its group in ``groups``; the sharded pack must equal the
    plain pack on int32 sums that wrap across the shard boundaries."""
    args = T.wrap_arrays(256, at=62)
    tensors = P.to_device(args, torch.device("cpu"))
    mesh = T.cpu_mesh()
    G, C, K = args[0].shape[0], args[5].shape[0], args[8].shape[0]
    plan = P.mesh_plan(mesh.devices, G, C, K)
    reps = {torch.device("cpu"): tensors[:8]}
    b = plan.k_bounds
    slots = tuple(tuple(t[b[d]: b[d + 1]] for t in tensors[8:11])
                  + (tensors[12][:, b[d]: b[d + 1]],) for d in range(4))
    for objective in OBJECTIVES:
        recs = [P.choose_config_shard_reference(*(tensors[i] for i in (0, 2, 4, 5, 6, 7)),
                                                g0, g1, c0, c1, objective)
                for _, g0, g1, c0, c1 in plan.tile_bounds()]
        shards = P.mesh_shards(plan, reps, recs, slots, args[11])
        assert all(sh.xchg is shards[0].xchg for sh in shards)  # one device: one buffer
        bufs = {}
        for sh, grp in zip(shards, groups):
            sh.xchg = bufs.setdefault(grp, torch.zeros_like(shards[0].xchg))
        P.mesh_scan(shards, P.ffd_shard_cap_reference, P.ffd_shard_apply_reference)
        want = P.pack_reference(*tensors, objective=objective)
        _assert_equal(P.mesh_outputs(shards), want, f"{groups} {objective}")
        for buf in bufs.values():  # every buffer holds every shard's columns
            assert torch.equal(buf, shards[0].xchg)


def test_choice_records_combine_to_the_first_index_argmin():
    """Ties across model shards and rows with no feasible config: the
    shards' least (key, index) is `choose_config_reference`'s choice."""
    cases = (T.tie_arrays(), T.first_configs(T.wrap_arrays(256), 6))  # 4096 and 6 configs
    for args in cases:
        args = P.to_device(args, torch.device("cpu"))
        req, _, maxper, _, feas, alloc, price, openable = args[:8]
        _combine_case(req, maxper, feas, alloc, price, openable)


def _combine_case(req, maxper, feas, alloc, price, openable) -> None:
    G, C = feas.shape
    for objective in OBJECTIVES:
        want = P.choose_config_reference(req, maxper, feas, alloc, price, openable, objective)
        for M in (1, 2, 4, 8):  # 8 > 6 configs: empty shards
            b = P.split_bounds(C, M)
            rec = torch.stack([fused_packer.choose_config_shard(
                req, maxper, feas, alloc, price, openable, 0, G, b[m], b[m + 1], objective)
                for m in range(M)])
            for got, w in zip(P.combine_choice(rec), want):
                assert torch.equal(got, w), (objective, M)


def test_score_keys_order_as_floats():
    vals = torch.tensor([-np.inf, -3.5, -1e-30, -0.0, 0.0, 1e-30, 2.0, np.inf], dtype=torch.float32)
    keys = P.score_keys(vals)
    assert keys[3] == keys[4]  # -0.0 == +0.0
    assert bool((keys[1:] >= keys[:-1]).all()) and len(set(keys.tolist())) == 7


# ---------------------------------------------------- the solver's backend
def test_default_pack_fn(monkeypatch):
    cpu = torch.device("cpu")
    monkeypatch.delenv("KARPENTER_TPU_SHARDED", raising=False)
    assert default_pack_fn(cpu) is None
    # more cards alone keep the one-device pack (the mesh is asked for)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert default_pack_fn(torch.device("cuda", 0)) is None
    monkeypatch.setenv("KARPENTER_TPU_SHARDED", "0")
    assert default_pack_fn(cpu) is None
    monkeypatch.setenv("KARPENTER_TPU_SHARDED", "1")
    fn = default_pack_fn(cpu)
    assert fn.kernel_name == "scan-sharded" and fn.mesh.shape == (1, 1)
    pool, types, pods = T.flagship_problem(scale=0.01)
    ts = TorchScheduler([pool], {pool.name: types}, device="cpu")
    res = ts.solve(pods)
    assert ts.last_kernel == "scan-sharded" and ts.pack_fn.mesh.shape == (1, 1)
    assert ts._resident.states and ts._resident.states[-1].mesh is ts.pack_fn.mesh
    monkeypatch.setenv("KARPENTER_TPU_SHARDED", "0")
    ref = TorchScheduler([pool], {pool.name: types}, device="cpu")
    assert ref.solve(pods).new_nodes and ref.last_kernel == "reference"
    assert len(res.new_nodes) == len(ref.solve(pods).new_nodes)


# ---------------------------------------------- the resident state on a mesh
def test_mesh_stream():
    """tests/test_resident_fuzz.py's ``test_mesh_stream`` (seed 101, 16
    steps, a catalog roll at step 7) on both packages, each scheduler's
    pack_fn its package's mesh: the warm-tick counters, the mirrors, the
    sharded device buffers read back whole, the pad hygiene and the decoded
    results as tests/test_torch_resident.py holds them."""
    from karpenter_tpu.obs.device import OBSERVATORY as JAX_OBS
    from karpenter_tpu.parallel.mesh import make_mesh, mesh_pack_fn
    from karpenter_tpu_torch.obs.device import OBSERVATORY as PORT_OBS
    from test_torch_resident import _TwinFuzz

    steps, rolls = 16, (7,)
    scopes = (JAX_OBS.begin_scope(), PORT_OBS.begin_scope())
    try:
        fz = _TwinFuzz(101)
        jax_fn = mesh_pack_fn(make_mesh(8))
        port_fn = port_mesh.mesh_pack_fn(T.cpu_mesh())
        for sd, fn in ((fz.jax, jax_fn), (fz.port, port_fn)):
            sd.ts = sd.s.scheduler([sd.pool], sd.inventory, pack_fn=fn)
        for i in range(steps):
            fz.step(roll=i in rolls)
            assert fz.port.ts.last_kernel == "scan-sharded"
    finally:
        JAX_OBS.end_scope(scopes[0])
        PORT_OBS.end_scope(scopes[1])
    ts = fz.port.ts
    assert all(st.mesh is port_fn.mesh for st in ts._resident.states)
    assert fz.checked >= steps - max(2, steps // 8), (fz.checked, fz.skipped)
    assert ts.resident_rebuilds >= 1 + len(rolls), (ts.resident_hits, ts.resident_rebuilds)
    assert ts.resident_hits > ts.resident_rebuilds, (ts.resident_hits, ts.resident_rebuilds)
    port = scopes[1]
    assert port.resident_updates.get("donated", 0) > 0
    assert port.resident_updates == scopes[0].resident_updates
    # every warm tick resharded the slot buffers; every pack exchanged
    assert port.transfer_bytes.get("resident_reshard", 0) > 0
    assert port.transfer_bytes.get("mesh_exchange", 0) > 0


def test_resident_state_places_by_the_table():
    """A state seeded for a mesh places each buffer as `SHARD_SPECS` says
    (the table the sharded pack reads), and packs through it."""
    pool, types, pods = T.flagship_problem(scale=0.005)
    mesh = T.cpu_mesh()
    ts = TorchScheduler([pool], {pool.name: types}, device="cpu",
                        pack_fn=port_mesh.mesh_pack_fn(mesh))
    ts.solve(pods)
    st = ts._resident.states[-1]
    for name, spec in port_mesh.SHARD_SPECS.items():
        buf = getattr(st, f"d_{name}")
        assert buf.spec == spec, name
        assert len(buf.tensors()) == (1 if spec == "repl" else mesh.shape[0]), name
    bounds = P.split_bounds(st.Kp, mesh.shape[0])
    assert [t.shape[0] for t in st.d_used0.parts] == np.diff(bounds).tolist()
    assert st.device_bytes() > 0
    ts.solve(pods + T.flagship_problem(scale=0.001)[2])
    assert ts.last_resident and ts._resident.states[-1] is st


# ------------------------------------------------------------ the fast path
def test_fastpath_falls_back_on_a_mesh():
    """An admission attempt on a warm state seeded for a mesh refreshes the
    state, then falls back with ``sharded_backend`` on both packages."""
    from karpenter_tpu.parallel.mesh import make_mesh, mesh_pack_fn
    from test_torch_fastpath import _fallback, _live_node, _side

    seen = {}
    for pkg, fn in ((JAX, lambda: mesh_pack_fn(make_mesh(8))),
                    (PORT, lambda: port_mesh.mesh_pack_fn(T.cpu_mesh()))):
        s = _side(pkg)
        env = s.Environment()
        pool = env.default_node_pool()
        types = env.instance_types.list(pool, env.default_node_class())
        existing = [_live_node(s, pool.name, i) for i in range(4)]
        ts = s.Scheduler([pool], {pool.name: types}, existing=existing, pack_fn=fn())
        ts.solve([s.Pod(name=f"seed-{i}", requests=s.SIZE) for i in range(4)])
        assert ts._resident.states and ts._resident.states[-1].mesh is not None
        res = s.fastpath.try_admit(ts, [s.Pod(name="arrival-1", requests=s.SIZE)])
        seen[pkg] = _fallback(s, res, s.fastpath.REASON_SHARDED_BACKEND)
    assert seen[PORT] == seen[JAX]
