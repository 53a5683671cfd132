"""The port's feasibility expansion against the JAX package's, on the CPU.

``assemble_feasibility`` (the dense [G, C] mask from the factorized
admission, ``karpenter_tpu/parallel/mesh.py:assemble_feasibility``) in the
port's in-place form, a tile at a time and several tiles a call, and the
mesh's expansion (`mesh_assemble_plan`: one call a device over its tiles,
the other devices' tiles copied in) on meshes of CPU shards.  The JAX side
is the reference's jitted function on the CPU.  Tolerance: none, byte for
byte; a mask's bytes outside the written tiles must keep the sentinel they
were prefilled with.
"""

import re

import numpy as np
import pytest
import torch

from karpenter_tpu.parallel import mesh as jax_mesh
from karpenter_tpu_torch import testing as T
from karpenter_tpu_torch.obs.device import OBSERVATORY
from karpenter_tpu_torch.ops import _build
from karpenter_tpu_torch.ops import fused_packer as F
from karpenter_tpu_torch.ops import packer as P

SENTINEL = 0xA5
SHAPES = ((1, 1), (2, 1), (1, 2), (4, 2))
# the seven admission arrays: sizes no multiple of 16 (G 37, C 100, S 5,
# T 23), every class its own signature (S == G), the mesh tests' problem
ARRAYS = {
    "unaligned": lambda: T.assemble_arrays(),
    "own-signatures": lambda: T.assemble_arrays(S=37),
    "mesh-step": lambda: tuple(T.mesh_step_problem()[k] for k in T.MESH_STEP_ARGS[:7]),
}


def _dense(adm) -> np.ndarray:
    return np.asarray(jax_mesh.assemble_feasibility(*adm))


def _tiles(G: int, C: int) -> list:
    """[3, G) x [5, C - 2), widths 1, 15 and 17 from config 5, a tile
    starting on config 3, the whole mask and an empty one."""
    return [(3, G, 5, C - 2), (3, G, 5, 6), (3, G, 5, 20), (3, G, 5, 22),
            (1, G // 2, 3, C - 5), (0, G, 0, C), (2, 2, 0, C)]


def _prefilled(G: int, C: int, pad: int):
    base = torch.full((G, C + pad), SENTINEL, dtype=torch.uint8)
    return base, base[:, :C].view(torch.bool)


def _expect(want: np.ndarray, tiles, pad: int) -> np.ndarray:
    """The bytes of a mask prefilled with `SENTINEL` (rows C + pad apart)
    after ``tiles`` of ``want`` are written into it."""
    G, C = want.shape
    out = np.full((G, C + pad), SENTINEL, np.uint8)
    for g0, g1, c0, c1 in tiles:
        out[g0:g1, c0:c1] = want[g0:g1, c0:c1]
    return out


@pytest.mark.parametrize("arrays", sorted(ARRAYS))
def test_tiles_match_jax(arrays):
    """Each tile, as a tile of its own and written in place (`assemble_tiles`,
    one tile) into a mask prefilled with a sentinel (rows C and C + 3
    bytes apart), equals the JAX package's dense mask; no byte outside it
    changes."""
    adm = ARRAYS[arrays]()
    want = _dense(adm)
    G, C = want.shape
    t = tuple(torch.from_numpy(a) for a in adm)
    for g0, g1, c0, c1 in _tiles(G, C):
        got = F.assemble_feasibility(*t, g0, g1, c0, c1)
        np.testing.assert_array_equal(got.numpy(), want[g0:g1, c0:c1])
        for pad in (0, 3):
            base, out = _prefilled(G, C, pad)
            F.assemble_tiles(*t, [(g0, g1, c0, c1)], out)
            np.testing.assert_array_equal(base.numpy(), _expect(want, [(g0, g1, c0, c1)], pad))


@pytest.mark.parametrize("arrays", sorted(ARRAYS))
def test_several_tiles_in_one_call(arrays):
    """`assemble_tiles` (the kernel's one launch a device) writes 9
    disjoint unaligned tiles into a prefilled mask: each equals the JAX
    mask, the rest keeps the sentinel; the plain version does the same."""
    adm = ARRAYS[arrays]()
    want = _dense(adm)
    G, C = want.shape
    gb = [3 + b for b in P.split_bounds(G - 3, 4)]
    cb = [5 + b for b in P.split_bounds(C - 7, 2)]
    tiles = [(gb[i], gb[i + 1], cb[j], cb[j + 1]) for i in range(4) for j in range(2)]
    tiles.append((0, 1, 0, 1))
    t = tuple(torch.from_numpy(a) for a in adm)
    for write in (F.assemble_tiles, P.assemble_tiles_reference):
        for pad in (0, 3):
            base, out = _prefilled(G, C, pad)
            write(*t, tiles, out)
            np.testing.assert_array_equal(base.numpy(), _expect(want, tiles, pad))


def _plan(devices, G=37, C=100, K=32):
    return P.mesh_plan(tuple(tuple(row) for row in devices), G, C, K)


def test_plan_one_card():
    """A (4, 2) mesh of one device: one group of all 8 tiles, row by row,
    and nothing to copy."""
    for dev in (torch.device("cpu"), torch.device("cuda", 0)):
        plan = _plan([[dev] * 2] * 4)
        ap = P.mesh_assemble_plan(plan)
        assert len(ap.groups) == 1 and ap.copies == ()
        assert ap.groups[0][0] == dev
        assert ap.groups[0][1] == tuple(b[1:] for b in plan.tile_bounds())
        assert len(ap.groups[0][1]) == 8


def test_plan_distinct_devices():
    """On 8 distinct devices each tile is written once, on its own device,
    and copied to the 7 others."""
    devs = [torch.device("cuda", i) for i in range(8)]
    plan = _plan([devs[2 * d: 2 * d + 2] for d in range(4)])
    ap = P.mesh_assemble_plan(plan)
    assert [dev for dev, _ in ap.groups] == devs
    bounds = {b[0]: b[1:] for b in plan.tile_bounds()}
    assert all(tiles == (bounds[dev],) for dev, tiles in ap.groups)
    assert len(ap.copies) == 8 * 7
    for dev in devs:
        srcs = sorted(src.index for src, dst, _ in ap.copies if dst == dev)
        assert srcs == [i for i in range(8) if i != dev.index]
    for src, dst, tile in ap.copies:
        assert src != dst and tile == bounds[src]


def test_plan_skips_empty_tiles():
    """A tile with no class or no config is neither written nor copied:
    3 classes over 4 data rows leave the last row empty."""
    devs = [torch.device("cuda", i) for i in range(8)]
    plan = _plan([devs[2 * d: 2 * d + 2] for d in range(4)], G=3)
    ap = P.mesh_assemble_plan(plan)
    assert [len(t) for _, t in ap.groups] == [1] * 6 + [0, 0]
    assert len(ap.copies) == 6 * 7


@pytest.mark.parametrize("arrays", sorted(ARRAYS))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_expansion_matches_jax(arrays, shape):
    """`mesh_assemble_feasibility` on a mesh of CPU shards of one device
    (every tile written in place by one call, no byte copied) and of
    distinct devices (``cpu:i``: each tile copied to every other device's
    mask): every device's mask equals the JAX package's dense mask."""
    adm = ARRAYS[arrays]()
    want = _dense(adm)
    G, C = want.shape
    D, M = shape
    t = tuple(torch.from_numpy(a) for a in adm)
    for distinct in (False, True):
        devs = [torch.device("cpu", i) if distinct else torch.device("cpu")
                for i in range(D * M)]
        plan = _plan([devs[d * M: (d + 1) * M] for d in range(D)], G, C)
        adm_d = {dev: t for dev in dict.fromkeys(devs)}
        counted, OBSERVATORY.enabled = OBSERVATORY.enabled, True
        try:
            before = OBSERVATORY.snapshot()["transfer_bytes"].get(P.MESH_SITE, 0)
            masks = F.mesh_assemble_feasibility(plan, adm_d, G, C)
            copied = OBSERVATORY.snapshot()["transfer_bytes"].get(P.MESH_SITE, 0) - before
        finally:
            OBSERVATORY.enabled = counted
        assert list(masks) == list(adm_d)
        for mask in masks.values():
            np.testing.assert_array_equal(mask.numpy(), want)
        assert copied == (len(adm_d) - 1) * G * C


def test_mesh_expansion_order(monkeypatch):
    """The expansion writes each device's tiles in one call, every device
    first, then copies the other devices' tiles in, in
    `mesh_assemble_plan`'s order: the order the card takes."""
    adm = tuple(torch.from_numpy(a) for a in T.assemble_arrays())
    devs = [torch.device("cpu", i) for i in range(4)]
    plan = _plan([devs[0:2], devs[2:4]])
    ap = P.mesh_assemble_plan(plan)
    log = []
    write, exchange = P.assemble_tiles_reference, P._exchange

    def logged_write(*args):
        log.append(("write", args[8].data_ptr(), tuple(args[7])))
        write(*args)

    def logged_exchange(dst, src):
        log.append(("copy", dst.data_ptr(), src.data_ptr()))
        exchange(dst, src)

    monkeypatch.setattr(P, "assemble_tiles_reference", logged_write)
    monkeypatch.setattr(P, "_exchange", logged_exchange)
    masks = F.mesh_assemble_feasibility(plan, {d: adm for d in devs}, 37, 100)
    writes = [e for e in log if e[0] == "write"]
    assert log[:len(writes)] == writes and len(writes) == 4
    assert [e[2] for e in writes] == [tiles for _, tiles in ap.groups]
    assert [e[1] for e in writes] == [masks[d].data_ptr() for d in devs]
    copies = log[len(writes):]
    assert len(copies) == len(ap.copies) == 4 * 3
    for (_, dst, src), (s_dev, d_dev, (g0, g1, c0, c1)) in zip(copies, ap.copies):
        assert dst == masks[d_dev][g0:g1, c0:c1].data_ptr()
        assert src == masks[s_dev][g0:g1, c0:c1].data_ptr()
    for mask in masks.values():
        np.testing.assert_array_equal(mask.numpy(), _dense(T.assemble_arrays()))


def test_layout():
    """The launch `assemble_layout` gives: at Gp 320, Cp 8192 on 132 SMs
    32 classes a block, 160 blocks (a full wave); on 161 SMs 28; the (4,
    2) plan's 8 tiles in one grid of z 8, 192 blocks; small shapes 4
    classes a block; a tile's first byte off 16 adds a chunk."""
    lay = F.assemble_layout([(0, 320, 0, 8192, 0)], 132)
    assert (lay.gc, lay.grid) == (32, (16, 10, 1))
    assert F.assemble_layout([(0, 320, 0, 8192, 0)], 161).gc == 28
    plan = _plan([[torch.device("cpu")] * 2] * 4, G=320, C=8192)
    tiles = [(*b[1:], 0) for b in plan.tile_bounds()]
    lay = F.assemble_layout(tiles, 132)
    assert (lay.gc, lay.grid) == (32, (8, 3, 8))
    lay = F.assemble_layout([(0, 37, 0, 100, 0)], 132)
    assert (lay.gc, lay.grid) == (4, (1, 10, 1))
    assert F.assemble_layout([(0, 4, 0, 512, 0)], 132).grid[0] == 1
    assert F.assemble_layout([(0, 4, 0, 512, 5)], 132).grid[0] == 2


def test_layout_constants_match_the_kernel():
    """`fused_packer`'s copies of the kernel's layout constants are the
    ones ``csrc/mesh_pack.cu`` compiles with."""
    src = (_build.CSRC / "mesh_pack.cu").read_text()
    for name, value in (("kAssembleWarps", F.ASSEMBLE_WARPS),
                        ("kAssembleBytes", F.ASSEMBLE_BYTES),
                        ("kAssembleMaxChunk", F.ASSEMBLE_MAX_CHUNK),
                        ("kAssembleMaxTiles", F.ASSEMBLE_MAX_TILES)):
        assert re.search(rf"constexpr int {name} = {value};", src), name


def test_card_tensors_never_take_the_plain_version():
    """A tensor that does not lie on the CPU takes the kernel or raises:
    here a meta tensor is refused, and a mask that is not [G, C] bool with
    contiguous rows is refused before any launch."""
    adm = tuple(torch.from_numpy(a).to("meta") for a in T.assemble_arrays())
    with pytest.raises(ValueError, match="no kernel"):
        F.assemble_feasibility(*adm)
    with pytest.raises(ValueError, match="no kernel"):
        F.assemble_tiles(*adm, [(0, 1, 0, 1)], torch.empty((37, 100), dtype=torch.bool,
                                                             device="meta"))
    bad = torch.empty((100, 37), dtype=torch.bool).t()
    with pytest.raises(ValueError, match="contiguous"):
        F._mask_check(bad, 37, 100, torch.device("cpu"))
    with pytest.raises(ValueError, match="bool mask"):
        F._mask_check(torch.empty((37, 100), dtype=torch.uint8), 37, 100, torch.device("cpu"))
