"""Time ``assemble_feasibility`` on the card, for the port of one tree.

Loads ``karpenter_tpu_torch`` from ``--root`` (default: this file's
directory) and chip_smoke.py's timers from this file's directory, builds the
tree's ``csrc/mesh_pack.cu``, and at the factorized step of chip_smoke.py's
phase 15 (Gp 320, Cp 8192: ``testing.mesh_step_problem(classes=320,
k_slots=4096, types=1024)``) checks the kernel's whole mask bit-equal to the
plain version, then prints one JSON line:

- ``kernel_ms``: device ms a whole-mask launch (`chip_smoke.profiled_ms`,
  torch.profiler over ``--iters`` launches); ``kernel_events_ms`` the same
  by CUDA events (`chip_smoke.events_device_ms`);
- ``mesh``: ``fused_packer.mesh_assemble_feasibility`` over the (4, 2) mesh
  of 8 shards on the one card: its launches and mask exchange bytes (site
  ``mesh_exchange``) a call, and its host-clock ms a call (synchronised);
- ``card``: the card's name and power limit as nvidia-smi gives them.

To compare two trees on one card, run each in its own process, in turns,
e.g. with the parent unpacked by ``git archive`` into a directory that
.gitignore lists::

    for r in 1 2; do for t in _parent . . _parent; do
        python3 assemble_time.py --root $t; done; done
"""

import argparse
import importlib.util
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
STEP = {"classes": 320, "k_slots": 4096, "types": 1024}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("assemble_time.py: no CUDA device")
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import karpenter_tpu_torch
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.obs.device import OBSERVATORY
    from karpenter_tpu_torch.ops import _build
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P
    from karpenter_tpu_torch.parallel import mesh as PM

    if not karpenter_tpu_torch.__file__.startswith(root + os.sep):
        raise SystemExit(f"loaded {karpenter_tpu_torch.__file__}, not the port under {root}")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.build_all(("mesh_pack",))
    build_s = time.perf_counter() - t0
    p = T.mesh_step_problem(**STEP)
    adm = P.to_device(tuple(p[k] for k in T.MESH_STEP_ARGS[:7]), dev)
    G, C = len(p["sig_of"]), len(p["t_of"])
    want = P.assemble_feasibility_reference(*adm, 0, G, 0, C)
    whole = lambda: F.assemble_feasibility(*adm)
    if not torch.equal(whole(), want):
        raise SystemExit("assemble_feasibility differs from its plain version")
    kernel_ms = cs.profiled_ms(torch, whole, "assemble_feasibility", args.iters)
    kernel_events = cs.events_device_ms(torch, whole, args.iters)

    mesh = PM.make_mesh(8, [dev] * 8)
    plan = P.mesh_plan(mesh.devices, G, C, STEP["k_slots"])
    adm_d = {d: adm for d in mesh.distinct()}
    expand = lambda: F.mesh_assemble_feasibility(plan, adm_d, G, C)
    OBSERVATORY.enabled = True
    site = lambda: OBSERVATORY.snapshot()["transfer_bytes"].get(P.MESH_SITE, 0)
    launches, b0 = F.LAUNCHES["assemble_feasibility"], site()
    masks = expand()
    launches, mask_bytes = F.LAUNCHES["assemble_feasibility"] - launches, site() - b0
    if not all(torch.equal(m, want) for m in masks.values()):
        raise SystemExit("the mesh's expansion differs from the plain mask")
    walls = []
    for _ in range(args.iters):
        torch.cuda.synchronize()
        t = time.perf_counter()
        expand()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    print(json.dumps({
        "root": args.root, "card": cs.card_line(), "build_s": build_s, "shape": [G, C],
        "kernel_ms": kernel_ms, "kernel_events_ms": kernel_events,
        "mesh": {"launches": launches, "mask_exchange_bytes": mask_bytes,
                 "wall_ms_p50": statistics.median(walls), "wall_ms_min": min(walls)},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
