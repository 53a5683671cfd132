"""Port runs of the JAX package's own tests.

`port_tests` reads a reference test file, maps the package name
(``karpenter_tpu`` -> ``karpenter_tpu_torch``) and runs the source as a
module of its own, so each test keeps its body and its assertions word for
word and exercises the port.  A test file imports what it returns into its
globals, where pytest collects it under the port file's name.  Cases named
in ``left_out`` (a test function, a class, or ``Class.method``) are not
collected; each port file says why it leaves them out.  ``only`` collects
the named top-level tests alone, for a file most of whose cases another
port test already twins.  ``text`` is a list of (reference text, port
text) replacements made in the source after the rename, for what the port
says in its own words (each port file names them).  ``fixtures`` names the
reference file's module-level fixtures its cases use (an autouse one
too), returned with them so pytest finds them in the port file.

`on_the_cpu` is the fixture those files use: the reference tests build
their operators, schedulers, solver servers and packs without naming a
device, and the port's default is the card, so it maps an unnamed device
to the CPU for the test.
"""

import pathlib
import re
import types

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent

# The suite runs in several worker processes at once (pytest-xdist, each
# importing every test module), and PyTorch's intra-op threads spin while
# they wait: one thread a process keeps the port's CPU drives from
# oversubscribing the host's cores.
torch.set_num_threads(1)


# the reference's fleet tests build their runs in module-scoped fixtures,
# before `on_the_cpu`: these replacements ask each of their `run_fleet` and
# `replay_fleet` calls for the CPU
FLEET_ON_THE_CPU = {
    "test_sim_fleet.py": [
        ('run_fleet("store-fleet-chaos", 0, TICKS)',
         'run_fleet("store-fleet-chaos", 0, TICKS, device="cpu")'),
        ("replay_fleet(str(path))", 'replay_fleet(str(path), device="cpu")'),
    ],
    "test_sim_fleet_shards.py": [
        ('run_fleet("store-fleet-shard-chaos", 0, TICKS)',
         'run_fleet("store-fleet-shard-chaos", 0, TICKS, device="cpu")'),
        ("replay_fleet(str(path))", 'replay_fleet(str(path), device="cpu")'),
    ],
    "test_service_tenants.py": [
        ("operators=OPERATORS", 'operators=OPERATORS, device="cpu"'),
        ("replay_fleet(str(path))", 'replay_fleet(str(path), device="cpu")'),
    ],
}


def port_tests(ref_file: str, left_out=(), only=None, text=(), fixtures=()) -> dict:
    """The test functions and classes of ``tests/<ref_file>`` run on the
    port, minus ``left_out`` (or ``only`` those named)."""
    path = REPO / "tests" / ref_file
    src = re.sub(r"\bkarpenter_tpu\b", "karpenter_tpu_torch", path.read_text())
    for ref, port in text:
        assert ref in src, f"{ref_file} does not say {ref!r}"
        src = src.replace(ref, port)
    mod = types.ModuleType(f"ported_{path.stem}")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    methods = {}
    for name in left_out:
        cls, _, meth = name.partition(".")
        if meth:
            methods.setdefault(cls, []).append(meth)
    out = {}
    for name, obj in vars(mod).items():
        if not name.startswith(("test_", "Test")) or name in left_out:
            continue
        if only is not None and name not in only:
            continue
        if isinstance(obj, type) and name in methods:
            # a subclass with the left-out methods blanked: pytest collects
            # only callables
            obj = type(name, (obj,), {m: None for m in methods[name]})
        out[name] = obj
    for name in fixtures:
        out[name] = vars(mod)[name]
    missing = [n for n in (*left_out, *(only or ()), *fixtures)
               if n.partition(".")[0] not in vars(mod)]
    assert not missing, f"{ref_file} has no {missing}"
    return out


@pytest.fixture
def on_the_cpu(monkeypatch):
    """An operator, scheduler, solver server (and its tenant pool), fleet
    runner (``sim/fleet.py``) or pack (``ops/packer.py``'s `run_pack`) built
    without a device runs on the CPU."""
    from karpenter_tpu_torch import operator
    from karpenter_tpu_torch.ops import packer, resident
    from karpenter_tpu_torch.scheduling import solver
    from karpenter_tpu_torch.service import server
    from karpenter_tpu_torch.sim import fleet

    card_default = packer.resolve_device

    def resolve(device=None):
        return card_default("cpu" if device is None else device)

    for mod in (operator, solver, packer, resident, server, fleet):
        monkeypatch.setattr(mod, "resolve_device", resolve)
