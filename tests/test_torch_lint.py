"""The port's lint gate held to the JAX package's suite.

The cases of ``tests/test_lint.py`` run on the port
(`torch_ported.port_tests`): every registered rule reports zero live
findings on the port's own tree (`test_package_is_clean`, 18 cases), the
teeth harness forges a violation for each rule and holds it to fire and to
be silenced by its allowlist, the full-tensorize deny fence, the lock-seam,
settings-flow, baseline and profile cases, the CLI smoke (``python -m
karpenter_tpu_torch lint --json`` in a fresh process) and the exit codes.

The port's words, as ``text`` replacements of the reference's source:

- the ``device-put`` teeth forge the port's upload idiom, a raw
  ``torch.as_tensor(a, device=dev)`` in a loop and outside one, where the
  reference forges ``jax.device_put``;
- the ``tracer-safety`` teeth forge an unseamed call of a launch wrapper
  (a function that calls ``_lib().ffd_x(...)``) from another module,
  silenced by its ``(file, qualname)`` entry, where the reference forges a
  ``jax.jit`` body (the port's rule has no traced-body properties,
  ``analysis/tracer.py``);
- the ``metric-doc`` and ``service-tenant-metrics`` teeth document their
  families in ``docs/torch/metrics.md``, the page the port's rules read.

Left out: ``test_tracer_safety_call_site_allowlist``, which forges a
``jax.jit`` callable.  `test_tracer_safety_call_site_allowlist_on_the_port`
replaces it: one unseamed wrapper call is the one finding (a dispatched
one and a host query are clean), silenced by its ``(file, qualname)``.

`test_rule_catalogs_and_clean_sets_match_the_reference` is the CPU twin:
the port's engine over the port's tree and the reference's over its own
run the same 18 rules, and both live sets are empty.
"""

from torch_ported import port_tests

DEVICE_PUT_LOOP = (r'"            d = jax.device_put(a)\n"',
                   r'"            d = torch.as_tensor(a, device=dev)\n"')
DEVICE_PUT_PIN = (r'"        return device_put(a)\n"',
                  r'"        return torch.as_tensor(a, device=dev)\n"')

TRACER_TEETH = (
    r'''        # the forged unseamed jit dispatch + an impure traced body
        files={
            "ops/x.py": (
                "import jax\n"
                "import time\n"
                "@jax.jit\n"
                "def kernel(x):\n"
                "    print('tracing')\n"
                "    t = time.time()\n"
                "    x[0] = t\n"
                "    return x\n"
                "def solve(x):\n"
                "    return kernel(x)\n"
            )
        },
        expect=[
            "print(...) inside traced body",
            "time.time(...) inside traced body",
            "assigns into a traced parameter",
            "bypasses the counted seam",
        ],
        silence=None,  # impure bodies have no allowlist: only the call
        # site is allowlistable (checked separately below)''',
    r'''        # the forged unseamed call of a launch wrapper from another module
        files={
            "ops/x.py": (
                "def _lib():\n"
                "    return None\n"
                "def kernel(x):\n"
                "    return _lib().ffd_x(x)\n"
            ),
            "scheduling/y.py": (
                "from forged.ops.x import kernel\n"
                "def solve(x):\n"
                "    return kernel(x)\n"
            ),
        },
        expect=["solve", "launch wrapper kernel(...)",
                "bypasses the counted seam"],
        silence=frozenset({("forged/scheduling/y.py", "solve")}),''',
)

globals().update(port_tests(
    "test_lint.py",
    left_out=("test_tracer_safety_call_site_allowlist",),
    fixtures=("snap",),
    text=[
        DEVICE_PUT_LOOP,
        DEVICE_PUT_PIN,
        TRACER_TEETH,
        ('docs={"docs/metrics.md"', 'docs={"docs/torch/metrics.md"'),
        ('            "docs/metrics.md": (', '            "docs/torch/metrics.md": ('),
        ('"absent from docs/metrics.md"', '"absent from docs/torch/metrics.md"'),
    ],
))


def test_tracer_safety_call_site_allowlist_on_the_port(tmp_path):
    """The seam-dispatch rule is allowlistable by (file, qualname): one
    unseamed call of a launch wrapper is the one finding; the same wrapper
    handed to ``OBSERVATORY.dispatch`` and a host query of the library
    (exempt by its entry name) are clean."""
    from karpenter_tpu_torch.analysis import PackageSnapshot, run_rules

    files = {
        "ops/x.py": (
            "def _lib():\n"
            "    return None\n"
            "def kernel(x):\n"
            "    return _lib().ffd_x(x)\n"
            "def occupancy(k):\n"
            "    return _lib().ffd_query(k)\n"
        ),
        "ops/y.py": (
            "from forged.obs.device import OBSERVATORY\n"
            "from forged.ops.x import kernel, occupancy\n"
            "def solve(x):\n"
            "    occupancy(4)\n"
            "    return kernel(x)\n"
            "def solve_counted(x):\n"
            "    return OBSERVATORY.dispatch('kernel', kernel, x)\n"
        ),
    }
    for rel, src in files.items():
        path = tmp_path / "forged" / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
    forged = PackageSnapshot(tmp_path / "forged")
    exempt = frozenset({"ffd_query"})
    live, _ = run_rules(
        forged, rule_names=["tracer-safety"],
        allowlists={"tracer-safety": exempt},
    )
    assert len(live) == 1 and "bypasses the counted seam" in live[0].message
    assert live[0].file == "forged/ops/y.py" and "solve:" in live[0].message
    silenced, _ = run_rules(
        forged, rule_names=["tracer-safety"],
        allowlists={"tracer-safety": exempt | {("forged/ops/y.py", "solve")}},
    )
    assert not silenced
    # without the host query's exemption its caller is a wrapper too
    both, _ = run_rules(
        forged, rule_names=["tracer-safety"],
        allowlists={"tracer-safety": frozenset()},
    )
    assert len(both) == 2 and "occupancy(...)" in both[0].message


def test_rule_catalogs_and_clean_sets_match_the_reference():
    """The CPU twin: each package's engine over its own tree runs the same
    18 rules, and both report zero live findings."""
    from karpenter_tpu.analysis import PackageSnapshot as RefSnapshot
    from karpenter_tpu.analysis import RULES as REF_RULES
    from karpenter_tpu.analysis import run_rules as ref_run
    from karpenter_tpu_torch.analysis import RULES, PackageSnapshot, run_rules

    assert sorted(RULES) == sorted(REF_RULES) and len(RULES) == 18
    live, _ = run_rules(PackageSnapshot.load())
    ref_live, _ = ref_run(RefSnapshot.load())
    assert [f.render() for f in live] == [f.render() for f in ref_live] == []

