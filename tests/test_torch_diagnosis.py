"""The port's diagnosis layer: the SLO engine, the anomaly detector, the
flight recorder, the doctor and the operator's diagnosis tail.

Every case of ``tests/test_diagnosis.py`` runs on the port
(`torch_ported.port_tests`), with the operators on the CPU.  None needs an
A3e or A8 module, so none is left out.  The doctor's device rules say "new
launch signature" where the reference says "compile" or "jit": the port
counts a new launch signature where the JAX package counts a jit compile
(``obs/device.py``); `DOCTOR_WORDING` maps the reference's words in those
cases' assertions.

Then the doctor twin: on the same flight dump, forged with the reference
tests' helpers or dumped by the port's own operator, ``doctor.diagnose`` of
both packages must return the same diagnosis, the reference's causes in
the port's words.
"""

import importlib
import re

import pytest

from torch_ported import on_the_cpu, port_tests  # noqa: F401

PACKAGES = ("karpenter_tpu", "karpenter_tpu_torch")
# what the reference's doctor says of its device rules -> the port's words
DOCTOR_WORDING = [
    ("device compile(s)", "new launch signature(s)"),
    ("warm jit entry points", "warm kernel entry points"),
    ("warm-tick device recompile", "warm-tick new launch signature"),
    ("warm recompile of device fn", "warm new launch signature of device fn"),
]

pytestmark = pytest.mark.usefixtures("on_the_cpu")
globals().update(port_tests("test_diagnosis.py", text=[
    (f'"24 {DOCTOR_WORDING[0][0]}"', f'"24 {DOCTOR_WORDING[0][1]}"'),
    *((f'"{a}"', f'"{b}"') for a, b in DOCTOR_WORDING[1:]),
]))


def in_port_words(cause: str) -> str:
    """A reference doctor cause in the port's words."""
    cause = re.sub(r"(\d+) device compile\(s\)", r"\1 new launch signature(s)", cause)
    for ref, port in DOCTOR_WORDING[1:]:
        cause = cause.replace(ref, port)
    cause = cause.replace(
        "a jit entry point is retracing on a steady cluster — look for padded-bucket "
        "churn or a failed buffer donation",
        "a kernel entry point is launching at new shapes on a steady cluster — look "
        "for padded-bucket churn or a resident state re-seeded")
    return cause


def diagnoses(path) -> list:
    """Both packages' ``diagnose`` of one dump, the reference's causes in
    the port's words."""
    out = []
    for pkg in PACKAGES:
        doctor = importlib.import_module(f"{pkg}.obs.doctor")
        flight = importlib.import_module(f"{pkg}.obs.flight")
        diag = doctor.diagnose(flight.load_flight(str(path)))
        if pkg == PACKAGES[0]:
            diag["suspected_causes"] = [in_port_words(c) for c in diag["suspected_causes"]]
        out.append(diag)
    return out


def forged_dumps(tmp_path) -> dict:
    import test_diagnosis as ref

    return {
        "regression": ref._synthetic_regression_dump(tmp_path),
        "storm": ref._device_dump(tmp_path, "storm", roll=True),
        "transfer": ref._device_dump(tmp_path, "xfer", transfer_spike=True),
        "warm": ref._device_dump(tmp_path, "warm", warm_no_roll=True),
        "event": ref._device_dump(tmp_path, "evt", recompile_event=True),
        "quiet": ref._device_dump(tmp_path, "quiet"),
        "starved": ref._tenant_wait_dump(tmp_path, "starved", starved=True),
        "balanced": ref._tenant_wait_dump(tmp_path, "balanced", starved=False),
    }


@pytest.mark.parametrize("dump", ["regression", "storm", "transfer", "warm", "event",
                                  "quiet", "starved", "balanced"])
def test_doctor_twin_on_forged_dump(dump, tmp_path):
    ref, port = diagnoses(forged_dumps(tmp_path)[dump])
    assert ref == port
    if dump != "quiet" and dump != "balanced":
        assert port["suspected_causes"], port


def test_doctor_twin_on_a_port_operator_dump(tmp_path):
    """The port's operator with ``flight_dir``: a blackout opens the cloud
    circuits, the circuit rule breaches and the ring is dumped; both
    doctors name the same causes on that dump, and the entry point's
    ``doctor`` subcommand prints them."""
    import contextlib
    import io

    from karpenter_tpu_torch.__main__ import main as entry
    from karpenter_tpu_torch.api import Pod, Resources, Settings
    from karpenter_tpu_torch.testing import Environment

    settings = Settings(
        cluster_name="test", flight_dir=str(tmp_path), cloud_max_retries=1,
        cloud_circuit_failure_threshold=2,
        slo_rules={"cloud-circuit-open": {"budget": 0.1, "fast_window_s": 4.0,
                                          "slow_window_s": 8.0}},
    )
    env = Environment(settings=settings, device="cpu")
    env.default_node_class()
    env.default_node_pool()
    for _ in range(3):
        env.step(1.0)
    env.cloud.chaos.add_blackout(env.clock.now(), 30.0)
    for i in range(8):
        env.kube.put_pod(Pod(name=f"p-{i}", requests=Resources(cpu=0.5, memory="1Gi")))
        env.step(1.0)
    dumps = sorted(tmp_path.glob("flight-*-slo_breach.jsonl"))
    assert dumps, sorted(p.name for p in tmp_path.iterdir())
    ref, port = diagnoses(dumps[0])
    assert ref == port
    assert port["breaches"] and port["suspected_causes"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert entry(["doctor", str(dumps[0])]) == 0
    for cause in port["suspected_causes"]:
        assert cause in out.getvalue()
