"""``refresh_split.py`` on both packages at a small size, on the CPU.

The script splits each fast-path attempt's resident refresh into its
parts; here it drives phase 8's arrivals over 200 of config 2's pods
through the JAX package's operator and the port's (``device="cpu"``).
The two must see the same attempts (outcome and reason counts), every
attempt that reached the score must have hit a resident state, and each
split must account for its refresh: the parts are non-negative and the
device, snapshot and mirror parts lie inside the apply.  The script's
twin mode drives the two operators in step and must find no tick where
they differ.
"""

import pytest

import refresh_split

PACKAGES = refresh_split.PACKAGES


@pytest.fixture(scope="module")
def splits():
    return {pkg: refresh_split.drive(pkg, "cpu", n_pods=200, arrivals=6, bursts=1, oversized=1)[0]
            for pkg in PACKAGES}


def test_both_packages_see_the_same_attempts(splits):
    ref, port = (splits[pkg].summary() for pkg in PACKAGES)
    assert ref["attempts"] == port["attempts"]
    assert port["attempts"].get("nominated", 0) > 0
    assert ref["refresh_hits"] == port["refresh_hits"] > 0
    assert (ref["live_nodes"], ref["classes"]) == (port["live_nodes"], port["classes"])


@pytest.mark.parametrize("pkg", PACKAGES)
def test_split_accounts_for_the_refresh(pkg, splits):
    summary = splits[pkg].summary()
    assert set(summary["ms"]) == set(refresh_split.PARTS)
    for part, v in summary["ms"].items():
        assert v is not None and 0.0 <= v["p50"] <= v["p99"], part
    rows = [a["ms"] for a in splits[pkg].hits()]
    assert len(rows) == summary["refresh_hits"] > 0
    for m in rows:
        assert min(m.values()) >= 0.0, m
        assert m.get("device", 0.0) + m.get("snapshot", 0.0) <= m["apply"]
        assert m["plan"] + m["apply"] <= m["refresh"]



def test_twin_drive_agrees_tick_for_tick():
    """Both packages' operators, in step over the same small drive, agree
    after every tick (bind, singles, a burst and its quiet tick, an
    oversized pod)."""
    out = refresh_split.twin(n_pods=200, arrivals=6, bursts=1, oversized=1)
    assert out == {"ticks": out["ticks"], "first_difference": None}
    assert out["ticks"] >= 10
