"""The port's constraint compiler against the JAX package's.

The same cluster, built in both packages from one spec (tests/torch_specs.py),
must partition into the same groups and compile to equal arrays, in the
same class and config order."""

import numpy as np
import pytest

import torch_specs
from karpenter_tpu.ops import tensorize as jax_tensorize
from karpenter_tpu_torch.interop import ARRAY_FIELDS
from karpenter_tpu_torch.ops import tensorize


def _compile(t, s, scenario):
    pools, inventory, existing, pods = torch_specs.build(s, scenario)
    groups, unsupported, reason = t.partition_groups(
        pods, existing=existing, pools=pools
    )
    sup = [p for _, members in groups for p in members]
    prob = t.compile_problem(
        sup, pools, inventory, existing=existing, presplit=True, groups=groups
    )
    return groups, unsupported, reason, prob


def _configs(prob):
    return [
        (
            c.pool.name if c.pool is not None else None,
            c.instance_type.name if c.instance_type is not None else None,
            c.zone,
            c.capacity_type,
            c.price,
            c.existing.name if c.existing is not None else None,
        )
        for c in prob.configs
    ]


@pytest.mark.parametrize("scenario", torch_specs.SCENARIOS)
def test_compile_matches_reference(scenario):
    jg, ju, jr, jprob = _compile(
        jax_tensorize, torch_specs.side("karpenter_tpu"), scenario
    )
    pg, pu, pr, prob = _compile(
        tensorize, torch_specs.side("karpenter_tpu_torch"), scenario
    )
    assert [[p.name for p in m] for _, m in pg] == [[p.name for p in m] for _, m in jg]
    assert [p.name for p in pu] == [p.name for p in ju]
    assert pr == jr
    assert prob.axes == jprob.axes
    assert prob.unsupported_reason == jprob.unsupported_reason
    assert prob.n_track_slots == jprob.n_track_slots
    assert prob.compile_relaxed == jprob.compile_relaxed
    for name in ARRAY_FIELDS:
        got, want = getattr(prob, name), getattr(jprob, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert [[p.name for p in cm.pods] for cm in prob.classes] == [
        [p.name for p in cm.pods] for cm in jprob.classes
    ]
    assert _configs(prob) == _configs(jprob)
