"""The CUDA kernels against their plain PyTorch version, on the card.

Marked ``cuda``: each test asks for the ``cuda_device`` fixture, which skips
where ``torch.cuda.is_available()`` is false, so every worker collects the
same tests everywhere.  On the card: ``python -m pytest -m cuda
tests/test_torch_cuda.py``.  Tolerance: none — every output must be equal
(``node_used`` compared as float32 bit patterns)."""

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import testing as T
from karpenter_tpu_torch.ops import fused_packer
from karpenter_tpu_torch.ops.packer import pack_reference, pad_problem, to_device
from karpenter_tpu_torch.ops.tensorize import compile_problem
from karpenter_tpu_torch.scheduling.solver import TorchScheduler

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_bit_equal(got, want):
    for a, b in zip(got, want):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("objective", ["nodes", "cost"])
@pytest.mark.parametrize("problem", ["flagship", "heterogeneous"])
def test_kernel_matches_reference(cuda_device, problem, objective):
    if problem == "flagship":
        pool, types, pods = T.flagship_problem(scale=0.1)
        prob = compile_problem(pods, [pool], {pool.name: types})
    else:
        pools, inv, pods = T.heterogeneous_problem(scale=0.1)
        prob = compile_problem(pods, pools, inv)
    args = to_device(pad_problem(prob)[0], cuda_device)
    before = dict(fused_packer.LAUNCHES)
    got = fused_packer.ffd_pack(*args, objective=objective)
    torch.cuda.synchronize()
    assert fused_packer.LAUNCHES["choose_config"] == before["choose_config"] + 1
    assert fused_packer.LAUNCHES["ffd_scan"] == before["ffd_scan"] + 1
    _assert_bit_equal(got, pack_reference(*args, objective=objective))


def test_solve_on_card_matches_cpu(cuda_device):
    pools, inv, pods = T.heterogeneous_problem(scale=0.1)
    card = TorchScheduler(pools, inv, device=cuda_device)
    got = card.solve(pods)
    cpu = TorchScheduler(pools, inv, device="cpu").solve(pods)
    assert card.last_kernel == "cuda_ffd"
    key = lambda r: sorted(tuple(sorted(p.name for p in n.pods)) for n in r.new_nodes)
    assert key(got) == key(cpu)
    assert got.total_price() == cpu.total_price()


def test_wrapper_rejects_bad_inputs(cuda_device):
    pools, inv, pods = T.heterogeneous_problem(scale=0.01)
    args = list(to_device(pad_problem(compile_problem(pods, pools, inv))[0], cuda_device))
    args[0] = args[0].double()
    with pytest.raises(ValueError, match="dtype"):
        fused_packer.ffd_pack(*args)
