"""The CUDA ppa_eval kernel against its plain version, on the card.

Needs an NVIDIA GPU with nvcc (the kernel is built at first use); skipped
elsewhere.  On the card: ``python -m pytest -q -m cuda tests/``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ppa_eval import (op_table_tensor, ppa_eval,
                                          ppa_eval_plain)
from repro_torch.perfmodel import get_evaluator
from repro_torch.perfmodel import workload as T_W
from repro_torch.perfmodel.designspace import SPACE

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("which", ["prefill", "decode"])
@pytest.mark.parametrize("b", [1, 255, 256, 65_553, 131_072])
def test_kernel_matches_plain(cuda, which, b):
    wl = getattr(T_W, f"gpt3_layer_{which}")()
    idx = torch.as_tensor(SPACE.sample(np.random.default_rng(7), b),
                          device=cuda)
    dv = SPACE.decode_values(idx)
    tab = op_table_tensor(wl, cuda)
    before = ppa_eval.launches
    got = ppa_eval(dv, tab, float(wl.tp))
    torch.cuda.synchronize()
    assert ppa_eval.launches == before + 1
    want = ppa_eval_plain(dv, tab, float(wl.tp))
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-4)
    np.testing.assert_allclose(got[:, 1:5], want[:, 1:5], rtol=1e-4,
                               atol=1e-9)
    np.testing.assert_allclose(got[:, 5], want[:, 5], rtol=1e-5)
    assert np.array_equal(got, want)      # same arithmetic, same order


def test_auto_backend_times_the_candidates_on_the_card(cuda):
    ev = get_evaluator("proxy", backend="auto", device=cuda)
    assert ev.backend in ("roofline", "cuda")
    idx = SPACE.sample(np.random.default_rng(3), 500)
    ref = get_evaluator("proxy", backend="roofline", device=cuda)
    assert np.array_equal(ev.objectives(idx), ref.objectives(idx))


def test_kernel_rejects_misaligned_rows(cuda):
    tab = op_table_tensor(T_W.gpt3_layer_prefill(), cuda)
    buf = torch.ones(8 * 5 + 1, dtype=torch.float32, device=cuda)
    dv = buf[1:].view(5, 8)               # contiguous but 4-byte offset
    with pytest.raises(ValueError, match="aligned"):
        ppa_eval(dv, tab, 8.0)


def test_launch_leaves_the_current_device_alone(cuda):
    """A launch on the last card's tensors selects that card only for the
    launch."""
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    before = torch.cuda.current_device()
    tab = op_table_tensor(T_W.gpt3_layer_decode(), last)
    dv = SPACE.decode_values(torch.as_tensor(
        SPACE.sample(np.random.default_rng(4), 300), device=last))
    out = ppa_eval(dv, tab, 8.0)
    assert out.device == last
    assert torch.cuda.current_device() == before
    torch.cuda.synchronize(last)
    assert torch.equal(out, ppa_eval_plain(dv, tab, 8.0))
