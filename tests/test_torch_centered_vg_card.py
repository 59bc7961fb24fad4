"""PyTorch port, the whitened FN value-and-grad's kernel on a card
(csrc/centered_vg.cu; tests marked ``cuda``, skipped without one): at every
shape of ``perf/vg_timing.CASES`` (the paths' chain counts and grids,
n = 41 to 3169, C = 1 to 128) the kernel agrees with its plain version
(float64 within 1e-12 relative, float32 within twice the plain version's
own error against float64), a chain's bits do not depend on what shares its
launch, and the x block of g_psi is the one-block kernel's bit for bit
(``vg_timing.check_case``). This file imports no JAX, so that it runs
where the card is and JAX is not installed."""
import pytest
import torch

from manifold_constrained_gaussian_process_inference_tpu_torch.perf import vg_timing


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(vg_timing.CASES))
def test_kernel_against_plain_version_and_pr11(card, name):
    err = vg_timing.check_case(vg_timing.make_case(name))
    assert err["x_block_bits_pr11_float32"] and err["x_block_bits_pr11_float64"]
