"""PyTorch port, the whitened FN value-and-grad's kernel on a card
(csrc/centered_vg.cu; tests marked ``cuda``, skipped without one): at every
shape of ``perf/vg_timing.CASES`` (the paths' chain counts and grids,
n = 41 to 3169, C = 1 to 128) the kernel agrees with its plain version and
with the scalar cluster kernel (float64 within 1e-12 relative, float32 within twice
the plain version's and the scalar cluster kernel's own error against float64), and a
chain's bits do not depend on what shares its launch
(``vg_timing.check_case``); the card's prepared tiles are
``prepare_tiles_torch``'s bit for bit in both dtypes, and a launch meant
as one wave (within TARGET_BLOCKS blocks) fits the card at once
(cudaOccupancyMaxActiveClusters). This file imports no JAX, so that it runs
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
    from manifold_constrained_gaussian_process_inference_tpu_torch.ops import centered_vg as cv

    case = vg_timing.make_case(name)
    err = vg_timing.check_case(case)
    assert err["prepare_equal"]
    tile = cv.tiling(case["n"], case["bandwidth"], case["chains"])
    if tile.cluster * tile.clusters <= cv.TARGET_BLOCKS:
        assert err["active_clusters"] >= err["clusters"] == tile.clusters
    for what in ("lp", "g"):
        assert err[f"{what}_rel_pr12_float64"] <= vg_timing.TOL_F64
        assert err[f"{what}_float32"] <= vg_timing.F32_FACTOR * err[f"{what}_float32_pr12"]
