"""manifold_constrained_gaussian_process_inference_tpu_torch

The PyTorch/CUDA port of the JAX package
``manifold_constrained_gaussian_process_inference_tpu``: the same
``solve_magi`` entry, ``MagiConfig`` keys, Psi layout and ``MagiResult``
contract, with the band-storage matvec as a hand-written CUDA kernel for
Hopper (csrc/band_matvec.cu).

Float32 contractions on the card must stay true float32 (the JAX package
needed Precision.HIGHEST on the TPU for the same reason: the GP operators
feed quadratic forms scaled by ~1/jitter). Importing the package turns
TF32 off for matmuls and cuDNN; ``solve_magi`` asserts it is still off.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from .config import MagiConfig, default_device, default_dtype  # noqa: E402,F401
from .models import FN_SYSTEM, OdeSystem, get_system, registered_systems  # noqa: E402,F401
from .ops import (  # noqa: E402,F401
    GPCov,
    build_gp_cov,
    calculate_gp_covariances,
    log_likelihood_and_gradient_banded,
    log_posterior,
)
from .inference import MagiResult, MagiTarget, run_nuts, solve_magi  # noqa: E402,F401

__version__ = "0.1.0"


def __getattr__(name):
    # the postprocessing layer loads on first use (plot_magi imports
    # matplotlib), as in the JAX package
    if name in ("magi_summary", "results_to_chain", "plot_magi"):
        from . import postprocess

        return getattr(postprocess, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
