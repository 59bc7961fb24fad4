from . import band, cuda_band, gp_cov, kernels, likelihood  # noqa: F401
from .gp_cov import GPCov, build_gp_cov, calculate_gp_covariances  # noqa: F401
from .likelihood import (  # noqa: F401
    BandedLikelihoodData,
    LikelihoodData,
    log_likelihood_and_gradient_banded,
    log_posterior,
    make_banded_likelihood_data,
    make_likelihood_data,
)
