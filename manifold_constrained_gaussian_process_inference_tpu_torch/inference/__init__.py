from .adapt import build_window_schedule  # noqa: F401
from .checkpoint import (  # noqa: F401
    SamplerCheckpoint,
    checkpoint_from_result,
    load_checkpoint,
    run_chains_resumed,
    save_checkpoint,
)
from .nlml import negative_log_marginal_likelihood, optimize_gp_hyperparameters  # noqa: F401
from .nuts import nuts_transition, run_nuts  # noqa: F401

# the JAX package's alias (the reference exports run_nuts_sampler)
run_nuts_sampler = run_nuts
from .chees import run_chees  # noqa: E402,F401
from .solve import MagiError, MagiResult, map_warm_start, solve_magi  # noqa: E402,F401
from .target import MagiTarget  # noqa: E402,F401
from .tempering import geometric_ladder, run_parallel_tempering  # noqa: E402,F401
from .transforms import ThetaTransform, make_theta_transform  # noqa: E402,F401
from .whiten import (  # noqa: E402,F401
    PsiWhitener,
    build_psi_whitener,
    gauss_newton_map,
    make_centered_whitened_vg,
    wrap_value_and_grad,
)
