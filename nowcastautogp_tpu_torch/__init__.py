"""nowcastautogp_tpu_torch — the PyTorch and CUDA port of nowcastautogp_tpu.

The fit-and-forecast main paths: data transforms, the particle ensemble of
heap-encoded kernel trees, data-annealed SMC with host structure proposals
and batched HMC, the forecaster (``forecast``, ``predict_mvn``, and the
per-draw HMC refresh ``forecast_n_hmc``) and the no-refresh shared-date
nowcast forecast, and CRPS/quantile scoring.  The masked GP log marginal
likelihood runs in hand-written CUDA kernels on an NVIDIA card (``csrc/``:
by default the fused K1/K2 up to capacity 512 and the composed
K4 -> K3 -> K5 path up to 2048; under the opt-in "pallas" LML and
covariance backends, ``ops.lml.set_lml_backend`` and
``ops.cov.set_cov_backend``, the covariances K7F/K7B and the blocked
Cholesky core K6a/K6b) and in their plain torch versions on the CPU.  Entry points run on the card unless the caller passes
``device="cpu"``.  The port imports torch and numpy and never jax; module
and function names follow the JAX package ``nowcastautogp_tpu``, which is
its reference.
"""

from .eval.crps import (
    crps_ensemble, crps_matrix, quantile_matrix, quantile_matrix_device,
)
from .fitting import make_and_fit_model
from .forecasting import forecast
from .inference.schedule import linear_schedule
from .inference.smc import fit_smc
from .models.config import DEFAULT_DEPTH, GPConfig, HMCConfig
from .models.gp_model import (
    GPModel, add_data, maybe_resample, mcmc_parameters, mcmc_structure,
    num_particles, predict_mvn,
)
from .models.posterior import MvNormalMixture
from .nowcast import create_nowcast_data, forecast_with_nowcasts
from .tdata import TData, create_transformed_data
from .transforms import get_transformations

__version__ = "0.1.0"

__all__ = [
    "TData", "GPModel", "GPConfig", "HMCConfig", "DEFAULT_DEPTH",
    "create_transformed_data", "get_transformations", "make_and_fit_model",
    "forecast", "forecast_with_nowcasts", "create_nowcast_data",
    "fit_smc", "add_data", "predict_mvn", "maybe_resample",
    "mcmc_structure", "mcmc_parameters", "num_particles", "linear_schedule",
    "MvNormalMixture",
    "crps_ensemble", "crps_matrix", "quantile_matrix",
    "quantile_matrix_device",
]
