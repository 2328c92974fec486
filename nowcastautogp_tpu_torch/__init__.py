"""nowcastautogp_tpu_torch — the PyTorch and CUDA port of nowcastautogp_tpu.

The fit-and-forecast main paths: data transforms, the particle ensemble of
heap-encoded kernel trees, data-annealed SMC with host or device structure
proposals and batched HMC, the forecaster (``forecast``, ``predict_mvn``,
and the per-draw HMC refresh ``forecast_n_hmc``) and the nowcast forecast
with its refresh branches; the multi-series panel (``fit_panel``,
``forecast_panel``, ``panel_predict_mvn``) on one card; and the workflow
around them: CRPS/WIS scoring, hubverse quantile submissions,
vintaged data, the five-approach acceptance comparison
(``run_acceptance``), additive decomposition, checkpoints, phase
timers and spans (``recording``).  The masked GP log marginal
likelihood runs in hand-written CUDA kernels on an NVIDIA card (``csrc/``:
by default the fused K1/K2 up to capacity 512 and the composed
K4 -> K3 -> K5 path above, up to 4096; under the opt-in "pallas" LML and
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
from .eval.acceptance import run_acceptance, synthetic_nhsn_vintage
from .eval.submission import quantile_submission, write_submission_csv
from .eval.wis import (
    FLUSIGHT_QUANTILES, coverage_matrix, interval_score, wis_ensemble,
    wis_matrix,
)
from .fitting import make_and_fit_model
from .forecasting import forecast
from .inference.schedule import linear_schedule
from .inference.smc import fit_smc
from .models.config import DEFAULT_DEPTH, GPConfig, HMCConfig
from .models.decompose import decompose
from .models.gp_model import (
    GPModel, add_data, maybe_resample, mcmc_parameters, mcmc_structure,
    num_particles, predict_mvn,
)
from .models.posterior import MvNormalMixture
from .nowcast import create_nowcast_data, forecast_with_nowcasts
from .parallel.panel import fit_panel, forecast_panel, panel_predict_mvn
from .tdata import TData, create_transformed_data
from .transforms import get_transformations
from .utils.data import VintagedData, load_vintaged_csv
from .utils.profiling import (
    device_trace, phase_report, recording, reset_phases,
)
from .utils.serialize import load_model, save_model

__version__ = "0.1.0"

__all__ = [
    "TData", "GPModel", "GPConfig", "HMCConfig", "DEFAULT_DEPTH",
    "create_transformed_data", "get_transformations", "make_and_fit_model",
    "forecast", "forecast_with_nowcasts", "create_nowcast_data",
    "fit_smc", "add_data", "predict_mvn", "maybe_resample",
    "mcmc_structure", "mcmc_parameters", "num_particles", "linear_schedule",
    "MvNormalMixture",
    "decompose", "crps_ensemble", "crps_matrix", "quantile_matrix",
    "quantile_matrix_device", "run_acceptance", "synthetic_nhsn_vintage",
    "wis_ensemble", "wis_matrix", "interval_score", "coverage_matrix",
    "FLUSIGHT_QUANTILES", "quantile_submission", "write_submission_csv",
    "phase_report", "reset_phases", "device_trace", "recording",
    "save_model", "load_model", "VintagedData", "load_vintaged_csv",
    "fit_panel", "forecast_panel", "panel_predict_mvn",
]
