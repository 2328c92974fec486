"""nowcastautogp_tpu_torch — the PyTorch and CUDA port of nowcastautogp_tpu.

The port's first slice: the fit-and-nowcast main path.  Data transforms,
the particle ensemble of heap-encoded kernel trees, data-annealed SMC with
host structure proposals and batched HMC, the no-refresh shared-date
nowcast forecast, and CRPS/quantile scoring.  The masked GP log marginal
likelihood runs in hand-written CUDA kernels on an NVIDIA card
(``ops/megalml.py``, ``csrc/megalml.cu``) and in plain torch on the CPU.
The port imports torch and numpy and never jax; module and function names
follow the JAX package ``nowcastautogp_tpu``, which is its reference.
"""

from .eval.crps import (
    crps_ensemble, crps_matrix, quantile_matrix, quantile_matrix_device,
)
from .fitting import make_and_fit_model
from .inference.schedule import linear_schedule
from .inference.smc import fit_smc
from .models.config import DEFAULT_DEPTH, GPConfig, HMCConfig
from .models.gp_model import GPModel, add_data, maybe_resample, num_particles
from .nowcast import create_nowcast_data, forecast_with_nowcasts
from .tdata import TData, create_transformed_data
from .transforms import get_transformations

__version__ = "0.1.0"

__all__ = [
    "TData", "GPModel", "GPConfig", "HMCConfig", "DEFAULT_DEPTH",
    "create_transformed_data", "get_transformations", "make_and_fit_model",
    "forecast_with_nowcasts", "create_nowcast_data",
    "fit_smc", "add_data", "maybe_resample", "num_particles",
    "linear_schedule",
    "crps_ensemble", "crps_matrix", "quantile_matrix",
    "quantile_matrix_device",
]
