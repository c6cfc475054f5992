"""Simulation-based inference for pulse-based drift-diffusion models in JAX.

A JAX/XLA/Pallas framework with the capabilities of the reference
``SBI-for-Diffusion-Models`` pipeline (see SURVEY.md), run on one NVIDIA GPU:
pulse-DDM trial simulation (vmap+scan / a Pallas kernel on the GPU), a Mixed
Neural Likelihood Estimator (categorical choice head + conditional
rational-quadratic-spline flow over log-RT) in plain JAX, many-chain
NUTS/HMC/slice MCMC over the learned likelihood, and simulation-based
calibration -- all running end-to-end on device and scaling over a
``jax.sharding.Mesh``.
"""

from . import constants
from .run_config import RunConfig, RUN_CONFIG_PARAMS
from .distributions import (
    Beta,
    BoxUniform,
    LogNormal,
    MultipleIndependent,
    Normal,
    Uniform,
    mcmc_transform,
)
from .proposals import ExtendedProposal, PulseSequenceProposal
from .models import (
    ChoiceModelParams,
    RTChoiceModelParams,
    choice_model_simulator,
    choice_model_simulator_torch,
    generate_pulse_matrix,
    generate_pulse_matrix_numpy,
    generate_pulse_sides,
    n_pulses_max_from_schedule,
    pack_x_rt_choice,
    pulse_schedule,
    rt_choice_model_simulator,
    rt_choice_model_simulator_torch,
    simulate_session_data_rt_choice,
)
from .data_simulator import (
    sim_wrapper,
    simulate_observed_session,
    simulate_training_set_with_conditions,
    summarize_trials,
)
from .nets import MNLE, MNLEConfig, build_mnle
from .potentials import ConditionedMNLELogLikelihood, ThetaOnlyPosteriorPotential
from .inference import MCMCPosterior, run_nuts, run_slice
from .mnle import load_model, run_inference_mcmc, run_sbc, save_model, train_mnle
from .analysis import pairplot, sbc_uniformity_stats
from .pipeline import build_prior_theta, main
from .snpe import DirectPosterior, train_snle, train_snpe
from .datasets import make_x_from_rat_df, split_by_subject
from .models.hierarchical import (
    HierarchicalModel,
    run_hierarchical_inference,
    simulate_hierarchical_sessions,
)
from .models.pulse_ddm_7p import (
    rt_choice_model_simulator_7p,
    simulate_session_data_7p,
)

__version__ = "0.1.0"
