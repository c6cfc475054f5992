"""Test configuration: run on a virtual 8-device CPU mesh.

Multi-card hardware is not available in CI, so sharding paths are validated
on fake host devices -- the standard JAX substitute for the fake-backend
infrastructure the reference lacks (see SURVEY.md section 4).

Tests that need the GPU carry the ``gpu`` marker and skip elsewhere; the
decision is taken at run time by the ``_gpu_only`` fixture below. On the
card they run with ``python -m pytest -m gpu tests/``, which leaves JAX's
platform alone; every other selection forces the CPU mesh before JAX
initializes its backends.
"""

import os

import pytest


def pytest_configure(config):
    if (config.option.markexpr or "").strip() == "gpu":
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    assert len(jax.devices()) == 8, (
        f"expected 8 virtual CPU devices, got {jax.devices()}"
    )


@pytest.fixture(autouse=True)
def _gpu_only(request):
    if request.node.get_closest_marker("gpu") is not None:
        import jax

        if jax.default_backend() != "gpu":
            pytest.skip("needs a GPU: run `python -m pytest -m gpu tests/` on the card")


# ---------------------------------------------------------------------------
# Fast/slow split: the statistical / end-to-end tests
# below take 20-120 s each on the virtual-CPU mesh and dominate the suite's
# ~40 min serial wall-clock. They are marked `slow` centrally (from the
# measured --durations profile) so the fast tier still imports and exercises
# every module:
#
#   python -m pytest tests/ -q -m "not slow" -n 4   # fast tier, ~3-4 min
#   python -m pytest tests/ -q                      # full suite, ~40 min
SLOW_TESTS = frozenset({
    # hierarchical joint inference (full NUTS per test)
    "test_hierarchical_inference_batched_datasets",
    "test_hierarchical_inference_with_parallel_tempering",
    "test_hierarchical_inference_with_ensemble",
    "test_simulate_and_infer_tiny",
    # batched SBC driver end-to-end
    "test_run_sbc_batched_shapes_and_files",
    "test_run_sbc_serial_matches_interface",
    "test_run_sbc_batched_with_slice",
    "test_run_sbc_batched_on_mesh",
    "test_run_sbc_batched_with_pulse_rep",
    "test_run_sbc_batched_with_parallel_tempering",
    "test_run_sbc_pt_on_mesh",
    "test_sbc_mixing_gate_remediation",
    "test_sbc_remediation_substitutes_draws",
    "test_sbc_remediation_escalates_rounds",
    # MNLE training / statistical recovery
    "test_training_learns_synthetic_likelihood",
    "test_z_score_x_string_semantics",
    "test_num_categories_explicit_and_validated",
    "test_embedded_training_uses_pulse_block",
    "test_log_theta_dims_train_and_roundtrip",
    "test_censored_rt_likelihood",
    "test_shifted_log_train_recovers_onset",
    "test_append_mode_log_prob_normalizes",
    "test_pulse_rep_learns_atomic_rts",
    "test_pulse_rep_log_prob_normalizes",
    "test_cond_affine_exact_identity",
    "test_cond_affine_normalizes",
    # flow / SNPE / SNLE statistical recovery
    "test_fit_flow_learns_conditional_gaussian",
    "test_snpe_recovers_gaussian_posterior",
    "test_snle_posterior_on_gaussian",
    # MCMC / tempering statistical tests
    "test_compose_moves_hop_plus_slice",
    "test_pt_recovers_bimodal_weights_plain_nuts_fails",
    "test_mcmc_posterior_pt_path",
    # mesh-sharded training / chains
    "test_tp_train_step_2d_mesh",
    "test_chain_sharded_nuts",
    # ensemble potential end-to-end
    "test_potential_stack_duck_typing",
    # potentials statistical checks
    "test_summed_loglik_matches_manual_tiling",
    "test_potential_prior_plus_tempered_loglik",
})


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.name.split("[")[0] in SLOW_TESTS:
            item.add_marker(pytest.mark.slow)
