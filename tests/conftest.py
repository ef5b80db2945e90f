"""Test environment: 8 fake CPU devices.

The reference tests ensemble samplers under ``mpiexec -n 2..4`` on one node
(SURVEY.md §6). The JAX equivalent needs no cluster either: force the host
platform and 8 virtual CPU devices so the shard_map path runs real
collectives. Must run before jax is imported anywhere.
"""

import os

# BIPYMC_GPU_TESTS=1 keeps the real backend so the tests marked ``gpu``
# (compiled Triton kernels against their plain references) run on the
# card:   BIPYMC_GPU_TESTS=1 python -m pytest tests -m gpu -p no:xdist
# Otherwise the suite runs on the CPU backend with 8 virtual devices, and
# the fused kernels run in Pallas interpret mode.
_GPU_TESTS = os.environ.get("BIPYMC_GPU_TESTS") == "1"

if not _GPU_TESTS:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not _GPU_TESTS:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
# The XLA CPU client's async dispatch pool can deadlock interpret-mode
# Pallas calls on a single-core box (they wait for the slot they
# occupy); synchronous dispatch removes the pool from the picture.
jax.config.update("jax_cpu_enable_async_dispatch", False)


import pytest  # noqa: E402

# ---------------------------------------------------------------------------
# Suite tiering. `pytest -m quick` runs ONE cheap,
# representative test per component — golden pins, exactness/reference
# matches, one mesh path, validation probes — and must stay under ~2
# minutes on a single CPU core. The full suite (no -m) remains the
# nightly gate. A bare filename marks the whole file.
# ---------------------------------------------------------------------------
QUICK = {
    # L0 numerics / rng / linalg
    "test_rng_bits.py::test_bits_to_uniform_law",
    "test_linalg.py::test_solve_chol",
    # proposals, archive, index sampling
    "test_proposals.py::test_gaussian_logpdf_matches_scipy",
    "test_ensemble_utils.py::test_archive_ring_buffer_wraparound",
    "test_distinct_idx.py::test_matches_reference[16-3-11]",
    # golden trajectory pins: every core sampler family
    "test_golden.py",
    # injected-stream exact fidelity vs the NumPy reference
    "test_fidelity_injected.py::test_dram_injected_stream_exact",
    # single-chain family API
    "test_rw_samplers.py::test_seeded_reproducibility",
    # ensemble family API
    "test_ensemble_samplers.py::test_reset_reruns_identically",
    # mesh paths (vmap <-> shard_map bit-identity, sharded archive)
    "test_sharding.py::test_dream_mesh_equals_vmap",
    "test_sharded_archive.py::test_ring_gather_matches_direct_gather",
    # streaming R-hat early stop
    "test_early_stop.py::test_streaming_rhat_matches_batch_formula",
    # fused Pallas engines
    "test_fused_chunk.py::test_fused_validation_errors",
    "test_fused_rw.py::test_fused_rejects_rank1_mode",
    "test_stretch.py::test_odd_walker_count_raises",
    "test_kernel_route.py::test_interpret_only_on_cpu",
    # GP family
    "test_gp.py::test_pairwise_sqdist_matches_bruteforce",
    "test_gp.py::test_log_ml_grad_matches_finite_difference",
    "test_gp_sparse.py::test_elbo_equals_exact_lml_when_z_is_x",
    "test_gp_sharded.py::test_sharded_gram_matches_dense",
    "test_gp_xla.py::test_log_ml_and_grad_match_scipy[64-1]",
    # diagnostics, plotting, checkpoint
    "test_diagnostics.py::test_rhat_matches_numpy_formula",
    "test_diagnostics.py::test_mode_occupancy_and_hops",
    "test_checkpoint_plot.py::test_checkpoint_roundtrip_state",
    "test_checkpoint_plot.py::test_plot_rank",
    # gradient family
    "test_hmc.py::test_leapfrog_reversibility",
    "test_nuts.py::test_checkpoint_index_math",
    "test_chees.py::test_van_der_corput_stratifies",
    # particle / variational / evidence / calibration
    "test_smc.py::test_systematic_resampling_exact_counts",
    "test_ns.py::test_max_batches_warns",
    "test_svgd.py::test_step_matches_numpy_reference",
    "test_advi.py::test_validation",
    "test_evidence.py::test_streaming_lse_matches_direct",
    "test_psis.py::test_gpd_fit_recovers_shape_and_scale",
    "test_loo.py::test_loo_shape_validation",
    "test_sbc.py::test_validation",
    # slice / tempering / delayed acceptance / laplace
    "test_eslice.py::test_diag_vector_matches_diag_matrix",
    "test_enslice.py::test_numpy_reference_one_generation",
    "test_tempering.py::test_pt_validates_ladder",
    "test_da.py::test_da_perfect_surrogate_accepts_every_promotion",
    "test_laplace.py::test_laplace_cov_exact_on_gaussian",
    # flows / mixtures / global moves / transforms
    "test_flows.py::test_identity_at_init",
    "test_mixtures.py::test_gmm_proposal_inflate",
    "test_flowmh_fused.py::test_validation",
    "test_transforms.py::test_roundtrip_all_regimes",
    # targets / external likelihoods / debug utils / f64
    "test_external.py::test_external_matches_traceable",
    "test_utils_debug.py::test_validate_ok",
    "test_float64.py::test_float64_samplers",
}


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Tests marked ``gpu`` need a CUDA device: decided here, at run time,
    never at import (every xdist worker must collect the same tests)."""
    if (request.node.get_closest_marker("gpu") is not None
            and jax.default_backend() != "gpu"):
        pytest.skip("needs a GPU: run with BIPYMC_GPU_TESTS=1 on the card")


def pytest_collection_modifyitems(config, items):
    for item in items:
        nid = item.nodeid
        if nid.startswith("tests/"):
            nid = nid[len("tests/"):]
        if nid in QUICK or nid.split("::", 1)[0] in QUICK:
            item.add_marker(pytest.mark.quick)
