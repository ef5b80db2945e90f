"""bipymc_tpu — accelerator-native Bayesian MCMC.

A brand-new JAX/XLA/Pallas framework with the capabilities of
``wgurecky/bipymc`` (see SURVEY.md for the capability contract):

- Sampler zoo: Metropolis, Adaptive Metropolis (Haario 2001), Delayed
  Rejection (Green & Mira 2001), DRAM (Haario 2006), DE-MC (ter Braak 2006),
  DE-MC-z with snooker updates (ter Braak & Vrugt 2008), DREAM-zs with
  crossover adaptation (Vrugt 2009/2011).
- Chains are a *batch axis*, never objects: ``vmap`` gives many chains on one
  device; ``jax.shard_map`` over a ``Mesh(("chains",))`` gives many devices
  with the same step function — this replaces the reference's mpi4py chain
  pool (SURVEY.md §3.2).
- GP regression (SE-ARD kernel, Cholesky fit/predict, exact log-marginal
  likelihood with ``jax.grad`` hyperopt).
- Fused multi-generation engines (``fused=True``): whole chunks of
  generations per Pallas-Triton kernel on the GPU (interpret mode on the
  CPU) — ``ops/route.py``.
- On-device diagnostics: split Gelman-Rubin R-hat, FFT autocorrelation / ESS,
  acceptance fractions, streaming R-hat early stopping.
"""

from bipymc_tpu.samplers.api import (
    Metropolis,
    AdaptiveMetropolis,
    DrMetropolis,
    Dram,
    DelayedAcceptance,
    DeMc,
    DeMcZ,
    Dream,
    EnsembleSampler,
    EnsembleSlice,
    FlowMh,
    Hmc,
    Chees,
    EllipticalSlice,
    Mala,
    Nuts,
    NestedSampler,
    Smc,
    Svgd,
    Advi,
    ParallelTempering,
    DreamZs,
)
from bipymc_tpu.utils.init import var_ball
from bipymc_tpu.utils.diagnostics import (gelman_rubin,
                                          effective_sample_size,
                                          rank_normalized_rhat,
                                          ess_bulk, ess_multichain, ess_tail,
                                          mcse_mean, mcse_sd,
                                          mode_occupancy, mode_hops,
                                          geweke, multivariate_rhat,
                                          summary)
from bipymc_tpu.utils.external import (external_log_like,
                                       external_log_like_masked)
from bipymc_tpu.utils.laplace import map_estimate, laplace_cov, map_laplace
from bipymc_tpu.utils.transforms import constrain, transform_log_prob
from bipymc_tpu.utils.sbc import sbc_ranks, sbc_uniformity
from bipymc_tpu.utils.flows import (FlowConfig, FlowParams, fit_flow,
                                    flow_log_q, flow_proposal,
                                    flow_sample, flow_transform)
from bipymc_tpu.utils.mixtures import (GmmParams, fit_gmm, gmm_log_q,
                                       gmm_proposal, gmm_sample)
from bipymc_tpu.utils.proposals import Proposal
from bipymc_tpu.utils.psis import psis, surrogate_reweight, importance_resample
from bipymc_tpu.utils.loo import loo, loo_compare, pointwise_loglik, waic
from bipymc_tpu.utils.evidence import (BridgeResult, EvidenceResult,
                                       bridge_evidence, power_ladder,
                                       power_posterior_evidence)
from bipymc_tpu.models.targets import stratified_mode_init

__version__ = "0.3.0"

__all__ = [
    "Metropolis",
    "AdaptiveMetropolis",
    "DrMetropolis",
    "Dram",
    "DelayedAcceptance",
    "DeMc",
    "DeMcZ",
    "Dream",
    "EnsembleSampler",
    "EnsembleSlice",
    "FlowMh",
    "Hmc",
    "Chees",
    "EllipticalSlice",
    "Mala",
    "Nuts",
    "NestedSampler",
    "Smc",
    "Svgd",
    "Advi",
    "ParallelTempering",
    "DreamZs",
    "var_ball",
    "gelman_rubin",
    "effective_sample_size",
    "rank_normalized_rhat",
    "ess_bulk",
    "ess_multichain",
    "mcse_mean",
    "mcse_sd",
    "ess_tail",
    "summary",
    "mode_occupancy",
    "mode_hops",
    "stratified_mode_init",
    "external_log_like",
    "external_log_like_masked",
    "map_estimate",
    "laplace_cov",
    "map_laplace",
    "constrain",
    "transform_log_prob",
    "sbc_ranks",
    "FlowConfig",
    "FlowParams",
    "fit_flow",
    "flow_log_q",
    "flow_proposal",
    "flow_sample",
    "flow_transform",
    "GmmParams",
    "fit_gmm",
    "gmm_log_q",
    "gmm_proposal",
    "gmm_sample",
    "Proposal",
    "psis",
    "surrogate_reweight",
    "importance_resample",
    "sbc_uniformity",
    "loo",
    "loo_compare",
    "pointwise_loglik",
    "waic",
    "BridgeResult",
    "EvidenceResult",
    "bridge_evidence",
    "power_ladder",
    "power_posterior_evidence",
]
