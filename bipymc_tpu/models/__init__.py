from bipymc_tpu.models.targets import (
    correlated_gaussian,
    correlated_gaussian_block,
    banana,
    banana_block,
    rosenbrock,
    gaussian_mixture,
    gaussian_mixture_block,
    neal_funnel,
    eggbox,
    line_fit_log_like,
)
